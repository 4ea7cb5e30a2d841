"""Lazy ``nvcc`` build and ``ctypes`` binding of the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` into one shared library with
a plain C interface at the first CUDA call, never at import: one ``nvcc``
per source, all started together, then one link. The library goes to
``_build/`` beside the package (listed in ``.gitignore``), named by a hash
of all the sources, so an edited source is rebuilt and an unchanged set is
loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from torch_m3gnet_tpu_torch.utils import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argument types; every entry returns cudaError_t as int
# and takes the stream last.
_ENTRIES = {
    # (sh, gm, src offsets, out, num_edges, num_nodes, l_max, n_max, members,
    #  sh member stride, gm member stride, stream); a stride of 0: the
    #  operand is shared by every member
    "m3g_q_scatter": [_P] * 4 + [_I] * 5 + [_L] * 2 + [_P],
    # (in0, in1, src, out, num_edges, num_nodes, l_max, n_max, members,
    #  in0 member stride, in1 member stride, stream)
    "m3g_r1_gather": [_P] * 4 + [_I] * 5 + [_L] * 2 + [_P],
    "m3g_r2_gather": [_P] * 4 + [_I] * 5 + [_L] * 2 + [_P],
    # (data, idx, out, rows, num_cols, num_idx, stream)
    "m3g_windowed_take": [_P] * 3 + [_I] * 3 + [_P],
    # (vals, order or NULL, offsets, out, rows, num_cols, num_idx, stream)
    "m3g_windowed_scatter": [_P] * 4 + [_I] * 3 + [_P],
    # (basis, gate, e1 offsets, e2, out, rows, num_edges, num_trip, members,
    #  basis member stride, gate member stride, stream)
    "m3g_fused_triplet_gate_sum": [_P] * 5 + [_I] * 4 + [_L] * 2 + [_P],
    # (basis, gate, g, e1, e2, e2 order, e2 offsets, d_basis, d_gate, rows,
    #  num_edges, num_trip, members, basis, gate and g member strides, stream)
    "m3g_backward_pair": [_P] * 9 + [_I] * 4 + [_L] * 3 + [_P],
    # (data, seg offsets, out, rows, num_rows_m, num_segments, rows of one
    #  member, stream)
    "m3g_sorted_segment_sum": [_P] * 3 + [_I] * 4 + [_P],
    # (host table of (pointer, length, bound, element bytes, sort mask, range
    #  mask) int64 rows, rows, word, stream)
    "m3g_check_batch_index": [_P, _I, _P, _P],
    # (core, gate, host array of the 6 parameter pointers, out, F, M, 16-byte
    #  vectors, eps, stream)
    "m3g_norm_gate_fwd": [_P] * 4 + [_I, _L, _I, _F] + [_P],
    # (F, M, 16-byte vectors, out: the backward's rows of partial sums,
    #  stream (unused)); launches nothing
    "m3g_norm_gate_bwd_rows": [_I, _L, _I, _P, _P],
    # (g, core, gate, parameters, d_core, d_gate, partial sums, their rows,
    #  host array of the 6 gradient pointers, F, M, 16-byte vectors, eps, stream)
    "m3g_norm_gate_bwd": [_P] * 7 + [_I, _P, _I, _L, _I, _F] + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of torch_m3gnet_tpu_torch are built at first use"
        )
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one library in ``_build/`` unless the
    same sources and headers (``csrc/*.cuh``) were built before; returns the
    library path. The compilers' reports (``-Xptxas -v``: registers, spills)
    are kept beside it as ``<lib>.log``."""
    srcs = sources()
    digest = hashlib.sha256()
    for src in srcs + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    lib = BUILD_DIR / f"libm3g_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [lib.with_name(f"{lib.stem}.{src.stem}.{tag}.o") for src in srcs]
    procs = [
        subprocess.Popen(
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(srcs, objs)
    ]
    reports = [(src, proc.communicate()[0], proc.returncode) for src, proc in zip(srcs, procs)]
    tmp = lib.with_name(f"{lib.name}.{tag}")
    failed = [(src, out) for src, out, rc in reports if rc != 0]
    if not failed:
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        reports.append(("link", link.stdout + link.stderr, link.returncode))
        if link.returncode != 0:
            failed = [("link", link.stdout + link.stderr)]
    lib.with_suffix(".so.log").write_text(
        "".join(f"== {src}\n{out}" for src, out, _ in reports)
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        src, out = failed[0]
        raise RuntimeError(f"nvcc failed building {src}:\n{out[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_index(name: str, label: str, t, length: int) -> None:
    """Raise ``ValueError`` unless ``t`` is a 1-D index of ``length``
    entries: the run offsets or the order that a sorted op takes from the
    batch (``data.to_torch`` builds them once per batch). It runs on every
    path, so that a CPU run catches a caller that forgets them."""
    if t is None:
        raise ValueError(f"{name}: {label} is required: the batch carries it "
                         f"(data.to_torch builds it)")
    if tuple(t.shape) != (length,):
        raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, expected ({length},)")


def is_cuda(name: str, floats, indices) -> bool:
    """True for the kernel path, False for the CPU (plain) path.

    ``floats`` and ``indices`` are (label, tensor) pairs. Raises for what no
    kernel takes: a device other than the CPU or CUDA, operands on
    different devices, and on CUDA a float type other than float32 or
    indices that are not contiguous int32."""
    import torch

    dev = floats[0][1].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for label, t in [*floats, *indices]:
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, expected {dev}")
    for label, t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32 {label}, got {t.dtype}")
    for label, t in indices:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name}: {label} must be contiguous int32, got {t.dtype}")
    return True


def call(name: str, entry: str, device, *args) -> None:
    """Call C entry ``entry`` with ``args`` (pointers and sizes as ints) on
    the current stream of ``device`` and raise on a CUDA error."""
    import torch

    with torch.cuda.device(device):
        err = getattr(library(), entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: {entry} failed with CUDA error {err}")


def launch(name: str, entry: str, device, *args) -> None:
    """:func:`call` of a kernel's launch, and add one to the counter
    ``launch.<name>`` (``utils.profiling``)."""
    call(name, entry, device, *args)
    profiling.count(f"launch.{name}")
