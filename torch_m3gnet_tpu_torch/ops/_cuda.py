"""Lazy ``nvcc`` build and ``ctypes`` binding of the port's CUDA kernels.

The kernels under ``csrc/`` are compiled for ``sm_90a`` into a shared
library with a plain C interface at the first CUDA call, never at import.
The library goes to ``_build/`` beside the package (listed in
``.gitignore``), named by a hash of its source, so an edited source is
rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# C entry points: (in0, in1, src, out, num_edges, num_nodes, l_max, n_max,
# stream) -> cudaError_t as int.
_ENTRY_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ENTRIES = ("m3g_q_scatter", "m3g_r1_gather", "m3g_r2_gather")

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


def build() -> Path:
    """Compile ``csrc/factorized_stage.cu`` into ``_build/`` unless the same
    source was built before; returns the library path. The compiler's report
    (``-Xptxas -v``: registers, spills) is kept beside it as ``<lib>.log``."""
    src = CSRC / "factorized_stage.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(tmp), str(src),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".so.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in _ENTRIES:
                fn = getattr(lib, name)
                fn.argtypes = _ENTRY_ARGTYPES
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
