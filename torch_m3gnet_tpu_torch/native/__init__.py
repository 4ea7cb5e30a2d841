"""Native (C++) host components, built on first use and bound with ``ctypes``.

Own copy of ``torch_m3gnet_tpu.native``: ``neighbor.cpp`` holds the O(N)
cell-list neighbour search (``m3g_neighbor_list``) and the triplet
enumerator (``m3g_threebody``) that MD and relaxation run at every
neighbour-list rebuild. The first call compiles it with
``g++ -O3 -shared -fPIC -std=c++17`` into ``_build/`` beside the package
(listed in ``.gitignore``), named by a hash of the source, so an edited
source is rebuilt and an unchanged one is loaded as it is.

Unlike the JAX package, a failed build raises :class:`NativeBuildError`
instead of falling back to numpy: the callers choose the native path for
large cells, where numpy's O(N^2 * images) search would take the run's
time. A caller who wants numpy passes ``use_native=False`` to
``data.neighbor_list_pbc`` and ``data.compute_threebody``.

``CALLS`` counts the calls that ran each native function.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "neighbor.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

CALLS = {"neighbor_list": 0, "threebody": 0}

_P64, _PF64, _I64, _F64 = (ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
                           ctypes.c_int64, ctypes.c_double)
_ENTRIES = {
    # (lattice, pos, n, cutoff, cap, src, dst, shift, dist)
    "m3g_neighbor_list": [_PF64, _PF64, _I64, _F64, _I64, _P64, _P64, _P64, _PF64],
    # (edge_src, dist, num_nodes, num_edges, cutoff, cap, e1, e2, per_node, per_edge)
    "m3g_threebody": [_P64, _PF64, _I64, _I64, _F64, _I64, _P64, _P64, _P64, _P64],
}

_lock = threading.Lock()
_libs: dict[tuple[str, str], ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """The C++ source did not compile or the library did not load."""


def reset_call_counts() -> None:
    for name in CALLS:
        CALLS[name] = 0


def build() -> Path:
    """Compile ``neighbor.cpp`` with ``CXX`` into ``BUILD_DIR`` unless this
    source was built there before; returns the library path. Each process
    compiles to its own temporary name and renames it into place, so
    concurrent first calls never load half a file."""
    cxx, build_dir = CXX, Path(BUILD_DIR)
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = build_dir / f"libm3g_native_{digest}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as exc:  # the compiler itself is missing
        raise NativeBuildError(f"cannot run {cxx!r} to build {SOURCE.name}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"{cxx} failed building {SOURCE.name}:\n{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded native library, built on first call with ``CXX`` into
    ``BUILD_DIR``."""
    key = (CXX, str(BUILD_DIR))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise NativeBuildError(f"cannot load {path}: {exc}") from exc
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int64
            _libs[key] = lib
        return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def neighbor_list_native(
    lattice: np.ndarray, cart_coords: np.ndarray, cutoff: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cell-list neighbour search; the contract of ``data.neighbor_list_pbc``
    (edges sorted by (src, dst, shift))."""
    lib = library()
    lattice = np.ascontiguousarray(lattice, dtype=np.float64).reshape(3, 3)
    pos = np.ascontiguousarray(cart_coords, dtype=np.float64).reshape(-1, 3)
    n = pos.shape[0]
    CALLS["neighbor_list"] += 1
    if n == 0:
        return (np.zeros((2, 0), dtype=np.int64), np.zeros((0, 3), dtype=np.int64),
                np.zeros((0,), dtype=np.float64))
    # Capacity from the mean density with slack; the function reports the
    # size it needs when that is too small.
    density = n / max(abs(np.linalg.det(lattice)), 1e-12)
    cap = int(n * max(density * 4.19 * cutoff**3 * 1.5, 16.0)) + 64
    for _ in range(3):
        src = np.empty(cap, dtype=np.int64)
        dst = np.empty(cap, dtype=np.int64)
        shift = np.empty((cap, 3), dtype=np.int64)
        dist = np.empty(cap, dtype=np.float64)
        got = lib.m3g_neighbor_list(
            _ptr(lattice, _PF64), _ptr(pos, _PF64), n, float(cutoff), cap,
            _ptr(src, _P64), _ptr(dst, _P64), _ptr(shift, _P64), _ptr(dist, _PF64))
        if got >= 0:
            return np.stack([src[:got], dst[:got]]), shift[:got], dist[:got]
        cap = -got + 64
    raise RuntimeError("neighbor list capacity negotiation failed")


def threebody_native(
    num_nodes: int, edge_index: np.ndarray, distances: np.ndarray, threebody_cutoff: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Triplet enumeration; the contract and output order of
    ``data.compute_threebody``."""
    lib = library()
    src = np.ascontiguousarray(np.asarray(edge_index)[0], dtype=np.int64)
    dist = np.ascontiguousarray(distances, dtype=np.float64)
    num_edges = src.shape[0]
    if src.size and (src.min() < 0 or src.max() >= num_nodes):
        raise ValueError(f"edge sources outside [0, {num_nodes})")
    # Exact size: T = sum d * (d - 1) over the nodes' 3-body degrees.
    deg = np.bincount(src[dist <= threebody_cutoff], minlength=num_nodes)
    cap = int((deg * (deg - 1)).sum())
    e1 = np.empty(cap, dtype=np.int64)
    e2 = np.empty(cap, dtype=np.int64)
    per_node = np.empty(num_nodes, dtype=np.int64)
    per_edge = np.empty(num_edges, dtype=np.int64)
    CALLS["threebody"] += 1
    got = lib.m3g_threebody(
        _ptr(src, _P64), _ptr(dist, _PF64), num_nodes, num_edges, float(threebody_cutoff), cap,
        _ptr(e1, _P64), _ptr(e2, _P64), _ptr(per_node, _P64), _ptr(per_edge, _P64))
    if got != cap:
        raise RuntimeError(f"threebody_native size mismatch: {got} != {cap}")
    return np.stack([e1, e2]), per_node, per_edge
