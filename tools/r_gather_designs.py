"""Compare candidate designs of r1_gather and r2_gather (B2, B3) with the
kernel the port ships, on one NVIDIA GPU.

    python3 tools/r_gather_designs.py [--rounds 3]

The designs and probes are in ``tools/r_gather_designs.cu`` (see its
header); this script compiles that file once per variant (``nvcc``,
``sm_90a``, one process each, all started together) into the port's
git-ignored ``_build/r_gather_designs/``, then

1. holds each design (not the probes) against the plain versions: at the
   bench shapes (the default model's l_max = n_max = 3 on the bench batch
   of ``chip_smoke.py``) within ``chip_smoke.FWD_TOL`` and bitwise equal to
   the shipped kernel, two calls bitwise equal; exactly on every case of
   ``chip_smoke.SORTED_CASES`` at (l_max, n_max) = (1, 1), (3, 3), (4, 4),
   with the operand as given and as an offset view; within ``FWD_TOL`` on
   uniform random (unsorted) ids;
2. times the shipped kernel (through the port's wrapper) and every variant
   at the bench shapes, in turns: ``--rounds`` rounds, the order reversed
   in every other round. Per call: ``events_us`` (CUDA events after the
   clean L2 flush of ``chip_smoke.time_device``, median of 30; the ``ms`` of
   ``chip_smoke.py``'s kernel rows, in µs), ``kernel_us`` (the
   profiler's device time of its kernel, clean flush, ``kernel_parts``) and
   ``warm_us`` (no flush).

Prints one JSON line per variant and op, then the card's ``nvidia-smi``
name and power limit. Exits non-zero without a GPU or if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOURCE = Path(__file__).with_suffix(".cu")
# name: nvcc defines; designs 1-3 are the function, 4-5 probes (header of SOURCE)
VARIANTS = {
    "tile_256": ["-DDESIGN=1", "-DTHREADS=64"],
    "tile_512": ["-DDESIGN=1", "-DTHREADS=128"],
    "tile_1024": ["-DDESIGN=1", "-DTHREADS=256"],
    "warp_window": ["-DDESIGN=2", "-DTHREADS=128"],
    "two_columns": ["-DDESIGN=3", "-DTHREADS=128"],
    "copy_4B": ["-DDESIGN=4", "-DTHREADS=256", "-DEDGES=1"],
    "copy_16B": ["-DDESIGN=4", "-DTHREADS=128", "-DEDGES=4"],
    "copy_src_4B": ["-DDESIGN=5", "-DTHREADS=256", "-DEDGES=1"],
}
OPS = ("r1_gather", "r2_gather")


def build(workdir: Path) -> dict[str, ctypes.CDLL]:
    from torch_m3gnet_tpu_torch.ops import _cuda

    workdir.mkdir(parents=True, exist_ok=True)
    nvcc, include = _cuda._nvcc(), ROOT / "torch_m3gnet_tpu_torch" / "csrc"
    procs = {
        name: subprocess.Popen(
            [nvcc, *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             f"-I{include}", *flags, "-o", str(workdir / f"{name}.so"), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()
    }
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(workdir / f"{name}.so"))
        for op in OPS:
            fn = getattr(lib, f"m3g_{op}")
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def caller(lib, op: str):
    """The variant's op with the wrapper's signature (A, operand, src, l, n)."""
    import torch

    def call(a, x, src, l_max, n_max):
        rows = l_max * n_max if op == "r1_gather" else l_max * l_max
        out = torch.empty((rows, src.shape[0]), dtype=torch.float32, device=a.device)
        err = getattr(lib, f"m3g_{op}")(a.data_ptr(), x.data_ptr(), src.data_ptr(),
                                         out.data_ptr(), src.shape[0], a.shape[1], l_max, n_max,
                                         torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{op}: CUDA error {err}")
        return out

    return call


def check_design(name: str, fns: dict, shipped: dict, bench) -> None:
    import torch

    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs

    a, operands, src = bench
    for op in OPS:
        plain, fn = getattr(fs, f"{op}_plain"), fns[op]
        got, again = fn(a, operands[op], src, 3, 3), fn(a, operands[op], src, 3, 3)
        cs.check(f"{name} {op} bench", got, plain(a, operands[op], src, 3, 3), cs.FWD_TOL)
        if not (torch.equal(got, again) and torch.equal(got, shipped[op])):
            raise AssertionError(f"{name} {op}: not bitwise equal to itself and the shipped kernel")
        for case in cs.SORTED_CASES:
            for l_max, n_max in ((1, 1), (3, 3), (4, 4)):
                an, xn, sn, _ = cs.r_case_inputs(case, op, l_max, n_max)
                ta, tx, ts = (torch.as_tensor(v, device="cuda") for v in (an, xn, sn))
                want = plain(ta, tx, ts, l_max, n_max)
                for operand in (tx, cs.offset_view(tx)):
                    if not (torch.equal(fn(ta, operand, ts, l_max, n_max), want)
                            and torch.equal(fn(ta, operand, ts, l_max, n_max), want)):
                        raise AssertionError(f"{name} {op} {case} ({l_max}, {n_max}) differs")
        rand = torch.randint(0, a.shape[1], src.shape, dtype=torch.int32, device="cuda")
        cs.check(f"{name} {op} unsorted ids", fn(a, operands[op], rand, 3, 3),
                 plain(a, operands[op], rand, 3, 3), cs.FWD_TOL)
    print(f"  {name}: exact on every sorted case (both paths), bitwise repeatable")


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("r_gather_designs: no CUDA device is available", file=sys.stderr)
        return 1

    from torch_m3gnet_tpu_torch.data import to_torch
    from torch_m3gnet_tpu_torch.ops import _cuda
    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gbatch = to_torch(cs.build_batch(), "cuda", torch.float32)
    src, n = gbatch.edge_src, gbatch.num_nodes
    sh, gm, a = cs.stage_inputs(n, gbatch.num_edges, 3, 3, "cuda")
    operands = {"r1_gather": sh, "r2_gather": gm}
    fns = {"shipped": {op: getattr(fs, op) for op in OPS}}
    libs = build(_cuda.BUILD_DIR / "r_gather_designs")
    fns.update({name: {op: caller(lib, op) for op in OPS} for name, lib in libs.items()})
    with torch.no_grad():
        shipped = {op: getattr(fs, op)(a, operands[op], src, 3, 3) for op in OPS}
        for name in VARIANTS:
            if not name.startswith("copy"):
                check_design(name, fns[name], shipped, (a, operands, src))

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda").zero_()
    names = list(fns)
    rows = {(name, op): {"events_us": [], "kernel_us": [], "warm_us": []}
            for name in names for op in OPS}
    with torch.no_grad():
        for rnd in range(args.rounds):
            for name in names if rnd % 2 == 0 else names[::-1]:
                for op in OPS:
                    call = lambda f=fns[name][op], x=operands[op]: f(a, x, src, 3, 3)  # noqa: E731
                    row = rows[(name, op)]
                    row["events_us"].append(cs.time_device(call, flush) * 1e3)
                    row["warm_us"].append(cs.time_device(call, flush, "warm") * 1e3)
                    row["kernel_us"].append(sum(cs.kernel_parts(call, flush).values()))
    for (name, op), row in rows.items():
        print(json.dumps({"variant": name, "op": op, "card": smi, **row}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
