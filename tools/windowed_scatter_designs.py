"""Compare candidate designs of the sorted-owner sum of windowed_scatter_fm
(B7) with the kernel the port ships, on one NVIDIA GPU.

    python3 tools/windowed_scatter_designs.py [--rounds 3]

The designs are in ``tools/windowed_scatter_designs.cu`` (see its header):
the shipped body with other block sizes (the shipped kernel runs the e1
call with 256 edges a block, the e2 call with 128), and variants of the
``e2`` call: the shipped gather rebuilt (a check), with fewer entries a
thread a pass, at 256 edges a block (the first design), reading the order
in the gather instead of staging it first, by each owner's depth instead
of by entry; owners that read their own runs without a shared value
buffer; a block that stages its window of ``vals`` (the triplet range of
its edges' source nodes) and sums from it; and two probes (the shipped
gather without the sum; neither). This script compiles that file once per variant (``nvcc``,
``sm_90a``, one process each, all started together) into the port's
git-ignored ``_build/windowed_scatter_designs/``, then

1. holds each design (not the probes) against the shipped kernel and the
   plain version: at
   the bench shapes (F = 4 on the bench batch of ``chip_smoke.py``, by
   ``triplet_e1`` with its offsets and by ``triplet_e2`` with its order)
   within ``chip_smoke.FWD_TOL`` of the plain version and bitwise equal to
   the shipped kernel where it sums the same chunks, two calls bitwise
   equal; exactly
   equal to the plain version on every case of ``chip_smoke.SORTED_CASES``
   (by the sorted ids and by uniform random ids, the values as given and as
   an offset view);
2. times the shipped kernel (through the port's wrapper) and every variant
   at the bench shapes, in turns: ``--rounds`` rounds, the order reversed
   in every other round. Per call (``e1``, ``e2``): ``events_us`` (CUDA
   events after the clean L2 flush of ``chip_smoke.time_device``, median of
   30), ``kernel_us`` (the profiler's device time of its kernel, clean
   flush, ``kernel_parts``) and ``warm_us`` (no flush).

Prints one JSON line per variant and call, then the card's ``nvidia-smi``
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
# name: nvcc defines (header of SOURCE)
VARIANTS = {
    "owned_b128": ["-DDESIGN=1", "-DTHREADS=128"],
    "owned_b256": ["-DDESIGN=1", "-DTHREADS=256"],
    "owned_b64": ["-DDESIGN=1", "-DTHREADS=64"],
    "staged8_b128": ["-DDESIGN=4", "-DTHREADS=128", "-DGATHER_MODE=0", "-DGATHER=8"],
    "staged_b128": ["-DDESIGN=4", "-DTHREADS=128", "-DGATHER_MODE=0", "-DGATHER=4"],
    "staged_b256": ["-DDESIGN=4", "-DTHREADS=256", "-DGATHER_MODE=0", "-DGATHER=4"],
    "ldg8_b128": ["-DDESIGN=4", "-DTHREADS=128", "-DGATHER_MODE=4", "-DGATHER=8"],
    "depth_b256": ["-DDESIGN=4", "-DTHREADS=256", "-DGATHER_MODE=1"],
    "walk_b256": ["-DDESIGN=2", "-DTHREADS=256"],
    "window_b256": ["-DDESIGN=3", "-DTHREADS=256", "-DWINDOW=3056"],
    "probe_gather_b128": ["-DDESIGN=4", "-DTHREADS=128", "-DGATHER_MODE=2", "-DGATHER=8"],
    "probe_floor_b128": ["-DDESIGN=4", "-DTHREADS=128", "-DGATHER_MODE=3"],
}
# probes: parts of the e2 call alone, whose sums are not the function's
PROBES = {name for name in VARIANTS if name.startswith("probe")}
# the calls of each variant that sum in the shipped kernel's chunks (the
# same blocks and chunk bounds), so that their sums are bitwise equal to it
SAME_CHUNKS = {
    name: [c for c, same in (("e1", "-DTHREADS=256" in flags),
                             ("e2", name in ("owned_b128", "staged8_b128"))) if same]
    for name, flags in VARIANTS.items()
}
CALLS = ("e1", "e2")


def build(workdir: Path) -> dict[str, ctypes.CDLL]:
    from torch_m3gnet_tpu_torch.ops import _cuda

    workdir.mkdir(parents=True, exist_ok=True)
    nvcc, include = _cuda._nvcc(), ROOT / "torch_m3gnet_tpu_torch" / "csrc"
    procs = {
        name: subprocess.Popen(
            [nvcc, *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-Xptxas", "-v", f"-I{include}", *flags, "-o", str(workdir / f"{name}.so"),
             str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()
    }
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        print(f"  {name}: " + " | ".join(line.strip() for line in log.splitlines()
                                         if "registers" in line))
        lib = ctypes.CDLL(str(workdir / f"{name}.so"))
        fn = lib.m3g_windowed_scatter
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def caller(lib):
    """The variant with the wrapper's signature (vals, idx, E, owners)."""
    import torch

    def call(vals, idx, num_edges, owners):
        order, offsets = owners
        out = torch.empty((vals.shape[0], num_edges), dtype=torch.float32, device=vals.device)
        err = lib.m3g_windowed_scatter(vals.data_ptr(), None if order is None else order.data_ptr(),
                                       offsets.data_ptr(), out.data_ptr(), vals.shape[0],
                                       num_edges, vals.shape[1],
                                       torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"windowed_scatter_fm: CUDA error {err}")
        return out

    return call


def check_design(name: str, fn, shipped: dict, bench) -> None:
    import torch

    from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
    from torch_m3gnet_tpu_torch.ops import sorted_segment as ss
    from torch_m3gnet_tpu_torch.ops import windowed_take as wt

    vals, idx, owners, e = bench
    for call in CALLS:
        got, again = fn(vals, idx[call], e, owners[call]), fn(vals, idx[call], e, owners[call])
        cs.check(f"{name} {call} bench", got, wt.scatter_fm_plain(vals, idx[call], e), cs.FWD_TOL)
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {call}: two calls differ")
        if call in SAME_CHUNKS[name] and not torch.equal(got, shipped[call]):
            raise AssertionError(f"{name} {call}: not bitwise equal to the shipped kernel")
    for case in cs.SORTED_CASES:
        vn, e1, e2, ne = cs.scatter_case_inputs(case)
        tv, te1, te2 = (torch.as_tensor(x, device="cuda") for x in (vn, e1, e2))
        for tidx, own in ((te1, (None, ss.sorted_segment_offsets(te1, ne))),
                          (te2, ft.triplet_e2_order(te2, ne))):
            want = wt.scatter_fm_plain(tv, tidx, ne)
            for operand in (tv, cs.offset_view(tv)):
                if not (torch.equal(fn(operand, tidx, ne, own), want)
                        and torch.equal(fn(operand, tidx, ne, own), want)):
                    raise AssertionError(f"{name} {case}: differs from the plain version")
    same = SAME_CHUNKS[name]
    print(f"  {name}: exact on every sorted case, bitwise repeatable"
          + (f", bitwise equal to the shipped kernel ({', '.join(same)})" if same else ""))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("windowed_scatter_designs: no CUDA device is available", file=sys.stderr)
        return 1

    from torch_m3gnet_tpu_torch.data import to_torch
    from torch_m3gnet_tpu_torch.ops import _cuda
    from torch_m3gnet_tpu_torch.ops import windowed_take as wt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gbatch = to_torch(cs.build_batch(), "cuda", torch.float32)
    e = gbatch.num_edges
    vals = cs.triplet_inputs(gbatch, 9)[4]
    idx = {"e1": gbatch.triplet_e1, "e2": gbatch.triplet_e2}
    owners = {"e1": (None, gbatch.triplet_e1_offsets),
              "e2": (gbatch.triplet_e2_order, gbatch.triplet_e2_offsets)}
    fns = {"shipped": wt.windowed_scatter_fm}
    libs = build(_cuda.BUILD_DIR / "windowed_scatter_designs")
    fns.update({name: caller(lib) for name, lib in libs.items()})
    with torch.no_grad():
        shipped = {c: wt.windowed_scatter_fm(vals, idx[c], e, owners[c]) for c in CALLS}
        for name in VARIANTS:
            if name not in PROBES:
                check_design(name, fns[name], shipped, (vals, idx, owners, e))

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda").zero_()
    names = list(fns)
    rows = {(name, c): {"events_us": [], "kernel_us": [], "warm_us": []}
            for name in names for c in CALLS}
    with torch.no_grad():
        for rnd in range(args.rounds):
            for name in names if rnd % 2 == 0 else names[::-1]:
                for c in CALLS:
                    call = lambda f=fns[name], c=c: f(vals, idx[c], e, owners[c])  # noqa: E731
                    row = rows[(name, c)]
                    row["events_us"].append(cs.time_device(call, flush) * 1e3)
                    row["warm_us"].append(cs.time_device(call, flush, "warm") * 1e3)
                    row["kernel_us"].append(sum(cs.kernel_parts(call, flush).values()))
    for (name, c), row in rows.items():
        print(json.dumps({"variant": name, "call": c, "card": smi, **row}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
