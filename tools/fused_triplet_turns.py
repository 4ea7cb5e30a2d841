"""Time fused_triplet_gate_sum (B4) and backward_pair (B5) of two or more
trees of the repo in turns on one NVIDIA GPU, at one member and at K = 3.

    python3 tools/fused_triplet_turns.py --parent DIR [--also DIR ...] [--rounds 1] [--ops OP ...]

``DIR`` holds another tree of the repo, for example the parent commit
unpacked with ``git archive`` into the git-ignored ``_checkout/``. Each
round runs its turns as parent, the ``--also`` trees, this tree, this tree,
the ``--also`` trees in reverse, parent, each in a fresh process that puts
its tree first on ``sys.path``, so that it imports that tree's
``torch_m3gnet_tpu_torch`` (and builds that tree's kernels into that tree's
``_build/``), and takes the timing helpers of this tree's ``chip_smoke.py``.
A turn builds the bench batch with its kernel index and, for each op
(both, or those ``--ops`` names, called with the index that the tree's
wrapper takes: the e1 offsets and the e2 order, or the e2 order alone in
trees whose B4 ran its own offsets pass),

- prints the registers, shared memory and spills ``ptxas`` gave each
  instantiation of the op's LN = 9 kernel in that tree's build;
- at one member (``chip_smoke.triplet_inputs``, as phase 7 calls it):
  checks the result against the plain version (``chip_smoke.FWD_TOL``) and
  reads ``kernel_us``, the profiler's device time of the call's CUDA
  kernels (clean L2 flush, median of the recorded launches of 10 calls;
  ``parts_us`` splits it), and the CUDA-event times of
  ``chip_smoke.l2_times`` (``ms`` clean, ``cold_dirty_us``, ``warm_us``);
- at K = 3 members as the committee calls it (``chip_smoke.time_members``:
  the basis shared): the call's device time beside 3 single calls;
- samples ``nvidia-smi``'s SM clock and power draw every 50 ms while it
  reads (``clocks_sm_mhz``, ``power_w``: min, median, max).

Prints one JSON line per turn and op, then the card's ``nvidia-smi`` name
and power limit. Exits non-zero without a GPU or if a check fails.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from windowed_scatter_turns import Clocks, chip_smoke  # noqa: E402

KERNELS = {"fused_triplet_gate_sum": "fused_triplet_gate_sum_kernelILi9E",
           "backward_pair": "backward_pair_kernelILi9E"}


def ptxas(log: Path, kernel: str) -> list[str]:
    """The ptxas lines of each instantiation of ``kernel`` in a build log
    (with and without the member arithmetic, where the tree has both)."""
    lines = log.read_text().splitlines()
    return [" | ".join(x.replace("ptxas info    :", "").strip() for x in lines[i + 2:i + 4])
            for i, line in enumerate(lines)
            if "Compiling entry function" in line and kernel in line]


def turn(tree: str, label: str, names: list[str]) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    cs = chip_smoke()
    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.data import to_torch
    from torch_m3gnet_tpu_torch.ops import _cuda
    from torch_m3gnet_tpu_torch.ops import fused_triplet as ft

    if not torch.cuda.is_available():
        raise SystemExit("fused_triplet_turns: no CUDA device is available")
    log = _cuda.build().with_suffix(".so.log")
    cfg = M3GNetConfig()
    gbatch = to_torch(cs.build_batch(), "cuda", torch.float32)
    ln, e = cfg.l_max * cfg.n_max, gbatch.num_edges
    basis, gate, g, _, _ = cs.triplet_inputs(gbatch, ln)
    e1, e2 = gbatch.triplet_e1, gbatch.triplet_e2
    index = ((gbatch.triplet_e2_order, gbatch.triplet_e2_offsets),)  # the e2 order
    if "e1_offsets" in inspect.signature(ft.fused_triplet_gate_sum).parameters:
        index = (gbatch.triplet_e1_offsets, *index)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda").zero_()
    member = cs.member_specs(gbatch, cfg)
    # the committee's calls with the tree's own signature
    member["fused_triplet_gate_sum"] = (
        lambda b, q: ft.fused_triplet_gate_sum(b, q, e1, e2, e, *index),
        *member["fused_triplet_gate_sum"][1:])
    member["backward_pair"] = (
        lambda b, q, c: ft.backward_pair(b, q, c, e1, e2, e, *index),
        *member["backward_pair"][1:])
    bw = cs.bandwidth(torch.cuda.get_device_name(0))
    ops = {
        "fused_triplet_gate_sum": (
            lambda: ft.fused_triplet_gate_sum(basis, gate, e1, e2, e, *index),
            lambda: ft.fused_triplet_gate_sum_plain(basis, gate, e1, e2, e)),
        "backward_pair": (
            lambda: ft.backward_pair(basis, gate, g, e1, e2, e, *index),
            lambda: ft.backward_pair_plain(basis, gate, g, e1, e2, e)),
    }
    with torch.no_grad():
        for op in names:
            fn, plain = ops[op]
            got, want = fn(), plain()
            for i, (x, y) in enumerate(zip(*(z if isinstance(z, tuple) else (z,)
                                             for z in (got, want)))):
                cs.check(f"{label} {op} (output {i + 1})", x, y, cs.FWD_TOL)
            with Clocks() as clocks:
                l2 = cs.l2_times(fn, flush)
                parts = cs.kernel_parts(fn, flush)
                k3 = cs.time_members(op, member, flush, bw)
            print(json.dumps({"turn": label, "tree": tree, "op": op,
                              "ptxas": ptxas(log, KERNELS[op]), "kernel_us": sum(parts.values()),
                              "parts_us": parts, "ms": l2["ms"],
                              "cold_dirty_us": l2["cold_dirty_us"], "warm_us": l2["warm_us"],
                              "k3": k3, **clocks.reading}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="the other tree (a directory)")
    parser.add_argument("--also", action="append", default=[], help="a further tree")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--ops", nargs="+", choices=sorted(KERNELS), default=sorted(KERNELS))
    parser.add_argument("--turn", nargs=2, metavar=("TREE", "LABEL"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.turn:
        turn(*args.turn, args.ops)
        return 0
    for tree in [args.parent, *args.also]:
        if not tree or not (Path(tree) / "torch_m3gnet_tpu_torch").is_dir():
            parser.error("--parent and --also must name trees of the repo")
    others = [(args.parent, "parent")] + [(t, f"also{i}") for i, t in enumerate(args.also)]
    order = others + [(str(ROOT), "change")] * 2 + others[::-1]
    for _ in range(args.rounds):
        for tree, label in order:
            subprocess.run([sys.executable, __file__, "--turn", tree, label, "--ops", *args.ops],
                           check=True, timeout=900)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
