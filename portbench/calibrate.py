"""Readings that the correctness limits are set from, on the card:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--seconds 3]
        [--control 1,2,3] [--fault half_batch --fault-seeds 1,2,3]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, and the numbers that its check compares (the program's
readings); for each ``--control`` seed also the numbers of the control, the
reference in TF32 in the program's place; for each ``--fault-seeds`` seed
the numbers with the fault planted (``faults.py``). One JSON line a
reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from portbench import faults, harness


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def reading(workload, seed, seconds, role, device="cuda", fault=None, patch=None):
    import torch

    ctx, spec = harness.prepare(workload, seed, device, patch=patch)
    kind = spec.kind
    with faults.FAULTS[fault](ctx.traffic["kind"]) if fault else contextlib.nullcontext():
        kind.setup(ctx)
        kind.window(ctx, seconds)
    kind.release(ctx)
    if device == "cuda":
        torch.cuda.empty_cache()
    out = {"workload": workload, "seed": seed, "role": role,
           "program": kind.check(ctx)}
    if role == "control":
        out["control"] = kind.control(ctx)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control", type=seeds, default=[])
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    for seed in args.seeds:
        reading(args.workload, seed, args.seconds,
                "control" if seed in args.control else "program")
    for seed in args.fault_seeds:
        reading(args.workload, seed, args.seconds, "fault:" + args.fault, fault=args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
