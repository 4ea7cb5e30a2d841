"""Time windowed_scatter_fm (B7) and windowed_take_fm (B6) of two trees of
the repo in turns on one NVIDIA GPU, the ``e1`` and the ``e2`` call apart.

    python3 tools/windowed_scatter_turns.py --parent DIR [--rounds 1]

``DIR`` holds another tree of the repo, for example the parent commit
unpacked with ``git archive`` into the git-ignored ``_checkout/``. Each
round runs four turns, parent, this tree, this tree, parent, each in a
fresh process that puts its tree first on ``sys.path``, so that it imports
that tree's ``torch_m3gnet_tpu_torch`` (and builds that tree's kernels into
that tree's ``_build/``), and takes the timing helpers of this tree's
``chip_smoke.py``. A turn builds the bench batch with its kernel index, and
for each op and call (the op with the batch's owners of the index where its
wrapper takes them: the ``triplet_e1`` offsets, the e2 order) it

- checks the result against the plain version (``chip_smoke.FWD_TOL``);
- reads ``kernel_us``, the profiler's device time of the call's CUDA
  kernels (clean L2 flush, mean of 10 calls; ``parts_us`` splits it by
  kernel), and the
  CUDA-event times under the three L2 states (``ms`` clean, median of 30,
  ``cold_dirty_us``, ``warm_us``) of ``chip_smoke.l2_times``;
- samples ``nvidia-smi``'s SM clock and power draw every 50 ms while it
  reads (``clocks_sm_mhz``, ``power_w``: min, median, max).

Prints one JSON line per turn, op and call, then the card's ``nvidia-smi``
name and power limit. Exits non-zero without a GPU or if a check fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def chip_smoke():
    """This tree's chip_smoke.py as a module (its package imports resolve
    through sys.path, so to the tree the turn put first)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Clocks:
    """``nvidia-smi`` sampling the SM clock and power draw every 50 ms."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate(timeout=30)[0]
        rows = [line.split(",") for line in out.splitlines() if line.count(",") == 1]
        clocks, power = [], []
        for sm, pw in rows:
            try:
                clocks.append(float(sm))
                power.append(float(pw))
            except ValueError:
                continue

        def spread(xs):
            return [min(xs), statistics.median(xs), max(xs)] if xs else None

        self.reading = {"clocks_sm_mhz": spread(clocks), "power_w": spread(power)}
        return False


def turn(tree: str, label: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    cs = chip_smoke()
    from torch_m3gnet_tpu_torch.data import to_torch
    from torch_m3gnet_tpu_torch.ops import windowed_take as wt

    if not torch.cuda.is_available():
        raise SystemExit("windowed_scatter_turns: no CUDA device is available")
    gbatch = to_torch(cs.build_batch(), "cuda", torch.float32)
    _, _, _, data, vals = cs.triplet_inputs(gbatch, 9)
    e = gbatch.num_edges
    idx = {"e1": gbatch.triplet_e1, "e2": gbatch.triplet_e2}
    owners = {"e1": (None, gbatch.triplet_e1_offsets),
              "e2": (gbatch.triplet_e2_order, gbatch.triplet_e2_offsets)}
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda").zero_()
    ops = {
        "windowed_scatter_fm": (wt.windowed_scatter_fm, lambda i: wt.scatter_fm_plain(vals, i, e),
                                lambda i: (vals, i, e)),
        "windowed_take_fm": (wt.windowed_take_fm, lambda i: wt.take_fm_plain(data, i),
                             lambda i: (data, i)),
    }
    with torch.no_grad():
        for op, (kernel, plain, args) in ops.items():
            with_owners = "owners" in inspect.signature(kernel).parameters
            for call, i in idx.items():
                extra = (owners[call],) if with_owners else ()

                def fn(kernel=kernel, i=i, extra=extra, args=args):
                    return kernel(*args(i), *extra)

                cs.check(f"{label} {op} ({call})", fn(), plain(i), cs.FWD_TOL)
                with Clocks() as clocks:
                    l2 = cs.l2_times(fn, flush)
                    parts = cs.kernel_parts(fn, flush)
                print(json.dumps({"turn": label, "tree": tree, "op": op, "call": call,
                                  "owners": with_owners, "kernel_us": sum(parts.values()),
                                  "parts_us": parts, "ms": l2["ms"],
                                  "cold_dirty_us": l2["cold_dirty_us"], "warm_us": l2["warm_us"],
                                  **clocks.reading}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="the other tree (a directory)")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--turn", nargs=2, metavar=("TREE", "LABEL"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.turn:
        turn(*args.turn)
        return 0
    if not args.parent or not (Path(args.parent) / "torch_m3gnet_tpu_torch").is_dir():
        parser.error("--parent must name a tree of the repo")
    order = [(args.parent, "parent"), (str(ROOT), "change")]
    for _ in range(args.rounds):
        for tree, label in (order[0], order[1], order[1], order[0]):
            subprocess.run([sys.executable, __file__, "--turn", tree, label], check=True,
                           timeout=900)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
