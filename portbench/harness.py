"""The benchmark's harness: one run of one cell, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
harness reads the configuration from ``configs/<config>.json``, the mix
from ``traffic/<traffic>.json``, whose ``kind`` names the loop in
``kinds/<kind>.py``, each per-layer metric's reader from
``metrics/<metric>.py`` and the cell's correctness limits from
``limits/<workload>.json``. Adding a cell adds files and entries; no file
here changes.

A run: set-up (weights from the seed on the device, the traffic's pool,
one warm-up of every shape the window uses), then either the measured
window (``--trace 0``: the end-to-end metrics) or a short profiled window
(``--trace 1``: the per-layer metrics), then the comparison with the plain
reference that decides ``correct``, after the program's state is freed.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "torch_m3gnet_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def resolve(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``workload`` with its configuration, traffic, kind module,
    metrics and limits, each from its own file."""
    bench = manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    listed = lambda m: "workloads" not in m or workload in m["workloads"]
    return SimpleNamespace(
        cell=cell,
        config=load_json(root / config["file"]),
        traffic=traffic,
        kind=importlib.import_module(f"portbench.kinds.{traffic['kind']}"),
        end_to_end=[m for m in bench["end_to_end"] if listed(m)],
        per_layer=[m for m in bench["per_layer"] if listed(m)],
        limits=load_json(HERE / "limits" / f"{workload}.json"),
    )


def reader(metric: str):
    """The ``read(trace, ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not load,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def model_config(cfg: dict):
    """The program's ``M3GNetConfig`` from the configuration file's fields."""
    import dataclasses

    from torch_m3gnet_tpu_torch import M3GNetConfig

    names = {f.name for f in dataclasses.fields(M3GNetConfig)}
    return M3GNetConfig(**{k: v for k, v in cfg.items() if k in names})


def potential(ctx):
    """The program's potential with the benchmark's seeded weights."""
    from torch_m3gnet_tpu_torch import build_model

    from portbench import weights

    cfg = ctx.config
    ctx.weights = weights.make_weights(cfg, ctx.seed, ctx.device)
    ctx.elemental = weights.elemental_energies(cfg, ctx.seed)
    pot = build_model(model_config(cfg), elemental_energies=list(ctx.elemental),
                      energy_scale=cfg["energy_scale"], device=ctx.device)
    pot.load_state_dict(ctx.weights)
    return pot


def work_of(batch) -> dict:
    """A host batch's padded shapes and real sizes, for the readers."""
    import numpy as np

    return {"nodes": batch.num_nodes, "edges_pad": batch.num_edges,
            "triplets_pad": batch.num_triplets, "graphs_pad": batch.num_graphs,
            "atoms": int(np.sum(batch.node_mask)), "edges": int(np.sum(batch.edge_mask)),
            "triplets": int(np.sum(batch.triplet_mask)), "graphs": batch.num_graphs_real,
            "steps": 1}


def device_info(device: str) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.split("\n")[0]
        info["power_limit"] = smi.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "unread"
    return info


def prepare(workload: str, seed: int, device: str = "cuda", root: Path = ROOT, patch=None):
    """The run's context and its resolved cell. ``patch`` (tests, the
    calibration) edits both before set-up: smaller traffic, a narrower
    model, a broken program."""
    spec = resolve(workload, root)
    ctx = SimpleNamespace(workload=workload, seed=seed % 2**62, device=device,
                          config=dict(spec.config), traffic=dict(spec.traffic),
                          limits=dict(spec.limits))
    if patch is not None:
        patch(ctx, spec)
    return ctx, spec


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        root: Path = ROOT, t_start: float | None = None, patch=None) -> dict:
    """One run of ``workload``; returns the result line's object."""
    t_start = time.monotonic() if t_start is None else t_start
    import torch

    ctx, spec = prepare(workload, seed, device, root, patch)
    kind = spec.kind
    if device == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    kind.setup(ctx)
    setup_s = time.monotonic() - t_start
    breakdown = None
    if trace:
        tr = kind.traced(ctx)
        dev = device_info(device)  # before the readers, which may allocate
        if tr.finish is not None:
            tr.finish()
        t0, t1 = tr.window()
        metrics = {}
        for m in spec.per_layer:
            value = reader(m["name"])(tr, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tr.busy(t0, t1), window_s=(t1 - t0) / 1e9)
        breakdown = tr.breakdown()
        attempted = len(tr.spans())
    else:
        e2e = kind.window(ctx, seconds)
        dev = device_info(device)
        attempted = e2e.pop("attempted")
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: the benchmark may not import JAX or the "
                         f"JAX package")
    kind.release(ctx)
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = kind.check(ctx)
    checks = {name: {"value": float(value), "limit": ctx.limits[name]}
              for name, value in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    import torch

    chips = resolve(args.workload).cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
