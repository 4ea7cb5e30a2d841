"""What the port's parallel tests run on their spawned ranks.

``parallel.launch.run("tests._torch_parallel_ranks:<function>", S, ...)``
imports this module in each rank. It imports torch and the port only,
never JAX or a test module: the test files compute JAX's side in the
pytest process and hand the ranks plain inputs (host batches, numpy
weights). Every function returns numpy arrays, one result per case.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.models import build_model
from torch_m3gnet_tpu_torch.ops.halo import all_reduce, halo_exchange_fm
from torch_m3gnet_tpu_torch.parallel import (
    GraphParallelPotential,
    GraphParallelTrainer,
    make_mesh,
)


# kernel name -> (module, the function its wrapper calls on a CPU tensor)
PLAIN = {
    "q_scatter": ("factorized_stage", "q_scatter_plain"),
    "r1_gather": ("factorized_stage", "r1_gather_plain"),
    "r2_gather": ("factorized_stage", "r2_gather_plain"),
    "fused_triplet_gate_sum": ("fused_triplet", "fused_triplet_gate_sum_plain"),
    "backward_pair": ("fused_triplet", "backward_pair_plain"),
    "windowed_take_fm": ("windowed_take", "take_fm_plain"),
    "windowed_scatter_fm": ("windowed_take", "scatter_fm_plain"),
    "sorted_segment_sum": ("sorted_segment", "sorted_segment_sum_fm_plain"),
}


def count_plain_calls(counts: dict) -> None:
    """Count each kernel wrapper's calls of its plain version (on the CPU
    it calls it exactly where on the card it launches its kernel)."""
    import importlib

    for name, (module, attr) in PLAIN.items():
        mod = importlib.import_module(f"torch_m3gnet_tpu_torch.ops.{module}")
        fn = getattr(mod, attr)

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        setattr(mod, attr, wrapper)


def potential(settings: dict, state: dict, mode: str):
    """The model of ``settings`` in ``mode`` with the weights ``state``, in
    their dtype."""
    cfg = M3GNetConfig(**{**settings, "threebody_mode": mode})
    weights = {k: torch.as_tensor(v) for k, v in state.items()}
    pot = build_model(cfg, device="cpu").to(next(iter(weights.values())).dtype)
    pot.model.load_state_dict(weights)
    return cfg, pot


def exchange(plan: dict, x: np.ndarray, w: np.ndarray, v: np.ndarray) -> dict:
    """ext = halo_exchange_fm(x_r); L = sum over ranks of sum(sin(ext) * w_r);
    its value, dL/dx_r, and d/dx_r of sum over ranks of sum(dL/dx * v_r)."""
    mesh = make_mesh(None, "gp", "cpu")
    group, r = mesh.get_group("gp"), dist.get_rank()
    send, recv = (torch.as_tensor(plan[k][r]) for k in ("send", "recv"))
    xr = torch.as_tensor(x[r]).t().requires_grad_(True)
    ext = halo_exchange_fm(xr, send, recv, plan["offsets"], group)
    loss_r = (torch.sin(ext) * torch.as_tensor(w[r]).t()).sum()
    (g,) = torch.autograd.grad(loss_r, xr, create_graph=True)
    (gg,) = torch.autograd.grad((g * torch.as_tensor(v[r]).t()).sum(), xr)
    return dict(forward=ext.detach().t().numpy(), loss=float(all_reduce(loss_r.detach(), group)),
                grad=g.detach().t().numpy(), gradgrad=gg.t().numpy())


def gp_eval(settings: dict, states: dict, cases: dict) -> dict:
    """E/F/S of each case ``name -> (mode, stacked shards, weights[,
    settings of its own])`` through ``GraphParallelPotential.apply``
    (every shard's forces)."""
    mesh = make_mesh(None, "gp", "cpu")
    out = {}
    for name, (mode, sharded, weights, *own) in cases.items():
        _, pot = potential({**settings, **(own[0] if own else {})}, states[weights], mode)
        res = GraphParallelPotential(pot, mesh).apply(sharded)
        out[name] = dict(energy=res.energy.numpy(), forces=res.forces.numpy(),
                         stress=res.stress.numpy())
    return out


def gp_train(settings: dict, state: dict, modes, sharded, stack2d, steps: dict,
             ckpt_dir: str) -> dict:
    """The gp loss and every weight gradient (mean of the ranks' local
    gradients) per mode on a 4-shard mesh; the dp x gp loss and gradient on
    a 2 x 2 mesh; ``GraphParallelTrainer`` steps (gp in the gather and the
    fused mode, dp x gp on the 2 x 2 mesh in the factorized mode) and a
    checkpoint round trip."""
    gp_mesh = make_mesh(None, "gp", "cpu")
    mesh2d = make_mesh((2, 2), ("dp", "gp"), "cpu")
    world = dist.get_world_size()

    def loss_and_grads(mesh, mode, batch, dp_axis=None):
        cfg, pot = potential(settings, state, mode)
        loss = GraphParallelPotential(pot, mesh).make_loss(cfg, dp_axis)(batch)
        grads = torch.autograd.grad(loss, [p for _, p in pot.model.named_parameters()])
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        names = [n for n, _ in pot.model.named_parameters()]
        sizes = [g.numel() for g in grads]
        mean = {n: (f / world).view_as(g).numpy()
                for n, f, g in zip(names, flat.split(sizes), grads)}
        return float(loss), mean

    out = {"loss": {}, "grads": {}}
    for mode in modes:
        out["loss"][mode], out["grads"][mode] = loss_and_grads(gp_mesh, mode, sharded)
    out["loss2d"], out["grads2d"] = loss_and_grads(mesh2d, "gather", stack2d, "dp")

    def trainer_steps(mode, mesh, batch, dp_axis=None, **kw):
        cfg, pot = potential(settings, state, mode)
        cfg = cfg.replace(**steps["config"])
        trainer = GraphParallelTrainer(pot, cfg, mesh, dp_axis=dp_axis, **kw)
        losses = [float(trainer.train_step(batch, steps["lr"])["loss"])
                  for _ in range(steps["n"])]
        flat = torch.cat([p.detach().reshape(-1) for p in pot.parameters()])
        parts = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(parts, flat)
        return cfg, trainer, dict(
            step_losses=losses, params={k: v.numpy() for k, v in pot.model.state_dict().items()},
            params_equal_across_ranks=all(torch.equal(parts[0], p) for p in parts))

    cfg, trainer, row = trainer_steps("gather", gp_mesh, sharded,
                                      log_dir=os.path.join(ckpt_dir, "logs"))
    out.update(row)
    out["fused_steps"] = trainer_steps("fused", gp_mesh, sharded)[2]
    out["dp_gp_steps"] = trainer_steps("factorized", mesh2d, stack2d, "dp")[2]
    trainer.save_checkpoint(ckpt_dir, tag="last")
    live = float(trainer.eval_loss(sharded))
    _, fresh = potential(settings, state, "gather")
    restored = GraphParallelTrainer(fresh, cfg, gp_mesh)
    restored.restore_checkpoint(ckpt_dir, tag="last")
    out["eval_live"], out["eval_restored"] = live, float(restored.eval_loss(sharded))
    out["files"] = sorted(os.listdir(ckpt_dir))
    return out


def dp_steps(settings: dict, state: dict, batches: list, lr: float) -> dict:
    """``DataParallel`` steps on the rows of stacked batches (each rank
    builds nothing: it takes its row of each stack): the combined metrics
    of each step and the weights after each."""
    from torch_m3gnet_tpu_torch.parallel import DataParallel

    mesh = make_mesh(None, "dp", "cpu")
    cfg, pot = potential(settings, state, "factorized")
    dp = DataParallel(pot, cfg, mesh)
    metrics, params = [], []
    for stacked in batches:
        metrics.append({k: float(v) for k, v in dp.train_step(stacked, lr).items()})
        params.append({k: v.numpy().copy() for k, v in pot.model.state_dict().items()})
    evals = {k: float(v) for k, v in dp.eval_step(batches[-1]).items()}
    return dict(metrics=metrics, params=params, eval=evals)


def dp_train_model(runs: dict) -> dict:
    """``train_model`` with ``num_devices`` = the world size, per run
    ``name -> (settings, root, splits, params)``; the splits are graph
    lists or streaming caches ``(cache_dir, name, shard_size, count)``.
    Both ranks log parameter norms, as the JAX side does in the test."""
    from torch_m3gnet_tpu_torch.data.streaming import StreamingGraphDataset
    from torch_m3gnet_tpu_torch.parallel import dp
    from torch_m3gnet_tpu_torch.train import run

    dp.DataParallel = functools.partial(dp.DataParallel, log_param_stats=True)
    out = {}
    for name, (settings, root, splits, params) in runs.items():
        cfg = M3GNetConfig(root=root, **settings)
        if isinstance(splits[0], tuple):
            splits = [StreamingGraphDataset(None, cfg.cutoff, cfg.threebody_cutoff,
                                            cache_dir=c, name=n, shard_size=sz,
                                            expected_count=cnt)
                      for c, n, sz, cnt in splits]
        trainer, st, test = run.train_model(
            cfg, *splits, device="cpu", dtype=torch.float64,
            params={k: torch.as_tensor(v) for k, v in params.items()})
        with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
            rows = [json.loads(x) for x in f]
        out[name] = dict(
            epoch=st.epoch, step=st.step, test=test, rows=rows,
            params={k: v.numpy() for k, v in trainer.potential.model.state_dict().items()})
    return out


def gp_job(exchange_args: tuple, eval_args: tuple) -> dict:
    """:func:`exchange` and :func:`gp_eval` in one job."""
    return dict(exchange=exchange(*exchange_args), eval=gp_eval(*eval_args))


def gp_launches(settings: dict, modes, sharded) -> dict:
    """Each mode's kernel calls on this rank in one gp evaluation and in one
    ``GraphParallelTrainer`` step of a partitioned graph (seeded weights)."""
    counts: dict = {}
    count_plain_calls(counts)
    mesh = make_mesh(None, "gp", "cpu")
    out = {}
    for mode in modes:
        cfg = M3GNetConfig(**{**settings, "threebody_mode": mode})
        pot = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        trainer = GraphParallelTrainer(pot, cfg, mesh)
        counts.clear()
        trainer.gp(sharded)
        out[mode] = {"eval": {n: counts.get(n, 0) for n in PLAIN}}
        counts.clear()
        trainer.train_step(sharded)
        out[mode]["train"] = {n: counts.get(n, 0) for n in PLAIN}
    return out


def raise_on(rank: int) -> int:
    """Rank ``rank`` raises; the others wait in a collective for it."""
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return dist.get_rank()


def sleep(seconds: float) -> None:
    import time

    time.sleep(seconds)
