"""Training: ``Trainer.train_step`` on padded batches of mp-mix structures
labelled by the benchmark's Morse pair potential, one optimiser step per
batch, the pool cycled.

Set-up builds one trainer and drives it through its first steps on the
pool's first batches, by the same call the window makes; the first
``followed`` steps are those the reference follows. Traffic keys:
``recipe`` x ``repeat`` (one batch), ``pool``, ``strain``, ``noise``, ``pad_multiple``, ``traced``
(steps in the profiled window), ``followed``, ``block_atoms``.
"""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from portbench import harness, labels, mpmix, trace
from portbench.reference import drive


def setup(ctx):
    from torch_m3gnet_tpu_torch.data import Structure, pack_structures
    from torch_m3gnet_tpu_torch.train import Trainer

    t, cfg = ctx.traffic, ctx.config
    ctx.pot = harness.potential(ctx)
    ctx.trainer = Trainer(ctx.pot, harness.model_config(cfg).replace(root=tempfile.gettempdir()),
                          prefetch=0)
    ctx.structures = mpmix.batches(t["recipe"] * t["repeat"], t["pool"], ctx.seed, t["strain"],
                                   t["noise"])
    ctx.labels = [labels.morse_labels(batch, cfg["cutoff"], ctx.seed, ctx.device)
                  for batch in ctx.structures]
    ctx.pool = [pack_structures(
        [Structure(*s, properties={"energy": e, "forces": f, "stress": st})
         for s, (e, f, st) in zip(batch, labs)],
        cfg["cutoff"], cfg["threebody_cutoff"], pad_multiple=t["pad_multiple"])
        for batch, labs in zip(ctx.structures, ctx.labels)]
    ctx.graphs = [len(b) for b in ctx.structures]
    names = [n for n, _ in ctx.pot.named_parameters()]
    params = list(ctx.pot.parameters())
    losses = []
    for i in range(len(ctx.pool)):  # every shape of the window, once
        losses.append(ctx.trainer.train_step(ctx.pool[i])["loss"])
        if i == 0:
            state = ctx.trainer.optimizer.state
            ctx.first_moment = {  # a step that applies nothing leaves no moment
                n: state[p]["exp_avg"].detach().clone() if p in state else torch.zeros_like(p)
                for n, p in zip(names, params)}
        if i + 1 == t["followed"]:
            ctx.followed = {n: p.detach().clone() for n, p in zip(names, params)}
    ctx.losses = [float(x) for x in losses[: t["followed"]]]
    ctx.step = len(ctx.pool)
    sync(ctx)


def sync(ctx):
    if ctx.device == "cuda":
        torch.cuda.synchronize()


def window(ctx, seconds: float) -> dict:
    graphs, n = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = ctx.step % len(ctx.pool)
        ctx.trainer.train_step(ctx.pool[i])
        sync(ctx)
        graphs += ctx.graphs[i]
        ctx.step += 1
        n += 1
    elapsed = time.perf_counter() - t0
    return {"attempted": n, "train_structures_per_s": graphs / elapsed}


def traced(ctx) -> trace.Trace:
    tr = trace.Trace()
    with trace.profiled(ctx.device) as records:
        for _ in range(ctx.traffic["traced"]):
            i = ctx.step % len(ctx.pool)
            with trace.span():
                ctx.trainer.train_step(ctx.pool[i])
                sync(ctx)
            tr.work.append(harness.work_of(ctx.pool[i]))
            ctx.step += 1
    tr.records = records
    return tr


def release(ctx):
    ctx.trainer = ctx.pot = None


def check(ctx) -> dict:
    """The first ``followed`` steps against the reference's in float64:
    each step's loss (relative), the first gradient (from Adam's first
    moment after one step) and the weights' change over the steps, each by
    its worst leaf (see ``drive.leaf_norm_gap``)."""
    return compare(ctx)


def control(ctx) -> dict:
    """The check with the reference in TF32 in the program's place."""
    t = ctx.traffic
    weights = {k: v.to(ctx.device) for k, v in ctx.weights.items()}
    return compare(ctx, drive.train_steps(weights, ctx.config, batches(ctx), ctx.elemental,
                                          t["followed"], "tf32", t["block_atoms"]))


def batches(ctx) -> list:
    return [list(zip(s, lab)) for s, lab in zip(ctx.structures, ctx.labels)]


def compare(ctx, program=None) -> dict:
    """``program``: (losses, first gradient, weights after the followed
    steps) standing in the program's place (the control, a fault)."""
    t = ctx.traffic
    weights = {k: v.to(ctx.device) for k, v in ctx.weights.items()}
    losses, grad, after = drive.train_steps(weights, ctx.config, batches(ctx), ctx.elemental,
                                            t["followed"], "float64", t["block_atoms"])
    if program is None:
        program = (ctx.losses, {k: v / (1 - 0.9) for k, v in ctx.first_moment.items()},
                   ctx.followed)  # Adam's first moment after one step is 0.1 g
    p_losses, p_grad, p_after = program
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grad.items()}
    med = float(np.median(list(norms.values())))
    # Leaves whose reference gradient is nought to rounding move under Adam by
    # round-off alone: their change is left out, by this rule, not by name.
    moved = {k for k, n in norms.items() if n >= 1e-3 * med}
    change = lambda w: {k: w[k].double().to(weights[k].device) - weights[k].double()
                        for k in moved}
    return {"loss_err": max(abs(p - r) / abs(r) for p, r in zip(p_losses, losses)),
            "grad_err": drive.leaf_norm_gap(p_grad, grad),
            "update_err": drive.leaf_norm_gap(change(p_after), change(after))}
