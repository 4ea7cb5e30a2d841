"""E/F/S screening: one closed-loop client sends padded batches of mp-mix
structures; each request is ``to_torch`` of a host batch, the potential,
and energies, forces and stresses copied to the host.

Traffic keys: ``recipe`` x ``repeat`` (one batch's structures), ``pool`` (distinct
batches, built in set-up and cycled), ``strain``, ``noise``,
``pad_multiple``, ``traced`` (requests in the profiled window), ``checked``
(pool batches that the reference checks), ``block_atoms`` (reference
block size).
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from portbench import harness, mpmix, trace
from portbench.reference import drive


def setup(ctx):
    from torch_m3gnet_tpu_torch.data import Structure, pack_structures

    t, cfg = ctx.traffic, ctx.config
    ctx.pot = harness.potential(ctx)
    ctx.structures = mpmix.batches(t["recipe"] * t["repeat"], t["pool"], ctx.seed, t["strain"],
                                   t["noise"])
    ctx.pool = [pack_structures([Structure(*s) for s in batch], cfg["cutoff"],
                                cfg["threebody_cutoff"], pad_multiple=t["pad_multiple"])
                for batch in ctx.structures]
    ctx.atoms = [int(np.sum(b.node_mask)) for b in ctx.pool]
    ctx.last = {}
    for i in range(len(ctx.pool)):  # every shape of the window, once
        request(ctx, i)
    sync(ctx)


def sync(ctx):
    if ctx.device == "cuda":
        torch.cuda.synchronize()


def request(ctx, i: int, traced: bool = False):
    from torch.profiler import record_function

    from torch_m3gnet_tpu_torch.data import to_torch

    pot = ctx.pot
    with record_function("portbench.to_torch") if traced else contextlib.nullcontext():
        graph = to_torch(ctx.pool[i], ctx.device, torch.float32, pot.model.batch_index)
        if traced:
            sync(ctx)
    out = pot(graph)
    ctx.last[i] = (out.energy.detach().cpu(), out.forces.detach().cpu(),
                   out.stress.detach().cpu())


def window(ctx, seconds: float) -> dict:
    lat, atoms, n = [], 0, 0
    t0 = time.perf_counter()
    while n < 2 or time.perf_counter() - t0 < seconds:  # two, for a quantile
        i = n % len(ctx.pool)
        ts = time.perf_counter()
        request(ctx, i)
        lat.append(time.perf_counter() - ts)
        atoms += ctx.atoms[i]
        n += 1
    elapsed = time.perf_counter() - t0
    return {"attempted": n, "efs_atoms_per_s": atoms / elapsed,
            "efs_batch_p95_ms": statistics.quantiles(lat, n=20)[-1] * 1e3}


def traced(ctx) -> trace.Trace:
    tr = trace.Trace()
    with trace.profiled(ctx.device) as records:
        for k in range(ctx.traffic["traced"]):
            i = k % len(ctx.pool)
            with trace.span():
                request(ctx, i, traced=True)
            tr.work.append(harness.work_of(ctx.pool[i]))
    tr.records = records
    return tr


def release(ctx):
    ctx.pot = None


def picks(ctx) -> list[int]:
    rng = np.random.default_rng([ctx.seed, 3])
    return [int(i) for i in rng.choice(len(ctx.pool), size=ctx.traffic["checked"], replace=False)]


def check(ctx) -> dict:
    """Energy per atom (eV), forces and stress (each as its largest error
    over the largest reference magnitude) of the last answer in the window
    to each checked pool batch, against the reference in float64."""
    return compare(ctx, picks(ctx))


def control(ctx) -> dict:
    """The check with the reference in TF32 in the program's place."""
    weights = {k: v.to(ctx.device) for k, v in ctx.weights.items()}
    answers = {}
    for i in picks(ctx):
        ref = drive.efs(weights, ctx.config, ctx.structures[i], ctx.elemental, "tf32",
                        ctx.traffic["block_atoms"])
        answers[i] = (np.array([e for e, _, _ in ref]), np.concatenate([f for _, f, _ in ref]),
                      np.stack([s for _, _, s in ref]))
    return compare(ctx, picks(ctx), answers)


def compare(ctx, picks, answers=None) -> dict:
    """``answers``: per pool batch, (energies, forces, stresses) that stand
    in the program's place (the control); the program's by default."""
    weights = {k: v.to(ctx.device) for k, v in ctx.weights.items()}
    e_err, f_got, f_ref, s_got, s_ref = 0.0, [], [], [], []
    for i in picks:
        structs = ctx.structures[i]
        ref = drive.efs(weights, ctx.config, structs, ctx.elemental, "float64",
                        ctx.traffic["block_atoms"])
        energy, forces, stress = (answers or ctx.last)[i]
        off = 0
        for b, (s, (e_r, f_r, st_r)) in enumerate(zip(structs, ref)):
            n = len(s[2])
            e_err = max(e_err, abs(float(energy[b]) - e_r) / n)
            f_got.append(np.asarray(forces[off:off + n], float))
            f_ref.append(f_r)
            s_got.append(np.asarray(stress[b], float))
            s_ref.append(st_r)
            off += n
    return {"energy_err": e_err,
            "forces_err": drive.max_rel(np.concatenate(f_got), np.concatenate(f_ref)),
            "stress_err": drive.max_rel(np.stack(s_got), np.stack(s_ref))}
