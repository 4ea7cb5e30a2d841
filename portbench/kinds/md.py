"""NVE molecular dynamics through ``simulate.md.run_md`` on one cell.

The window runs chunks of one rebuild period, each a ``run_md`` call that
continues from the state the last chunk reached (positions wrapped into
the cell, velocities). NVE, so a run is deterministic for its check.

Traffic keys: ``compound``, ``reps`` (the cell), ``temperature`` (K, the
Maxwell-Boltzmann draw of the first velocities), ``dt`` (fs),
``rebuild_every``, ``skin`` (A), ``pad_multiple``, ``traced`` (chunks in
the profiled window).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness, mpmix, trace
from portbench.reference import drive

KB_EV = 8.617333262e-5  # Boltzmann constant, eV/K
# amu A^2 / fs^2 in eV (CODATA 2018)
KE_TO_EV = 1.66053906660e-27 * 1e-20 / 1e-30 / 1.602176634e-19


def setup(ctx):
    t = ctx.traffic
    ctx.pot = harness.potential(ctx)
    lattice, pos, numbers = mpmix.crystal(t["compound"], t["reps"])
    ctx.lattice, ctx.numbers = lattice, numbers
    ctx.masses = mpmix.masses(numbers)
    rng = np.random.default_rng([ctx.seed, 5])
    sigma = np.sqrt(KB_EV * t["temperature"] / KE_TO_EV / ctx.masses)[:, None]
    vel = rng.standard_normal(pos.shape) * sigma
    vel -= (ctx.masses[:, None] * vel).sum(0) / ctx.masses.sum()  # no drift
    ctx.state = (pos, vel)
    ctx.first = chunk(ctx)  # the first chunk, from the benchmark's own state
    ctx.chunks = []
    sync(ctx)


def sync(ctx):
    if ctx.device == "cuda":
        torch.cuda.synchronize()


def wrap(pos, lattice):
    return (pos @ np.linalg.inv(lattice)) % 1.0 @ lattice


def chunk(ctx) -> tuple:
    """One rebuild period from ``ctx.state``; returns (start positions,
    start velocities, end positions, end velocities, energies)."""
    from torch_m3gnet_tpu_torch.data import Structure
    from torch_m3gnet_tpu_torch.simulate.md import MDConfig, run_md

    t, cfg = ctx.traffic, ctx.config
    pos, vel = wrap(ctx.state[0], ctx.lattice), ctx.state[1]
    res = run_md(ctx.pot, [Structure(ctx.lattice, pos, ctx.numbers)], cfg["cutoff"],
                 cfg["threebody_cutoff"],
                 MDConfig(dt=t["dt"], n_steps=t["rebuild_every"], ensemble="nve",
                          temperature=t["temperature"], rebuild_every=t["rebuild_every"],
                          skin=t["skin"]),
                 velocities=[vel], pad_multiple=t["pad_multiple"])
    end = res.structures[0]
    ctx.state = (end.cart_coords, end.properties["velocities"])
    return pos, vel, end.cart_coords, end.properties["velocities"], res.energies[:, 0]


def window(ctx, seconds: float) -> dict:
    steps, n = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ctx.chunks.append(chunk(ctx))
        steps += ctx.traffic["rebuild_every"]
        n += 1
    elapsed = time.perf_counter() - t0
    return {"attempted": n, "md_atom_steps_per_s": len(ctx.numbers) * steps / elapsed}


def traced(ctx) -> trace.Trace:
    tr = trace.Trace()
    with trace.profiled(ctx.device) as records:
        for _ in range(ctx.traffic["traced"]):
            with trace.span():
                ctx.chunks.append(chunk(ctx))
    tr.records = records
    starts = [c[0] for c in ctx.chunks[-ctx.traffic["traced"]:]]
    # the real sizes of each chunk's list, counted after the peak memory is read
    tr.finish = lambda: tr.work.extend(list_sizes(ctx, pos) for pos in starts)
    return tr


def list_sizes(ctx, pos) -> dict:
    """Atoms, edges (the skin list) and triplets of a chunk's graph, counted
    by the benchmark's own neighbour search."""
    from portbench.reference import neighbors

    cfg, t = ctx.config, ctx.traffic
    x = torch.as_tensor(pos, device=ctx.device)
    lat = torch.as_tensor(ctx.lattice, device=ctx.device)
    src, dst, shift = neighbors.neighbor_list(x, lat, cfg["cutoff"] + t["skin"])
    dist = torch.linalg.vector_norm(x[dst] + shift @ lat - x[src], dim=1)
    e1, _ = neighbors.triplets(src, dist, len(pos), cfg["threebody_cutoff"])
    return {"atoms": len(pos), "edges": len(src), "triplets": len(e1), "graphs": 1,
            "steps": t["rebuild_every"]}


def release(ctx):
    ctx.pot = None


def check(ctx) -> dict:
    """The first chunk (from the benchmark's state) and one chunk of the
    window drawn from the seed (from the state the program reached), each
    followed by the reference in float64: the chunk's displacement and
    velocity change (largest error over the largest reference change).
    The energy is not compared here: the float32 total of 13,500 atoms
    carries ~1e-5 eV/atom of summation noise, as large as the control's
    error (PERF.md); the screen cells compare energies per structure."""
    return compare(ctx, checked(ctx))


def checked(ctx) -> list:
    pick = int(np.random.default_rng([ctx.seed, 3]).integers(len(ctx.chunks)))
    return [ctx.first, ctx.chunks[pick]]


def control(ctx) -> dict:
    """The check with the reference in TF32 in the program's place."""
    weights = {k: v.to(ctx.device) for k, v in ctx.weights.items()}
    reached = [drive.md_chunk(weights, ctx.config, (ctx.lattice, c[0], ctx.numbers), c[1],
                              ctx.masses, ctx.elemental, ctx.traffic, "tf32")
               for c in checked(ctx)]
    return compare(ctx, checked(ctx), reached)


def compare(ctx, chunks, reached=None) -> dict:
    """``reached``: per chunk, (end positions, end velocities, energies) that
    stand in the program's place (the control); the program's by default."""
    weights = {k: v.to(ctx.device) for k, v in ctx.weights.items()}
    out = {"displacement_err": 0.0, "velocity_err": 0.0}
    for c, (pos0, vel0, pos1, vel1, _) in enumerate(chunks):
        x, v, _ = drive.md_chunk(weights, ctx.config, (ctx.lattice, pos0, ctx.numbers), vel0,
                                 ctx.masses, ctx.elemental, ctx.traffic)
        if reached is not None:
            pos1, vel1, _ = reached[c]
        dx = drive.min_image(pos1 - x, ctx.lattice)
        moved = drive.min_image(x - pos0, ctx.lattice)
        out["displacement_err"] = max(out["displacement_err"],
                                      np.abs(dx).max() / np.abs(moved).max())
        out["velocity_err"] = max(out["velocity_err"], drive.max_rel(vel1 - vel0, v - vel0))
    return out
