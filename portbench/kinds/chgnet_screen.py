"""E/F/S and magnetic moments of CHGNet: the screen kind's one closed-loop
client on the CHGNet configuration. Each request is ``to_torch`` of a host
batch packed with its bond pairs (``pack_structures(..., bond_pairs=True)``
at the bond-graph cutoff), the potential, and energies, forces, stresses
and magnetic moments copied to the host.

The weights are this kind's own (:func:`layout`, :func:`make_weights`: the
program's ``state_dict`` names, one seeded draw on the device). The check
compares the last answer to ``checked`` pool batches with the plain
reference in float64 (``reference/chgnet.py``): ``energy_err`` (eV/atom,
worst structure), ``forces_err``, ``stress_err`` and ``magmom_err`` (each
the largest error over the largest reference magnitude).

Traffic keys: those of ``kinds/screen.py``. The benchmark's CPU rehearsal
(``conftest.tiny``) cuts the screen and train kinds by name and gives every
other kind the MD kinds' cut, ``reps``: a traffic that carries ``reps``
takes the screen kinds' cut instead (:data:`REHEARSAL`).
"""

from __future__ import annotations

import contextlib
import math
import statistics
import time

import numpy as np
import torch

from portbench import harness, mpmix, trace, weights
from portbench.kinds import screen
from portbench.reference import chgnet as reference
from portbench.reference import drive


# conftest.tiny's cut of the screen kinds, for a traffic that carries ``reps``
REHEARSAL = {"recipe": [["Cu", 2, 2, 2], ["NaCl", 1, 1, 2], ["Mg", 3, 3, 2]], "repeat": 1,
             "pool": 3, "traced": 2, "checked": 2}


def layout(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every weight, kernels as (in, out); kind is
    ``kernel``, ``embedding``, ``bias``, ``scale`` (LayerNorm weights) or
    ``frequency``."""
    d, r, a, convs = cfg["embedding_dim"], cfg["num_radial"], cfg["num_angular"], cfg["num_blocks"]
    leaves = [("model.atom_embedding.embedding", (cfg["num_types"], d), "embedding"),
              ("model.rbf_ag.frequencies", (r,), "frequency"),
              ("model.rbf_bg.frequencies", (r,), "frequency")]
    for name, fan_in in (("bond_embedding", r), ("bond_weights_ag", r), ("bond_weights_bg", r),
                         ("angle_embedding", a)):
        leaves.append((f"model.{name}.kernel", (fan_in, d), "kernel"))

    def dense(name, n_in, n_out, bias=True):
        leaves.append((f"{name}.kernel", (n_in, n_out), "kernel"))
        if bias:
            leaves.append((f"{name}.bias", (n_out,), "bias"))

    def conv(name, n_in, hidden, out):
        dims = [n_in, *hidden, d]
        for part in ("core", "gate"):
            for i in range(len(dims) - 1):
                dense(f"{name}.phi.{part}_{i}", dims[i], dims[i + 1])
            leaves.append((f"{name}.phi.{part}_norm.weight", (d,), "scale"))
            leaves.append((f"{name}.phi.{part}_norm.bias", (d,), "bias"))
        if out:
            dense(f"{name}.out", d, d)

    for t in range(convs):
        conv(f"model.atom_conv_{t}", 3 * d, [d], True)
    for t in range(convs - 1):
        conv(f"model.bond_conv_{t}", 4 * d, [d], True)
    for t in range(convs - 2):
        conv(f"model.angle_update_{t}", 4 * d, [], False)
    dense("model.site_wise", d, 1)
    dims = [d, d, d, d, 1]
    for i in range(len(dims) - 1):
        dense(f"model.readout.{i}", dims[i], dims[i + 1])
    return leaves


def make_weights(cfg: dict, seed: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """One normal draw on ``device`` cut into the leaves: kernels by
    1 / sqrt(fan_in), the embedding by 1 / sqrt(width), biases by 0.1,
    LayerNorm scales 1 + 0.1 N, frequencies n pi + 0.1 N."""
    leaves = layout(cfg)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for (name, shape, kind), size in zip(leaves, sizes):
        x = flat[off:off + size].reshape(shape)
        off += size
        if kind == "kernel":
            x = x / math.sqrt(shape[0])
        elif kind == "embedding":
            x = x / math.sqrt(shape[1])
        elif kind == "bias":
            x = 0.1 * x
        elif kind == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = math.pi * torch.arange(1, size + 1, device=device, dtype=dtype) + 0.1 * x
        out[name] = x
    return out


def model_flops(cfg: dict, work: dict) -> float:
    """Matrix-product FLOPs (2 m n k) of one CHGNet forward at a request's
    real sizes: the bases' linear maps (three per edge, one per angle), the
    atom convs' phi (per edge) and out (per node), the bond convs' phi (per
    angle) and out (per edge), the angle updates' phi (per angle), the
    magnetic moment and the readout (per node). Elementwise work, the
    LayerNorms and the gathers and sums are left out. ``work``: ``atoms``,
    ``bonds`` (undirected; two edges each) and ``angles``."""
    d, r, a, convs = cfg["embedding_dim"], cfg["num_radial"], cfg["num_angular"], cfg["num_blocks"]
    nodes, edges, angles = work["atoms"], 2 * work["bonds"], work["angles"]
    twin = lambda n_in, hidden: 2 * 2 * (n_in * hidden + hidden * d if hidden else n_in * d)
    per_edge = 3 * 2 * r * d + convs * twin(3 * d, d) + (convs - 1) * 2 * d * d
    per_angle = 2 * a * d + (convs - 1) * twin(4 * d, d) + (convs - 2) * twin(4 * d, 0)
    per_node = convs * 2 * d * d + 2 * d + 2 * (3 * d * d + d)
    return per_node * nodes + per_edge * edges + per_angle * angles


def setup(ctx):
    from torch_m3gnet_tpu_torch import build_model
    from torch_m3gnet_tpu_torch.data import Structure, pack_structures

    t, cfg = ctx.traffic, ctx.config
    if "reps" in t:
        t.update(REHEARSAL)
    ctx.weights = make_weights(cfg, ctx.seed, ctx.device)
    ctx.elemental = weights.elemental_energies(cfg, ctx.seed)
    ctx.pot = build_model(harness.model_config(cfg), elemental_energies=list(ctx.elemental),
                          device=ctx.device)
    ctx.pot.load_state_dict(ctx.weights)
    ctx.structures = mpmix.batches(t["recipe"] * t["repeat"], t["pool"], ctx.seed, t["strain"],
                                   t["noise"])
    ctx.pool = [pack_structures([Structure(*s) for s in batch], cfg["cutoff"],
                                cfg["threebody_cutoff"], pad_multiple=t["pad_multiple"],
                                bond_pairs="edge_reverse" in ctx.pot.model.batch_index)
                for batch in ctx.structures]
    ctx.atoms = [int(np.sum(b.node_mask)) for b in ctx.pool]
    ctx.last = {}
    for i in range(len(ctx.pool)):  # every shape of the window, once
        request(ctx, i)
    screen.sync(ctx)


def request(ctx, i: int, traced: bool = False):
    from torch.profiler import record_function

    from torch_m3gnet_tpu_torch.data import to_torch

    pot = ctx.pot
    with record_function("portbench.to_torch") if traced else contextlib.nullcontext():
        graph = to_torch(ctx.pool[i], ctx.device, torch.float32, pot.model.batch_index)
        if traced:
            screen.sync(ctx)
    out = pot(graph)
    ctx.last[i] = tuple(x.detach().cpu() for x in (out.energy, out.forces, out.stress,
                                                   out.magmom))


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
    """The profiled requests; ``ctx.counted`` holds what the program's
    counters ``chgnet.angles`` and ``chgnet.bonds`` added over them (the
    real angles and undirected bonds it evaluated; ``mfu.chgnet``)."""
    from torch_m3gnet_tpu_torch.utils.profiling import counts

    tr = trace.Trace()
    before = counts()
    with trace.profiled(ctx.device) as records:
        for k in range(ctx.traffic["traced"]):
            i = k % len(ctx.pool)
            with trace.span():
                request(ctx, i, traced=True)
            tr.work.append(harness.work_of(ctx.pool[i]))
    after = counts()
    ctx.counted = {name: after.get(name, 0) - before.get(name, 0)
                   for name in ("chgnet.angles", "chgnet.bonds")}
    tr.records = records
    return tr


release = screen.release


def check(ctx) -> dict:
    """Energy per atom (eV), forces, stress and magnetic moments (each as
    its largest error over the largest reference magnitude) of the last
    answer in the window to each checked pool batch, against the reference
    in float64."""
    return compare(ctx, screen.picks(ctx))


def control(ctx) -> dict:
    """The check with the reference in TF32 in the program's place."""
    answers = {}
    for i in screen.picks(ctx):
        ref = reference.efs(ctx.weights, ctx.config, ctx.structures[i], ctx.elemental, "tf32",
                            ctx.traffic["block_atoms"])
        answers[i] = (np.array([r[0] for r in ref]), np.concatenate([r[1] for r in ref]),
                      np.stack([r[2] for r in ref]), np.concatenate([r[3] for r in ref]))
    return compare(ctx, screen.picks(ctx), answers)


def compare(ctx, picks, answers=None) -> dict:
    """``answers``: per pool batch, (energies, forces, stresses, moments)
    that stand in the program's place (the control); the program's by
    default."""
    e_err, got, want = 0.0, {k: [] for k in "fsm"}, {k: [] for k in "fsm"}
    for i in picks:
        structs = ctx.structures[i]
        ref = reference.efs(ctx.weights, ctx.config, structs, ctx.elemental, "float64",
                            ctx.traffic["block_atoms"])
        energy, forces, stress, magmom = (answers or ctx.last)[i]
        off = 0
        for b, (s, (e_r, f_r, st_r, m_r)) in enumerate(zip(structs, ref)):
            n = len(s[2])
            e_err = max(e_err, abs(float(energy[b]) - e_r) / n)
            for key, mine, theirs in (("f", forces[off:off + n], f_r), ("s", stress[b], st_r),
                                      ("m", magmom[off:off + n], m_r)):
                got[key].append(np.asarray(mine, float).reshape(-1))
                want[key].append(np.asarray(theirs, float).reshape(-1))
            off += n
    err = {k: drive.max_rel(np.concatenate(got[k]), np.concatenate(want[k])) for k in got}
    return {"energy_err": e_err, "forces_err": err["f"], "stress_err": err["s"],
            "magmom_err": err["m"]}
