"""Drive the PyTorch port on every card of one host, one NCCL rank a card.

    python3 multicard_smoke.py [--parts gp_eval,dp_gp,...]

It needs two or more CUDA devices and uses up to four; with fewer than two
it exits 1 with a message on stderr and prints no result. S runs over each
of 2 and 4 that the cards allow. Ranks start through
``parallel.launch.run(..., backend="nccl")``: rank ``r`` is bound to
``cuda:r`` before its process group starts, so every collective, a barrier
too, runs on its own card. The CLI part runs under ``torchrun``. Every model
is the default one (227,549 parameters, f32, full width and depth, weights
from seed 0); the checks take ``chip_smoke.py``'s tolerances (``MODEL_TOL``
for E/F/S, ``TRAIN_TOL`` for loss and gradients, ``UPDATE_TOL`` for
updates), and its helpers, which this script imports.

Parts, in this order (one JSON line each):

1. ``gp_eval``: gp-4000 (``chip_smoke.gp_cell``: a 10x10x10 fcc-Cu
   supercell, 4,000 atoms, labelled by the seed-1 teacher), reordered along
   an axis and cut into S slabs, evaluated in the factorized and the fused
   mode: E/F/S (every shard's forces gathered) against the whole cell on
   one card, each rank's launches exactly one eval's of its mode, the gp
   eval's ms (host clock to a synchronise, median of 5, on the shards
   already on the cards) against one card's; the halo exchange of 64 f32
   columns held to its index reference (the columns each real edge reads
   are the global columns of its destination) and then timed with CUDA
   events after a synchronise and a barrier (median of 20), with its bytes
   and GB/s; ``broadcast_parameters``' ms; each rank's bound card.
2. ``gp_train``: one ``GraphParallelTrainer`` step on gp-4000 in the
   factorized and in the fused mode (B4-B7's double backward; the exchange
   crossed twice a block): its loss (``MODEL_TOL``), the gradient it hands
   the optimizer (``TRAIN_TOL``) and its update (``UPDATE_TOL``) against
   one card's ``Trainer`` step on the whole cell in that mode; the weights
   bitwise equal on every rank afterwards; the step's ms.
3. ``gp_big``: gp-32000 (``BIG_REPS`` = 20: 32,000 atoms, ~1.36 M edges,
   ~9.8 M triplets), factorized, its shards passed to the ranks in files:
   the eval at each S against one card (``MODEL_TOL``; launches one
   eval's), step ms and peak GB a rank at S = 1, 2 and 4, the exchange as
   in part 1; one ``GraphParallelTrainer`` step at each S, the S = 4 step's
   loss and gradient against the S = 2 step's (``TRAIN_TOL``), with peak GB
   a rank. One card does not hold this train step, so it is not run there:
   its peak is predicted from the measured ones.
4. ``dp``: ``chip_smoke.dp_rank`` on S ranks, one card each: 4 labelled
   mlearn cells a rank, then a tail of 3 that leaves the last rank fully
   padded; each step against the same weighted gradient on one card, an
   unweighted mean failing the tail's check (``chip_smoke.check_dp``); the
   dp step's ms against one rank's 4-cell step; the dp streaming
   producer's host ms a batch at S ranks.
5. ``mesh_cli``: ``torchrun --standalone --nproc-per-node S -m
   torch_m3gnet_tpu_torch.cli.train_mlearn --mesh S`` (NCCL, the default)
   for one epoch on that mlearn set: every rank printed the same test
   metrics, rank 0 alone logged, its checkpoint loads and evaluates
   (``chip_smoke.check_mesh_cli``); the one-card run's test metrics beside
   it (dp weights each rank's metrics by its real graphs, so the two differ
   by design).
6. ``dp_gp``: on four cards, a ("dp", "gp") mesh of 2 x 2: gp-4000 and a
   second jitter of it (both labelled by the teacher), one per dp row
   (``chip_smoke.dp_gp_rank``): each row's gp E/F/S against its cell on
   one card, each rank's launches one eval's, the eval's ms; then one
   ``GraphParallelTrainer(..., dp_axis="dp")`` step: its loss against the
   mean of the two cells' one-card losses (``MODEL_TOL``), the gradient it
   hands the optimizer against the mean of their gradients (``TRAIN_TOL``),
   its update (``UPDATE_TOL``), the weights bitwise equal on all four
   ranks, the step's ms, the trainer's ``eval_loss`` (no grad) against the
   step's loss; the first row's gradient alone and the sum of the rows'
   must each fail the gradient check (``chip_smoke.check_dp_gp``).

``--parts gp_eval,dp_gp`` runs only the parts named (every part without
it; ``gp_eval`` and ``gp_train`` share one job a size, which then runs
only the named one). A part that fails does not stop the next; the script then ends with
``{"ok": false, "failed": [...]}`` and exit 1. On success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
after the cards' ``nvidia-smi`` name and power limit and the link matrix.

The rank code is :func:`rank_job` (parts :data:`PARTS`); ``platform="cpu"``
runs it over gloo on the CPU at a small size (``tests/test_torch_multicard.py``).
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

import chip_smoke as cs

# gp-32000: a 20x20x20 fcc-Cu supercell.
BIG_REPS = 20
# The halo exchange timed: F feature columns (one block's node features) of
# f32 values from EXCHANGE_SEED, REPS_EXCHANGE calls.
EXCHANGE_F, EXCHANGE_SEED, REPS_EXCHANGE = 64, 7, 20
# The links under large messages: LINK_BYTES a rank, REPS_LINK calls.
LINK_BYTES, REPS_LINK, CPU_LINK_BYTES = 256 * 2**20, 5, 2**16
# Each job's time limit, and the whole script's: a part that would start
# after SCRIPT_BUDGET_S is skipped (and fails).
JOB_TIMEOUT_S, BIG_JOB_TIMEOUT_S, CLI_TIMEOUT_S, SCRIPT_BUDGET_S = 240, 420, 300, 1200
FIELDS = ("energy", "forces", "stress")
MODES = ("factorized", "fused")
GB = 1e9


# ---------------------------------------------------------------------------
# What each rank runs
# ---------------------------------------------------------------------------

def _device(inputs):
    import torch

    if inputs["platform"] == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _mine(files) -> dict:
    """This rank's file of ``files`` (one a rank)."""
    import torch.distributed as dist

    with open(files[dist.get_rank()], "rb") as f:
        return pickle.load(f)


def _mesh(inputs, shape=None, names="gp"):
    from torch_m3gnet_tpu_torch.parallel import make_mesh

    return make_mesh(shape, names, inputs["platform"])


def _model(inputs, **kw):
    import torch

    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.models import build_model

    cfg = M3GNetConfig(**{**inputs["settings"], **kw})
    return cfg, build_model(cfg, device=_device(inputs),
                            generator=torch.Generator().manual_seed(0))


def _peak_reset(inputs) -> None:
    import torch

    if inputs["platform"] == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(inputs):
    import torch

    if inputs["platform"] != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / GB


def collective_ms(fn, inputs, reps: int) -> list:
    """Each of ``reps`` calls of ``fn()`` timed alone: a synchronise and a
    barrier first (every rank starts together), then CUDA events on the
    current stream around the call, where the collective's stream is waited
    on (the host clock on the CPU)."""
    import torch
    import torch.distributed as dist

    fn()
    times = []
    for _ in range(reps):
        cs.synchronize()
        dist.barrier()
        if inputs["platform"] == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def exchange(inputs, mine: dict, group) -> dict:
    """The halo exchange of ``EXCHANGE_F`` seeded f32 columns on this
    rank's shard: held to its index reference (every real edge's
    destination column equals the global column of its destination id,
    exactly: the exchange copies), then timed."""
    import torch
    import torch.distributed as dist

    from torch_m3gnet_tpu_torch.ops.halo import halo_exchange_fm

    shard, dev = mine["shard"], _device(inputs)
    nps, size, rank = shard.num_nodes, dist.get_world_size(group), dist.get_rank(group)
    x_all = torch.as_tensor(np.random.default_rng(EXCHANGE_SEED).standard_normal(
        (EXCHANGE_F, size * nps)).astype(np.float32), device=dev)
    x = x_all[:, rank * nps:(rank + 1) * nps].contiguous()
    send, recv = (torch.as_tensor(getattr(shard, k), device=dev).to(torch.int32)
                  for k in ("halo_send_idx", "halo_recv_idx"))

    def call():
        return halo_exchange_fm(x, send, recv, shard.halo_offsets, group)

    ext = call()
    real = np.asarray(shard.edge_mask, bool)
    local_ids = torch.as_tensor(np.asarray(shard.edge_dst)[real], device=dev, dtype=torch.long)
    global_ids = torch.as_tensor(mine["dst_global"], device=dev, dtype=torch.long)
    err = float((ext[:, local_ids] - x_all[:, global_ids]).abs().max())
    times = collective_ms(call, inputs, REPS_EXCHANGE)
    rows = int(np.asarray(shard.halo_send_idx).shape[-1])
    nbytes = rows * EXCHANGE_F * 4
    ms = statistics.median(times)
    return {"index_check_max_abs": err, "edges_checked": int(real.sum()), "ms": ms,
            "ms_min": min(times), "rows_sent": rows, "offsets": list(shard.halo_offsets),
            "bytes_sent": nbytes, "gb_per_s": nbytes / (ms * 1e-3) / GB}


def link_probe(inputs, group) -> dict:
    """The links' rate under large messages, beside the exchange's small
    ones: an even ``all_to_all_single`` and an ``all_reduce`` of
    ``inputs["link_bytes"]`` f32 bytes a rank (``LINK_BYTES`` on the card),
    each timed as the exchange is (median of ``REPS_LINK``). The
    all-to-all's rate counts the bytes each rank sends to the others; the
    all-reduce's is its bus rate, 2 (S - 1) / S x bytes over the time."""
    import torch
    import torch.distributed as dist

    size = dist.get_world_size(group)
    n = inputs["link_bytes"] // 4 // size * size
    x, y = (torch.ones(n, device=_device(inputs)) for _ in range(2))
    out = {"bytes_per_rank": 4 * n}
    for label, fn, moved in (
            ("all_to_all", lambda: dist.all_to_all_single(y, x, group=group), (size - 1) / size),
            ("all_reduce", lambda: dist.all_reduce(x, group=group), 2 * (size - 1) / size)):
        ms = statistics.median(collective_ms(fn, inputs, REPS_LINK))
        out[label] = {"ms": ms, "gb_per_s": moved * 4 * n / (ms * 1e-3) / GB}
    return out


def gp_eval_part(inputs) -> dict:
    """Part 1 on one rank."""
    import torch.distributed as dist

    from torch_m3gnet_tpu_torch.parallel import GraphParallelPotential
    from torch_m3gnet_tpu_torch.parallel.dp import broadcast_parameters

    mine, mesh, out = _mine(inputs["gp_eval"]["files"]), _mesh(inputs), {}
    rank, shard = dist.get_rank(), mine["shard"]
    for mode in MODES:
        cfg, pot = _model(inputs, threebody_mode=mode)
        gp = GraphParallelPotential(pot, mesh)
        cs.reset_launches()
        res = gp.apply(shard)
        cs.synchronize()
        row = {"launches": cs.all_launches() if inputs["platform"] == "cuda" else None,
               "expected": cs.expected_launches(mode, cfg.num_blocks, False)}
        card = gp.to_device(shard, _device(inputs), index=pot.model.batch_index)
        row["gp_eval_ms"] = cs.rank_times(lambda: gp(card))
        if rank == 0:
            row["efs"] = cs.host_efs(res)
        out[mode] = row
    out["exchange"] = exchange(inputs, mine, gp.group)
    out["link"] = link_probe(inputs, gp.group)
    out["broadcast_ms"] = statistics.median(collective_ms(lambda: broadcast_parameters(pot),
                                                         inputs, 5))
    return out


def gp_train_part(inputs) -> dict:
    """Part 2 on one rank: one ``GraphParallelTrainer`` step in each mode
    (``chip_smoke.gp_step``: the gradient it hands the optimizer
    recorded)."""
    from torch_m3gnet_tpu_torch.parallel import GraphParallelTrainer

    shard, out = _mine(inputs["gp_train"]["files"])["shard"], {}
    for mode in MODES:
        cfg, pot = _model(inputs, threebody_mode=mode)
        trainer = cs.recording(GraphParallelTrainer)(pot, cfg, _mesh(inputs))
        out[mode] = cs.gp_step(trainer, shard, _device(inputs))
    return out


def gp_big_part(inputs) -> dict:
    """Part 3 on one rank: the eval (E/F/S, launches, ms, peak) and the
    exchange, then one ``GraphParallelTrainer`` step (loss, gradient,
    peak, ms)."""
    import torch.distributed as dist

    from torch_m3gnet_tpu_torch.parallel import GraphParallelPotential, GraphParallelTrainer

    mine, mesh, rank = _mine(inputs["gp_big"]["files"]), _mesh(inputs), dist.get_rank()
    cfg, pot = _model(inputs)
    gp = GraphParallelPotential(pot, mesh)
    card = gp.to_device(mine["shard"], _device(inputs), index=pot.model.batch_index)
    _peak_reset(inputs)
    cs.reset_launches()
    res = gp.apply(card)
    out = {"eval_peak_gb": _peak_gb(inputs),
           "launches": cs.all_launches() if inputs["platform"] == "cuda" else None,
           "expected": cs.expected_launches("factorized", cfg.num_blocks, False)}
    if rank == 0:
        out["efs"] = cs.host_efs(res)
    del res
    out["gp_eval_ms"] = cs.rank_times(lambda: gp(card))
    out["exchange"] = exchange(inputs, mine, gp.group)
    trainer = cs.recording(GraphParallelTrainer)(pot, cfg, mesh)
    _peak_reset(inputs)
    loss = float(trainer.train_step(card, cfg.learning_rate)["loss"])
    out["train_peak_gb"] = _peak_gb(inputs)
    if rank == 0:
        out.update(loss=loss, grads=[g.cpu().numpy() for g in trainer.grads])
    out["gp_train_step_ms"] = cs.rank_times(lambda: trainer.train_step(card), reps=2)
    return out


def dp_part(inputs) -> dict:
    """Part 4 on one rank: ``chip_smoke.dp_rank`` on this rank's card."""
    return cs.dp_rank({**inputs["dp"], "device": _device(inputs)})


def dp_gp_part(inputs) -> dict:
    """Part 6 on one rank: ``chip_smoke.dp_gp_rank`` on a 2 x 2 ("dp",
    "gp") mesh, this rank's shard on its card: the eval of its dp row, then
    one dp x gp ``GraphParallelTrainer`` step over both rows."""
    cfg, _ = _model(inputs)
    return cs.dp_gp_rank({"batch": _mine(inputs["dp_gp"]["files"])["shard"],
                          "device": _device(inputs), "config": cfg})


PARTS = {"gp_eval": gp_eval_part, "gp_train": gp_train_part, "gp_big": gp_big_part,
         "dp": dp_part, "dp_gp": dp_gp_part}
# The script's parts, in the order they run (``--parts`` picks among them).
PART_NAMES = ("gp_eval", "gp_train", "gp_big", "dp", "mesh_cli", "dp_gp")


def rank_job(inputs: dict) -> dict:
    """What each rank runs: its binding, the parts ``inputs["parts"]`` in
    order (each part's inputs under its name), each part's end in seconds
    from the job's start (``t0``, the caller's clock), and the cards on
    which this process holds a CUDA context."""
    import torch
    import torch.distributed as dist

    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "bound_device": str(getattr(dist.group.WORLD, "bound_device_id", None)),
           "timeline_s": {"rank_up": time.time() - inputs["t0"]}}
    if inputs["platform"] == "cuda":
        out["current_device"] = torch.cuda.current_device()
    for part in inputs["parts"]:
        out[part] = PARTS[part](inputs)
        out["timeline_s"][part] = time.time() - inputs["t0"]
    has_context = getattr(torch._C, "_cuda_hasPrimaryContext", None)
    if inputs["platform"] == "cuda" and has_context is not None:
        out["contexts_on"] = [i for i in range(torch.cuda.device_count()) if has_context(i)]
    return out


# ---------------------------------------------------------------------------
# The caller: cells, one-card references, jobs and checks
# ---------------------------------------------------------------------------

def _write_rows(tmp, name, rows) -> list:
    """One pickle a rank (its data), in the job's temporary directory:
    large graphs never go through ``launch.run``'s pickled arguments."""
    paths = []
    for r, row in enumerate(rows):
        paths.append(os.path.join(tmp, f"{name}_rank{r}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump(row, f, protocol=pickle.HIGHEST_PROTOCOL)
    return paths


def shard_files(tmp, name, full, size) -> tuple:
    """``full`` cut into ``size`` slabs: (the stacked shards, one file a
    rank holding its shard and the global destination id of each of its
    real edges, in edge order: the exchange's index reference)."""
    from torch_m3gnet_tpu_torch.parallel import partition_graph

    sharded = partition_graph(full, size)
    nps = sharded.positions.shape[1]
    src, dst = np.asarray(full.edge_src), np.asarray(full.edge_dst)
    rows = [{"shard": sharded.row(r), "dst_global": dst[src // nps == r]} for r in range(size)]
    return sharded, _write_rows(tmp, f"{name}_S{size}", rows)


def cell_graph(cell, cfg):
    """A cell's graph at the model's cutoffs, reordered along its longest
    axis (index blocks become slabs)."""
    from torch_m3gnet_tpu_torch.data import graph_from_structure
    from torch_m3gnet_tpu_torch.parallel.graph_shard import spatial_reorder

    return spatial_reorder(graph_from_structure(cell, cfg.cutoff, cfg.threebody_cutoff), "axis")[0]


def _free(device) -> None:
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def one_card_eval(cfg, full, device, reps: int = 5) -> dict:
    """The seed-0 model's E/F/S of the whole cell on one card, its eval ms
    (the graph already on the card) and peak GB."""
    import torch

    from torch_m3gnet_tpu_torch.data import to_torch
    from torch_m3gnet_tpu_torch.models import build_model

    pot = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    card = to_torch(full, device, index=pot.model.batch_index)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = {"efs": cs.host_efs(pot(card))}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / GB if cuda else None
    out["eval_ms"] = cs.rank_times(lambda: pot(card), reps=reps)
    del pot, card
    _free(device)
    return out


def gp4000_data(tmp, sizes, device="cuda", settings=None, reps=cs.GP_REPS) -> dict:
    """gp-4000 (``reps`` a side), its shards at each S, and one card's
    eval and ``Trainer`` step on the whole cell in both modes."""
    from torch_m3gnet_tpu_torch.config import M3GNetConfig

    settings = settings or {}
    cfg = M3GNetConfig(**settings)
    t0 = time.perf_counter()
    full = cell_graph(cs.gp_cell(reps, device=device, cfg=cfg), cfg)
    data = {"full": full, "settings": settings, "sizes": {}}
    for size in sizes:
        sharded, files = shard_files(tmp, "gp4000", full, size)
        data["sizes"][size] = {"files": files, **shard_shapes(sharded)}
    data["host_build_s"] = time.perf_counter() - t0
    data["one_card"] = {mode: one_card_eval(cfg.replace(threebody_mode=mode), full, device)
                        for mode in MODES}
    data["one_card_step"] = {mode: cs.one_device_step(cfg.replace(threebody_mode=mode), full,
                                                      device) for mode in MODES}
    _free(device)
    data["cell"] = {"atoms": full.num_nodes, "edges": full.num_edges,
                    "triplets": full.num_triplets}
    return data


def shard_shapes(sharded) -> dict:
    """The halo's rows against an all-gather's, and a shard's padded
    (nodes, edges, triplets)."""
    from torch_m3gnet_tpu_torch.parallel import halo_stats

    return {"halo_stats": halo_stats(sharded),
            "shard_padded": [int(sharded.positions.shape[1]), int(sharded.edge_src.shape[1]),
                             int(sharded.triplet_e1.shape[1])]}


def gp32000_data(tmp, sizes, device="cuda", settings=None, reps=BIG_REPS) -> dict:
    """gp-32000, labelled by the teacher on one card, its shards at each S
    in files, and one card's eval of the whole cell."""
    from torch_m3gnet_tpu_torch.config import M3GNetConfig

    settings = settings or {}
    cfg = M3GNetConfig(**settings)
    t0 = time.perf_counter()
    cell = cs.gp_cell(reps, device=device, cfg=cfg)
    _free(device)
    full = cell_graph(cell, cfg)
    data = {"settings": settings, "sizes": {},
            "cell": {"reps": reps, "atoms": full.num_nodes, "edges": full.num_edges,
                     "triplets": full.num_triplets}}
    for size in sizes:
        sharded, files = shard_files(tmp, "gp32000", full, size)
        data["sizes"][size] = {"files": files, **shard_shapes(sharded)}
        del sharded
    data["host_build_s"] = time.perf_counter() - t0
    data["one_card"] = one_card_eval(cfg, full, device)
    return data


def dp_data(tmp, sizes, device="cuda", cfg=None, structures=None) -> dict:
    """Phase 9's labelled cells as an mlearn set, and per S the dp stacks
    of ``check_parallel``: 4 cells a rank, then a tail of 3 that leaves the
    last rank fully padded."""
    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.data import BucketSpec
    from torch_m3gnet_tpu_torch.data.dataset import build_graphs, stack_global_batch
    from torch_m3gnet_tpu_torch.data.io import load_mlearn_json

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                          "mlearn_Cu.yaml")
    cfg = cfg or M3GNetConfig.from_yaml(config).replace(accumulate_grad_batches=1)
    if structures is None:
        structures = cs.workflow_structures()
        cs.label_structures(M3GNetConfig(), structures, device)
        _free(device)
    mlearn, _ = cs.write_workflow_data(tmp, structures)
    train = load_mlearn_json(os.path.join(mlearn, "training.json"))
    data = {"mlearn": mlearn, "config": config, "cfg": cfg, "train": train, "stacks": {}}
    for size in sizes:
        n = cs.DP_PER_RANK * size
        graphs = list(build_graphs(train[: n + cs.DP_TAIL], cfg.cutoff, cfg.threebody_cutoff))
        bucket = BucketSpec.for_batches(graphs, cs.DP_PER_RANK, cfg.pad_multiple)
        data["stacks"][size] = {
            "full": stack_global_batch(graphs[:n], cs.DP_PER_RANK, size, bucket),
            "tail": stack_global_batch(graphs[n:], cs.DP_PER_RANK, size, bucket)}
    return data


def dp_gp_data(tmp, g4000, device="cuda", reps=cs.GP_REPS) -> dict:
    """gp-4000 and a second jitter of it (seed GP_SEED + 1) partitioned to
    common shapes for a 2 x 2 mesh, and each on one card: its E/F/S and
    its ``Trainer`` step (factorized)."""
    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.parallel import stack_partitions

    cfg = M3GNetConfig(**g4000["settings"])
    second = cell_graph(cs.gp_cell(reps, cs.GP_SEED + 1, device, cfg), cfg)
    stack = stack_partitions([g4000["full"], second], 2)
    rows = [{"shard": stack.row(r // 2).row(r % 2)} for r in range(4)]
    return {"files": _write_rows(tmp, "dp_gp", rows),
            "evals": [g4000["one_card"]["factorized"]["efs"],
                      one_card_eval(cfg, second, device)["efs"]],
            "steps": [g4000["one_card_step"]["factorized"],
                      cs.one_device_step(cfg, second, device)]}


def run_job(parts, size, inputs, platform="cuda", timeout_s=JOB_TIMEOUT_S) -> list:
    """``rank_job`` for ``parts`` on ``size`` ranks (NCCL on the card, gloo
    on the CPU, where the link probe moves ``CPU_LINK_BYTES``)."""
    from torch_m3gnet_tpu_torch.parallel import launch

    t0 = time.time()
    link = LINK_BYTES if platform == "cuda" else CPU_LINK_BYTES
    ranks = launch.run("multicard_smoke:rank_job", size,
                       {"link_bytes": link, **inputs, "t0": t0, "parts": list(parts),
                        "platform": platform},
                       backend="nccl" if platform == "cuda" else "gloo", timeout_s=timeout_s)
    ranks[0]["job_s"] = time.time() - t0
    return ranks


def check_binding(ranks, platform="cuda") -> dict:
    """Every rank on NCCL, bound to ``cuda:rank`` and computing there."""
    got = [{k: r.get(k) for k in ("backend", "bound_device", "current_device", "contexts_on")}
           for r in ranks]
    if platform == "cuda":
        for r, g in enumerate(got):
            if not (g["backend"] == "nccl" and g["bound_device"] == f"cuda:{r}"
                    and g["current_device"] == r):
                raise AssertionError(f"rank {r} is not bound to cuda:{r}: {g}")
    return {"ranks": got, "job_s": ranks[0]["job_s"],
            "timeline_s": [r["timeline_s"] for r in ranks]}


def efs_errors(got: dict, want: dict, label: str) -> dict:
    """Each field's largest error over the reference's largest magnitude
    (the gathered forces cut to the cell's atoms), within ``MODEL_TOL``."""
    import torch

    errs = {}
    for f in FIELDS:
        w = torch.as_tensor(want[f])
        errs[f] = cs.rel_err(torch.as_tensor(got[f])[: len(w)], w)[1]
        print(f"  {label} {f}: rel={errs[f]:.3e} tol={cs.MODEL_TOL:.0e}")
        if not errs[f] <= cs.MODEL_TOL:
            raise AssertionError(f"{label} {f}: relative error {errs[f]:.3e}")
    return errs


def check_launches(row, label) -> None:
    if row["launches"] is not None and row["launches"] != row["expected"]:
        raise AssertionError(f"{label}: launches {row['launches']}, expected one eval's "
                             f"{row['expected']}")


def check_exchange(ex: dict, label: str) -> dict:
    print(f"  {label} exchange: index check max abs {ex['index_check_max_abs']} over "
          f"{ex['edges_checked']} edges; {ex['rows_sent']} rows x {EXCHANGE_F} f32 sent a call, "
          f"offsets {ex['offsets']}: {ex['ms']:.4f} ms (min {ex['ms_min']:.4f}), "
          f"{ex['gb_per_s']:.2f} GB/s")
    if ex["index_check_max_abs"] != 0.0:
        raise AssertionError(f"{label}: the exchanged columns differ from their index "
                             f"reference by {ex['index_check_max_abs']}")
    return ex


def check_gp_eval(ranks, data, size) -> dict:
    """Part 1 at ``size`` ranks: every rank's launches, rank 0's E/F/S
    against one card, the exchange's index check."""
    info = {"halo_stats": data["sizes"][size]["halo_stats"],
            "shard_padded": data["sizes"][size]["shard_padded"]}
    for mode in ("factorized", "fused"):
        for r in ranks:
            check_launches(r["gp_eval"][mode], f"gp-4000 {mode}, S={size}, rank {r['rank']}")
        row = ranks[0]["gp_eval"][mode]
        info[mode] = {"rel_err": efs_errors(row["efs"], data["one_card"][mode]["efs"],
                                            f"gp-4000 {mode} S={size}"),
                      "launches_per_rank": row["launches"],
                      "gp_eval_ms": [r["gp_eval"][mode]["gp_eval_ms"] for r in ranks],
                      "one_card_eval_ms": data["one_card"][mode]["eval_ms"]}
    info["exchange"] = [check_exchange(r["gp_eval"]["exchange"], f"S={size} rank {r['rank']}")
                        for r in ranks]
    info["broadcast_parameters_ms"] = [r["gp_eval"]["broadcast_ms"] for r in ranks]
    info["link"] = [r["gp_eval"]["link"] for r in ranks]
    print(f"  S={size} links, {info['link'][0]['bytes_per_rank']} bytes a rank: "
          + ", ".join(f"{k} {info['link'][0][k]['ms']:.3f} ms {info['link'][0][k]['gb_per_s']:.1f} "
                      f"GB/s" for k in ("all_to_all", "all_reduce")))
    return info


def check_gp_train(ranks, data, size) -> dict:
    """Part 2 at ``size`` ranks: each mode's step against one card's
    ``Trainer`` step on the whole cell (``chip_smoke.check_gp_step``)."""
    out = {}
    for mode in MODES:
        out[mode] = cs.check_gp_step(
            f"gp-4000 train step, {mode}, S={size}", ranks[0]["gp_train"][mode],
            data["one_card_step"][mode],
            [r["gp_train"][mode]["weights_bitwise_equal_across_ranks"] for r in ranks])
        out[mode]["gp_train_step_ms"] = [r["gp_train"][mode]["step_ms"] for r in ranks]
    return out


def check_gp_big(by_size: dict, data) -> dict:
    """Part 3: each S's eval against one card; the S = 4 train step
    against the S = 2 step; the predicted one-card train peak."""
    import torch

    info = {"cell": data["cell"], "one_card": {k: data["one_card"][k]
                                               for k in ("eval_ms", "peak_gb")}}
    for size, ranks in by_size.items():
        for r in ranks:
            check_launches(r["gp_big"], f"gp-32000 S={size} rank {r['rank']}")
        row = ranks[0]["gp_big"]
        info[f"S{size}"] = {
            "halo_stats": data["sizes"][size]["halo_stats"],
            "shard_padded": data["sizes"][size]["shard_padded"],
            "rel_err": efs_errors(row["efs"], data["one_card"]["efs"], f"gp-32000 S={size}"),
            "gp_eval_ms": [r["gp_big"]["gp_eval_ms"] for r in ranks],
            "eval_peak_gb": [r["gp_big"]["eval_peak_gb"] for r in ranks],
            "train_peak_gb": [r["gp_big"]["train_peak_gb"] for r in ranks],
            "gp_train_step_ms": [r["gp_big"]["gp_train_step_ms"] for r in ranks],
            "loss": row["loss"],
            "exchange": [check_exchange(r["gp_big"]["exchange"], f"gp-32000 S={size} "
                                        f"rank {r['rank']}") for r in ranks]}
    if 2 in by_size and 4 in by_size:
        a, b = by_size[2][0]["gp_big"], by_size[4][0]["gp_big"]
        loss_err = abs(b["loss"] - a["loss"]) / max(abs(a["loss"]), 1e-30)
        grad_err = max(cs.rel_err(torch.as_tensor(g4), torch.as_tensor(g2))[1]
                       for g4, g2 in zip(b["grads"], a["grads"]))
        print(f"  gp-32000 train step S=4 vs S=2: loss {b['loss']:.6e} vs {a['loss']:.6e} "
              f"(rel {loss_err:.3e}), worst gradient rel {grad_err:.3e} tol {cs.TRAIN_TOL:.0e}")
        if not (loss_err <= cs.TRAIN_TOL and grad_err <= cs.TRAIN_TOL):
            raise AssertionError("gp-32000: the S=4 train step differs from the S=2 step")
        info["train_S4_vs_S2"] = {"loss_rel_err": loss_err, "grad_rel_err": grad_err}
    if data["one_card"]["peak_gb"] is not None and 2 in by_size and 4 in by_size:
        p2, p4 = max(info["S2"]["train_peak_gb"]), max(info["S4"]["train_peak_gb"])
        ratio = p4 / max(info["S4"]["eval_peak_gb"])
        # a + b / S through the two measured peaks, and the one-card eval's
        # peak times the train:eval ratio of the S = 4 ranks
        info["predicted_one_card_train_peak_gb"] = {
            "a_plus_b_over_S": 3 * p2 - 2 * p4,
            "one_card_eval_peak_x_train_eval_ratio": data["one_card"]["peak_gb"] * ratio}
        print(f"  predicted one-card train peak (not run): "
              f"{info['predicted_one_card_train_peak_gb']} GB")
    return info


def run_mesh_cli(size, data, tmp, device="cuda") -> dict:
    """Part 5: ``train_mlearn --mesh S`` under torchrun (NCCL), each rank's
    output in its own file, checked by ``chip_smoke.check_mesh_cli``."""
    root, logs = os.path.join(tmp, f"cli_S{size}"), os.path.join(tmp, f"torchrun_S{size}")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(size), "--log-dir", logs, "--redirects", "3", "-m",
           "torch_m3gnet_tpu_torch.cli.train_mlearn", "--mesh", str(size), "--path",
           data["mlearn"], "--config", data["config"], "--root", root, "--max-epochs", "1",
           "--device", device]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.time() - t0
    outs = sorted(glob.glob(os.path.join(logs, "**", "stdout.log"), recursive=True))
    if proc.returncode != 0 or len(outs) != size:
        errs = sorted(glob.glob(os.path.join(logs, "**", "stderr.log"), recursive=True))
        raise AssertionError(f"torchrun --nproc-per-node {size}: exit {proc.returncode}, "
                             f"{len(outs)} rank logs\n{proc.stderr[-3000:]}\n"
                             + "".join(open(e).read()[-2000:] for e in errs))
    ranks = [{"cli": {"test": json.loads(open(p).read())["test"], "wall_s": wall}} for p in outs]
    info = cs.check_mesh_cli(ranks, {"root": root, "config": data["config"],
                                     "batch": data["stacks"][size]["full"].row(0)}, n_ranks=size)
    info["torchrun_wall_s"] = wall
    return info


def one_card_cli(data, tmp, device="cuda") -> dict:
    """The same CLI run on one card, in this process."""
    from torch_m3gnet_tpu_torch.cli import train_mlearn

    t0 = time.perf_counter()
    test = cs.cli_metrics(train_mlearn.main, [
        "--path", data["mlearn"], "--config", data["config"], "--root",
        os.path.join(tmp, "cli_one_card"), "--max-epochs", "1", "--device", device])
    return {"test": test, "wall_s": time.perf_counter() - t0}


def _plain(x):
    """JSON for numpy scalars and arrays."""
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def cards_and_links(cards: int) -> tuple:
    """(each card's ``nvidia-smi`` name and power limit, the topology matrix
    as ``nvidia-smi topo -m`` prints it, the links between the cards used):
    that matrix's entries where it runs, each card's active NVLinks and
    their GB/s (``nvlink --status``), and whether CUDA gives each card peer
    access to each other's memory."""
    import torch

    def run(*args) -> str:
        proc = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
        return (proc.stdout + proc.stderr).strip()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    topo, nvlink = run("topo", "-m"), run("nvlink", "--status")
    rows = [line.split() for line in topo.splitlines() if re.match(r"GPU\d+\s", line)]
    per_card, card = {}, None
    for line in nvlink.splitlines():
        head = re.match(r"GPU (\d+):", line)
        if head:
            card = int(head.group(1))
            per_card[card] = {"active": 0, "gb_per_s": 0.0}
        rate = re.search(r"Link \d+: ([\d.]+) GB/s", line)
        if rate and card is not None:
            per_card[card]["active"] += 1
            per_card[card]["gb_per_s"] += float(rate.group(1))
    links = {"topo": {f"{i}-{j}": rows[i][1 + j] for i in range(min(cards, len(rows)))
                      for j in range(cards) if i != j and 1 + j < len(rows[i])},
             "nvlink_per_card": {c: v for c, v in per_card.items() if c < cards},
             "peer_access": {f"{i}-{j}": torch.cuda.can_device_access_peer(i, j)
                             for i in range(cards) for j in range(cards) if i != j}}
    return smi.stdout.strip().splitlines()[:cards], topo, links


def nccl_transports(log_dir: str) -> dict:
    """NCCL's version and the transports its channels chose (``via ...``
    in its INFO logs, one file a process under ``log_dir``), with counts."""
    found, versions = {}, set()
    for path in glob.glob(os.path.join(log_dir, "nccl.*")):
        with open(path, errors="replace") as f:
            for line in f:
                via = re.search(r" via (\S+)", line)
                version = re.search(r"NCCL version (\S+)", line)
                if via:
                    found[via.group(1)] = found.get(via.group(1), 0) + 1
                if version:
                    versions.add(version.group(1))
    return {"versions": sorted(versions), "transports": found}


def _failure(exc) -> dict:
    traceback.print_exc()
    return {"failed": f"{type(exc).__name__}: {str(exc)[:400]}"}


def run_parts(cards: int, header: dict, platform: str = "cuda", settings=None,
              reps=(cs.GP_REPS, BIG_REPS), structures=None, deadline=None,
              only=None) -> list:
    """Parts 1-6 on ``cards`` cards (``platform="cpu"``: gloo ranks on the
    CPU, the model ``settings``, cells of ``reps`` a side and the dp set
    ``structures``, labelled: a rehearsal), or only the parts named in
    ``only``; prints each part's line and returns the parts that failed."""
    settings = settings or {}
    only = set(PART_NAMES if only is None else only)
    sizes = [s for s in (2, 4) if s <= cards]
    deadline = deadline or time.time() + SCRIPT_BUDGET_S
    failed, data = [], {}
    with tempfile.TemporaryDirectory(prefix="m3g_multicard_") as tmp:

        def part(label, fn):
            if label not in only:
                return
            print(f"== {label}")
            t0 = time.perf_counter()
            try:
                if time.time() > deadline:
                    raise TimeoutError("skipped: the script's time budget is spent")
                info = fn()
            except Exception as exc:
                failed.append(label)
                info = _failure(exc)
            info["part_s"] = time.perf_counter() - t0
            print(json.dumps({label: {**header, **info}}, default=_plain))

        def need(key, make):
            if key not in data:
                data[key] = make()
            return data[key]

        def per_size(job, check) -> dict:
            """``check(job(S), S)`` at each S; one S's failure does not stop
            the next."""
            out = {}
            for size in sizes:
                try:
                    out[f"S{size}"] = check(job(size), size)
                except Exception as exc:
                    out[f"S{size}"] = _failure(exc)
            bad = [k for k, v in out.items() if "failed" in v]
            if bad:
                raise AssertionError(f"failed at {bad}: {out}")
            return out

        def job(parts, size, inputs, timeout_s=JOB_TIMEOUT_S):
            return run_job(parts, size, {"settings": settings, **inputs}, platform, timeout_s)

        def g4000():
            return need("gp4000", lambda: gp4000_data(tmp, sizes, platform, settings, reps[0]))

        def gp_job(size):  # parts 1 and 2 share one job a size
            if size not in data.setdefault("gp_jobs", {}):
                files = g4000()["sizes"][size]["files"]
                data["gp_jobs"][size] = job([p for p in ("gp_eval", "gp_train") if p in only],
                                            size, {"gp_eval": {"files": files},
                                                   "gp_train": {"files": files}})
            return data["gp_jobs"][size]

        def eval_check(ranks, size):
            return {"binding": check_binding(ranks, platform), **check_gp_eval(ranks, g4000(), size)}

        part("gp_eval", lambda: {"cell": g4000()["cell"], **per_size(gp_job, eval_check)})
        part("gp_train", lambda: per_size(gp_job, lambda r, s: check_gp_train(r, g4000(), s)))

        def gp_big():
            big = need("gp32000", lambda: gp32000_data(tmp, sizes, platform, settings, reps[1]))
            by_size, bad = {}, {}
            for size in sizes:  # a size that fails (out of memory) does not stop the next
                try:
                    by_size[size] = job(("gp_big",), size, {
                        "gp_big": {"files": big["sizes"][size]["files"]}}, BIG_JOB_TIMEOUT_S)
                    check_binding(by_size[size], platform)
                except Exception as exc:
                    by_size.pop(size, None)
                    bad[f"S{size}"] = _failure(exc)
            info = {"host_build_s": big["host_build_s"], **check_gp_big(by_size, big)}
            if bad:
                raise AssertionError(f"gp-32000 failed at {bad}; the rest: {info}")
            return info

        part("gp_big", gp_big)

        def dps():
            return need("dp", lambda: dp_data(tmp, sizes, platform, cfg=None if not settings
                                              else dp_config(settings), structures=structures))

        def dp_job(size):
            d = dps()
            return job(("dp",), size, {"dp": {"config": d["cfg"], "stacks": d["stacks"][size]}})

        def dp_check(ranks, size):
            d = dps()
            info = {"binding": check_binding(ranks, platform), **cs.check_dp(ranks[0]["dp"])}
            info["stream_producer"] = cs.stream_producer_ms(d["train"], d["cfg"], os.path.join(
                tmp, f"shards_S{size}"), ranks=size)
            print(f"  dp S={size}: step {info['dp_step_ms']:.1f} ms vs one rank "
                  f"{info['one_rank_step_ms']:.1f} ms; producer {info['stream_producer']}")
            return info

        part("dp", lambda: per_size(dp_job, dp_check))
        part("mesh_cli", lambda: {"one_card": one_card_cli(dps(), tmp, platform), **per_size(
            lambda size: run_mesh_cli(size, dps(), tmp, platform), lambda info, size: info)})

        def dp_gp():
            d = need("dp_gp", lambda: dp_gp_data(tmp, g4000(), platform, reps[0]))
            ranks = job(("dp_gp",), 4, {"dp_gp": {"files": d["files"]}})
            return {"binding": check_binding(ranks, platform),
                    **cs.check_dp_gp([r["dp_gp"] for r in ranks], d["evals"], d["steps"])}

        if cards >= 4:
            part("dp_gp", dp_gp)
    return failed


def dp_config(settings: dict):
    """The dp parts' config with other model ``settings`` (a rehearsal)."""
    from torch_m3gnet_tpu_torch.config import M3GNetConfig

    return M3GNetConfig(**settings).replace(accumulate_grad_batches=1)


def parse_parts(argv=None) -> list:
    """The parts named by ``--parts a,b`` (every part without it)."""
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on every card of one host.")
    ap.add_argument("--parts", default=",".join(PART_NAMES),
                    help=f"comma-separated parts to run, of {', '.join(PART_NAMES)}")
    names = [p for p in ap.parse_args(argv).parts.split(",") if p]
    unknown = sorted(set(names) - set(PART_NAMES))
    if unknown or not names:
        ap.error(f"unknown parts {unknown}; choose from {', '.join(PART_NAMES)}")
    return names


def main(argv=None) -> int:
    import torch

    only = parse_parts(argv)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        print(f"multicard_smoke: needs two or more CUDA devices, this host has {count}",
              file=sys.stderr)
        return 1
    from torch_m3gnet_tpu_torch.ops import _cuda

    start = time.time()
    cards = min(count, 4)
    name = torch.cuda.get_device_name(0)
    smi, topo, links = cards_and_links(cards)
    print(f"== cards: {cards} x {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print("\n".join(f"  {line}" for line in smi))
    print(topo)
    print(f"  links between the cards used: {json.dumps(links)}")
    t0 = time.perf_counter()
    _cuda.build()
    _cuda.library()
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="m3g_nccl_") as nccl_logs:
        if "NCCL_DEBUG" not in os.environ:  # the transports each channel takes, in files
            os.environ.update(NCCL_DEBUG="INFO",
                              NCCL_DEBUG_FILE=os.path.join(nccl_logs, "nccl.%h.%p"))
        failed = run_parts(cards, {"card": name, "nvidia_smi": smi, "cards": cards,
                                   "links": links}, deadline=start + SCRIPT_BUDGET_S, only=only)
        print(f"  NCCL: {nccl_transports(nccl_logs)}")
    print(f"  script {time.time() - start:.1f} s")
    print("\n".join(smi))
    if failed:
        print(json.dumps({"ok": False, "failed": failed}))
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
