"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. card: the device name and ``nvidia-smi``'s name and power limit;
2. build: ``nvcc`` compiles every CUDA source of the port (``csrc/*.cu``),
   one process per source, all at once, into one library;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the bench shapes (the ``src``, ``triplet_e1``, ``triplet_e2`` and
   ``edge_graph`` of the real bench batch, seeded inputs), forward and VJP:
   the composed factorized stage (B1-B3), ``fused_triplet_gate_sum``
   through ``backward_pair`` (B4, B5, with the batch's e1 offsets and e2
   order; B5 two calls bitwise equal), ``windowed_take_fm`` through
   ``windowed_scatter_fm`` (B6, B7; B7 sums along the batch's owners of
   each index, the ``triplet_e1`` offsets and the e2 order, two calls
   bitwise equal; also along each index's stable order), and
   ``sorted_segment_sum`` (B8) at the four sorted sums of the path, with
   the offsets the model passes (the batch's; the strain stress's from
   ``Potential.assemble``): forward, VJP (the gather), gradient of the
   gradient (B8 again), two calls bitwise equal; then B1-B5 and B7 on
   the sorted indices of ``SORTED_CASES`` (one segment owning every entry, a
   20,480-entry run, runs across chunk boundaries, a ragged segment count,
   long stretches of empty segments; B4 and B5 with uniform random e2) at
   (l_max, n_max) = (1, 1), (3, 3), (4, 4) (B2 and B3 also with the operand
   as an offset view, a pointer that is not 16-byte aligned) and LN = 1, 9, 16,
   B7 by the sorted ids with their offsets and with their (identity) order
   and by uniform random ids with their order, its values also as an
   offset view:
   equal to the plain versions (dyadic data, exact sums), two calls bitwise
   equal; then each kernel Function's ``torch.func.vmap`` rule at K = 3
   members (``check_member_rules``), bitwise equal to 3 single calls and
   with one launch per call: at the bench shapes (B1-B5 at every pattern
   of shared, at stride 0, and batched float operands: 3 for B1-B4, 7 for
   B5; B6/B7 by e1 and e2; B8 at its four sorted sums) and on every case
   of ``SORTED_CASES``; then ``check_grid_slices``: B1-B5 with 65,540
   members, B7 with 4 x 65,540 rows and B8 with 70,400 rows (short runs
   and long ones), past the 65,535 blocks of a grid's y axis, against
   their plain versions, the members at each slice bound bitwise their own
   calls; then the index check of a host batch (``ops.batch_check``) at a
   tiny batch's sizes and a screen batch's, the kernel giving the plain
   version's word on the clean arrays and on every fault case of
   ``batch_check_faults``, and its time at the screen sizes against its
   bound (the ``{"batch_check": ...}`` line; at least ``CHECK_MIN_SHARE``);
   then CHGNet's norm-and-gate (``ops.norm_gate``, "BN"): both kernels
   against the plain version in float64 at ``NORM_GATE_CASES`` and at a
   screen request's shapes (output, d core, d gate, the parameters'
   gradients, two calls bitwise equal), the
   second order through its Functions, and both kernels' times at a
   chgnet-mptrj.screen request's shapes beside their bounds, the plain
   version and the transpose + ``layer_norm`` yardstick (the
   ``{"norm_gate": ...}`` line);
4. model: the default 227,549-parameter M3GNet (seeded weights) evaluates
   energy, forces and stress on the bench batch (32 perturbed 108-atom fcc
   Cu cells, ``pad_multiple=512``) in the factorized mode through B1-B3 and
   B8; the same weights on the CPU through the plain versions give the
   reference; B1-B3 must each have launched 2 x num_blocks times in that one
   evaluation, B8 num_blocks + 2 times, and B4-B7 never;
5. fused model: the same weights in ``threebody_mode="fused"`` evaluate the
   same batch through B4-B8 (full width, full depth); held against the CPU's
   fused mode and against the factorized mode on the card; B4 and B5 must
   each have launched num_blocks times, B6 and B7 twice, B8 num_blocks + 2
   times, B1-B3 never;
6. training: a teacher (the same architecture, seed 1) labels the bench
   batch with its E/F/S; a student (seed 0, default config) in the
   factorized mode (B1-B3 + B8) and in the fused mode (B4-B8): one step's
   loss and weight gradients against the same step on the CPU, the exact
   launch counts of one train step, and five steps whose loss falls and
   stays finite; the two modes' first losses agree;
7. times: each mode's eval step (CUDA events, median of 50) with a profiler
   breakdown, each mode's train step (median of 20) with its breakdown,
   then from the host batch (median of 10: each step copies the batch,
   checks its indices and builds its mode's kernel index), the device time
   of building each part of that index (the offsets of ``edge_src`` and
   ``triplet_e1``, the e2 order) and its sum per mode, and each kernel beside
   its plain version, its bound and, where one PyTorch call computes the
   same function, that call (median of 30), with its time split by CUDA
   kernel (``parts_us``). Kernel times come under three L2 states (see
   ``time_device``): ``ms`` after a clean flush (a 256 MB read that leaves
   no dirty line), ``cold_dirty_us`` after the older ``zero_()`` flush
   (dirty lines that the timed call writes back) and ``warm_us`` with the
   inputs just touched; the plain, library and ``parts_us`` times take the
   clean flush. B6 and B7 time their ``e1`` and their ``e2`` call apart
   (``per_call``), and B7's row gives each call's own bytes and bound
   (``design_bytes``, ``design_bound_us``): its sorted-owner sum reads the
   offsets (and, by e2, the order) instead of the ids. Each row's
   ``members``: the vmap rule's call at K = 3 as the committee makes it,
   beside 3 single calls timed apart, and the K = 3 bound with a shared
   operand read once (``time_members``).

8. simulate: the bench cells (32 x 108 atoms, so the C++ neighbour list
   and triplet enumerator run by default) packed natively and by numpy,
   every field equal and the distances within 1e-12, with both host build
   times; NVE MD of the default model for 20 steps with a rebuild every 10
   (launches of the whole run exactly those of its 22 evaluations:
   B1-B3 each 2 x num_blocks per evaluation, B8 num_blocks + 2, B4-B7
   never; the rebuild through the native path), its first 10 steps against
   the same run on the CPU, the total-energy drift per graph; NVT twice
   with one seed, bitwise equal, temperatures of the right order; MD, FIRE
   and L-BFGS steps with no host synchronisation (the sync debug mode at
   "error"); the rebuild (host, ``to_torch``) and the MD steps timed
   apart, with the busy share of a 10-step call; FIRE with cell relaxation
   on 8 cells for two rebuilds, each energy and largest generalized force
   (atoms and cell) lower; ``elastic_tensor`` and ``force_constants`` of a
   4-atom cell on the card (one gradient, then one batched backward over
   the Hessian's rows through B1-B3 and B8) against the CPU and against
   the row-by-row loop on the card, both timed; ``force_constants`` of
   that cell 5x5x5 (500 atoms, 1,500 rows) in chunks of rows sized to
   ``HESSIAN_CHUNK_BYTES``, timed, with its peak GB, the rows at the chunk
   bounds against the row loop. The numbers go into the
   ``{"simulate": ...}`` line.

9. train workflow: 112 perturbed, strained fcc-Cu cells (half 32, half
   108 atoms; isotropic volume strains up to 5 %) labelled by a seed-1
   teacher (energy scale 10) on the card, written as an
   mlearn set (96 training, 16 test) and as MPF block pickles (trajectories
   of 4 frames, CIF strings). The mlearn CLI (``configs/mlearn_Cu.yaml``,
   2 epochs), the MPF CLI streaming (``configs/mpf.yaml``, 16-graph shards,
   1 epoch), ``train_model`` on those shards with a 3-class ladder (every
   class trained, in its own padded shape) and in memory in the fused mode
   (1 epoch each), all on the card with the default model: each run's
   launches exactly its train and eval steps' (B1-B3 and B8, or B4-B8);
   the mlearn run's logs and checkpoints, a train loss that falls from
   epoch 0 to 1, finite test metrics, and ``last`` restored into a fresh
   potential evaluating a test batch bit for bit as the trainer does. Then
   one epoch with ``prefetch=2`` and one with ``prefetch=0`` under
   deterministic algorithms: bitwise equal weights, each step period, the
   busy share of a profiled epoch and the producer's host work per batch;
   and a 2-step ``train_model`` on 16 cells on the card against the CPU
   (losses within ``WORKFLOW_TOL``; the same run on the CPU with its
   updates skipped must fail it: the losses see the weights). At phase 9's
   padded shapes (the bucket of batch 8; the ladder's smallest class) every
   kernel is held against its plain version, and one ``Trainer`` step of
   the student against the CPU where it acts: its gradient within
   ``TRAIN_TOL``, its update within ``UPDATE_TOL``; a negated gradient, a
   skipped update and ``r1_gather`` off by ``CONTROL_SCALE`` must each
   fail. The numbers go into the ``{"workflow": ...}`` line; the mlearn
   run's ``best`` checkpoint (the default model) is kept for phase 10.

10. user CLIs and the committee, from that checkpoint and its sidecar, at
   full width (the default model): ``predict`` on the 32 bench cells in one
   batch, in the factorized and the fused mode (each run one evaluation's
   launches), against ``--device cpu`` (``MODEL_TOL``) and fused against
   factorized (``MODE_TOL``); the card's energies of two cells against the
   port's numpy oracle at f64 (``ORACLE_TOL``; the oracle with the
   readout's output kernel off by 1e-3 must fail); a committee of three
   (the checkpoint, seeds 1 and 2) on the bench batch, one
   ``torch.func.vmap`` over the members, in the factorized and the fused
   mode: launches exactly one evaluation's in either mode, mean and std
   within ``ENSEMBLE_TOL`` of three single
   evaluations, one member's std exactly 0, its ms against the three
   evaluations' and its peak GB; ``relax`` (FIRE with the cell,
   8 cells, 20 steps) and ``md`` (NVE, 8 cells, 5 steps) against
   ``--device cpu`` (``MD_TOL``); ``md`` NPT on the 32 cells for 20 steps
   with ``--traj-out``, each frame's cell from the volume log; ``elastic
   --eos`` on a 4-atom cell against ``--device cpu`` (``ELASTIC_TOL``).
   Each run's wall time goes into the ``{"cli": ...}`` line.

11. parallel: two ranks (four for dp x gp) on one card (``cuda:0``) over
   gloo (NCCL refuses two ranks on one GPU; gloo stages CUDA tensors
   through the host, so these times are correctness numbers, not scaling),
   spawned by
   ``parallel.launch`` (each rank imports this file; a rank that fails or
   outlasts ``PAR_TIMEOUT_S`` fails the phase). gp: a 10x10x10 fcc-Cu
   supercell (4,000 atoms, Gaussian jitter 0.05 A, phase 9's teacher's
   E/F/S as targets), reordered along an axis and cut into two slabs, the
   default model (seed 0) in the factorized and the fused mode: each rank's
   launches exactly one eval's of its mode, E/F/S (every shard's forces
   gathered) against the unpartitioned graph on one rank on the card
   (``MODEL_TOL``); one ``GraphParallelTrainer.train_step`` in each mode
   (the fused one through B4-B7's double backward): its loss and the
   gradient it hands the optimizer against one device's ``Trainer`` step
   on the whole cell in that mode (``MODEL_TOL``, ``TRAIN_TOL``), its
   update against Adam given that gradient (``UPDATE_TOL``), the weights
   after the step bitwise equal on both ranks (``check_gp_step``); the halo
   exchange of 64 feature columns timed. dp: phase 9's first 8 mlearn
   cells as 2 x 4 graphs, then a tail of 3 that leaves rank 1 fully
   padded: each step's combined gradient against the same weighted
   gradient formed row by row on one rank
   (``TRAIN_TOL``), its update against Adam given that gradient
   (``UPDATE_TOL``); an unweighted mean must fail the tail's check. Then
   ``train_mlearn --mesh 2 --device cuda:0`` on both ranks of the same job
   (the CLI joins their process group; torchrun starts it in
   ``tests/test_torch_parallel_dp.py``) for one epoch on phase 9's mlearn
   set: both ranks print the same test metrics, rank 0 alone logs one row,
   and its checkpoint loads and evaluates. Then one NCCL rank on
   ``cuda:0`` (``launch.run(..., 1, backend="nccl")``, the part of the
   NCCL path one card can run): the card bound before its process group
   started (``device_id``), ``broadcast_parameters`` over NCCL, and one
   ``DataParallel`` step bitwise equal to the ``Trainer`` step on the same
   batch (``nccl_one_rank``). Then dp x gp: four gloo ranks on ``cuda:0``,
   a 2 x 2 ("dp", "gp") mesh, the gp cell and its second jitter (seed
   ``GP_SEED + 1``, teacher-labelled) one a dp row, each in two slabs
   (``dp_gp_rank``, ``check_dp_gp``): each rank's launches one eval's, each
   row's E/F/S against its cell on one device; one
   ``GraphParallelTrainer(..., dp_axis="dp")`` step: its loss and gradient
   against the mean of the two cells' one-device ``Trainer`` steps, its
   update, the weights bitwise equal on all four ranks, the trainer's
   ``eval_loss`` (no grad) against the step's loss; the first row's
   gradient alone and the sum of the rows' in place of their mean must
   each fail. ``multicard_smoke.py`` runs the NCCL path on several cards.
   Prints the ``{"parallel": ...}`` line (gp eval ms per mode against one
   device's, the gp train step per mode, the exchange per call and its
   rows, the dp step against one rank's, the dp x gp eval and train step,
   and the dp streaming producer's host ms per
   batch on the mlearn training set: a rank's full stream as
   ``train_model`` reads it, one device's, and a rank's stride of shards).

12. bf16 and remat (``compute_dtype="bfloat16"``, ``remat_triplets=True``):
   phase 4's weights evaluate the bench batch under bf16 in the factorized,
   fused and gather modes, each against the CPU's bf16 (plain versions)
   within ``BF16_GAP_FRACTION`` of the card's own bf16-f32 gap per field,
   that gap non-zero and within ``BF16_CONTROL`` of the CPU's (the casts
   act on the card), the energies within the JAX package's bound of f32,
   the launches exactly the f32 eval's, the eval timed beside f32's; the
   seed-0 student under bf16 in the factorized and fused modes: one step's
   loss and whole weight gradient against the CPU's bf16 step (the same
   gap rule, phase 6's f32 step on either side), one step's launches, five
   steps that lower the loss, the step's ms and peak; ``remat_triplets`` in
   all three modes: one step's loss and every weight gradient against the
   step without it (``TRAIN_TOL``), the launches of one eval and one train
   step with the recompute (``expected_launches(..., remat=True)``), peak GB
   and step ms beside the step without remat; bf16 and remat together
   (factorized) against the bf16 step. Prints the ``{"precision_remat":
   ...}`` line.

The last line is ``{"ok": true, "device": {...}}``; the ``{"kernels": [...]}``
line and the card's ``nvidia-smi`` line come just before it.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Bench operating point (bench.py): 32 perturbed 3x3x3 fcc-Cu supercells.
N_GRAPHS, N_CELLS, PAD_MULTIPLE = 32, 3, 512
# Padded (N, E, T) and real (edges, triplets) of that batch.
BENCH_SHAPES = (3584, 147_456, 1_057_792)
BENCH_REAL = (147_014, 1_057_536)
N_PARAMS = 227_549

# Kernel vs plain version on the card, as a fraction of the reference's
# largest magnitude. Forward: f32 sums of up to ~500 terms (the last node
# holds the padded tail) in another order; the plain q_scatter sums with
# atomics. VJP: two such sums chained through sin'.
FWD_TOL = 1e-5
VJP_TOL = 1e-4
# Card vs CPU for the model's E, F, S and atomic energies: f32 through three
# blocks and one backward pass, every sum in another order (kernels, cuBLAS,
# atomics on the card; sequential on the CPU).
MODEL_TOL = 1e-4
# Card vs CPU for one training step: the loss within MODEL_TOL, and each
# weight gradient within TRAIN_TOL of that tensor's largest magnitude. The
# gradients go through the double backward of three blocks: f32 sums over
# 147k edges in other orders (cuBLAS, the atomics of the index_add sums by
# dst on the card; sequential on the CPU; B5 and B7 sum along the batch's
# owners with no atomics, so they do not vary between runs); the CPU
# rehearsal at 2,816 edges left 1.8e-6 between f32 and f64 in the worst
# tensor.
TRAIN_TOL = 2e-4
# Fused mode vs factorized mode on the card, as a fraction of the largest
# magnitude: one function through two f32 algorithms. The factorized stage
# sums over all pairs of a node's edges and subtracts the j = k diagonal
# (proj - g), so it cancels a few digits that the per-triplet sum never
# forms; JAX's own f32 check of the two (test_perf_options.py) allows 1e-5
# relative on energies and 5e-5 absolute on forces.
MODE_TOL = 1e-4
# Each graph's forces sum to zero exactly in exact arithmetic (every edge
# adds +g at its source and -g at its destination); f32 leaves rounding of
# ~84 edge terms per atom over 108 atoms.
FORCE_SUM_TOL = 1e-3

# Phase 8 (simulate). MD: MD_STEPS steps of 1 fs, a neighbour-list rebuild
# every MD_REBUILD; relaxation: FIRE on RELAX_GRAPHS of the bench cells.
MD_STEPS, MD_REBUILD, RELAX_GRAPHS = 20, 10, 8
# Native vs numpy neighbour distances: the same f64 differences, summed in
# another order (an f64 ulp at 5 A is 9e-16).
NATIVE_DIST_TOL = 1e-12
# Card vs CPU over the first MD_REBUILD NVE steps, as a fraction of the
# largest magnitude (E_pot, KE per graph; positions): each step's forces
# differ by the eval's f32 rounding (within MODEL_TOL) and positions by
# f32 rounding at ~11 A (6e-7 A); ten steps of dt = 1 fs move a Cu atom
# by ~1e-7 A per 1e-4 eV/A of force difference.
MD_TOL = 1e-4
# NVE total-energy drift per graph over MD_STEPS (eV). KE at 300 K is ~4.1 eV
# per 108-atom cell; the CPU rehearsal (2 cells, f32) drifted 2.9e-3 eV at
# most, the rebuild included, where edges that cross cutoff + skin shift the
# energy (the model's edge terms do not vanish beyond its cutoff).
DRIFT_TOL = 2e-2
# Card vs CPU for the strain Hessian and the force constants (f32 double
# backward; fraction of the largest magnitude): second derivatives lose
# digits to cancellation that the first derivatives keep.
ELASTIC_TOL = 1e-3

# Peak memory bandwidth (NVIDIA data sheets) and f32 rate outside the tensor
# cores (67 TFLOP/s, H100 SXM) for the bounds.
F32_FLOPS = 67e12


def bandwidth(name: str) -> float:
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM


def bench_structures(n_graphs: int = N_GRAPHS, n_cells: int = N_CELLS) -> list:
    """The bench structures of bench.py: perturbed fcc-Cu supercells."""
    from torch_m3gnet_tpu_torch.data import Structure

    rng = np.random.default_rng(0)
    base = Structure.from_frac_coords(
        np.eye(3) * 3.62,
        [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]],
        [29] * 4,
    ).supercell((n_cells, n_cells, n_cells))
    return [
        Structure(
            base.lattice,
            base.cart_coords + 0.05 * rng.standard_normal(base.cart_coords.shape),
            base.atomic_numbers,
        )
        for _ in range(n_graphs)
    ]


def build_batch(n_graphs: int = N_GRAPHS, n_cells: int = N_CELLS, pad_multiple: int = PAD_MULTIPLE):
    """The bench batch, built as bench.py builds it, with the port's data code."""
    from torch_m3gnet_tpu_torch.data import pack_structures

    return pack_structures(bench_structures(n_graphs, n_cells), 5.0, 4.0, pad_multiple=pad_multiple)


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float((got.double() - want.double()).abs().max())
    return err, err / max(float(want.double().abs().max()), 1e-30)


def check(label: str, got, want, tol: float) -> float:
    err, rel = rel_err(got, want)
    ok = rel <= tol
    print(f"  {label}: max_abs_err={err:.3e} rel={rel:.3e} tol={tol:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: relative error {rel:.3e} above {tol:.0e}")
    return err


def stage_inputs(num_nodes: int, num_edges: int, l_max: int, n_max: int, device):
    """Seeded (sh, gm, A) of the stage's shapes, standard normal f32."""
    import torch

    rng = np.random.default_rng(1)
    m, ln, mn = l_max * l_max, l_max * n_max, l_max * l_max * n_max
    return tuple(
        torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device)
        for shape in ((m, num_edges), (ln, num_edges), (mn, num_nodes))
    )


# Sorted indices that stress the sorted-owner sums (B1 by src, B4 by e1) and
# the gathers by src (B2, B3) beyond the bench batch: the CPU tests hold the
# plain versions to JAX on them and phase 3 holds the kernels to the plain
# versions. B1 blocks own 4 nodes and stage 512 edges per chunk; B4 blocks
# own 256 edges and stage 8,192 / (LN + 1) triplets per chunk.
SORTED_CASES = ("one-segment", "long-run", "chunk-crossing", "ragged-count", "empty-stretches")


def sorted_index_case(case: str) -> tuple[np.ndarray, int]:
    """(sorted int32 ids, number of segments S) of one case:

    - one-segment: all 3,001 entries on segment 13 of 21;
    - long-run: segment 150 of 300 owns a run of 20,480 (longer than any
      chunk), the others 0-9 each;
    - chunk-crossing: runs of 0-160 over 300 segments, so chunk boundaries
      fall inside runs and a block's span outgrows its chunk;
    - ragged-count: 517 segments (not a multiple of 4 or 256), runs 0-12;
    - empty-stretches: 1,203 segments, entries only on 0-2, 600-605 and a
      700-entry tail on the last one, so whole blocks own nothing.

    The entry count is a multiple of 4 in two cases and not in three, so
    that the kernels' 16-byte and scalar staging both run."""
    rng = np.random.default_rng(30 + SORTED_CASES.index(case))
    if case == "one-segment":
        return np.full(3001, 13, np.int32), 21
    if case == "long-run":
        runs = rng.integers(0, 10, 300)
        runs[150] = 20_480
        runs[-1] += (2 - runs.sum()) % 4  # entry count = 2 mod 4
    elif case == "chunk-crossing":
        runs = rng.integers(0, 161, 300)
        runs[-1] += -runs.sum() % 4  # a multiple of 4
    elif case == "ragged-count":
        runs = rng.integers(0, 13, 517)
        runs[-1] += (1 - runs.sum()) % 4
    else:
        runs = np.zeros(1203, np.int64)
        runs[[0, 1, 2, 600, 601, 602, 603, 604, 605]] = rng.integers(1, 41, 9)
        runs[-1] = 700 + (-runs.sum() - 700) % 4
    return np.repeat(np.arange(runs.size), runs).astype(np.int32), int(runs.size)


def dyadic(rng, shape) -> np.ndarray:
    """f32 values k / 4 with |k| <= 8: every product of two is a multiple of
    1/16 below 4 in magnitude, so each sum of the cases (at most ~2^15
    terms) is exact in f32 in any order, and a kernel that sums the right
    terms equals its plain version exactly."""
    return (rng.integers(-8, 9, shape) / 4).astype(np.float32)


def q_case_inputs(case: str, l_max: int, n_max: int):
    """(sh (M, E), gm (LN, E), sorted src (E,), N) for B1, numpy."""
    src, n = sorted_index_case(case)
    rng = np.random.default_rng(40 + SORTED_CASES.index(case))
    e = src.shape[0]
    return dyadic(rng, (l_max * l_max, e)), dyadic(rng, (l_max * n_max, e)), src, n


def r_case_inputs(case: str, op: str, l_max: int, n_max: int):
    """(A (MN, N), operand, sorted src (E,), N) for B2 (``op`` "r1_gather",
    operand sh (M, E)) or B3 ("r2_gather", operand gm (LN, E)), numpy."""
    sh, gm, src, n = q_case_inputs(case, l_max, n_max)
    rng = np.random.default_rng(70 + SORTED_CASES.index(case))
    a = dyadic(rng, (l_max * l_max * n_max, n))
    return a, sh if op == "r1_gather" else gm, src, n


def offset_view(x):
    """A contiguous copy of ``x`` whose data pointer lies 4 bytes past a
    16-byte boundary: a kernel that vectorizes its accesses must take its
    scalar path on it."""
    buf = x.new_empty(x.numel() + 1)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def triplet_case_inputs(case: str, ln: int):
    """(basis (LN, T), gate (LN, E), sorted e1 (T,), e2 (T,), E) for B4, numpy."""
    e1, e = sorted_index_case(case)
    rng = np.random.default_rng(50 + SORTED_CASES.index(case))
    t = e1.shape[0]
    e2 = rng.integers(0, e, t).astype(np.int32)
    return dyadic(rng, (ln, t)), dyadic(rng, (ln, e)), e1, e2, e


def scatter_case_inputs(case: str, f: int = 4):
    """(vals (F, T), sorted e1 (T,), uniform random e2 (T,), E) for B7, numpy:
    the ids of ``triplet_case_inputs``, dyadic values."""
    _, _, e1, e2, e = triplet_case_inputs(case, 1)
    rng = np.random.default_rng(80 + SORTED_CASES.index(case))
    return dyadic(rng, (f, e1.shape[0])), e1, e2, e


def check_sorted_index_cases() -> None:
    """B1, B2, B3, B4, B5 and B7 against their plain versions on every case
    of ``SORTED_CASES``, at (l_max, n_max) = (1, 1), (3, 3), (4, 4) (B1-B3;
    B2 and B3 also with the operand as an offset view, whose pointer is not
    16-byte aligned), LN = 1, 9, 16 (B4, B5) and F = 4 (B7, by the sorted ids
    with their offsets and with their order, and by uniform random ids with
    their order, the values as given and as an offset view): equal to them
    (dyadic data: every sum is exact in any order), and two kernel calls
    bitwise equal."""
    import torch

    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs
    from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
    from torch_m3gnet_tpu_torch.ops import sorted_segment as ss
    from torch_m3gnet_tpu_torch.ops import windowed_take as wt

    def run(label, kernel, plain):
        with torch.no_grad():
            # each a tuple of outputs: backward_pair has two
            calls = [o if isinstance(o, tuple) else (o,) for o in (kernel(), kernel(), plain())]
        for part, (x, y, w) in enumerate(zip(*calls)):
            name = label if part == 0 else f"{label} (output {part + 1})"
            check(name, x, w, FWD_TOL)
            if not torch.equal(x, w):
                raise AssertionError(f"{name}: differs from the plain version on dyadic data")
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: two calls differ")

    for case in SORTED_CASES:
        for l_max, n_max in ((1, 1), (3, 3), (4, 4)):
            sh, gm, src, n = q_case_inputs(case, l_max, n_max)
            tsh, tgm, ts = (torch.as_tensor(x, device="cuda") for x in (sh, gm, src))
            off = ss.sorted_segment_offsets(ts, n)
            tag = f"{case} (l_max, n_max) = ({l_max}, {n_max}), E = {src.shape[0]}, N = {n}"
            run(f"q_scatter {tag}", lambda: fs.q_scatter(tsh, tgm, ts, off, n, l_max, n_max),
                lambda: fs.q_scatter_plain(tsh, tgm, ts, n, l_max, n_max))
            for op in ("r1_gather", "r2_gather"):
                a, x, _, _ = r_case_inputs(case, op, l_max, n_max)
                ta, tx = (torch.as_tensor(v, device="cuda") for v in (a, x))
                plain = getattr(fs, f"{op}_plain")
                # the operand as given and as an unaligned offset view
                for label, operand in (("", tx), (", offset operand", offset_view(tx))):
                    run(f"{op} {tag}{label}",
                        lambda: getattr(fs, op)(ta, operand, ts, off, l_max, n_max),
                        lambda: plain(ta, operand, ts, l_max, n_max))
        for ln in (1, 9, 16):
            basis, gate, e1, e2, e = triplet_case_inputs(case, ln)
            g = dyadic(np.random.default_rng(60 + ln), gate.shape)
            tb, tgt, tg, te1, te2 = (torch.as_tensor(x, device="cuda")
                                     for x in (basis, gate, g, e1, e2))
            off1, order = ss.sorted_segment_offsets(te1, e), ft.triplet_e2_order(te2, e)
            tag = f"{case} LN = {ln}, T = {e1.shape[0]}, E = {e}"
            run(f"fused_triplet_gate_sum {tag}",
                lambda: ft.fused_triplet_gate_sum(tb, tgt, te1, te2, e, off1, order),
                lambda: ft.fused_triplet_gate_sum_plain(tb, tgt, te1, te2, e))
            run(f"backward_pair {tag}",
                lambda: ft.backward_pair(tb, tgt, tg, te1, te2, e, off1, order),
                lambda: ft.backward_pair_plain(tb, tgt, tg, te1, te2, e))
        vals, e1, e2, e = scatter_case_inputs(case)
        tv, te1, te2 = (torch.as_tensor(x, device="cuda") for x in (vals, e1, e2))
        for index, tidx, owners in (("e1", te1, (None, ss.sorted_segment_offsets(te1, e))),
                                    ("e1 (its order)", te1, ft.triplet_e2_order(te1, e)),
                                    ("e2", te2, ft.triplet_e2_order(te2, e))):
            # the values as given and as an unaligned offset view
            for label, operand in (("", tv), (", offset vals", offset_view(tv))):
                run(f"windowed_scatter_fm {case} by {index}, T = {e1.shape[0]}, E = {e}{label}",
                    lambda: wt.windowed_scatter_fm(operand, tidx, e, owners),
                    lambda: wt.scatter_fm_plain(operand, tidx, e))
    print("  every case: equal to the plain version, two calls bitwise equal")


def check_kernels(src, offsets, num_nodes: int, l_max: int, n_max: int,
                  edge_mask=None) -> dict[str, float]:
    """Each of B1-B3 against its plain version, forward and composed VJP,
    by the sorted ``src`` and its run ``offsets`` (the batch's).
    With ``edge_mask``, gm and the VJP's cotangent are zero on padded
    edges, as the model's are (its cutoff factor carries the mask): a batch
    padded far beyond its real edges then puts no sum of thousands of
    random terms on the padding node, which the VJP's sin would turn into
    phase errors."""
    import torch

    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs

    e = src.shape[0]
    sh, gm, a = stage_inputs(num_nodes, e, l_max, n_max, src.device)
    emask = 1.0 if edge_mask is None else edge_mask.to(gm.dtype)
    gm = gm * emask
    errs = {}
    with torch.no_grad():
        errs["q_scatter"] = check(
            "q_scatter", fs.q_scatter(sh, gm, src, offsets, num_nodes, l_max, n_max),
            fs.q_scatter_plain(sh, gm, src, num_nodes, l_max, n_max), FWD_TOL)
        errs["r1_gather"] = check(
            "r1_gather", fs.r1_gather(a, sh, src, offsets, l_max, n_max),
            fs.r1_gather_plain(a, sh, src, l_max, n_max), FWD_TOL)
        errs["r2_gather"] = check(
            "r2_gather", fs.r2_gather(a, gm, src, offsets, l_max, n_max),
            fs.r2_gather_plain(a, gm, src, l_max, n_max), FWD_TOL)

    def stage_grads(q, r1):
        s, g = sh.clone().requires_grad_(True), gm.clone().requires_grad_(True)
        proj = r1(q(s, g, src, num_nodes, l_max, n_max), s, src, l_max, n_max)
        return torch.autograd.grad((torch.sin(proj - g) * emask).sum(), (s, g))

    got = stage_grads(*stage_kernels(offsets))
    want = stage_grads(fs.q_scatter_plain, fs.r1_gather_plain)
    check("stage VJP d_sh (r2 + r2 kernels)", got[0], want[0], VJP_TOL)
    check("stage VJP d_gm (r1 + q kernels)", got[1], want[1], VJP_TOL)
    return errs


def stage_kernels(offsets):
    """B1 and B2 with the run offsets of their ``src`` bound, called as their
    plain versions are."""
    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs

    return (lambda sh, gm, src, n, l_max, n_max: fs.q_scatter(sh, gm, src, offsets, n, l_max,
                                                              n_max),
            lambda a, sh, src, l_max, n_max: fs.r1_gather(a, sh, src, offsets, l_max, n_max))


# The hand kernels' ops, each counted as ``launch.<op>`` by ``ops._cuda.launch``.
KERNEL_OPS = ("q_scatter", "r1_gather", "r2_gather", "fused_triplet_gate_sum", "backward_pair",
              "windowed_take_fm", "windowed_scatter_fm", "sorted_segment_sum")


def reset_launches() -> None:
    from torch_m3gnet_tpu_torch.utils import profiling

    profiling.reset_counts("launch.")


def all_launches() -> dict[str, int]:
    from torch_m3gnet_tpu_torch.utils import profiling

    counts = profiling.counts()
    return {name: counts.get(f"launch.{name}", 0) for name in KERNEL_OPS}


def expected_launches(mode: str, nb: int, train: bool, remat: bool = False) -> dict[str, int]:
    """Kernel launches of one eval (or one train step) of ``nb`` blocks.

    An eval runs each three-body kernel forward and in the backward pass of
    the forces; a train step adds the backward of that backward. B8: one
    node aggregation per block, forces and strain stress (nb + 2); a train
    step adds one per block, where the double backward differentiates the
    node aggregation's VJP (the gather), whose VJP is B8: 2 nb + 2. The
    gather mode's triplet->edge sum adds one per block to an eval and two
    to a train step. ``remat``: every backward pass that reaches a block's
    stage (one in an eval, two in a train step) recomputes its forward: B1
    and B2, B4, or the gather mode's B8 sum once more per block and pass.
    ``compute_dtype`` changes no count."""
    counts = {name: 0 for name in all_launches()}
    redo = (2 if train else 1) * nb if remat else 0
    if mode == "factorized":
        for name in ("q_scatter", "r1_gather", "r2_gather"):
            counts[name] = (6 if train else 2) * nb + (redo if name != "r2_gather" else 0)
    elif mode == "fused":
        counts.update(fused_triplet_gate_sum=(3 if train else 1) * nb + redo,
                      backward_pair=(3 if train else 1) * nb,
                      windowed_take_fm=4 if train else 2, windowed_scatter_fm=2)
    counts["sorted_segment_sum"] = (2 * nb + 2 if train else nb + 2) + (
        nb * (2 if train else 1) + redo if mode == "gather" else 0)
    return counts


def check_triplet_kernels(gbatch, ln: int, f: int = 4, masked: bool = False) -> dict[str, float]:
    """B4-B7 against their plain versions on the batch's real triplet_e1
    (sorted) and triplet_e2 (unsorted), forward and VJP, with the batch's
    owners of each (B7 also by each index's stable order, which by e1 is
    the identity: the ordered path at the bench shape). ``masked``:
    B7's values and the take VJP's cotangent are zero on padded triplets,
    as the model's are (its basis carries the mask)."""
    import torch

    from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
    from torch_m3gnet_tpu_torch.ops import windowed_take as wt

    basis, gate, g, data, vals = triplet_inputs(gbatch, ln, f)
    tmask = gbatch.triplet_mask.to(vals.dtype) if masked else 1.0
    vals = vals * tmask
    e1, e2, e = gbatch.triplet_e1, gbatch.triplet_e2, gbatch.num_edges
    off1, order = gbatch.triplet_e1_offsets, (gbatch.triplet_e2_order, gbatch.triplet_e2_offsets)
    owners = {"e1": (None, off1), "e2": order}
    errs = {}
    with torch.no_grad():
        errs["fused_triplet_gate_sum"] = check(
            "fused_triplet_gate_sum",
            ft.fused_triplet_gate_sum(basis, gate, e1, e2, e, off1, order),
            ft.fused_triplet_gate_sum_plain(basis, gate, e1, e2, e), FWD_TOL)
        got = ft.backward_pair(basis, gate, g, e1, e2, e, off1, order)
        again = ft.backward_pair(basis, gate, g, e1, e2, e, off1, order)
        want = ft.backward_pair_plain(basis, gate, g, e1, e2, e)
        errs["backward_pair"] = max(check("backward_pair d_basis", got[0], want[0], FWD_TOL),
                                    check("backward_pair d_gate", got[1], want[1], FWD_TOL))
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise AssertionError("backward_pair: two calls differ")
        print("  backward_pair: two calls bitwise equal")
        take_errs, scatter_errs = [], []
        for label, idx in (("e1", e1), ("e2", e2)):
            take_errs.append(check(f"windowed_take_fm ({label})",
                                   wt.windowed_take_fm(data, idx, owners[label]),
                                   wt.take_fm_plain(data, idx), FWD_TOL))
            got = wt.windowed_scatter_fm(vals, idx, e, owners[label])
            scatter_errs.append(check(f"windowed_scatter_fm ({label})", got,
                                      wt.scatter_fm_plain(vals, idx, e), FWD_TOL))
            again = wt.windowed_scatter_fm(vals, idx, e, owners[label])
            # by the stable order (by e1 the identity: the ordered path, in
            # other blocks than by offsets)
            by_order = wt.windowed_scatter_fm(vals, idx, e, ft.triplet_e2_order(idx, e))
            check(f"windowed_scatter_fm ({label}, by its stable order)", by_order,
                  wt.scatter_fm_plain(vals, idx, e), FWD_TOL)
            if not torch.equal(got, again):
                raise AssertionError(f"windowed_scatter_fm ({label}): calls differ")
        print("  windowed_scatter_fm: two calls bitwise equal")
        errs["windowed_take_fm"], errs["windowed_scatter_fm"] = max(take_errs), max(scatter_errs)

    def fused_grads(fused):
        b, gt = basis.clone().requires_grad_(True), gate.clone().requires_grad_(True)
        return torch.autograd.grad(torch.sin(fused(b, gt)).sum(), (b, gt))

    got = fused_grads(lambda b, gt: ft.fused_triplet_gate_sum(b, gt, e1, e2, e, off1, order))
    want = fused_grads(lambda b, gt: ft.fused_triplet_gate_sum_plain(b, gt, e1, e2, e))
    check("fused VJP d_basis (backward_pair kernel)", got[0], want[0], VJP_TOL)
    check("fused VJP d_gate (backward_pair kernel)", got[1], want[1], VJP_TOL)

    def take_grad(take):
        d = data.clone().requires_grad_(True)
        y = torch.sin(take(d, e1, owners["e1"])) * take(d, e2, owners["e2"]) * tmask
        return torch.autograd.grad(y.sum(), d)[0]

    check("take VJP (windowed_scatter_fm kernel, e1 and e2)", take_grad(wt.windowed_take_fm),
          take_grad(lambda d, idx, _owners: wt.take_fm_plain(d, idx)), VJP_TOL)
    return errs


def triplet_inputs(gbatch, ln: int, f: int = 4):
    """Seeded (basis (LN,T) zero on padded triplets, gate (LN,E), g (LN,E),
    data (F,E), vals (F,T)), f32 on the batch's device."""
    import torch

    rng = np.random.default_rng(2)
    e, t = gbatch.num_edges, gbatch.num_triplets
    mask = gbatch.triplet_mask.cpu().numpy()
    arrays = (rng.standard_normal((ln, t)) * mask, rng.uniform(0, 1, (ln, e)),
              rng.standard_normal((ln, e)), rng.standard_normal((f, e)),
              rng.standard_normal((f, t)))
    return tuple(torch.as_tensor(a.astype(np.float32), device=gbatch.edge_src.device)
                 for a in arrays)


def check_outputs(label, out, ref, gbatch, tol) -> None:
    """E, F, S and atomic energies finite and within ``tol`` of ``ref``;
    each graph's forces sum to ~0."""
    import torch

    from torch_m3gnet_tpu_torch.ops.segment import segment_sum

    for name in ("energy", "forces", "stress", "atomic_energy"):
        got = getattr(out, name).detach()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} is not finite")
        want = getattr(ref, name).detach()
        check(f"{name} {label}", got.to(want.device), want, tol)
    if tuple(out.forces.shape) != (gbatch.num_nodes, 3) or tuple(out.stress.shape) != (gbatch.num_graphs, 6):
        raise AssertionError("unexpected output shapes")
    f = out.forces.detach()
    per_graph = segment_sum(f, gbatch.node_graph, gbatch.num_graphs).abs().max()
    rel = float(per_graph / f.abs().max())
    print(f"  per-graph force sum: max={float(per_graph):.3e} rel={rel:.3e} tol={FORCE_SUM_TOL:.0e}")
    if rel > FORCE_SUM_TOL:
        raise AssertionError("per-graph forces do not sum to zero")


def counted_eval(pot, gbatch, expected: dict[str, int]):
    """One evaluation with every launch count set to 0 just before it;
    the counts just after must be ``expected``."""
    import torch

    reset_launches()
    out = pot(gbatch)
    torch.cuda.synchronize()
    launches = all_launches()
    print(f"  launches in one eval: {launches}")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    return out, launches


def cpu_reference(cfg, pot, batch):
    """The same weights on the CPU, through the plain versions."""
    from torch_m3gnet_tpu_torch.models import build_model

    cpu_pot = build_model(cfg, device="cpu")
    cpu_pot.load_state_dict(pot.state_dict())
    t0 = time.perf_counter()
    ref = cpu_pot(batch)
    print(f"  CPU reference eval: {time.perf_counter() - t0:.1f} s")
    return ref


def check_model(pot, batch, gbatch, cfg):
    """One counted factorized evaluation on the card, compared with the CPU;
    returns (card output, launches, the CPU's E/F/S)."""
    expected = expected_launches("factorized", cfg.num_blocks, False)
    out, launches = counted_eval(pot, gbatch, expected)
    ref = cpu_reference(cfg, pot, batch)
    check_outputs("card vs CPU", out, ref, gbatch, MODEL_TOL)
    e = out.energy.detach().cpu().numpy()
    print(f"  energy[:4] (eV) = {e[:4].tolist()}")
    return out, launches, detached(ref)


def check_fused_model(pot, out_factorized, batch, gbatch, cfg):
    """The same weights in the fused mode: one counted evaluation on the
    card, compared with the CPU's fused mode and the card's factorized mode."""
    from torch_m3gnet_tpu_torch.models import build_model

    cfg_f = cfg.replace(threebody_mode="fused")
    pot_f = build_model(cfg_f, device="cuda")
    pot_f.load_state_dict(pot.state_dict())
    expected = expected_launches("fused", cfg.num_blocks, False)
    out, launches = counted_eval(pot_f, gbatch, expected)
    ref = cpu_reference(cfg_f, pot_f, batch)
    check_outputs("fused card vs CPU", out, ref, gbatch, MODEL_TOL)
    for name in ("energy", "forces", "stress", "atomic_energy"):
        check(f"{name} fused vs factorized (card)", getattr(out, name).detach(),
              getattr(out_factorized, name).detach(), MODE_TOL)
    return pot_f, out, launches, detached(ref)


def sorted_sum_cases(gbatch) -> list[tuple[str, int, object, int, object]]:
    """(label, F, sorted ids, segments, the offsets of the ids) of the four
    sorted sums that B8 takes on the path, at the batch's shapes, as the
    model calls them: the node aggregation (per block) and the forces by
    ``edge_src``, the gather-mode triplet->edge sum by ``triplet_e1`` (these
    three with the batch's offsets), the strain stress by ``edge_graph``
    (with the offsets that ``Potential.assemble`` builds)."""
    from torch_m3gnet_tpu_torch.ops.sorted_segment import sorted_segment_offsets

    src = gbatch.edge_src
    edge_graph = gbatch.node_graph.index_select(0, src)
    return [
        ("node aggregation by src", 64, src, gbatch.num_nodes, gbatch.edge_src_offsets),
        ("gather-mode e1 sum", 9, gbatch.triplet_e1, gbatch.num_edges,
         gbatch.triplet_e1_offsets),
        ("forces by src", 3, src, gbatch.num_nodes, gbatch.edge_src_offsets),
        ("strain stress by edge_graph", 9, edge_graph, gbatch.num_graphs,
         sorted_segment_offsets(edge_graph, gbatch.num_graphs)),
    ]


def seeded(shape, device, seed: int):
    import torch

    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device)


def check_sorted_segment(gbatch, masked: bool = False) -> float:
    """B8 against its plain version (``index_add``) at the four shapes, as
    the model calls it: forward, VJP (the gather), gradient of the gradient
    (whose backward runs B8 again), two kernel calls bitwise equal.
    ``masked``: the summed values and
    the second cotangent are zero on padded edges (triplets), as the
    model's are."""
    import torch

    from torch_m3gnet_tpu_torch.ops import sorted_segment as ss

    errs = []
    for i, (label, f, seg, nseg, off) in enumerate(sorted_sum_cases(gbatch)):
        x = seeded((f, seg.shape[0]), seg.device, 10 + i)
        mask = 1.0
        if masked:
            mask = (gbatch.triplet_mask if seg is gbatch.triplet_e1 else gbatch.edge_mask)
            mask = mask.to(x.dtype)
        x = x * mask
        w = seeded((f, nseg), seg.device, 20 + i)
        with torch.no_grad():
            got = ss.sorted_segment_sum_fm(x, seg, nseg, off)
            again = ss.sorted_segment_sum_fm(x, seg, nseg, off)
            errs.append(check(f"sorted_segment_sum {label} (F={f}, M={seg.shape[0]}, S={nseg})",
                              got, ss.sorted_segment_sum_fm_plain(x, seg, nseg), FWD_TOL))
        if not torch.equal(got, again):
            raise AssertionError(f"sorted_segment_sum {label}: two calls differ")
        print(f"  sorted_segment_sum {label}: two calls bitwise equal")

        def vjp(op):
            xx = x.clone().requires_grad_(True)
            return torch.autograd.grad((op(xx) * w).sum(), xx)[0]

        def grad_of_grad(op):
            # A quadratic loss: a periodic one would turn the rounding of
            # sums of ~4,600 terms (the stress row) into large phase errors.
            xx = x.clone().requires_grad_(True)
            y = op(xx)
            (g,) = torch.autograd.grad((y * y).sum(), xx, create_graph=True)
            return torch.autograd.grad((g * g * mask).sum(), xx)[0]

        def kernel(d):
            return ss.sorted_segment_sum_fm(d, seg, nseg, off)

        def plain(d):
            return ss.sorted_segment_sum_fm_plain(d, seg, nseg)

        check(f"  VJP (gather) {label}", vjp(kernel), vjp(plain), VJP_TOL)
        check(f"  grad of grad (B8 in the double backward) {label}",
              grad_of_grad(kernel), grad_of_grad(plain), VJP_TOL)
    return max(errs)


# Members of phase 3's vmap rules (and of phase 10's committee).
MEMBERS = 3


def member_patterns(n: int) -> list[tuple]:
    """Every in_dims of ``n`` float operands with at least one batched: each
    shared (None, stride 0 on a member axis) or batched in front (0)."""
    return [p for p in itertools.product((None, 0), repeat=n) if 0 in p]


def member_operands(shapes, device, seed: int, batched):
    """Seeded standard normal f32 operands: (MEMBERS, *shape) where
    ``batched``, else (*shape)."""
    import torch

    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(((MEMBERS,) if b else ()) + s)
                            .astype(np.float32), device=device)
            for s, b in zip(shapes, batched)]


def vmapped_vs_members(label, fn, operands, in_dims, launches: dict) -> None:
    """``fn`` under ``torch.func.vmap`` (``in_dims``: 0 for an operand with
    the member axis, None for one every member shares) against MEMBERS
    single calls, one per member: bitwise equal (each member is summed in
    the order of its own call), and the vmapped call's launches exactly
    ``launches`` (its kernel's; every count 0 just before it)."""
    import torch

    with torch.no_grad():
        reset_launches()
        got = torch.func.vmap(fn, in_dims=tuple(in_dims))(*operands)
        torch.cuda.synchronize()
        counts = {k: v for k, v in all_launches().items() if v}
        singles = [fn(*(x if d is None else x[k] for x, d in zip(operands, in_dims)))
                   for k in range(MEMBERS)]
    if counts != launches:
        raise AssertionError(f"{label}: the vmapped call launched {counts}, expected {launches}")
    got = got if isinstance(got, tuple) else (got,)
    for part, g in enumerate(got):
        want = torch.stack([s[part] if isinstance(s, tuple) else s for s in singles])
        if not torch.equal(g, want):
            raise AssertionError(f"{label} (output {part + 1}): the vmapped call differs from "
                                 f"{MEMBERS} single calls by {float((g - want).abs().max()):.3e}")


def member_specs(gbatch, cfg) -> dict:
    """The kernels' vmap rules at the bench shapes, as the committee and a
    batched Hessian call them: name -> (function of the float operands,
    operand shapes, the committee's in_dims, launches of one vmapped call,
    bytes of the K-member call with a shared operand read once, flops).
    B1: the geometry sh shared, gm batched (the forward); B2: A batched, sh
    shared; B3: both batched (the force VJP); B4: basis shared, gate batched;
    B5: basis shared, gate and g batched; B6, B7: rows batched, by e1 and
    by e2; B8: the node aggregation."""
    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs
    from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
    from torch_m3gnet_tpu_torch.ops import sorted_segment as ss
    from torch_m3gnet_tpu_torch.ops import windowed_take as wt

    k = MEMBERS
    src, num_nodes, l_max, n_max = gbatch.edge_src, gbatch.num_nodes, cfg.l_max, cfg.n_max
    e, t = gbatch.num_edges, gbatch.num_triplets
    m, ln, mn = l_max * l_max, l_max * n_max, l_max * l_max * n_max
    e1, e2 = gbatch.triplet_e1, gbatch.triplet_e2
    order = (gbatch.triplet_e2_order, gbatch.triplet_e2_offsets)
    off1, e1_owners = gbatch.triplet_e1_offsets, (None, gbatch.triplet_e1_offsets)
    node_off = gbatch.edge_src_offsets
    a_b, src_b, idx_b = 4 * mn * num_nodes, 4 * e, 4 * t
    one = lambda name: {name: 1}  # noqa: E731
    return {
        # B1 reads src's offsets, not src; B4 e1's offsets, not e1
        "q_scatter": (lambda sh, gm: fs.q_scatter(sh, gm, src, node_off, num_nodes, l_max, n_max),
                      [(m, e), (ln, e)], (None, 0), one("q_scatter"),
                      4 * m * e + k * 4 * ln * e + 4 * (num_nodes + 1) + k * a_b,
                      k * 2 * mn * e),
        "r1_gather": (lambda a, sh: fs.r1_gather(a, sh, src, node_off, l_max, n_max),
                      [(mn, num_nodes), (m, e)], (0, None), one("r1_gather"),
                      k * a_b + 4 * m * e + k * 4 * ln * e + src_b, k * 2 * mn * e),
        "r2_gather": (lambda a, gm: fs.r2_gather(a, gm, src, node_off, l_max, n_max),
                      [(mn, num_nodes), (ln, e)], (0, 0), one("r2_gather"),
                      k * (a_b + 4 * (ln + m) * e) + src_b, k * 2 * mn * e),
        "fused_triplet_gate_sum": (
            lambda b, g: ft.fused_triplet_gate_sum(b, g, e1, e2, e, off1, order),
            [(ln, t), (ln, e)], (None, 0), one("fused_triplet_gate_sum"),
            4 * ln * t + idx_b + 4 * (e + 1) + k * 4 * 2 * ln * e, k * 2 * ln * t),
        "backward_pair": (
            lambda b, g, c: ft.backward_pair(b, g, c, e1, e2, e, off1, order),
            [(ln, t), (ln, e), (ln, e)], (None, 0, 0), one("backward_pair"),
            4 * ln * t + 2 * idx_b + k * 4 * (ln * t + 3 * ln * e), k * 3 * ln * t),
        "windowed_take_fm": (
            lambda d: (wt.windowed_take_fm(d, e1, e1_owners), wt.windowed_take_fm(d, e2, order)),
            [(4, e)], (0,), {"windowed_take_fm": 2},
            2 * (k * 4 * 4 * e + idx_b + k * 4 * 4 * t), 0),
        "windowed_scatter_fm": (
            lambda v: (wt.windowed_scatter_fm(v, e1, e, e1_owners),
                       wt.windowed_scatter_fm(v, e2, e, order)),
            [(4, t)], (0,), {"windowed_scatter_fm": 2},
            2 * (k * 4 * 4 * t + idx_b + k * 4 * 4 * e), 2 * k * 4 * t),
        "sorted_segment_sum": (
            lambda d: ss.sorted_segment_sum_fm(d, src, num_nodes, node_off),
            [(64, e)], (0,), one("sorted_segment_sum"),
            k * 4 * 64 * e + 4 * (num_nodes + 1) + k * 4 * 64 * num_nodes, k * 64 * e),
    }


def check_member_rules(gbatch, cfg) -> None:
    """Each kernel Function's vmap rule on the card at K = MEMBERS, bitwise
    against MEMBERS single calls (``vmapped_vs_members``), with the launches
    of one vmapped call exactly one (B6/B7: one for each of the e1 and the
    e2 call): at the bench shapes (each kernel at every ``member_patterns``
    of its float operands: B1-B4 3, B5 7; B8 also at its four sorted sums)
    and on every case of ``SORTED_CASES`` (B1-B3 at (l_max, n_max) = (1,
    1), (3, 3), (4, 4) and B4/B5 at LN = 1, 9, 16, each at every pattern;
    B7 by the three indices of ``check_sorted_index_cases``, B8 by the
    sorted ids, F = 4)."""
    import torch

    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs
    from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
    from torch_m3gnet_tpu_torch.ops import sorted_segment as ss
    from torch_m3gnet_tpu_torch.ops import windowed_take as wt

    dev = gbatch.edge_src.device
    t0 = time.perf_counter()
    calls = 0
    for i, (name, (fn, shapes, _, launches, _, _)) in enumerate(
            member_specs(gbatch, cfg).items()):
        for pattern in member_patterns(len(shapes)):
            ops = member_operands(shapes, dev, 90 + i, [d is not None for d in pattern])
            vmapped_vs_members(f"{name} in_dims {pattern}", fn, ops, pattern, launches)
            calls += 1
    for i, (label, f, seg, nseg, off) in enumerate(sorted_sum_cases(gbatch)):
        (x,) = member_operands([(f, seg.shape[0])], dev, 100 + i, [True])
        vmapped_vs_members(f"sorted_segment_sum {label}",
                           lambda d: ss.sorted_segment_sum_fm(d, seg, nseg, off), [x], (0,),
                           {"sorted_segment_sum": 1})
        calls += 1
    print(f"  bench shapes: {calls} vmapped calls at K = {MEMBERS}, each bitwise equal to "
          f"{MEMBERS} single calls, with one launch")

    calls = 0
    rng = np.random.default_rng(110)

    def members_of(*shapes):
        """Dyadic member draws of each shape: (MEMBERS, *shape) each."""
        return [torch.as_tensor(dyadic(rng, (MEMBERS,) + s), device=dev) for s in shapes]

    for case in SORTED_CASES:
        for l_max, n_max in ((1, 1), (3, 3), (4, 4)):
            sh, gm, src, n = q_case_inputs(case, l_max, n_max)
            tsrc = torch.as_tensor(src, device=dev)
            off = ss.sorted_segment_offsets(tsrc, n)
            a = dyadic(rng, (l_max * l_max * n_max, n))
            for op, first, second, fn in (
                    ("q_scatter", sh, gm,
                     lambda x, y: fs.q_scatter(x, y, tsrc, off, n, l_max, n_max)),
                    ("r1_gather", a, sh,
                     lambda x, y: fs.r1_gather(x, y, tsrc, off, l_max, n_max)),
                    ("r2_gather", a, gm,
                     lambda x, y: fs.r2_gather(x, y, tsrc, off, l_max, n_max))):
                batched = members_of(first.shape, second.shape)
                shared = [torch.as_tensor(x, device=dev) for x in (first, second)]
                for pattern in member_patterns(2):
                    ops = [s if d is None else b for b, s, d in zip(batched, shared, pattern)]
                    vmapped_vs_members(f"{op} {case} ({l_max}, {n_max}) in_dims {pattern}", fn,
                                       ops, pattern, {op: 1})
                    calls += 1
        for ln in (1, 9, 16):
            basis, gate, e1, e2, e = triplet_case_inputs(case, ln)
            te1, te2 = (torch.as_tensor(x, device=dev) for x in (e1, e2))
            off1, order = ss.sorted_segment_offsets(te1, e), ft.triplet_e2_order(te2, e)
            g = dyadic(rng, gate.shape)
            batched = members_of(basis.shape, gate.shape, gate.shape)
            shared = [torch.as_tensor(x, device=dev) for x in (basis, gate, g)]
            for op, fn in (
                    ("fused_triplet_gate_sum",
                     lambda b, q: ft.fused_triplet_gate_sum(b, q, te1, te2, e, off1, order)),
                    ("backward_pair",
                     lambda b, q, c: ft.backward_pair(b, q, c, te1, te2, e, off1, order))):
                n = 2 if op == "fused_triplet_gate_sum" else 3
                for pattern in member_patterns(n):
                    ops = [s if d is None else b for b, s, d in zip(batched, shared, pattern)]
                    vmapped_vs_members(f"{op} {case} LN = {ln} in_dims {pattern}", fn, ops,
                                       pattern, {op: 1})
                    calls += 1
        vals, e1, e2, e = scatter_case_inputs(case)
        te1, te2 = (torch.as_tensor(x, device=dev) for x in (e1, e2))
        (tv,) = members_of(vals.shape)
        for index, tidx, owners in (("e1", te1, (None, ss.sorted_segment_offsets(te1, e))),
                                    ("e1 (its order)", te1, ft.triplet_e2_order(te1, e)),
                                    ("e2", te2, ft.triplet_e2_order(te2, e))):
            vmapped_vs_members(f"windowed_scatter_fm {case} by {index}",
                               lambda v: wt.windowed_scatter_fm(v, tidx, e, owners), [tv], (0,),
                               {"windowed_scatter_fm": 1})
            vmapped_vs_members(f"windowed_take_fm {case} by {index}",
                               lambda d: wt.windowed_take_fm(d, tidx, owners),
                               members_of((4, e)), (0,),
                               {"windowed_take_fm": 1})
            calls += 2
        seg, nseg = sorted_index_case(case)
        tseg = torch.as_tensor(seg, device=dev)
        seg_off = ss.sorted_segment_offsets(tseg, nseg)
        vmapped_vs_members(f"sorted_segment_sum {case}",
                           lambda d: ss.sorted_segment_sum_fm(d, tseg, nseg, seg_off),
                           members_of((4, seg.shape[0])), (0,),
                           {"sorted_segment_sum": 1})
        calls += 1
    print(f"  SORTED_CASES: {calls} vmapped calls at K = {MEMBERS}, each bitwise equal to "
          f"{MEMBERS} single calls ({time.perf_counter() - t0:.1f} s in all)")


# Past the gridDim.y limit of 65,535: B1-B5 with more members than that
# (their grid's y is the member), B7 with more than 4 x 65,535 rows and B8
# with more than 65,535 row blocks (its tiled sum, and its block sum for
# long runs) launch in slices. GRID_MEMBERS members put each past it.
GRID_Y, GRID_MEMBERS = 65_535, 65_540


def check_grid_slices() -> None:
    """Each kernel whose grid's y axis counts members or rows, at a member
    count past ``GRID_Y``: the vmapped call against its plain version (the
    formula, vectorised over the members; f32 sums of a few terms, 1e-5 of
    the output's largest magnitude), and the members on both sides of each
    slice bound bitwise equal to calls of those members alone. B1-B3 at
    (l_max, n_max) = (1, 1) on 64 edges of 8 nodes (GRID_MEMBERS members);
    B4 and B5 at LN = 1 on 64 triplets of 16 edges (GRID_MEMBERS members;
    B4 with the basis shared, B5 with the gate shared); B7 by a sorted and
    an unsorted index, 4 rows a member (GRID_MEMBERS);
    B8 on 64 rows a member (1,100 members, 70,400 rows) with short runs
    (the tiled sum, one row a block) and long ones (the block sum)."""
    import torch

    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs
    from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
    from torch_m3gnet_tpu_torch.ops import sorted_segment as ss
    from torch_m3gnet_tpu_torch.ops import windowed_take as wt

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(130)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def held(label, fn, operands, in_dims, want, per_slice):
        """vmap(fn) against ``want`` (a tensor, or a tuple for each output)
        and, at members on either side of each slice bound (every
        ``per_slice`` members), single calls."""
        as_tuple = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
        with torch.no_grad():
            reset_launches()
            got = as_tuple(torch.func.vmap(fn, in_dims=in_dims)(*operands))
            torch.cuda.synchronize()
            launched = sum(all_launches().values())
            want = as_tuple(want)
            k = got[0].shape[0]
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            scale = max(float(w.abs().max()) for w in want)
            if launched != 1 or not err <= 1e-5 * scale:
                raise AssertionError(f"{label}: {launched} launches, {err:.3e} from the plain "
                                     f"version (scale {scale:.3e})")
            bounds = range(per_slice, k, per_slice)
            for j in sorted({0, k - 1, *bounds, *(b - 1 for b in bounds)}):
                one = as_tuple(fn(*(x if d is None else x[j] for x, d in zip(operands, in_dims))))
                if not all(torch.equal(g[j], o) for g, o in zip(got, one)):
                    raise AssertionError(f"{label}: member {j} differs from its own call")
        print(f"  {label}: {k} members in one call, {err:.3e} from the plain version; members "
              f"at the slice bounds bitwise their own calls")

    k, e, n = GRID_MEMBERS, 64, 8
    src = torch.sort(torch.randint(0, n, (e,), generator=gen, device="cuda"))[0].to(torch.int32)
    sh, gm_k, a_k, b_k = normal(1, e), normal(k, 1, e), normal(k, 1, n), normal(k, 1, e)
    lsrc, off = src.long(), ss.sorted_segment_offsets(src, n)
    q_want = torch.zeros(k, 1, n, device="cuda").index_add_(2, lsrc, sh * gm_k)
    held("q_scatter, gm batched", lambda x, y: fs.q_scatter(x, y, src, off, n, 1, 1),
         [sh, gm_k], (None, 0), q_want, GRID_Y)
    held("r1_gather, A batched", lambda x, y: fs.r1_gather(x, y, src, off, 1, 1), [a_k, sh],
         (0, None), sh * a_k[:, :, lsrc], GRID_Y)
    held("r2_gather, both batched", lambda x, y: fs.r2_gather(x, y, src, off, 1, 1), [a_k, b_k],
         (0, 0), b_k * a_k[:, :, lsrc], GRID_Y)

    t, ne = 64, 16
    e1 = torch.sort(torch.randint(0, ne, (t,), generator=gen, device="cuda"))[0].to(torch.int32)
    e2 = torch.randint(0, ne, (t,), generator=gen, device="cuda", dtype=torch.int32)
    l1, l2, order = e1.long(), e2.long(), ft.triplet_e2_order(e2, ne)
    off1 = ss.sorted_segment_offsets(e1, ne)
    basis, basis_k, gate, gate_k, g_k = (
        normal(1, t), normal(k, 1, t), normal(1, ne), normal(k, 1, ne), normal(k, 1, ne))
    fwd_want = torch.zeros(k, 1, ne, device="cuda").index_add_(2, l1, basis * gate_k[:, :, l2])
    pair_want = (g_k[:, :, l1] * gate[:, l2],
                 torch.zeros(k, 1, ne, device="cuda").index_add_(2, l2, g_k[:, :, l1] * basis_k))
    held("fused_triplet_gate_sum, gate batched",
         lambda b, q: ft.fused_triplet_gate_sum(b, q, e1, e2, ne, off1, order),
         [basis, gate_k], (None, 0), fwd_want, GRID_Y)
    held("backward_pair, basis and g batched",
         lambda b, q, c: ft.backward_pair(b, q, c, e1, e2, ne, off1, order),
         [basis_k, gate, g_k], (0, None, 0), pair_want, GRID_Y)
    vals = normal(k, 4, t)
    for label, idx, owners in (("sorted", e1, (None, ss.sorted_segment_offsets(e1, ne))),
                               ("unsorted", e2, ft.triplet_e2_order(e2, ne))):
        want = torch.zeros(k, 4, ne, device="cuda").index_add_(2, idx.long(), vals)
        held(f"windowed_scatter_fm, {label} index",
             lambda v: wt.windowed_scatter_fm(v, idx, ne, owners), [vals], (0,), want,
             GRID_Y)  # a member is one block of 4 rows
    for label, m, nseg in (("short runs", 512, 100), ("long runs", 4096, 4)):
        seg = torch.sort(torch.randint(0, nseg, (m,), generator=gen, device="cuda"))[0]
        data = normal(1100, 64, m)
        want = torch.zeros(1100, 64, nseg, device="cuda").index_add_(2, seg, data)
        seg = seg.to(torch.int32)
        seg_off = ss.sorted_segment_offsets(seg, nseg)
        # one row a block, so the slice bounds fall inside members: every
        # member against its own call
        held(f"sorted_segment_sum, 64 rows a member, {label}",
             lambda d: ss.sorted_segment_sum_fm(d, seg, nseg, seg_off), [data], (0,), want, 1)
        del data, want
    print(f"  grid slices checked in {time.perf_counter() - t0:.1f} s")


# The index check of a host batch (ops.batch_check, csrc/batch_check.cu) at
# a tiny batch's sizes, with a halo plan and ragged tails, and at one screen
# batch's (the benchmark's mix: N 16,384, E 751,104, T 7,205,888, B 102 graphs).
# n, e, t, b: nodes, edges, triplets, graphs; h: halo rows sent (in two ring
# blocks) and halo slots received, 0 for none.
BATCH_CHECK_SIZES = {
    "tiny": dict(n=4_501, e=9_003, t=30_003, b=5, h=6),
    "screen": dict(n=16_384, e=751_104, t=7_205_888, b=102, h=0),
}
# int32 elements of one block's tile in csrc/batch_check.cu (16 KB; 2,048
# int64), of one pass of its 256 threads' 16-byte loads, and of a warp's.
CHECK_TILE, CHECK_PASS, CHECK_WARP = 4096, 1024, 128
# The kernel's share of its bound at a screen batch, at least.
CHECK_MIN_SHARE = 0.5


def batch_check_rules(sizes: dict, device) -> list:
    """A valid set of a batch's index arrays, in to_torch's order of rules:
    the sorted ones non-decreasing over [0, bound), the others spread over
    it, all int32 on ``device``."""
    import torch

    from torch_m3gnet_tpu_torch.ops.batch_check import IndexRule

    n, e, t, b, h = (sizes[k] for k in "netbh")

    def ascending(length, bound):
        return (torch.arange(length, device=device) * bound // length).to(torch.int32)

    def spread(length, bound):
        return ((torch.arange(length, device=device) * 7919 + 13) % bound).to(torch.int32)

    n_dst = n + h
    rules = []
    if h:
        rules += [IndexRule("halo_send_idx", spread(h, n), n, False, "a row"),
                  IndexRule("halo_recv_idx", spread(h, h), h, False, "a row")]
    return rules + [
        IndexRule("edge_src", ascending(e, n), n, True, "a node index"),
        IndexRule("edge_dst", spread(e, n_dst), n_dst, False, "a node index"),
        IndexRule("triplet_node_k", spread(t, n_dst), n_dst, False, "a node index"),
        IndexRule("triplet_e1", ascending(t, e), e, True, "an edge index"),
        IndexRule("triplet_e2", spread(t, e), e, False, "an edge index"),
        IndexRule("node_graph", ascending(n, b), b, True, "a graph index"),
    ]


def batch_check_faults(rules) -> list:
    """One fault a case: (label, rule position, {element: value}, int64,
    the word it must give). Each array gets values outside its bound at its
    first and last element and where the first tile ends, and an int64
    value that an int32 cast would wrap into range; each sorted array a
    single descent at its first and last pair, across a warp, a block's
    pass, the first tile's end (the block boundary), and into its ragged
    tail; every other element keeps to its rules."""
    cases = []
    for i, r in enumerate(rules):
        x = r.index.cpu().long()
        length, order, rng = len(x), 1 << 2 * i, 1 << (2 * i + 1)
        cases += [(f"{r.name} -1 at 0", i, {0: -1}, False, rng),
                  (f"{r.name} bound at the end", i, {length - 1: r.bound}, False, rng),
                  (f"{r.name} 2**32 + 1 as int64", i, {length // 2: 2**32 + 1}, True,
                   rng | (order if r.sorted else 0))]
        if length > CHECK_TILE + 1:
            # in a sorted array the value also breaks the order there
            cases.append((f"{r.name} bound at the first tile's end", i, {CHECK_TILE: r.bound},
                           False, rng | (order if r.sorted else 0)))
        if not r.sorted:
            continue
        pairs = {"first pair": 0, "last pair": length - 2,
                 "warp boundary": CHECK_WARP - 1, "pass boundary": CHECK_PASS - 1,
                 "block boundary": CHECK_TILE - 1, "into the tail": length // 4 * 4 - 1}
        for label, j in pairs.items():
            if 0 <= j < length - 1:
                cases.append((f"{r.name} descends at the {label} ({j})", i,
                              _descent(x, j), False, order))
        j = CHECK_TILE // 2 - 1  # the block boundary of an int64 array
        if j < length - 1:
            cases.append((f"{r.name} descends at the int64 block boundary ({j})", i,
                          _descent(x, j), True, order))
    return cases


def _descent(x, j: int) -> dict:
    """Values for elements j, j + 1 of the non-decreasing ``x`` (a CPU int64
    tensor) such that x[j] > x[j + 1] is its only descent and every value
    stays within [0, max(x) + 1]."""
    a, b = int(x[j]), int(x[j + 1])
    return {j + 1: a - 1} if a >= 1 else {j: b + 1}


def check_batch_index(sizes: dict, device: str = "cuda") -> dict:
    """The index check on ``sizes`` (BATCH_CHECK_SIZES): the clean rules give
    0, and each fault of :func:`batch_check_faults` gives its word, from the
    plain version on ``device`` and, on CUDA, from the kernel; returns
    {"cases": n}."""
    import torch

    from torch_m3gnet_tpu_torch.ops import batch_check as bc

    rules = batch_check_rules(sizes, device)
    cuda = torch.device(device).type == "cuda"

    def words(rs):
        plain = bc.index_word_plain(rs)
        return plain, (bc.index_word(rs) if cuda else plain)

    if words(rules) != (0, 0):
        raise AssertionError(f"batch check: the clean rules give {words(rules)}, expected 0")
    cases = batch_check_faults(rules)
    for label, i, values, wide, want in cases:
        x = rules[i].index.to(torch.int64) if wide else rules[i].index.clone()
        for j, v in values.items():
            x[j] = v
        got = words([*rules[:i], rules[i]._replace(index=x), *rules[i + 1:]])
        if got != (want, want):
            raise AssertionError(f"batch check, {label}: (plain, kernel) words {got}, "
                                 f"expected {want}")
    print(f"  batch check at {sizes}: the clean batch passes and {len(cases)} faults give "
          f"their words{' (kernel and plain version)' if cuda else ''}")
    return {"cases": len(cases)}


def time_batch_check(name: str, flush) -> dict:
    """The kernel at one screen batch's sizes: its device time (clean
    flush, median of 30) alone and with the word's memset (``call_us``), against
    its bound (every index read once at the card's bandwidth), and the
    plain version's on the card (host clock, median of 5: its reductions
    read each result back); raises below CHECK_MIN_SHARE of the bound."""
    import torch

    from torch_m3gnet_tpu_torch.ops import batch_check as bc

    rules = batch_check_rules(BATCH_CHECK_SIZES["screen"], "cuda")
    nbytes = sum(r.index.numel() * r.index.element_size() for r in rules)
    bound_us = nbytes / bandwidth(name) * 1e6
    call = lambda: bc.index_word_device(rules)  # noqa: E731
    call_us = time_device(call, flush) * 1e3
    parts = kernel_parts(call, flush)
    (kernel_us,) = [v for k, v in parts.items() if "check_batch_index" in k]
    plain = []
    for _ in range(5):
        flush_l2(flush, "clean")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bc.index_word_plain(rules)
        plain.append((time.perf_counter() - t0) * 1e6)
    row = {"bytes": nbytes, "bound_us": bound_us, "kernel_us": kernel_us, "call_us": call_us,
           "share": bound_us / kernel_us, "plain_us": statistics.median(plain),
           "parts_us": parts}
    print(json.dumps({"batch_check": row}))
    if row["share"] < CHECK_MIN_SHARE:
        raise AssertionError(f"batch check: {kernel_us:.2f} us, {row['share']:.0%} of its "
                             f"bound {bound_us:.2f} us, under {CHECK_MIN_SHARE:.0%}")
    return row


# CHGNet's norm-and-gate (ops.norm_gate, csrc/norm_gate.cu; "BN" in
# PERF.md): the checks' (F, M), M no multiple of the kernels' 64-column tile
# (1,001 and 130 not of 4 either: the 4-byte path), F up to the kernels' 256
# (past 64 the kernels hold 16 rows a thread, not 4), and the M of one
# chgnet-mptrj.screen batch's padded edges and angles (F 64), which the card
# checks too and times: there the backward's blocks each walk ~40-150 tiles
# and its second pass sums hundreds of rows, where the small cases take one
# tile a block.
NORM_GATE_CASES = ((64, 1_000), (8, 1_000), (64, 1_001), (8, 130), (100, 1_000), (256, 130))
NORM_GATE_SCREEN = {"edges": 751_104, "angles": 2_569_216}
NORM_GATE_EPS = 1e-5
# Kernel (f32) vs the plain version in float64, as a fraction of the
# reference's largest magnitude: the output and d core, d gate are sums of
# F terms a column; the parameters' gradients sums of M terms in another
# order. Second order (the Functions' double backward) goes through the
# plain backward in f32 and one more sum over M.
NORM_GATE_TOL = 1e-5
NORM_GATE_TOL2 = 1e-4


def norm_gate_inputs(f: int, m: int, device, seed: int = 0, dtype=None) -> list:
    """(g, core, gate, core bias, gate bias, core scale, core shift, gate
    scale, gate shift), float32 unless ``dtype``: columns neither centred
    nor of unit spread, scales near 1."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(*shape, generator=gen, dtype=torch.float64)  # noqa: E731
    g, core, gate = rand(f, m), 2.0 * rand(f, m) + 0.3, 1.5 * rand(f, m) - 0.2
    params = [0.1 * rand(f) + (1.0 if q in (2, 4) else 0.0) for q in range(6)]
    return [t.to(device=device, dtype=dtype or torch.float32) for t in (g, core, gate, *params)]


def check_norm_gate(device: str = "cuda") -> dict:
    """Both kernels (on the CPU: the plain version in float32) against the
    plain version in float64 at NORM_GATE_CASES and, on the card, at
    NORM_GATE_SCREEN's shapes (F 64): the output, d core, d gate and the six
    parameters' gradients within NORM_GATE_TOL, and the gradients bitwise
    equal in a second call. Returns the worst relative error of each."""
    import torch

    from torch_m3gnet_tpu_torch.ops import norm_gate as ng

    cuda = torch.device(device).type == "cuda"
    labels = ("out", "d_core", "d_gate", *(f"d_{p}" for p in ng.PARAMS))
    worst = dict.fromkeys(labels, 0.0)
    cases = [*NORM_GATE_CASES, *((64, m) for m in NORM_GATE_SCREEN.values() if cuda)]
    for f, m in cases:
        g, core, gate, *params = norm_gate_inputs(f, m, device, seed=f * m)
        ref = [t.double() for t in (g, core, gate, *params)]
        want = (ng.norm_gate_fm_plain(*ref[1:], NORM_GATE_EPS),
                *ng.norm_gate_backward_plain(*ref, NORM_GATE_EPS))
        if cuda:
            fwd = lambda: ng.norm_gate_fwd_cuda(core, gate, params, NORM_GATE_EPS)  # noqa: E731
            bwd = lambda: ng.norm_gate_bwd_cuda(g, core, gate, params, NORM_GATE_EPS)  # noqa: E731
        else:
            fwd = lambda: ng.norm_gate_fm_plain(core, gate, *params, NORM_GATE_EPS)  # noqa: E731
            bwd = lambda: ng.norm_gate_backward_plain(g, core, gate, *params,  # noqa: E731
                                                      NORM_GATE_EPS)
        got, again = (fwd(), *bwd()), bwd()
        for label, x, y in zip(labels, got, want):
            err = rel_err(x, y)[1]
            worst[label] = max(worst[label], err)
            if err > NORM_GATE_TOL:
                raise AssertionError(f"norm_gate {label} at F={f} M={m}: relative error "
                                     f"{err:.3e} above {NORM_GATE_TOL:.0e}")
        if not all(torch.equal(x, y) for x, y in zip(got[1:], again)):
            raise AssertionError(f"norm_gate at F={f} M={m}: two backward calls differ")
        del g, core, gate, params, ref, want, got, again  # the screen shapes' GBs
    print(f"  norm_gate at (F, M) {cases}: worst relative errors "
          f"{ {k: f'{v:.2e}' for k, v in worst.items()} }, gradients bitwise repeated")
    return worst


def check_norm_gate_second_order(device: str = "cuda") -> float:
    """The double backward through ``NormGate`` (the kernels' Functions; on
    the CPU only with the kernels' wrappers replaced by the plain version,
    as the CPU test does) in float32 against the plain version's autograd in
    float64: d/d(inputs) of a weighted sum of the first-order gradients,
    within NORM_GATE_TOL2 of each tensor's largest magnitude. Returns the
    worst relative error."""
    import torch

    from torch_m3gnet_tpu_torch.ops import norm_gate as ng

    f, m = NORM_GATE_CASES[0]
    g, *inputs = norm_gate_inputs(f, m, device, seed=1)
    _, *weights = norm_gate_inputs(f, m, device, seed=2)

    def second(fn, xs, gout, ws):
        xs = [x.detach().clone().requires_grad_(True) for x in xs]
        grads = torch.autograd.grad(fn(*xs), xs, gout, create_graph=True)
        return torch.autograd.grad(sum((d * w).sum() for d, w in zip(grads, ws)), xs)

    got = second(lambda *xs: ng.NormGate.apply(*xs, NORM_GATE_EPS), inputs, g, weights)
    want = second(lambda *xs: ng.norm_gate_fm_plain(*xs, NORM_GATE_EPS),
                  [x.double() for x in inputs], g.double(), [w.double() for w in weights])
    worst = 0.0
    for label, x, y in zip(("core", "gate", *ng.PARAMS), got, want):
        err = rel_err(x, y)[1]
        worst = max(worst, err)
        if err > NORM_GATE_TOL2:
            raise AssertionError(f"norm_gate second order, d {label}: relative error {err:.3e} "
                                 f"above {NORM_GATE_TOL2:.0e}")
    print(f"  norm_gate second order through NormGate: worst relative error {worst:.2e}")
    return worst


def library_norm_gate(core, gate, cs, csh, gs, gsh, eps: float = NORM_GATE_EPS):
    """The library yardstick: what the port ran before the kernels, each
    stack transposed to (M, F) rows, ``F.layer_norm`` (scales ``cs``, ``gs``,
    shifts ``csh``, ``gsh``), the gate, and the product transposed back (the
    Dense biases were in the products)."""
    import torch
    from torch.nn import functional as F

    f = core.shape[0]
    yc = F.layer_norm(core.t().contiguous(), (f,), cs, csh, eps)
    yg = F.layer_norm(gate.t().contiguous(), (f,), gs, gsh, eps)
    return (F.silu(yc) * torch.sigmoid(yg)).t().contiguous()


def time_norm_gate(name: str, flush) -> list[dict]:
    """Both kernels at NORM_GATE_SCREEN (F 64): device us (clean flush,
    median of 30) of the forward and of the backward call (its kernels
    split by ``kernel_parts``), against their bounds (12 F M bytes forward,
    20 F M backward, at the card's bandwidth); the plain version's; and the
    library yardstick's (:func:`library_norm_gate`, and its autograd
    backward)."""
    import torch

    from torch_m3gnet_tpu_torch.ops import norm_gate as ng

    f, eps, rows = 64, NORM_GATE_EPS, []
    for label, m in NORM_GATE_SCREEN.items():
        g, core, gate, *params = norm_gate_inputs(f, m, "cuda")
        fwd = lambda: ng.norm_gate_fwd_cuda(core, gate, params, eps)  # noqa: E731
        bwd = lambda: ng.norm_gate_bwd_cuda(g, core, gate, params, eps)  # noqa: E731
        lib_in = [t.detach().clone().requires_grad_(True) for t in (core, gate, *params[2:])]
        lib_out = library_norm_gate(*lib_in)
        times = {
            "fwd_us": time_device(fwd, flush),
            "bwd_us": time_device(bwd, flush),
            "plain_fwd_us": time_device(lambda: ng.norm_gate_fm_plain(core, gate, *params, eps),
                                        flush),
            "plain_bwd_us": time_device(
                lambda: ng.norm_gate_backward_plain(g, core, gate, *params, eps), flush),
            "library_fwd_us": time_device(
                lambda: library_norm_gate(core, gate, *params[2:], eps), flush),
            "library_bwd_us": time_device(
                lambda: torch.autograd.grad(lib_out, lib_in, g, retain_graph=True), flush),
        }
        row = {"m": m, "f": f, **{k: v * 1e3 for k, v in times.items()},
               "bound_fwd_us": 12 * f * m / bandwidth(name) * 1e6,
               "bound_bwd_us": 20 * f * m / bandwidth(name) * 1e6,
               "bwd_parts_us": kernel_parts(bwd, flush)}
        row["share_fwd"] = row["bound_fwd_us"] / row["fwd_us"]
        row["share_bwd"] = row["bound_bwd_us"] / row["bwd_us"]
        rows.append({label: row})
        del g, core, gate, params, lib_in, lib_out
    print(json.dumps({"norm_gate": rows}))
    return rows


def teacher_batch(cfg, batch, gbatch):
    """The bench batch labelled by a teacher (same architecture, weights from
    seed 1) with its E/F/S: (host batch with numpy targets, card batch with
    card targets)."""
    import torch

    from torch_m3gnet_tpu_torch.models import build_model

    teacher = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(1))
    out = teacher(gbatch)
    targets = {name: getattr(out, name).detach() for name in ("energy", "forces", "stress")}
    host = batch.replace(**{k: v.cpu().numpy() for k, v in targets.items()})
    print(f"  teacher energy[:2] (eV) = {targets['energy'][:2].tolist()}")
    return host, gbatch.replace(**targets)


def loss_and_grads(pot, batch, cfg):
    """The train step's loss and its gradient for every weight, by name."""
    import torch

    from torch_m3gnet_tpu_torch.train import loss_and_metrics

    loss, _ = loss_and_metrics(pot, batch, cfg)
    names, params = zip(*pot.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


def check_training(mode, cfg, host_train, card_train):
    """The student (seed 0) in ``mode``: one step's
    loss and gradients against the CPU, the launches of one counted train
    step, and five steps whose loss falls. Returns (trainer, first loss,
    launches of one step, the CPU's step-1 loss and gradients)."""
    import torch

    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.train import Trainer

    cfg_m = cfg.replace(threebody_mode=mode)
    pot = build_model(cfg_m, device="cuda", generator=torch.Generator().manual_seed(0))
    cpu_pot = build_model(cfg_m, device="cpu")
    cpu_pot.load_state_dict(pot.state_dict())
    loss, grads = loss_and_grads(pot, card_train, cfg_m)
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = loss_and_grads(cpu_pot, host_train, cfg_m)
    print(f"  CPU reference loss and gradients: {time.perf_counter() - t0:.1f} s")
    del cpu_pot
    check(f"{mode} step-1 loss card vs CPU", loss.cpu(), cpu_loss, MODEL_TOL)
    worst = max((rel_err(grads[n].cpu(), cpu_grads[n])[1], n) for n in cpu_grads)
    ok = worst[0] <= TRAIN_TOL
    print(f"  {mode} weight gradients card vs CPU: worst {worst[1]} rel={worst[0]:.3e} "
          f"over {len(cpu_grads)} tensors, tol={TRAIN_TOL:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{mode} gradient {worst[1]}: relative error {worst[0]:.3e}")

    trainer = Trainer(pot, cfg_m)
    expected = expected_launches(mode, cfg.num_blocks, True)
    reset_launches()
    losses = [float(trainer.train_step(card_train)["loss"])]
    torch.cuda.synchronize()
    launches = all_launches()
    print(f"  launches in one train step: {launches}")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    losses += [float(trainer.train_step(card_train)["loss"]) for _ in range(4)]
    print(f"  {mode} losses over 5 steps: {losses}")
    finite = all(bool(p.isfinite().all()) for p in pot.parameters())
    if not (finite and all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{mode} training: finite weights {finite}, losses {losses}")
    return trainer, float(loss), launches, (cpu_loss, cpu_grads)


def time_step(step, reps: int = 50, warmup: int = 5) -> tuple[float, float]:
    """Median step time (ms) of ``step()``: CUDA events around each call from
    an idle device, and host wall time to the end of the same call."""
    import torch

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    dev_ms, wall_ms = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step()
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return statistics.median(dev_ms), statistics.median(wall_ms)


def profile_step(step, step_ms: float, steps: int = 5) -> dict:
    """Device time per step by kernel (torch.profiler over ``steps`` calls of
    ``step()``, the window padded with host time as in ``kernel_parts``)
    and the device's busy share of the unprofiled step time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    return {
        "device_busy_ms_per_step": busy_ms,
        "busy_share": busy_ms / step_ms,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top": [[e.key[:80], e.count / steps, e.self_device_time_total / 1e3 / steps] for e in top],
        "top_host": [
            [e.key[:80], e.count / steps, e.self_cpu_time_total / 1e3 / steps]
            for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
        ],
    }


# L2 states before a timed kernel call (time_device).
L2_STATES = ("clean", "dirty", "warm")


def flush_l2(flush, state: str) -> None:
    """Put the L2 cache (50 MB on an H100) in ``state`` before a timed call:

    - ``clean``: read the 256 MB ``flush`` buffer into 4,096 row sums (16
      KB; a reduction by rows needs no zeroed scratch, so the flush adds no
      memset to the profiles). The lines the previous call left (its dirty
      outputs too, written back here, untimed) are evicted, and what stays
      is clean, so the timed call reads its inputs from device memory and
      pays for its own bytes only;
    - ``dirty``: ``flush.zero_()``, the protocol of the earlier slices. It
      leaves ~50 MB of dirty lines, which the timed call writes back as it
      reads, so a streaming kernel pays up to twice its bytes;
    - ``warm``: nothing. The previous call of the same function has just
      touched the inputs, which stay in L2 as far as they fit, as when a
      producer kernel has just written them."""
    if state == "clean":
        flush.view(4096, -1).sum(1)
    elif state == "dirty":
        flush.zero_()
    elif state != "warm":
        raise ValueError(f"unknown L2 state {state!r}")


def time_device(fn, flush, state: str = "clean", reps: int = 30) -> float:
    """Median device time (ms) of ``fn`` with the L2 put in ``state``
    (:func:`flush_l2`) before each call. A spin kernel after the flush keeps
    the device busy while the host enqueues the timed call, so the events
    see device time only, not the wrapper's host overhead."""
    import torch

    fn()
    pairs = []
    for _ in range(reps):
        flush_l2(flush, state)
        torch.cuda._sleep(2_000_000)  # ~1 ms of clock cycles
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def l2_times(fn, flush) -> dict:
    """The kernel's time under each L2 state: ``ms`` (clean flush),
    ``cold_dirty_us`` and ``warm_us``."""
    ms = {state: time_device(fn, flush, state) for state in L2_STATES}
    return {"ms": ms["clean"], "cold_dirty_us": ms["dirty"] * 1e3, "warm_us": ms["warm"] * 1e3}


# Host time on each side of a profiled window (s): the profiler drops the
# device records that it places outside its window (kernel_parts).
PROFILE_PAD_S = 0.05


def kernel_parts(fn, flush, calls: int = 10, copies: bool = False) -> dict[str, float]:
    """Device time (us per call of ``fn``) of each CUDA kernel that ``fn``
    launches, from torch.profiler over ``calls`` calls after a clean flush:
    where one call launches several kernels, how the time splits.
    ``copies``: keep torch's elementwise, fill
    and copy kernels too (the spin and the flush's sums stay out).

    The profiler drops device records at its window's ends, and cuts some
    short (on an H100 under torch 2.11 it kept 8 or 9 of 10 calls' kernels
    in many readings of this script, 4-5 of 10 in some), more the longer
    the process has run; a total divided by ``calls`` then reads a call
    that much faster. So the window is padded with host time
    on each side, the device is synchronised after every call, and a
    kernel's time per call is the median of its recorded launches times
    its launches per call (its records over the spin kernel's, one spin a
    call, rounded). With fewer than half the calls' spins recorded the
    reading is taken again with four times the padding (three tries, then
    it raises)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pad = PROFILE_PAD_S
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(calls):
                flush_l2(flush, "clean")
                torch.cuda._sleep(2_000_000)
                fn()
                torch.cuda.synchronize()
            time.sleep(pad)
        runs: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                runs.setdefault(e.name, []).append(e.time_range.elapsed_us())
        spins = sum(len(v) for k, v in runs.items() if "spin_kernel" in k)
        if 2 * spins >= calls:
            break
        pad *= 4
    else:
        raise AssertionError(f"the profiler recorded {spins} of {calls} calls in three tries: "
                             f"{ {k[:40]: len(v) for k, v in runs.items()} }")
    if spins != calls:
        print(f"  (the profiler recorded {spins} of {calls} calls)")
    return {
        k.replace("(anonymous namespace)::", "").split("(")[0][:60]:
            statistics.median(v) * max(1, round(len(v) / spins))
        for k, v in runs.items()
        if "spin_kernel" not in k and "reduce_kernel" not in k
        and (copies or ("elementwise" not in k and "fill" not in k.lower()))
    }


def time_batch_index(gbatch, flush) -> dict:
    """Device time (us, clean flush, median of 30) of building each part of
    a batch's kernel index, which ``to_torch`` does once per batch: the
    offsets of ``edge_src`` and ``triplet_e1`` and the e2 order; and their
    sum over the parts that each three-body mode builds (``per_mode``)."""
    from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
    from torch_m3gnet_tpu_torch.ops import sorted_segment as ss

    b = gbatch
    parts = {
        "edge_src_offsets": lambda: ss.sorted_segment_offsets(b.edge_src, b.num_nodes),
        "triplet_e1_offsets": lambda: ss.sorted_segment_offsets(b.triplet_e1, b.num_edges),
        "triplet_e2_order": lambda: ft.triplet_e2_order(b.triplet_e2, b.num_edges),
    }
    row = {name: time_device(fn, flush) * 1e3 for name, fn in parts.items()}
    row["e2_order_kernels_us"] = kernel_parts(parts["triplet_e2_order"], flush)
    row["per_mode"] = {
        mode: sum(row[n] for n in index if n in parts)
        for mode, index in (("factorized", ("edge_src_offsets",)),
                            ("gather", ("edge_src_offsets", "triplet_e1_offsets")),
                            ("fused", ("edge_src_offsets", "triplet_e1_offsets",
                                       "triplet_e2_order")))
    }
    print(json.dumps({"batch_index_us": row}))
    return row


def time_kernels(gbatch, cfg, card_name, launches, errs) -> list[dict]:
    """One row per kernel: its time, its plain version's, its bound and,
    where one PyTorch call computes the same function, that call's."""
    import torch

    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs
    from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
    from torch_m3gnet_tpu_torch.ops import windowed_take as wt

    src, num_nodes, l_max, n_max = gbatch.edge_src, gbatch.num_nodes, cfg.l_max, cfg.n_max
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=src.device).zero_()  # 256 MB > L2
    ss_rows = time_sorted_segment(gbatch, card_name, flush)
    time_batch_index(gbatch, flush)
    e, t = gbatch.num_edges, gbatch.num_triplets
    e1, e2 = gbatch.triplet_e1, gbatch.triplet_e2
    order = (gbatch.triplet_e2_order, gbatch.triplet_e2_offsets)
    node_off, off1 = gbatch.edge_src_offsets, gbatch.triplet_e1_offsets
    e1_owners = (None, off1)
    m, ln, mn = l_max * l_max, l_max * n_max, l_max * l_max * n_max
    sh, gm, a = stage_inputs(num_nodes, e, l_max, n_max, src.device)
    f = 4
    basis, gate, g, data, vals = triplet_inputs(gbatch, ln, f)
    bw = bandwidth(card_name)
    a_bytes, src_bytes, idx_bytes = 4 * mn * num_nodes, 4 * e, 4 * t
    fs_src = "torch_m3gnet_tpu_torch/csrc/factorized_stage.cu"
    ft_src = "torch_m3gnet_tpu_torch/csrc/fused_triplet.cu"
    wt_src = "torch_m3gnet_tpu_torch/csrc/windowed_take.cu"

    def both(fn):
        """The path calls the take and the scatter once with e1, once with e2,
        each with its owners (the e1 offsets, the e2 order)."""
        return [lambda: fn(e1, e1_owners), lambda: fn(e2, order)]

    specs = {
        # name: (source, kernel calls, plain calls, library calls or None,
        #        bytes moved: inputs once + outputs once, flops, TPU kernel);
        # B1 reads src's offsets and B4 e1's, not the ids
        "q_scatter": (
            fs_src, [lambda: fs.q_scatter(sh, gm, src, node_off, num_nodes, l_max, n_max)],
            [lambda: fs.q_scatter_plain(sh, gm, src, num_nodes, l_max, n_max)], None,
            4 * (m + ln) * e + 4 * (num_nodes + 1) + a_bytes, 2 * mn * e,
            "torch_m3gnet_tpu/ops/pallas_factorized_stage.py:230",
        ),
        "r1_gather": (
            fs_src, [lambda: fs.r1_gather(a, sh, src, node_off, l_max, n_max)],
            [lambda: fs.r1_gather_plain(a, sh, src, l_max, n_max)], None,
            a_bytes + 4 * (m + ln) * e + src_bytes, 2 * mn * e,
            "torch_m3gnet_tpu/ops/pallas_factorized_stage.py:340",
        ),
        "r2_gather": (
            fs_src, [lambda: fs.r2_gather(a, gm, src, node_off, l_max, n_max)],
            [lambda: fs.r2_gather_plain(a, gm, src, l_max, n_max)], None,
            a_bytes + 4 * (ln + m) * e + src_bytes, 2 * mn * e,
            "torch_m3gnet_tpu/ops/pallas_factorized_stage.py:340",
        ),
        "fused_triplet_gate_sum": (
            ft_src, [lambda: ft.fused_triplet_gate_sum(basis, gate, e1, e2, e, off1, order)],
            [lambda: ft.fused_triplet_gate_sum_plain(basis, gate, e1, e2, e)], None,
            4 * ln * t + idx_bytes + 4 * (e + 1) + 4 * 2 * ln * e, 2 * ln * t,
            "torch_m3gnet_tpu/ops/pallas_fused_triplet.py:381",
        ),
        "backward_pair": (
            ft_src, [lambda: ft.backward_pair(basis, gate, g, e1, e2, e, off1, order)],
            [lambda: ft.backward_pair_plain(basis, gate, g, e1, e2, e)], None,
            4 * 2 * ln * t + 2 * idx_bytes + 4 * 3 * ln * e, 3 * ln * t,
            "torch_m3gnet_tpu/ops/pallas_fused_triplet.py:513",
        ),
        "windowed_take_fm": (
            wt_src, both(lambda idx, owners: wt.windowed_take_fm(data, idx, owners)),
            both(lambda idx, _: wt.take_fm_plain(data, idx)),
            both(lambda idx, _: torch.index_select(data, 1, idx)),
            4 * f * e + idx_bytes + 4 * f * t, 0,
            "torch_m3gnet_tpu/ops/pallas_windowed_take.py:166",
        ),
        "windowed_scatter_fm": (
            wt_src, both(lambda idx, owners: wt.windowed_scatter_fm(vals, idx, e, owners)),
            both(lambda idx, _: wt.scatter_fm_plain(vals, idx, e)),
            both(lambda idx, _: torch.zeros((f, e), device=vals.device).index_add_(1, idx, vals)),
            4 * f * t + idx_bytes + 4 * f * e, f * t,
            "torch_m3gnet_tpu/ops/pallas_windowed_take.py:240",
        ),
    }

    def mean_ms(fns):
        return None if fns is None else statistics.mean(time_device(fn, flush) for fn in fns)

    def l2_by_call(fns):
        """Each call's L2 times and kernel split, and their means."""
        calls = [dict(l2_times(fn, flush), parts_us=kernel_parts(fn, flush)) for fn in fns]
        mean = {k: statistics.mean(c[k] for c in calls) for k in ("ms", "cold_dirty_us", "warm_us")}
        return mean, calls

    member = member_specs(gbatch, cfg)
    rows = [dict(ss_rows[0], launches=launches["sorted_segment_sum"],
                 max_abs_err=errs["sorted_segment_sum"],
                 members=time_members("sorted_segment_sum", member, flush, bw))]
    with torch.no_grad():
        for name, (source, kernel, plain, library, nbytes, flops, replaces) in specs.items():
            l2, calls = l2_by_call(kernel)
            plain_ms, library_ms = mean_ms(plain), mean_ms(library)
            bytes_ms = nbytes / bw * 1e3
            ops_ms = flops / F32_FLOPS * 1e3
            rows.append({
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": errs[name],
                "ms": l2["ms"],
                "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": library_ms,
                "cold_dirty_us": l2["cold_dirty_us"],
                "warm_us": l2["warm_us"],
                "bytes": nbytes,
                "parts_us": calls[0]["parts_us"],
            })
            if len(calls) > 1:  # B6, B7: the e1 and the e2 call apart
                by_call = dict(zip(("e1", "e2"), calls))
                rows[-1]["parts_us"] = {k: c.pop("parts_us") for k, c in by_call.items()}
                rows[-1]["per_call"] = by_call
            if name == "backward_pair":  # the e2 order's own reads: order, offsets, e1 again
                rows[-1]["design_bytes"] = nbytes + 4 * (2 * t + e + 1)
            if name == "windowed_scatter_fm":
                # vals, out and the offsets by e1; the order too by e2
                own = 4 * f * t + 4 * f * e + 4 * (e + 1)
                rows[-1]["design_bytes"] = {"e1": own, "e2": own + idx_bytes}
                rows[-1]["design_bound_us"] = {
                    k: v / bw * 1e6 for k, v in rows[-1]["design_bytes"].items()}
            rows[-1]["members"] = time_members(name, member, flush, bw)
            lib = "" if library_ms is None else f", library {library_ms * 1e3:.1f} us"
            print(f"  {name}: {l2['ms'] * 1e3:.2f} us clean, {l2['cold_dirty_us']:.2f} dirty, "
                  f"{l2['warm_us']:.2f} warm (plain {plain_ms * 1e3:.1f} us{lib}, "
                  f"bound {max(bytes_ms, ops_ms) * 1e3:.2f} us for {nbytes / 1e6:.2f} MB; "
                  f"kernels {rows[-1]['parts_us']})")
    return rows


def time_members(name: str, member: dict, flush, bw: float) -> dict:
    """The vmap rule's call at K = MEMBERS as the committee makes it
    (``member_specs``; B6 and B7: the e1 and the e2 call together) beside
    MEMBERS single calls, one per member, each alone, summed; and the
    K-member bound with a shared operand read once. Device time of every
    kernel a call launches (``kernel_parts`` with its copies, clean flush,
    mean of 10), so that the host's gaps between the launches of one call
    (B6/B7 launch twice) stay out; ``parts_us`` splits
    the K-member call by kernel; ``event_us``, CUDA events around the
    K-member call (``time_device``, clean flush, median of 30), the
    cross-check for a call of one launch (it adds the launch's ~4 us)."""
    import torch

    fn, shapes, dims, _, nbytes, flops = member[name]
    ops = member_operands(shapes, flush.device, 120, [d is not None for d in dims])
    call = lambda: torch.func.vmap(fn, in_dims=dims)(*ops)  # noqa: E731
    with torch.no_grad():
        parts = kernel_parts(call, flush, copies=True)
        event_us = time_device(call, flush) * 1e3
        singles_us = sum(
            sum(kernel_parts(lambda: fn(*(x if d is None else x[k] for x, d in zip(ops, dims))),
                             flush, copies=True).values())
            for k in range(MEMBERS))
    bytes_s, ops_s = nbytes / bw, flops / F32_FLOPS
    row = {"k": MEMBERS, "in_dims": list(dims), "us": sum(parts.values()), "parts_us": parts,
           "event_us": event_us, "singles_us": singles_us, "bound_us": max(bytes_s, ops_s) * 1e6,
           "bound_by": "bytes" if bytes_s >= ops_s else "operations", "bytes": nbytes}
    print(f"  {name} at K = {MEMBERS} (in_dims {dims}): {row['us']:.2f} us (CUDA events "
          f"{event_us:.2f}), {MEMBERS} single calls {row['singles_us']:.2f} us, bound "
          f"{row['bound_us']:.2f} us")
    return row


def time_sorted_segment(gbatch, card_name, flush) -> list[dict]:
    """B8 at each of its four shapes on the path: kernel (under the three L2
    states), plain version and ``index_add_`` (clean flush, median of 30)
    beside the bytes bound. Prints the rows as one line; the first (the
    node aggregation, the largest and the one each block runs) goes into
    the ``kernels`` line."""
    import torch

    from torch_m3gnet_tpu_torch.ops import sorted_segment as ss

    bw = bandwidth(card_name)
    rows = []
    with torch.no_grad():
        for i, (label, f, seg, nseg, off) in enumerate(sorted_sum_cases(gbatch)):
            x = seeded((f, seg.shape[0]), seg.device, 10 + i)
            m = seg.shape[0]
            # data and output once, and the index the call reads: the S + 1
            # offsets of the sorted ids
            nbytes = 4 * f * m + 4 * (nseg + 1) + 4 * f * nseg
            bytes_ms, ops_ms = nbytes / bw * 1e3, f * m / F32_FLOPS * 1e3
            l2 = l2_times(lambda: ss.sorted_segment_sum_fm(x, seg, nseg, off), flush)
            plain_ms = time_device(lambda: ss.sorted_segment_sum_fm_plain(x, seg, nseg), flush)
            library_ms = time_device(
                lambda: torch.zeros((f, nseg), device=x.device).index_add_(1, seg, x), flush)
            rows.append({
                "name": "sorted_segment_sum",
                "route": "cuda",
                "source": "torch_m3gnet_tpu_torch/csrc/sorted_segment.cu",
                "replaces": "torch_m3gnet_tpu/ops/pallas_segment.py:252",
                "also_replaces": "torch_m3gnet_tpu/ops/pallas_segment.py:129",
                "shape": {"call": label, "F": f, "M": m, "S": nseg},
                "ms": l2["ms"],
                "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": library_ms,
                "cold_dirty_us": l2["cold_dirty_us"],
                "warm_us": l2["warm_us"],
                "bytes": nbytes,
                "parts_us": kernel_parts(lambda: ss.sorted_segment_sum_fm(x, seg, nseg, off),
                                         flush),
            })
            print(f"  sorted_segment_sum {label}: {l2['ms'] * 1e3:.2f} us clean, "
                  f"{l2['cold_dirty_us']:.2f} dirty, {l2['warm_us']:.2f} warm (plain "
                  f"{plain_ms * 1e3:.1f} us, index_add_ {library_ms * 1e3:.1f} us, bound "
                  f"{max(bytes_ms, ops_ms) * 1e3:.2f} us for {nbytes / 1e6:.2f} MB)")
    print(json.dumps({"sorted_segment_sum_shapes": rows}))
    return rows


def step_line(label, step, gbatch, name, smi, real, reps=50, warmup=5, eval_ms=None,
              **extra) -> float:
    """Print the step line and the profile line of one step function; with
    ``eval_ms`` (a train step's), also its ratio to that eval step."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    step_ms, wall_ms = time_step(step, reps, warmup)
    if eval_ms is not None:
        extra.update(eval_ms=eval_ms, train_eval_ratio=step_ms / eval_ms)
    print(json.dumps({label: {
        "card": name, "nvidia_smi": smi, "step_ms": step_ms, "wall_ms": wall_ms,
        "items_per_s": sum(real) / (step_ms * 1e-3), "edges": real[0], "triplets": real[1],
        "graphs": gbatch.num_graphs, "reps": reps,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **extra,
    }}))
    profile = profile_step(step, step_ms)
    print(json.dumps({label.replace("eval", "profile").replace("train", "profile_train"): profile}))
    return step_ms


def md_config(**kw):
    """Phase 8's MD run: the bench cells at 300 K, dt 1 fs, a rebuild of the
    (skin-padded) neighbour list every MD_REBUILD steps."""
    from torch_m3gnet_tpu_torch.simulate import MDConfig

    return MDConfig(**{**dict(dt=1.0, n_steps=MD_STEPS, ensemble="nve", temperature=300.0,
                              rebuild_every=MD_REBUILD, seed=0), **kw})


def check_native_data(structures) -> dict:
    """Phase 8, native data: the bench cells (108 atoms each, so the C++ path
    runs by default) packed through the native neighbour list and triplet
    enumerator and through numpy: every field of the two batches equal, and
    per cell the native list's indices equal and its distances within
    NATIVE_DIST_TOL of numpy's. Returns the host build times."""
    from torch_m3gnet_tpu_torch import native
    from torch_m3gnet_tpu_torch.data import neighbor_list_pbc, pack_structures

    native.reset_call_counts()
    t0 = time.perf_counter()
    fast = pack_structures(structures, 5.0, 4.0, pad_multiple=PAD_MULTIPLE)
    native_s = time.perf_counter() - t0
    want = {"neighbor_list": len(structures), "threebody": len(structures)}
    if native.CALLS != want:
        raise AssertionError(f"native calls {native.CALLS}, expected {want}")
    t0 = time.perf_counter()
    slow = pack_structures(structures, 5.0, 4.0, pad_multiple=PAD_MULTIPLE, use_native=False)
    numpy_s = time.perf_counter() - t0
    if native.CALLS != want:
        raise AssertionError(f"the numpy path ran native code: {native.CALLS}")
    for f in dataclasses.fields(fast):
        a, b = getattr(fast, f.name), getattr(slow, f.name)
        if (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)):
            raise AssertionError(f"native and numpy batches differ in {f.name}")
    dist_err = 0.0
    for s in structures:
        a = neighbor_list_pbc(s.lattice, s.cart_coords, 5.0)
        b = neighbor_list_pbc(s.lattice, s.cart_coords, 5.0, use_native=False)
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            raise AssertionError("native and numpy neighbour lists differ")
        dist_err = max(dist_err, float(np.abs(a[2] - b[2]).max()))
    if dist_err > NATIVE_DIST_TOL:
        raise AssertionError(f"native distances off by {dist_err:.3e}")
    print(f"  native batch of {len(structures)} x {len(structures[0])} atoms: "
          f"{native_s * 1e3:.1f} ms; numpy: {numpy_s * 1e3:.1f} ms; fields equal, "
          f"distances within {dist_err:.1e}")
    return {"pack_native_ms": native_s * 1e3, "pack_numpy_ms": numpy_s * 1e3,
            "native_dist_err": dist_err}


def md_step_times(pot, structures, reps: int = 3) -> dict:
    """One rebuild (host list, then ``to_torch`` with the kernel index) and
    the MD steps between rebuilds, timed apart on the bench cells (after MD,
    FIRE and L-BFGS steps ran with no host synchronisation): ms per
    step = (t(11 steps) - t(1 step)) / 10, each the median of ``reps`` calls
    that end in a synchronise (every call also evaluates the start forces);
    the device's busy share of a 10-step call from the profiler."""
    import torch

    from torch_m3gnet_tpu_torch.simulate import md, relax

    cfg = md_config()
    wrapped = [s.wrap() for s in structures]
    host_ms, copy_ms = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, host = relax.build_batch(wrapped, [s.cart_coords for s in wrapped],
                                    [s.lattice for s in wrapped], 5.0 + cfg.skin, 4.0,
                                    PAD_MULTIPLE, dtype=np.float32)
        t1 = time.perf_counter()
        batch = relax.device_batch(pot, host)
        torch.cuda.synchronize()
        host_ms.append((t1 - t0) * 1e3)
        copy_ms.append((time.perf_counter() - t1) * 1e3)
    rng = np.random.default_rng(0)
    vel = np.zeros((batch.num_nodes, 3))
    real = sum(len(s) for s in structures)
    vel[:real] = md.maxwell_boltzmann_velocities(np.full(real, md.ATOMIC_MASSES[29]), 300.0, rng)
    dev = pot.model.edge_init.kernel.device
    vel, masses = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                   for a in (vel, md.node_masses(host)))
    gen = torch.Generator(device=dev).manual_seed(0)

    def run(n):
        with torch.no_grad():
            md._md_inner(pot, batch, vel, masses, gen, cfg, n)
        torch.cuda.synchronize()

    # The steps between rebuilds must not wait for the device: with the
    # sync debug mode at "error", any op that synchronises raises.
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            md._md_inner(pot, batch, vel, masses, gen, cfg, 2)
            relax._fire_inner(pot, batch, relax.FireConfig(relax_cell=True), 2)
            relax._lbfgs_inner(pot, batch, relax.LbfgsConfig(relax_cell=True), 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("  MD (NVE), FIRE and L-BFGS steps with cell ran with the sync debug mode at "
          "'error': no host synchronisation")
    run(2)  # warm-up
    times = {}
    for n in (1, 11):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(n)
            walls.append((time.perf_counter() - t0) * 1e3)
        times[n] = statistics.median(walls)
    step_ms = (times[11] - times[1]) / 10
    profile = profile_step(lambda: run(10), times[11] - step_ms, steps=1)
    return {
        "rebuild_host_ms": statistics.median(host_ms),
        "rebuild_to_torch_ms": statistics.median(copy_ms),
        "md_ms_per_step": step_ms, "atom_steps_per_s": real / (step_ms * 1e-3),
        "md_10_steps_ms": times[11] - step_ms,
        "md_busy_share": profile["busy_share"],
        "md_device_busy_ms_per_step": profile["device_busy_ms_per_step"] / 10,
        "md_kernel_launches_per_step": profile["kernel_launches_per_step"] / 10,
    }


def check_md(pot, cfg, structures) -> dict:
    """Phase 8, MD: NVE on the bench cells for MD_STEPS steps, one rebuild
    through the native list; the launches of the whole run (counts set to 0
    just before it) are those of MD_STEPS + rebuilds evaluations (each
    rebuild evaluates its start forces); its first MD_REBUILD steps against
    the same run on the CPU; the total-energy drift per graph; then NVT
    twice with one seed (deterministic algorithms on: torch's ``index_add``
    on the card then sums in a fixed order), bitwise equal."""
    import dataclasses as dc

    import torch

    from torch_m3gnet_tpu_torch import native
    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.simulate import run_md

    n_graphs, real = len(structures), sum(len(s) for s in structures)
    nve = md_config(record_trajectory=True)
    rebuilds = -(-MD_STEPS // MD_REBUILD)
    reset_launches()
    native.reset_call_counts()
    t0 = time.perf_counter()
    card = run_md(pot, structures, 5.0, 4.0, nve, pad_multiple=PAD_MULTIPLE)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = all_launches()
    evals = MD_STEPS + rebuilds
    per_eval = expected_launches("factorized", cfg.num_blocks, False)
    per_step = {k: v / evals for k, v in launches.items()}
    print(f"  NVE {MD_STEPS} steps ({rebuilds} rebuilds, {evals} evaluations): launches "
          f"{launches}; per MD step {per_step}")
    if launches != {k: v * evals for k, v in per_eval.items()}:
        raise AssertionError(f"MD launches {launches}, expected {per_eval} x {evals}")
    want_native = {"neighbor_list": n_graphs * rebuilds, "threebody": n_graphs * rebuilds}
    if native.CALLS != want_native:
        raise AssertionError(f"native calls {native.CALLS}, expected {want_native}")

    cpu_pot = build_model(cfg, device="cpu")
    cpu_pot.load_state_dict(pot.state_dict())
    t0 = time.perf_counter()
    cpu = run_md(cpu_pot, structures, 5.0, 4.0, dc.replace(nve, n_steps=MD_REBUILD),
                 pad_multiple=PAD_MULTIPLE)
    print(f"  CPU reference, {MD_REBUILD} steps: {time.perf_counter() - t0:.1f} s")
    errs = {}
    for label, got, want in (
        ("E_pot", card.energies[:MD_REBUILD], cpu.energies),
        ("KE", card.kinetic[:MD_REBUILD], cpu.kinetic),
        ("positions", np.stack([t[:MD_REBUILD] for t in card.trajectories]),
         np.stack(cpu.trajectories)),
    ):
        errs[label] = check(f"MD {label}, card vs CPU, {MD_REBUILD} steps", torch.as_tensor(got),
                            torch.as_tensor(want), MD_TOL)
    for name in ("energies", "kinetic", "temperatures"):
        if not np.isfinite(getattr(card, name)).all():
            raise AssertionError(f"MD {name} not finite")
    total = card.energies + card.kinetic
    drift = np.abs(total - total[0]).max(axis=0)  # (B,) eV
    print(f"  NVE total-energy drift per graph over {MD_STEPS} steps: max {drift.max():.3e} eV "
          f"(bound {DRIFT_TOL:g}); KE(0) mean {card.kinetic[0].mean():.3f} eV")
    if drift.max() > DRIFT_TOL:
        raise AssertionError(f"NVE energy drift {drift.max():.3e} eV above {DRIFT_TOL}")

    nvt = md_config(ensemble="nvt", friction=0.01, seed=1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = [run_md(pot, structures, 5.0, 4.0, nvt, pad_multiple=PAD_MULTIPLE)
                for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(
        np.array_equal(getattr(runs[0], k), getattr(runs[1], k))
        for k in ("energies", "kinetic")
    ) and all(
        np.array_equal(a.cart_coords, b.cart_coords)
        and np.array_equal(a.properties["velocities"], b.properties["velocities"])
        for a, b in zip(runs[0].structures, runs[1].structures)
    )
    temps = runs[0].temperatures
    print(f"  NVT {MD_STEPS} steps twice, seed 1: bitwise equal {same}; T mean "
          f"{temps.mean():.1f} K (min {temps.min():.1f}, max {temps.max():.1f})")
    if not same:
        raise AssertionError("two NVT runs with one seed differ")
    if not (np.isfinite(temps).all() and 100.0 < temps.mean() < 900.0):
        raise AssertionError(f"NVT temperatures off: mean {temps.mean()}")
    return {"md_nve_run_ms": run_ms, "md_steps": MD_STEPS, "md_rebuilds": rebuilds,
            "md_atoms": real, "md_launches_per_step": per_step,
            "md_card_vs_cpu_max_abs_err": errs, "nve_drift_ev_max": float(drift.max()),
            "nve_ke0_ev_mean": float(card.kinetic[0].mean()),
            "nvt_bitwise_repeat": same, "nvt_t_mean_k": float(temps.mean())}


def relax_state(pot, structures):
    """Per graph: energy, largest atomic force and largest generalized force
    of FIRE with cell relaxation (atoms' forces and the strain forces
    -V sigma / n_atoms, ASE UnitCellFilter's convention), evaluated on a
    neighbour list at cutoff + skin as the relaxation builds it."""
    import torch

    from torch_m3gnet_tpu_torch.simulate import relax

    wrapped = [s.wrap() for s in structures]
    graphs, host = relax.build_batch(wrapped, [s.cart_coords for s in wrapped],
                                     [s.lattice for s in wrapped], 5.3, 4.0, PAD_MULTIPLE)
    out = pot(host)
    n = len(structures)
    f = out.forces.detach().cpu().numpy()
    lat = torch.as_tensor(host.lattice)
    strain_f = relax._stress_force(out.stress.detach().cpu(), lat, torch.as_tensor(host.n_node),
                                   lat.dtype).numpy()
    offs = np.cumsum([0] + [g.num_nodes for g in graphs])
    fmax = np.array([np.linalg.norm(f[offs[i]:offs[i + 1]], axis=1).max() for i in range(n)])
    gmax = np.maximum(fmax, np.abs(strain_f[:n]).max(axis=(1, 2)))
    return out.energy.detach().cpu().numpy()[:n], fmax, gmax


def check_relax(pot, structures) -> dict:
    """Phase 8, relaxation: FIRE with cell relaxation on RELAX_GRAPHS bench
    cells for two rebuilds: each graph's energy and largest generalized
    force (what FIRE drives to zero with a cell DOF) fall. The seeded model
    is unbound, so the cell expands and the atoms' own largest force may
    grow; it is printed beside."""
    import torch

    from torch_m3gnet_tpu_torch.simulate import FireConfig, relax_structures

    fire = FireConfig(max_steps=2 * MD_REBUILD, rebuild_every=MD_REBUILD, relax_cell=True,
                      fmax=1e-6, smax=1e-9)
    e0, f0, g0 = relax_state(pot, structures)
    t0 = time.perf_counter()
    relaxed, _, _ = relax_structures(pot, structures, 5.0, 4.0, fire, pad_multiple=PAD_MULTIPLE)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    e1, f1, g1 = relax_state(pot, relaxed)
    n = len(structures)
    print(f"  FIRE + cell, {n} cells, {fire.max_steps} steps: E {e0.sum():.5f} -> "
          f"{e1.sum():.5f} eV (sum); largest generalized force {g0.max():.6f} -> "
          f"{g1.max():.6f}, atomic {f0.max():.6f} -> {f1.max():.6f} eV/A; "
          f"{ms / fire.max_steps:.2f} ms per step with its rebuilds")
    if not ((e1 < e0).all() and (g1 < g0).all()):
        raise AssertionError(f"relaxation did not lower every energy and generalized force: "
                             f"{e0} -> {e1}, {g0} -> {g1}")
    return {"relax_graphs": n, "relax_steps": fire.max_steps,
            "relax_ms_per_step": ms / fire.max_steps,
            "relax_e_ev": [float(e0.sum()), float(e1.sum())],
            "relax_gen_fmax": [float(g0.max()), float(g1.max())],
            "relax_atom_fmax": [float(f0.max()), float(f1.max())]}


def elastic_cell():
    """The 4-atom fcc-Cu cell of the second-derivative checks, perturbed."""
    from torch_m3gnet_tpu_torch.data import Structure

    rng = np.random.default_rng(2)
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    return Structure.from_frac_coords(np.eye(3) * 3.62, frac + rng.normal(0, 0.01, (4, 3)),
                                      [29] * 4)


def row_loop_hessian(fn, x, rows=None, chunk=None, pick=None):
    """The Hessian row by row, one backward per entry of the gradient: what
    ``simulate.elastic._hessian`` computes in batched backward passes of
    ``chunk`` rows (ignored here). ``pick``: only these rows, in this
    order (default the first ``rows``)."""
    import torch

    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(fn(x), x, create_graph=True)
        flat = grad.reshape(-1)
        pick = list(range(flat.numel() if rows is None else rows)) if pick is None else pick
        return torch.stack([
            torch.autograd.grad(flat[i], x, retain_graph=j < len(pick) - 1)[0]
            for j, i in enumerate(pick)
        ])


def check_elastic(pot, cfg) -> dict:
    """Phase 8, second derivatives: ``elastic_tensor`` and ``force_constants``
    of a perturbed 4-atom fcc-Cu cell on the card (one gradient, then one
    batched backward over the Hessian's rows, with B1-B3 and B8 launched in
    it) against the same on the CPU, both f32, and against the card's row
    by row loop (``row_loop_hessian``), each timed (host clock to a
    synchronise, one call after a warm one)."""
    import torch

    from torch_m3gnet_tpu_torch.data import pack_structures
    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.simulate import elastic, elastic_tensor, force_constants

    batch = pack_structures([elastic_cell()], 5.0, 4.0, pad_multiple=64)
    cpu_pot = build_model(cfg, device="cpu")
    cpu_pot.load_state_dict(pot.state_dict())

    def run(fn):
        fn(pot, batch)
        reset_launches()
        t0 = time.perf_counter()
        got = fn(pot, batch)
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t0) * 1e3, all_launches()

    out = {}
    for name, fn in (("elastic_tensor", elastic_tensor), ("force_constants", force_constants)):
        got, ms, launches = run(fn)
        batched = elastic._hessian
        elastic._hessian = row_loop_hessian
        try:
            rows, rows_ms, rows_launches = run(fn)
        finally:
            elastic._hessian = batched
        want = fn(cpu_pot, batch)
        err = check(f"{name} card vs CPU (f32)", torch.as_tensor(got), torch.as_tensor(want),
                    ELASTIC_TOL)
        check(f"{name} batched vs row by row (card)", torch.as_tensor(got),
              torch.as_tensor(rows), ELASTIC_TOL)
        print(f"  {name}: {ms:.1f} ms in one batched backward (row by row {rows_ms:.1f} ms); "
              f"launches {launches} (row by row {rows_launches})")
        second_order = ("q_scatter", "r1_gather", "r2_gather", "sorted_segment_sum")
        if not all(launches[k] for k in second_order):
            raise AssertionError(f"{name} did not run B1-B3 and B8 on the card: {launches}")
        if not np.isfinite(got).all():
            raise AssertionError(f"{name} is not finite")
        out[name] = {"ms": ms, "row_loop_ms": rows_ms, "max_abs_err": err,
                     "launches": launches, "row_loop_launches": rows_launches}
    out["force_constants_supercell"] = check_supercell_hessian(pot)
    return out


# Phase 8's supercell: the 4-atom cell 5x5x5 (500 atoms, 1,500 Hessian rows,
# so that one pass of every row would fold 96,000 feature rows into B8's
# grid, more than its y axis holds, and would need ~1,500 x one row's
# memory): the rows go in chunks (simulate.elastic.hessian_chunk).
SUPERCELL_REPS = (5, 5, 5)


def check_supercell_hessian(pot) -> dict:
    """``force_constants`` of the ``SUPERCELL_REPS`` supercell on the card
    in chunks of rows: timed (host clock to a synchronise), its peak device
    memory beside ``HESSIAN_CHUNK_BYTES``, its launches; the rows at the
    chunk bounds and the last row against the card's row-by-row loop
    (ELASTIC_TOL of the largest magnitude), finite, and the acoustic sum
    rule (each row sums to ~0 over the atoms)."""
    import torch

    from torch_m3gnet_tpu_torch.data import pack_structures
    from torch_m3gnet_tpu_torch.simulate import elastic, force_constants

    cell = elastic_cell().supercell(SUPERCELL_REPS)
    batch = pack_structures([cell], 5.0, 4.0, pad_multiple=64)
    n = len(cell)
    rows = 3 * n
    chunk = elastic.hessian_chunk(pot, batch.num_edges)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    fc = force_constants(pot, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = all_launches()
    if not all(launches[k] for k in ("q_scatter", "r1_gather", "r2_gather", "sorted_segment_sum")):
        raise AssertionError(f"the supercell's force constants did not run B1-B3 and B8: "
                             f"{launches}")
    got = torch.as_tensor(fc).reshape(rows, n, 3)
    pick = sorted({0, chunk - 1, chunk, rows - rows % chunk, rows - 1} & set(range(rows)))
    graph, energy = elastic._energy_fn(pot, batch)
    t0 = time.perf_counter()
    want = row_loop_hessian(lambda p: energy(p, graph.lattice), graph.positions, pick=pick)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    want = want[:, :n].reshape(len(pick), n, 3).cpu().double()
    err = check(f"force constants of {n} atoms, rows {pick} vs the row loop (card)",
                got[pick], want, ELASTIC_TOL)
    if not np.isfinite(fc).all():
        raise AssertionError("the supercell's force constants are not finite")
    sum_rule = float(got.sum(1).abs().max() / got.abs().max())
    if not sum_rule < 1e-3:
        raise AssertionError(f"acoustic sum rule: rows sum to {sum_rule:.3e} of the largest")
    passes = -(-rows // chunk)
    kernel = pot.model.edge_init.kernel  # (n_max, width)
    row_floats = peak_gb * 1e9 / (chunk * batch.num_edges * kernel.shape[-1]
                                  * pot.model.num_blocks * kernel.element_size())
    print(f"  force_constants, {n} atoms ({batch.num_edges} edges): {rows} rows in {passes} "
          f"batched passes of {chunk} rows, {ms:.1f} ms, peak {peak_gb:.2f} GB (budget "
          f"{elastic.HESSIAN_CHUNK_BYTES / 1e9:.2f} GB; {row_floats:.1f} floats a row for each "
          f"edge, unit and block, HESSIAN_ROW_FLOATS {elastic.HESSIAN_ROW_FLOATS}); launches "
          f"{launches}; {len(pick)} rows by the loop {loop_ms:.1f} ms; acoustic sum "
          f"{sum_rule:.2e} of the largest")
    return {"atoms": n, "edges": batch.num_edges, "rows": rows, "chunk": chunk, "passes": passes,
            "ms": ms, "peak_gb": peak_gb, "row_floats": row_floats, "launches": launches,
            "max_abs_err": err, "loop_rows": pick, "loop_ms": loop_ms, "acoustic_sum": sum_rule}


# ---------------------------------------------------------------------------
# Phase 9: the training workflow
# ---------------------------------------------------------------------------

# 96 training and 16 test cells, half 2x2x2 (32 atoms), half 3x3x3 (108).
WF_TRAIN, WF_TEST = 96, 16
# Each cell's isotropic volume strain is uniform in +-WF_VOLUME_STRAIN (on
# top of a 1 % shear and a 0.05 A jitter), and the teacher's energy scale is
# TEACHER_SCALE: the seeded teacher's energies barely depend on geometry (at
# scale 1, 0.034-0.036 eV/atom across +-5 % volume; forces ~2e-3 eV/A rms),
# so the labels' residual spread after the elemental fit, which becomes the
# student's energy scale, is 7.8e-3 eV with the shear alone and ~5e-2 with
# the strain. Scaled by 10 the spread is on the eV scale, the student's
# energy scale O(0.1-1), and its outputs are on the labels' scale: the
# losses see the weights (a 2-step run and one whose updates are skipped
# differ by ~40 %, the two modes' losses by ~2e-7; CPU rehearsal).
WF_VOLUME_STRAIN, TEACHER_SCALE = 0.05, 10.0
# MPF trajectories: frames per material id; stream shard size.
WF_FRAMES, WF_SHARD = 4, 16
# Card vs CPU for a 2-step train_model (f32 on both): the epoch's train loss
# and the test loss, as a fraction of the larger. The f32-vs-f64 CPU
# rehearsal of the same run (16 cells, the default model, CPU teacher
# labels) read 9.6e-10 apart. The losses hold the data path (batches,
# targets, masks, the elemental fit) and the weights: a control run whose
# updates are skipped (learning rate 0) must fail this tolerance. The step
# checks below hold the gradient and the update themselves.
WORKFLOW_TOL = 1e-5
# One Trainer step at phase 9's shapes, card vs CPU: the gradient the
# optimizer reads within TRAIN_TOL per tensor; the weights after the update
# within UPDATE_TOL x lr of the CPU's Adam given the card's gradient (the
# same update from the same inputs: f32 rounding of weights up to ~1.3 is
# ~1.2e-7 = 1.2e-4 lr; a step is at most lr). Control: r1_gather's output
# scaled by 1 + CONTROL_SCALE, a fault of one part in a thousand.
UPDATE_TOL = 1e-3
CONTROL_SCALE = 1e-3


def workflow_structures(n: int = WF_TRAIN + WF_TEST, seed: int = 2) -> list:
    """Perturbed, strained fcc-Cu cells, 2x2x2 and 3x3x3 in turn: an
    isotropic volume strain of up to WF_VOLUME_STRAIN and a 1 % shear. The
    strain is lower triangular, so each lattice is in the standard
    orientation a CIF's cell parameters rebuild (a along x, b in the xy
    plane)."""
    from torch_m3gnet_tpu_torch.data import Structure

    rng = np.random.default_rng(seed)
    base = Structure.from_frac_coords(
        np.eye(3) * 3.62, [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], [29] * 4)
    out = []
    for i in range(n):
        cell = base.supercell((2, 2, 2) if i % 2 == 0 else (3, 3, 3))
        iso = 1.0 + rng.uniform(-WF_VOLUME_STRAIN, WF_VOLUME_STRAIN)
        lattice = cell.lattice @ (iso * (np.eye(3) + np.tril(0.01 * rng.standard_normal((3, 3)))))
        cart = cell.frac_coords @ lattice + 0.05 * rng.standard_normal(cell.cart_coords.shape)
        out.append(Structure(lattice, cart, cell.atomic_numbers))
    return out


def label_structures(cfg, structures, device, chunk: int = 16) -> None:
    """E/F/S of a teacher (the same architecture, weights from seed 1,
    energy scale TEACHER_SCALE) as each structure's targets, in place."""
    import torch

    from torch_m3gnet_tpu_torch.data import pack_structures
    from torch_m3gnet_tpu_torch.models import build_model

    teacher = build_model(cfg, energy_scale=TEACHER_SCALE, device=device,
                          generator=torch.Generator().manual_seed(1))
    for lo in range(0, len(structures), chunk):
        part = structures[lo : lo + chunk]
        out = teacher(pack_structures(part, cfg.cutoff, cfg.threebody_cutoff, pad_multiple=128))
        e, f, s = (getattr(out, k).detach().cpu().double().numpy()
                   for k in ("energy", "forces", "stress"))
        offs = np.cumsum([0] + [len(x) for x in part])
        for j, x in enumerate(part):
            x.properties.update(energy=float(e[j]), forces=f[offs[j] : offs[j + 1]], stress=s[j])


def cif_of(s) -> str:
    """A P1 CIF of ``s`` as pymatgen writes one (cell parameters and the
    fractional atom_site loop)."""
    lengths = np.linalg.norm(s.lattice, axis=1)
    a1, a2, a3 = s.lattice

    def angle(u, v):
        return np.degrees(np.arccos(u @ v / np.linalg.norm(u) / np.linalg.norm(v)))

    head = [f"_cell_length_{k}   {x:.12f}" for k, x in zip("abc", lengths)]
    head += [f"_cell_angle_{k}   {x:.12f}" for k, x in
             zip(("alpha", "beta", "gamma"), (angle(a2, a3), angle(a1, a3), angle(a1, a2)))]
    rows = [f"  Cu  Cu{i}  1  {x:.12f}  {y:.12f}  {z:.12f}  1"
            for i, (x, y, z) in enumerate(s.frac_coords)]
    return "\n".join(["data_Cu", "_symmetry_space_group_name_H-M   'P 1'", *head, "loop_",
                      " _atom_site_type_symbol", " _atom_site_label",
                      " _atom_site_symmetry_multiplicity", " _atom_site_fract_x",
                      " _atom_site_fract_y", " _atom_site_fract_z", " _atom_site_occupancy",
                      *rows, ""])


def write_workflow_data(root, structures) -> tuple[str, str]:
    """The labelled cells as an mlearn set (``training.json``: the first
    WF_TRAIN, ``test.json``: the rest; stresses in kbar, VASP order) and as
    MPF block pickles (trajectories of WF_FRAMES frames per material id,
    CIF strings); returns their directories."""
    import os
    import pickle

    from torch_m3gnet_tpu_torch.data.io import KBAR_PER_EV_A3

    mlearn, mpf = os.path.join(root, "mlearn_Cu"), os.path.join(root, "mpf")
    os.makedirs(mlearn)
    os.makedirs(mpf)

    def record(s):
        p = s.properties
        return {"structure": {"lattice": {"matrix": s.lattice.tolist()},
                              "sites": [{"abc": f.tolist(), "species": [{"element": "Cu"}]}
                                        for f in s.frac_coords]},
                "outputs": {"energy": p["energy"], "forces": p["forces"].tolist(),
                            # model Voigt [xx,yy,zz,yz,zx,xy] -> VASP [xx,yy,zz,xy,yz,zx]
                            "virial_stress": (p["stress"][[0, 1, 2, 5, 3, 4]]
                                              * KBAR_PER_EV_A3).tolist()}}

    for name, part in (("training", structures[:WF_TRAIN]), ("test", structures[WF_TRAIN:])):
        with open(os.path.join(mlearn, f"{name}.json"), "w") as f:
            json.dump([record(s) for s in part], f)
    blocks: list[dict] = [{}, {}]
    for m in range(0, len(structures), WF_FRAMES):
        traj = structures[m : m + WF_FRAMES]
        blocks[(m // WF_FRAMES) % 2][f"mp-{1000 + m}"] = {
            "structure": [cif_of(s) for s in traj],
            "energy": [s.properties["energy"] for s in traj],
            "force": [s.properties["forces"] for s in traj],
            "stress": [KBAR_PER_EV_A3 * np.array([[v[0], v[5], v[4]], [v[5], v[1], v[3]],
                                                  [v[4], v[3], v[2]]])
                       for v in (s.properties["stress"] for s in traj)],
        }
    for i, block in enumerate(blocks):
        with open(os.path.join(mpf, f"block_{i}_cif.p"), "wb") as f:
            pickle.dump(block, f)
    return mlearn, mpf


def recording_trainer():
    """A Trainer that records the start of each train step and its batch's
    padded shape, and counts its eval steps; its instances in order."""
    from torch_m3gnet_tpu_torch.train import Trainer

    class RecordingTrainer(Trainer):
        instances: list = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.step_starts, self.step_shapes, self.evals = [], [], 0
            RecordingTrainer.instances.append(self)

        def train_step(self, batch, lr=None):
            self.step_starts.append(time.perf_counter())
            self.step_shapes.append((batch.num_nodes, batch.num_edges, batch.num_triplets))
            return super().train_step(batch, lr)

        def eval_step(self, batch):
            self.evals += 1
            return super().eval_step(batch)

    return RecordingTrainer


def cli_json(main, argv):
    """Run a CLI in process; the JSON it prints."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue())


def cli_metrics(main, argv) -> dict:
    """Run a training CLI in process; the test metrics it prints."""
    return cli_json(main, argv)["test"]


def workflow_run(label, fn, cfg, n_train) -> tuple[dict, object]:
    """Run ``fn()`` (a CLI or ``train_model``; it returns the test metrics)
    with the recording Trainer in ``train.run``, every launch count set to
    0 just before it: the launches must be those of its train and eval
    steps exactly. Returns the run's numbers and its trainer."""
    import torch

    from torch_m3gnet_tpu_torch.train import run

    cls, saved = recording_trainer(), run.Trainer
    run.Trainer = cls
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        test = fn()
        torch.cuda.synchronize()
    finally:
        run.Trainer = saved
    wall_s = time.perf_counter() - t0
    launches = all_launches()
    (trainer,) = cls.instances
    steps, evals = len(trainer.step_starts), trainer.evals
    mode = trainer.potential.model.threebody_mode
    per_train = expected_launches(mode, cfg.num_blocks, True)
    per_eval = expected_launches(mode, cfg.num_blocks, False)
    want = {k: steps * per_train[k] + evals * per_eval[k] for k in per_train}
    print(f"  {label}: {steps} train steps, {evals} eval steps, {wall_s:.1f} s; "
          f"launches {launches}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    rows = [json.loads(line) for line in
            open(f"{trainer.log_dir}/metrics.jsonl").read().splitlines()]
    epoch_s = [r["time"] for r in rows]
    per_epoch = steps // len(rows)
    periods = np.diff(trainer.step_starts[-per_epoch:])[2:] * 1e3
    if not all(np.isfinite(v) for v in test.values()):
        raise AssertionError(f"{label}: test metrics not finite: {test}")
    return {
        "wall_s": wall_s, "epoch_s": epoch_s, "train_steps": steps, "eval_steps": evals,
        "steps_per_s": per_epoch / epoch_s[-1], "structures_per_s": n_train / epoch_s[-1],
        "step_ms_median": float(np.median(periods)) if len(periods) else None,
        "train_loss": [r["train_loss"] for r in rows], "test_loss": test["loss"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
        "padded_shapes": sorted(set(trainer.step_shapes)),
    }, trainer


def check_restore(trainer, cfg, ckpt_dir, batch) -> None:
    """``last`` restored into a fresh potential: its evaluation of one test
    batch equals the trainer's bit for bit (deterministic algorithms, so
    that torch's ``index_add`` sums in one order)."""
    import torch

    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.train import Trainer

    path = f"{ckpt_dir}/last"
    meta = Trainer.load_meta(path)
    fresh = build_model(cfg, elemental_energies=meta["elemental_energies"],
                        energy_scale=meta["energy_scale"], device="cuda")
    fresh.load_state_dict(Trainer.load_params(path))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got, want = fresh(batch), trainer.potential(batch)
    finally:
        torch.use_deterministic_algorithms(False)
    for name in ("energy", "forces", "stress"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"restored {name} differs from the trainer's")
    print("  last checkpoint restored into a fresh potential: E, F, S of a test batch "
          "bitwise equal to the trainer's")


def prefetch_pair(cfg, graphs) -> dict:
    """One epoch with ``prefetch=2`` and one with ``prefetch=0`` from the same
    seeded weights and batch order, deterministic algorithms on: bitwise
    equal weights. Then, deterministic algorithms off, the step period
    (median after each epoch's first 2 steps) with ``prefetch`` 2 and 0 in
    turns (2, 0, 0, 2, twice; one epoch each); the device's busy share of
    one profiled epoch; the producer's host work per batch (assembly;
    checks, pinned copy and index to the event)."""
    import tempfile

    import torch

    from torch_m3gnet_tpu_torch.data import BucketSpec, batch_iterator
    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.train import prefetch

    bucket = BucketSpec.for_batches(graphs, cfg.batch_size, cfg.pad_multiple)

    def batches(seed):
        return lambda epoch: batch_iterator(graphs, cfg.batch_size, bucket,
                                            np.random.default_rng(seed))

    def epoch(pot, depth, seed):
        with tempfile.TemporaryDirectory() as logs:
            trainer = cls(pot, cfg, log_dir=logs, prefetch=depth)
            trainer.fit(batches(seed), max_epochs=1)
        torch.cuda.synchronize()
        return trainer

    cls = recording_trainer()
    weights = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for depth in (2, 0):
            pot = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
            epoch(pot, depth, 0)
            weights[depth] = {k: v.clone() for k, v in pot.state_dict().items()}
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(weights[0][k], weights[2][k]) for k in weights[0])
    print(f"  prefetch 2 vs 0, one epoch each, deterministic algorithms: weights bitwise "
          f"equal {same}")
    if not same:
        raise AssertionError("training with prefetch=2 and prefetch=0 gave different weights")
    turns = {2: [], 0: []}
    for depth in (2, 0, 0, 2) * 2:
        periods = np.diff(epoch(pot, depth, 3).step_starts)[2:] * 1e3
        turns[depth].append(float(np.median(periods)))
    step_ms = {d: float(np.median(t)) for d, t in turns.items()}
    print(f"  step period (median of each epoch), prefetch 2: {turns[2]} ms; prefetch 0: "
          f"{turns[0]} ms")

    with tempfile.TemporaryDirectory() as logs:
        trainer = cls(pot, cfg, log_dir=logs, prefetch=2)
        t0 = time.perf_counter()
        trainer.fit(batches(1), max_epochs=1)
        torch.cuda.synchronize()
        epoch_ms = (time.perf_counter() - t0) * 1e3
        trainer.epoch = 0
        profile = profile_step(lambda: trainer.fit(batches(1), max_epochs=1), epoch_ms, steps=1)

    assembly, to_card = [], []
    stream = torch.cuda.Stream()
    it = batches(2)(0)
    while True:
        t0 = time.perf_counter()
        b = next(it, None)
        if b is None:
            break
        t1 = time.perf_counter()
        _, event = prefetch._to_card(b, torch.device("cuda"), stream,
                                     torch.cuda.current_stream(), pot.model.batch_index)
        event.synchronize()
        assembly.append((t1 - t0) * 1e3)
        to_card.append((time.perf_counter() - t1) * 1e3)
    host = {"assembly_ms": statistics.median(assembly),
            "checks_copy_index_ms": statistics.median(to_card)}
    print(f"  profiled epoch: busy share {profile['busy_share']:.3f} of {epoch_ms:.0f} ms; "
          f"producer per batch {host}")
    return {"bitwise_equal": same, "step_ms_prefetch2": step_ms[2],
            "step_ms_prefetch0": step_ms[0], "turns_ms": {str(d): t for d, t in turns.items()},
            "epoch_ms": epoch_ms,
            "busy_share": profile["busy_share"],
            "device_busy_ms": profile["device_busy_ms_per_step"],
            "kernel_launches": profile["kernel_launches_per_step"], "producer": host}


def card_vs_cpu(cfg, train_graphs, test_graphs) -> dict:
    """A 2-step ``train_model`` (f32) on 16 cells, on the card and on the CPU
    with the same seeded weights: the epoch's train loss and the test loss
    within WORKFLOW_TOL (weights are not compared: Adam turns f32 noise in
    near-zero gradients into O(lr) weight differences). Control: the CPU run
    with its updates skipped (learning rate 0) must fail that tolerance, its
    test loss visibly higher: the losses see the weights."""
    import os
    import tempfile

    import torch

    from torch_m3gnet_tpu_torch.train.run import train_model

    out = {}
    for label, device, lr in (("cuda", "cuda", cfg.learning_rate),
                              ("cpu", "cpu", cfg.learning_rate), ("cpu_lr0", "cpu", 0.0)):
        with tempfile.TemporaryDirectory() as root:
            t0 = time.perf_counter()
            _, _, test = train_model(cfg.replace(root=root, accumulate_grad_batches=1,
                                                 learning_rate=lr),
                                     train_graphs, [], test_graphs, max_epochs=1,
                                     device=device)
            with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
                row = json.loads(f.read())
            out[label] = (torch.tensor([row["train_loss"], test["loss"]]),
                          time.perf_counter() - t0)
    print(f"  CPU runs: {out['cpu'][1]:.1f} s, {out['cpu_lr0'][1]:.1f} s")
    err = check("train_model train and test loss, card vs CPU (2 steps)", out["cuda"][0],
                out["cpu"][0], WORKFLOW_TOL)
    control = rel_err(out["cuda"][0], out["cpu_lr0"][0])[1]
    higher = bool(out["cpu_lr0"][0][1] > out["cuda"][0][1] * (1 + WORKFLOW_TOL))
    print(f"    control updates skipped (lr 0): {control:.3e} (tol {WORKFLOW_TOL:.0e}), test "
          f"loss {float(out['cpu_lr0'][0][1]):.4e} vs {float(out['cuda'][0][1]):.4e} "
          f"{'fails, as it must' if control > WORKFLOW_TOL and higher else 'PASSES'}")
    if not (control > WORKFLOW_TOL and higher):
        raise AssertionError(f"control with skipped updates passed the loss check: {control:.3e}")
    return {"losses_card": out["cuda"][0].tolist(), "losses_cpu": out["cpu"][0].tolist(),
            "max_abs_err": err, "losses_cpu_lr0": out["cpu_lr0"][0].tolist(),
            "control_lr0_rel": control}


def trainer_step(pot, cfg, batch) -> tuple[list, list, list, float]:
    """One ``Trainer`` step (no accumulation) on the host ``batch``: the
    weights before it, the gradient the optimizer read, the weights after
    it, and the step's loss."""
    from torch_m3gnet_tpu_torch.train import Trainer

    trainer = Trainer(pot, cfg.replace(accumulate_grad_batches=1))
    before = [p.detach().clone() for p in trainer.params]
    grads, step = [], trainer.optimizer.step

    def record(*args, **kwargs):
        grads.extend(p.grad.detach().clone() for p in trainer.params)
        return step(*args, **kwargs)

    trainer.optimizer.step = record
    loss = float(trainer.train_step(batch)["loss"])
    return before, grads, [p.detach().clone() for p in trainer.params], loss


def step_errors(cfg, cpu_grads, before, grads, after) -> tuple[float, float]:
    """(gradient error, update error) of a card step: each gradient against
    the CPU's, over its tensor's largest magnitude (the worst tensor); the
    weights after the step against the CPU's Adam given the same weights
    and gradient, over lr."""
    from torch_m3gnet_tpu_torch.train.loop import make_optimizer

    ref = [w.cpu().clone().requires_grad_(True) for w in before]
    opt = make_optimizer(ref, cfg)
    for p, g in zip(ref, grads):
        p.grad = g.cpu()
    opt.step()
    grad_err = max(rel_err(g.cpu(), c)[1] for g, c in zip(grads, cpu_grads))
    update_err = max(float((a.cpu().double() - r.detach().double()).abs().max())
                     for a, r in zip(after, ref)) / cfg.learning_rate
    return grad_err, update_err


def stage_vjp_vs_f64(src, offsets, num_nodes: int, l_max: int,
                     n_max: int) -> dict[str, float]:
    """The stage VJP of ``check_kernels`` on unmasked inputs, the kernels'
    and the plain version's (both f32) each against the plain version in
    f64, the worst of d_sh and d_gm relative to its largest magnitude: a
    reading of which f32 sum a padded batch's long run puts off."""
    import torch

    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs

    sh, gm, _ = stage_inputs(num_nodes, src.shape[0], l_max, n_max, src.device)

    def grads(q, r1, dtype):
        s, g = (x.to(dtype).clone().requires_grad_(True) for x in (sh, gm))
        proj = r1(q(s, g, src, num_nodes, l_max, n_max), s, src, l_max, n_max)
        return torch.autograd.grad(torch.sin(proj - g).sum(), (s, g))

    exact = grads(fs.q_scatter_plain, fs.r1_gather_plain, torch.float64)
    return {name: max(rel_err(got, want)[1]
                      for got, want in zip(grads(q, r1, torch.float32), exact))
            for name, q, r1 in (("kernel", *stage_kernels(offsets)),
                                ("plain_f32", fs.q_scatter_plain, fs.r1_gather_plain))}


def scaled_r_gather(r_forward, op: str, scale: float):
    """``factorized_stage._r_forward`` with ``op``'s output scaled: a kernel
    that is wrong by ``scale - 1``, for a control."""

    def wrong(name, *args):
        out = r_forward(name, *args)
        return out * scale if name == op else out

    return wrong


def workflow_step_checks(cfg, graphs, device: str = "cuda") -> dict:
    """Phase 9's shapes held where the losses cannot hold them: the bucket
    of batch 8 and the first batch of a 3-class ladder's smallest class.

    At each shape every kernel of the path against its plain version, as
    phase 3 does at the bench shape, with inputs zero where the model's are
    (padded edges and triplets: over a third of the bucket's edges are
    padding, all on one node, and an unmasked random sum there is a long
    f32 run whose rounding the VJPs' sin turns into phase errors; read at
    the bucket, unmasked, against f64). Then one ``Trainer`` step of the
    student as ``train_model`` builds it (the elemental fit and energy
    scale of ``graphs``, weights from ``cfg.seed``), on ``device`` against
    the CPU: factorized at both shapes, fused at the bucket. The loss within
    MODEL_TOL, the gradient the optimizer read within TRAIN_TOL, the update
    within UPDATE_TOL. Controls that must fail: the negated gradient, the
    update skipped (the weights as before) and (factorized bucket) a step
    whose r1_gather is off by CONTROL_SCALE. A step whose r2_gather is off
    by 1e-2 is read, not asserted: its only use is the forces' angular part."""
    import torch

    from torch_m3gnet_tpu_torch.data import BucketSpec, batch_iterator, to_torch
    from torch_m3gnet_tpu_torch.data.dataset import BucketLadder, ladder_batch_iterator
    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.ops import factorized_stage
    from torch_m3gnet_tpu_torch.train.elemental import fit_elemental_energies

    elemental, scale = fit_elemental_energies(graphs, cfg.num_types)
    bucket = BucketSpec.for_batches(graphs, cfg.batch_size, cfg.pad_multiple)
    ladder = BucketLadder.build(graphs, cfg.batch_size, 3, cfg.pad_multiple)
    batches = {"bucket": next(batch_iterator(graphs, cfg.batch_size, bucket)),
               "ladder class 0": next(ladder_batch_iterator(graphs, cfg.batch_size, ladder))}
    kernels = {}
    for where, batch in batches.items():
        print(f"  kernels vs plain at the {where} shape (N, E, T) = "
              f"{(batch.num_nodes, batch.num_edges, batch.num_triplets)}")
        gb = to_torch(batch, device, torch.float32)
        errs = check_kernels(gb.edge_src, gb.edge_src_offsets, gb.num_nodes, cfg.l_max,
                             cfg.n_max, gb.edge_mask)
        errs.update(check_triplet_kernels(gb, cfg.l_max * cfg.n_max, masked=True))
        errs["sorted_segment_sum"] = check_sorted_segment(gb, masked=True)
        kernels[where] = errs
    gb = to_torch(batches["bucket"], device, torch.float32)
    unmasked = stage_vjp_vs_f64(gb.edge_src, gb.edge_src_offsets, gb.num_nodes, cfg.l_max,
                                cfg.n_max)
    print(f"  stage VJP at the bucket, unmasked (read, not asserted): against f64, kernels "
          f"{unmasked['kernel']:.3e}, plain f32 {unmasked['plain_f32']:.3e}; padded edges "
          f"{gb.num_edges - int(gb.edge_mask.sum())} of {gb.num_edges}; most edges on one node "
          f"{int(torch.bincount(gb.edge_src.long()).max())}")
    print(f"  student energy scale {scale:.4e} eV (the labels' residual spread)")

    def fail(label, err, tol):
        print(f"    control {label}: {err:.3e} (tol {tol:.0e}) "
              f"{'fails, as it must' if err > tol else 'PASSES'}")
        if not err > tol:
            raise AssertionError(f"control {label} passed the check: {err:.3e} <= {tol:.0e}")
        return err

    def wrong_step(student, cfg_m, batch, op, by):
        saved = factorized_stage._r_forward
        factorized_stage._r_forward = scaled_r_gather(saved, op, 1 + by)
        try:
            return trainer_step(student(), cfg_m, batch)
        finally:
            factorized_stage._r_forward = saved

    out = []
    for mode, where in (("factorized", "bucket"), ("fused", "bucket"),
                        ("factorized", "ladder class 0")):
        cfg_m, batch = cfg.replace(threebody_mode=mode), batches[where]

        def student():
            return build_model(cfg_m, elemental_energies=list(map(float, elemental)),
                               energy_scale=scale, device=device,
                               generator=torch.Generator().manual_seed(cfg.seed))

        pot = student()
        cpu = build_model(cfg_m, elemental_energies=list(map(float, elemental)),
                          energy_scale=scale, device="cpu")
        cpu.load_state_dict(pot.state_dict())
        before, grads, after, loss = trainer_step(pot, cfg_m, batch)
        cpu_loss, cpu_grads = loss_and_grads(cpu, batch, cfg_m)
        cpu_grads = list(cpu_grads.values())
        del cpu
        label = f"{mode} step, {where}"
        check(f"{label}: loss vs CPU", torch.tensor([loss]), cpu_loss.reshape(1).double(),
              MODEL_TOL)
        grad_err, update_err = step_errors(cfg_m, cpu_grads, before, grads, after)
        ok = grad_err <= TRAIN_TOL and update_err <= UPDATE_TOL
        print(f"  {label}: gradient vs CPU {grad_err:.3e} (tol {TRAIN_TOL:.0e}), update vs "
              f"CPU Adam {update_err:.3e} lr (tol {UPDATE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: gradient {grad_err:.3e}, update {update_err:.3e}")
        row = {"mode": mode, "batch": where, "loss": loss, "loss_cpu": float(cpu_loss),
               "grad_err": grad_err, "update_err": update_err,
               "control_negated_grad": fail(
                   "negated gradient", step_errors(cfg_m, cpu_grads, before,
                                                   [-g for g in grads], after)[0], TRAIN_TOL),
               "control_skipped_update": fail(
                   "skipped update", step_errors(cfg_m, cpu_grads, before, grads, before)[1],
                   UPDATE_TOL)}
        if mode == "factorized" and where == "bucket":
            wrong = wrong_step(student, cfg_m, batch, "r1_gather", CONTROL_SCALE)
            row["control_r1_off"] = fail(f"r1_gather off by {CONTROL_SCALE:.0e}",
                                         step_errors(cfg_m, cpu_grads, *wrong[:3])[0], TRAIN_TOL)
            wrong = wrong_step(student, cfg_m, batch, "r2_gather", 1e-2)
            row["reading_r2_off_1e-2"] = step_errors(cfg_m, cpu_grads, *wrong[:3])[0]
            print(f"    r2_gather off by 1e-2 (read, not asserted): gradient "
                  f"{row['reading_r2_off_1e-2']:.3e}")
        out.append(row)
    return {"energy_scale": scale,
            "shapes": {w: [b.num_nodes, b.num_edges, b.num_triplets] for w, b in batches.items()},
            "kernels_max_abs_err": kernels, "stage_vjp_unmasked_vs_f64": unmasked,
            "steps": out}


def check_workflow(name, smi, keep: str | None = None) -> dict:
    """Phase 9: the training workflow on the card (see the module docstring).
    With ``keep`` (a directory), the mlearn run's ``best`` checkpoint and its
    sidecar are copied there."""
    import importlib
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from torch_m3gnet_tpu_torch.cli import train_mlearn, train_mpf
    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.data import BucketSpec, batch_iterator
    from torch_m3gnet_tpu_torch.data.dataset import GraphDataset, build_graphs
    from torch_m3gnet_tpu_torch.data.io import load_mlearn_json, load_mpf_pickles
    from torch_m3gnet_tpu_torch.data.streaming import StreamingGraphDataset, ladder_from_index
    from torch_m3gnet_tpu_torch.train.elemental import fit_elemental_energies
    from torch_m3gnet_tpu_torch.train.run import train_model

    configs = Path(__file__).resolve().parent / "configs"
    info = {"card": name, "nvidia_smi": smi}
    for module in ("yaml", "tensorboard"):
        try:
            importlib.import_module(module)
            info[f"{module}_imports"] = True
        except ImportError:
            info[f"{module}_imports"] = False
    print(f"  yaml imports: {info['yaml_imports']}; tensorboard imports: "
          f"{info['tensorboard_imports']}")
    cfg = M3GNetConfig.from_yaml(str(configs / "mlearn_Cu.yaml"))
    structures = workflow_structures()
    label_structures(cfg, structures, "cuda")
    t0 = time.perf_counter()
    graphs = list(build_graphs(structures, cfg.cutoff, cfg.threebody_cutoff))
    info["graph_build_s"] = time.perf_counter() - t0
    info["structures"] = len(structures)
    info["atoms"] = sum(len(s) for s in structures)
    per_atom = [s.properties["energy"] / len(s) for s in structures]
    info["labels"] = {
        "energy_scale": fit_elemental_energies(graphs[:WF_TRAIN], cfg.num_types)[1],
        "e_per_atom_ev": [min(per_atom), max(per_atom)],
        "force_rms_ev_a": float(np.sqrt(np.mean(np.concatenate(
            [s.properties["forces"].ravel() for s in structures]) ** 2))),
    }
    print(f"  labels (teacher scale {TEACHER_SCALE:g}, volume strain +-{WF_VOLUME_STRAIN:g}): "
          f"residual spread after the elemental fit (the student's energy scale) "
          f"{info['labels']['energy_scale']:.4e} eV; {info['labels']}")

    with tempfile.TemporaryDirectory() as tmp:
        mlearn, mpf = write_workflow_data(tmp, structures)
        t0 = time.perf_counter()
        ds = StreamingGraphDataset(structures, cfg.cutoff, cfg.threebody_cutoff,
                                   os.path.join(tmp, "shards"), shard_size=WF_SHARD)
        info["shard_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        read = sum(1 for _ in ds.iter_graphs(np.random.default_rng(0)))
        info["shard_read_s"] = time.perf_counter() - t0
        if read != len(structures):
            raise AssertionError(f"the stream yielded {read} of {len(structures)} graphs")
        print(f"  {len(structures)} cells ({info['atoms']} atoms): graphs {info['graph_build_s']:.2f} s; "
              f"{ds.n_shards} shards written {info['shard_write_s']:.2f} s, read "
              f"{info['shard_read_s']:.2f} s")
        runs = {}

        # The mlearn CLI (configs/mlearn_Cu.yaml), two epochs on the card.
        root = os.path.join(tmp, "run_mlearn")
        runs["train-mlearn"], trainer = workflow_run(
            "train-mlearn (CLI)", lambda: cli_metrics(train_mlearn.main, [
                "--path", mlearn, "--config", str(configs / "mlearn_Cu.yaml"), "--root", root,
                "--max-epochs", "2"]), cfg, WF_TRAIN)
        losses = runs["train-mlearn"]["train_loss"]
        ckpt = os.path.join(root, "checkpoints")
        files = set(os.listdir(ckpt))
        if not ({"best", "last", "best.meta.json", "last.meta.json"} <= files
                and len(losses) == 2 and losses[1] < losses[0]):
            raise AssertionError(f"mlearn run: checkpoints {sorted(files)}, train losses {losses}")
        print(f"  train loss by epoch {losses}; test loss {runs['train-mlearn']['test_loss']:.4e}")
        if keep is not None:  # for phases 10 and 11
            for f in ("best", "best.meta.json"):
                shutil.copy2(os.path.join(ckpt, f), keep)
            shutil.copytree(mlearn, os.path.join(keep, "mlearn_Cu"))
        test_graphs = GraphDataset(load_mlearn_json(os.path.join(mlearn, "test.json")),
                                   cfg.cutoff, cfg.threebody_cutoff,
                                   cache_dir=os.path.join(root, "cache"), name="test").graphs
        bucket = BucketSpec.for_batches(test_graphs, cfg.batch_size, cfg.pad_multiple)
        check_restore(trainer, cfg, ckpt, next(batch_iterator(test_graphs, cfg.batch_size,
                                                              bucket)))
        train_graphs = GraphDataset(load_mlearn_json(os.path.join(mlearn, "training.json")),
                                    cfg.cutoff, cfg.threebody_cutoff,
                                    cache_dir=os.path.join(root, "cache"), name="train").graphs

        # The MPF CLI, streaming (configs/mpf.yaml), one epoch.
        mpf_cfg = M3GNetConfig.from_yaml(str(configs / "mpf.yaml"))
        root = os.path.join(tmp, "run_mpf")
        splits = load_mpf_pickles([os.path.join(mpf, f"block_{i}_cif.p") for i in (0, 1)],
                                  mpf_cfg.val_ratio, mpf_cfg.test_ratio, mpf_cfg.seed)
        runs["train-mpf-stream"], _ = workflow_run(
            "train-mpf-stream (CLI)", lambda: cli_metrics(train_mpf.main, [
                "--path", mpf, "--config", str(configs / "mpf.yaml"), "--root", root,
                "--max-epochs", "1", "--shard-size", str(WF_SHARD)]), mpf_cfg, len(splits[0]))

        # The streaming ladder: train_model on the CLI's shard caches.
        streams = [StreamingGraphDataset(s, mpf_cfg.cutoff, mpf_cfg.threebody_cutoff,
                                         os.path.join(root, "cache"), name=n,
                                         shard_size=WF_SHARD)
                   for s, n in zip(splits, ("train", "val", "test"))]
        ladder_cfg = mpf_cfg.replace(root=os.path.join(tmp, "run_ladder"), bucket_classes=3)
        runs["train-ladder"], _ = workflow_run(
            "train-ladder (train_model, streaming)", lambda: train_model(
                ladder_cfg, *streams, max_epochs=1)[2], ladder_cfg, len(splits[0]))
        ladder = ladder_from_index(streams[0], mpf_cfg.batch_size, 3, mpf_cfg.pad_multiple)
        want = sorted((b.max_nodes, b.max_edges, b.max_triplets) for b in ladder.buckets)
        got = [tuple(s) for s in runs["train-ladder"]["padded_shapes"]]
        print(f"  ladder classes (N, E, T): {want}; trained on {got}")
        if got != want or len(got) != 3:
            raise AssertionError(f"ladder batches came in {got}, expected the 3 classes {want}")

        # The fused mode through the workflow (B4-B8), one epoch in memory.
        fused_cfg = cfg.replace(root=os.path.join(tmp, "run_fused"), threebody_mode="fused")
        runs["train-fused-workflow"], _ = workflow_run(
            "train-fused-workflow (train_model, in memory)", lambda: train_model(
                fused_cfg, train_graphs, test_graphs, test_graphs, max_epochs=1)[2],
            fused_cfg, WF_TRAIN)
    info["runs"] = runs

    info["prefetch"] = prefetch_pair(cfg, train_graphs)
    info["card_vs_cpu"] = card_vs_cpu(cfg, train_graphs[:16], test_graphs)
    info["step_checks"] = workflow_step_checks(cfg, train_graphs)
    return info


# ---------------------------------------------------------------------------
# Phase 10: the user CLIs and the committee, from phase 9's checkpoint
# ---------------------------------------------------------------------------

# FIRE with the cell on CLI_RELAX_GRAPHS bench cells for one rebuild window
# (the CLI relaxes in whole windows of 20 steps); NPT on the 32 bench cells
# for CLI_MD_STEPS steps with a rebuild every MD_REBUILD; NVE card vs CPU on
# CLI_NVE_GRAPHS cells for CLI_NVE_STEPS steps (cut from 20: a CPU step of 8
# cells takes ~0.7 s on the chip machine's host).
CLI_RELAX_GRAPHS, CLI_RELAX_STEPS = 8, 20
CLI_MD_STEPS, CLI_NVE_GRAPHS, CLI_NVE_STEPS = 20, 8, 5
# Card (f32) vs the port's numpy oracle (f64), total energy of a 108-atom
# bench cell, relative. f32 rounds the positions (6.6e-7 A at 11 A: ~1e-6 eV
# through forces of ~0.1 eV/A) and the sum of 108 scaled atomic energies
# (the elemental part, ~0.35 eV/atom, dominates: the sum's f32 ulp is
# ~4e-6 eV, a random walk of 108 roundings ~2e-5 eV); the three blocks' f32
# rounding of each atomic energy's model part (~1e-6 of ~0.02 eV) adds
# little. ~5e-7 of ~38 eV expected; the CPU rehearsal (f32 CPU model vs the
# oracle, the same cell) read 3e-8. Control: the readout's output kernel
# scaled by 1 + ORACLE_CONTROL moves each atomic energy's model part by 1e-3.
ORACLE_TOL, ORACLE_CONTROL = 2e-6, 1e-3
OUTPUT_FIELDS = ("energy", "forces", "stress", "energy_per_atom", "atomic_energy")


def write_cells_json(path, structures) -> str:
    """``structures`` as the CLIs' JSON input (cartesian coordinates)."""
    with open(path, "w") as f:
        json.dump([{"lattice": s.lattice.tolist(), "cart_coords": s.cart_coords.tolist(),
                    "atomic_numbers": s.atomic_numbers.tolist()} for s in structures], f)
    return str(path)


def counted_cli(label, main, argv, nb: int, mode: str = "factorized", evals=None):
    """Run a CLI on the card with every launch count set to 0 just before
    it; the launches just after must be ``evals`` evaluations' of ``mode``
    (``None``: a whole number of them, at least one). Returns (its JSON,
    launches, evaluations, wall s)."""
    import torch

    per_eval = expected_launches(mode, nb, False)
    reset_launches()
    t0 = time.perf_counter()
    out = cli_json(main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    key = "q_scatter" if mode == "factorized" else "fused_triplet_gate_sum"
    n = launches[key] // per_eval[key] if evals is None else evals
    print(f"  {label}: {wall:.2f} s; launches {launches} = {n} evaluations")
    if n < 1 or launches != {k: v * n for k, v in per_eval.items()}:
        raise AssertionError(f"{label}: launches {launches}, expected {per_eval} x {n}")
    return out, launches, n, wall


def predict_fields(out) -> dict:
    """The predict CLI's per-structure output as f64 tensors."""
    import torch

    return {"energy": torch.tensor([r["energy"] for r in out], dtype=torch.float64),
            "forces": torch.tensor([f for r in out for f in r["forces"]], dtype=torch.float64),
            "stress": torch.tensor([r["stress_voigt"] for r in out], dtype=torch.float64)}


def check_predict(cells, configs, ckpt, nb):
    """The predict CLI on the 32 bench cells in one batch, on the card in
    both three-body modes (one evaluation's launches each; each run twice,
    the second warm) and on the CPU: card vs CPU within MODEL_TOL, fused vs
    factorized within MODE_TOL. Returns its numbers and the card's
    (factorized) energies."""
    from torch_m3gnet_tpu_torch.cli import predict

    args = ["--structures", cells, "--checkpoint", ckpt, "--batch-size", str(N_GRAPHS)]
    runs, out = {}, {}
    for mode in ("factorized", "fused"):
        argv = [*args, "--config", configs[mode], "--device", "cuda"]
        walls = []
        for turn in ("", ", again"):
            out[mode], launches, _, wall = counted_cli(f"predict ({mode}{turn})", predict.main,
                                                       argv, nb, mode, evals=1)
            walls.append(wall)
        runs[mode] = {"wall_s": walls, "ms_per_batch": walls[-1] * 1e3,
                      "structures_per_s": N_GRAPHS / walls[-1], "launches": launches}
    t0 = time.perf_counter()
    cpu = cli_json(predict.main, [*args, "--config", configs["factorized"], "--device", "cpu"])
    print(f"  predict on the CPU: {time.perf_counter() - t0:.1f} s")
    got, fused, want = (predict_fields(x) for x in (out["factorized"], out["fused"], cpu))
    errs = {k: check(f"predict {k}, card vs CPU", got[k], want[k], MODEL_TOL) for k in want}
    for k in want:
        check(f"predict {k}, fused vs factorized (card)", fused[k], got[k], MODE_TOL)
    return {"runs": runs, "card_vs_cpu_max_abs_err": errs,
            "energy_ev": got["energy"][:4].tolist()}, got["energy"]


def check_oracle(cfg, ckpt, structures, card_energy) -> dict:
    """The card's energies (predict, factorized) of two bench cells against
    the port's numpy oracle at f64 on the checkpoint's weights and sidecar,
    within ORACLE_TOL; the oracle with one weight off by ORACLE_CONTROL must
    fail."""
    from torch_m3gnet_tpu_torch.data import graph_from_structure
    from torch_m3gnet_tpu_torch.models import flax_from_params
    from torch_m3gnet_tpu_torch.train import Trainer
    from torch_m3gnet_tpu_torch.utils.oracle import reference_energy_numpy

    meta = Trainer.load_meta(ckpt)
    elemental, scale = np.asarray(meta["elemental_energies"]), meta["energy_scale"]
    params = flax_from_params(Trainer.load_params(ckpt))
    out_layer = params["readout"]["dense_2"]
    wrong = {**params, "readout": {**params["readout"], "dense_2": {
        **out_layer, "kernel": out_layer["kernel"] * (1 + ORACLE_CONTROL)}}}
    rows = []
    for i in range(2):
        g = graph_from_structure(structures[i], cfg.cutoff, cfg.threebody_cutoff, dtype=np.float64)
        t0 = time.perf_counter()
        want = reference_energy_numpy(params, g, cfg, elemental, scale)
        oracle_s = time.perf_counter() - t0
        control = reference_energy_numpy(wrong, g, cfg, elemental, scale)
        got = float(card_energy[i])
        rel, rel_control = abs(got - want) / abs(want), abs(got - control) / abs(control)
        ok = rel <= ORACLE_TOL < rel_control
        print(f"  cell {i}: card {got:.8f} eV, oracle (f64) {want:.8f} eV: rel {rel:.3e} "
              f"(tol {ORACLE_TOL:.0e}); control (readout kernel x (1 + {ORACLE_CONTROL:g})) "
              f"{rel_control:.3e} {'fails, as it must' if rel_control > ORACLE_TOL else 'PASSES'}"
              f"; oracle {oracle_s:.2f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"oracle check of cell {i}: {rel:.3e}, control {rel_control:.3e}")
        rows.append({"card_ev": got, "oracle_ev": want, "rel_err": rel,
                     "control_rel": rel_control, "oracle_s": oracle_s})
    return {"energy_scale": scale, "cells": rows}


# The committee's mean and std against those of K single evaluations of its
# members, per field, as a fraction of the largest magnitude of that field in
# the K evaluations (f32). The vmapped dense layers run as batched matrix
# products, whose bits need not equal K separate ones (another blocking of
# the same sums); every kernel's member axis is bitwise (phase 3). So each
# member's outputs move by a few f32 ulp of the field's scale, and so do
# the mean and the std computed from them (the std of energies of ~300 eV
# that differ by ~1 eV inherits the ulp of 300 eV, not of 1 eV).
ENSEMBLE_TOL = 1e-6


def check_ensemble(name, smi, cfg, ckpt, gbatch, nb) -> dict:
    """K = MEMBERS members (the checkpoint and seeded weights 1, 2) on
    the bench batch, one ``torch.func.vmap`` over the members, in the
    factorized and the fused mode: launches exactly one evaluation's in
    either mode (B1-B5 on their member axis, B6-B8 with the members' rows
    folded); mean and std within ENSEMBLE_TOL of the largest
    magnitude of each field in K single evaluations (K potentials, each
    loaded with one member) of theirs; a one-member committee has std exactly 0. Then
    each committee's time against those K single evaluations (host clock to
    a synchronise, median of 5), both profiled (device busy ms, CUDA
    kernels a call), and its peak device memory beside one evaluation's."""
    import torch

    from torch_m3gnet_tpu_torch.models import EnsemblePotential, build_model, stack_params
    from torch_m3gnet_tpu_torch.train import Trainer

    meta = Trainer.load_meta(ckpt)
    members = [{k: v.cuda() for k, v in Trainer.load_params(ckpt).items()}]
    members += [build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(seed))
                .state_dict() for seed in range(1, MEMBERS)]
    stacked = stack_params(members)

    def timed(fn, reps=5):
        walls = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls[1:])

    def peak_gb(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    out = {"k": MEMBERS, "card": name, "nvidia_smi": smi, "tol": ENSEMBLE_TOL}
    for mode in ("factorized", "fused"):
        pots = []
        for sd in members:
            pots.append(build_model(dataclasses.replace(cfg, threebody_mode=mode),
                                    elemental_energies=meta["elemental_energies"],
                                    energy_scale=meta["energy_scale"], device="cuda"))
            pots[-1].load_state_dict(sd)
        ens = EnsemblePotential(pots[0])
        expected = expected_launches(mode, nb, False)
        reset_launches()
        mean, std = ens.apply(stacked, gbatch)
        torch.cuda.synchronize()
        launches = all_launches()
        print(f"  committee of {MEMBERS} ({mode}): launches {launches}")
        if launches != expected:
            raise AssertionError(f"committee launches ({mode}) {launches}, expected {expected}")
        singles = [p(gbatch) for p in pots]
        _, std1 = ens.apply(stack_params(members[:1]), gbatch)
        errs = {}
        for f in OUTPUT_FIELDS:
            x = torch.stack([getattr(o, f).detach() for o in singles])
            scale = float(x.abs().max())
            errs[f] = []
            for label, got, want in (("mean", mean, x.mean(0)),
                                     ("std", std, x.std(0, correction=0))):
                err = float((getattr(got, f) - want).abs().max())
                ok = err <= ENSEMBLE_TOL * scale
                print(f"  committee {label} {f} ({mode}) vs {MEMBERS} single evals: "
                      f"max_abs_err={err:.3e}, {err / scale:.3e} of the field's largest "
                      f"magnitude {scale:.3e}, tol={ENSEMBLE_TOL:.0e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"committee {label} {f} ({mode}): {err:.3e} above "
                                         f"{ENSEMBLE_TOL:.0e} x {scale:.3e}")
                errs[f].append(err)
            if not (getattr(std1, f) == 0).all():
                raise AssertionError(f"a one-member committee has a nonzero std of {f}")
        e_std = std.energy[: N_GRAPHS]
        ens_ms = timed(lambda: ens.apply(stacked, gbatch))
        singles_ms = timed(lambda: [p(gbatch) for p in pots])
        gb = {"committee": peak_gb(lambda: ens.apply(stacked, gbatch)),
              "one_eval": peak_gb(lambda: pots[0](gbatch))}

        # device busy ms and CUDA kernels of one call (profiler, 2 calls)
        prof = {label: {k: v for k, v in profile_step(fn, ms, steps=2).items()
                        if k in ("device_busy_ms_per_step", "kernel_launches_per_step")}
                for label, fn, ms in (("committee", lambda: ens.apply(stacked, gbatch), ens_ms),
                                      ("k_single_evals", lambda: [p(gbatch) for p in pots],
                                       singles_ms))}
        print(f"  {mode}: K = 1 std exactly 0; energy std per cell "
              f"{float(e_std.min()):.4e}-{float(e_std.max()):.4e} eV; committee eval "
              f"{ens_ms:.2f} ms, {MEMBERS} single evals {singles_ms:.2f} ms; peak "
              f"{gb['committee']:.2f} GB (one eval {gb['one_eval']:.2f} GB); profiled {prof} "
              f"| {name} | {smi}")

        out[mode] = {"launches": launches, "ensemble_ms": ens_ms, "k_single_evals_ms": singles_ms,
                     "peak_gb": gb, "profile": prof, "max_abs_err": errs,
                     "energy_std_ev": [float(e_std.min()), float(e_std.max())]}
        del pots, ens, mean, std, singles
    return out


def check_relax_cli(cells, config, ckpt, nb) -> dict:
    """The relax CLI, FIRE with the cell, on the card (launches: whole
    evaluations) and on the CPU: final energies, largest forces and
    positions within MD_TOL of the largest magnitude."""
    import torch

    from torch_m3gnet_tpu_torch.cli import relax

    argv = ["--structures", cells, "--config", config, "--checkpoint", ckpt, "--relax-cell",
            "--max-steps", str(CLI_RELAX_STEPS), "--fmax", "1e-6"]
    card, launches, evals, wall = counted_cli("relax (FIRE + cell)", relax.main,
                                              [*argv, "--device", "cuda"], nb)
    t0 = time.perf_counter()
    cpu = cli_json(relax.main, [*argv, "--device", "cpu"])
    print(f"  relax on the CPU: {time.perf_counter() - t0:.1f} s")
    errs = {}
    for key in ("energy", "fmax", "cart_coords"):
        got, want = (torch.tensor([r[key] for r in x], dtype=torch.float64) for x in (card, cpu))
        errs[key] = check(f"relax {key}, card vs CPU", got, want, MD_TOL)
    return {"graphs": len(card), "steps": CLI_RELAX_STEPS, "evaluations": evals, "wall_s": wall,
            "ms_per_step": wall * 1e3 / CLI_RELAX_STEPS, "card_vs_cpu_max_abs_err": errs,
            "energy_ev_sum": sum(r["energy"] for r in card)}


def read_extxyz_lattices(path) -> np.ndarray:
    """The (frames, 3, 3) ``Lattice`` of each frame of an extended XYZ file."""
    with open(path) as f:
        return np.array([np.array(line.split('"')[1].split(), dtype=float).reshape(3, 3)
                         for line in f if line.startswith("Lattice=")])


def check_md_cli(cells, cells_nve, structures, config, ckpt, nb, tmp) -> dict:
    """The md CLI: NPT on the bench cells with ``--traj-out`` on the card
    (launches: CLI_MD_STEPS + rebuilds evaluations), each cell's frames one
    per step with cells (V_t / V_0)^(1/3) x the initial one from the printed
    volume log; then NVE on the card and on the CPU, energies and final
    positions within MD_TOL."""
    import os

    import torch

    from torch_m3gnet_tpu_torch.cli import md

    common = ["--config", config, "--checkpoint", ckpt, "--rebuild-every", str(MD_REBUILD)]
    traj = os.path.join(tmp, "traj")
    rebuilds = -(-CLI_MD_STEPS // MD_REBUILD)
    npt, launches, _, wall = counted_cli(
        "md (NPT, --traj-out)", md.main,
        ["--structures", cells, *common, "--ensemble", "npt", "--steps", str(CLI_MD_STEPS),
         "--tau-p", "100", "--traj-out", traj, "--device", "cuda"], nb,
        evals=CLI_MD_STEPS + rebuilds)
    volumes = np.asarray(npt["volume_a3"])
    frames_err = 0.0
    for i, s in enumerate(structures):
        lattices = read_extxyz_lattices(f"{traj}.{i}.extxyz")
        want = s.lattice[None] * ((volumes[:, i] / s.volume) ** (1 / 3))[:, None, None]
        if lattices.shape != (CLI_MD_STEPS, 3, 3):
            raise AssertionError(f"cell {i}: frames {lattices.shape}")
        frames_err = max(frames_err, float(np.abs(lattices - want).max() / np.abs(want).max()))
    if frames_err > 1e-8 or np.allclose(volumes, volumes[:1]):
        raise AssertionError(f"NPT frames' cells off the volume log by {frames_err:.3e}")
    print(f"  NPT: {len(structures)} x {CLI_MD_STEPS} frames, cells within {frames_err:.1e} of "
          f"the volume log (volumes {volumes.min():.3f}-{volumes.max():.3f} A^3)")
    nve = ["--structures", cells_nve, *common, "--ensemble", "nve", "--steps", str(CLI_NVE_STEPS)]
    card, _, _, nve_wall = counted_cli("md (NVE)", md.main, [*nve, "--device", "cuda"], nb)
    t0 = time.perf_counter()
    cpu = cli_json(md.main, [*nve, "--device", "cpu"])
    print(f"  md (NVE) on the CPU: {time.perf_counter() - t0:.1f} s")
    errs = {}
    for key in ("potential_energy_ev", "kinetic_energy_ev"):
        errs[key] = check(f"md NVE {key}, card vs CPU", torch.tensor(card[key]),
                          torch.tensor(cpu[key]), MD_TOL)
    got, want = (torch.tensor([s["cart_coords"] for s in x["structures"]]) for x in (card, cpu))
    errs["positions"] = check("md NVE final positions, card vs CPU", got, want, MD_TOL)
    return {"npt_graphs": len(structures), "npt_steps": CLI_MD_STEPS, "npt_rebuilds": rebuilds,
            "npt_wall_s": wall, "npt_ms_per_step": wall * 1e3 / CLI_MD_STEPS,
            "npt_frames_rel_err": frames_err, "npt_launches": launches,
            "nve_graphs": CLI_NVE_GRAPHS, "nve_steps": CLI_NVE_STEPS, "nve_wall_s": nve_wall,
            "nve_card_vs_cpu_max_abs_err": errs}


def check_elastic_cli(config, ckpt, nb, tmp) -> dict:
    """The elastic CLI with ``--eos`` on a perturbed 4-atom Cu cell (phase
    8's) on the card (B1-B3 and B8 launched in its double backward) and on
    the CPU: the elastic matrix and the Gamma eigenvalues sign(f) f^2 within
    ELASTIC_TOL, the E(V) curve within MODEL_TOL."""
    import os

    import torch

    from torch_m3gnet_tpu_torch.cli import elastic

    path = write_cells_json(os.path.join(tmp, "elastic.json"), [elastic_cell()])
    argv = ["--structure", path, "--config", config, "--checkpoint", ckpt, "--eos"]
    reset_launches()
    t0 = time.perf_counter()
    card = cli_json(elastic.main, [*argv, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    print(f"  elastic --eos (card): {wall:.2f} s; launches {launches}")
    if not all(launches[k] for k in ("q_scatter", "r1_gather", "r2_gather", "sorted_segment_sum")):
        raise AssertionError(f"elastic did not run B1-B3 and B8 on the card: {launches}")
    t0 = time.perf_counter()
    cpu = cli_json(elastic.main, [*argv, "--device", "cpu"])
    print(f"  elastic --eos on the CPU: {time.perf_counter() - t0:.1f} s")

    def eig(x):
        f = torch.tensor(x["gamma_frequencies_thz"], dtype=torch.float64)
        return torch.sign(f) * f**2

    errs = {"elastic_gpa": check("elastic matrix, card vs CPU",
                                 torch.tensor(card["elastic_gpa"]),
                                 torch.tensor(cpu["elastic_gpa"]), ELASTIC_TOL),
            "gamma_eigenvalues": check("Gamma eigenvalues sign(f) f^2, card vs CPU", eig(card),
                                       eig(cpu), ELASTIC_TOL),
            "eos_energies_ev": check("E(V), card vs CPU", torch.tensor(card["eos_energies_ev"]),
                                     torch.tensor(cpu["eos_energies_ev"]), MODEL_TOL)}
    print(f"  bulk modulus (Voigt) card {card['bulk_modulus_voigt_gpa']} GPa, CPU "
          f"{cpu['bulk_modulus_voigt_gpa']}; Birch-Murnaghan card {card['birch_murnaghan']}, "
          f"CPU {cpu['birch_murnaghan']}")
    return {"wall_s": wall, "launches": launches, "card_vs_cpu_max_abs_err": errs,
            "bulk_modulus_voigt_gpa": card["bulk_modulus_voigt_gpa"],
            "birch_murnaghan": card["birch_murnaghan"]}


def check_cli(name, smi, ckpt, gbatch) -> dict:
    """Phase 10 (see the module docstring); returns the ``cli`` line."""
    import os
    import tempfile
    from pathlib import Path

    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.train import Trainer

    config = str(Path(__file__).resolve().parent / "configs" / "mlearn_Cu.yaml")
    cfg = M3GNetConfig.from_yaml(config)
    structures = bench_structures()
    n_params = sum(v.numel() for v in Trainer.load_params(ckpt).values())
    if n_params != N_PARAMS:
        raise AssertionError(f"the checkpoint holds {n_params} parameters, expected {N_PARAMS}")
    info = {"card": name, "nvidia_smi": smi, "checkpoint_params": n_params,
            "cuts": {"relax_steps": f"{CLI_RELAX_STEPS} (one rebuild window)",
                     "nve_vs_cpu": f"{CLI_NVE_GRAPHS} cells x {CLI_NVE_STEPS} steps (from 20)"}}
    with tempfile.TemporaryDirectory() as tmp:
        fused = os.path.join(tmp, "mlearn_Cu_fused.yaml")
        with open(config) as src, open(fused, "w") as dst:
            dst.write(src.read() + "\nthreebody_mode: fused\n")
        cells = write_cells_json(os.path.join(tmp, "bench.json"), structures)
        few = write_cells_json(os.path.join(tmp, "bench8.json"), structures[:CLI_RELAX_GRAPHS])
        print("  -- predict")
        info["predict"], energy = check_predict(cells, {"factorized": config, "fused": fused},
                                                ckpt, cfg.num_blocks)
        print("  -- oracle")
        info["oracle"] = check_oracle(cfg, ckpt, structures, energy)
        print("  -- committee")
        info["ensemble"] = check_ensemble(name, smi, cfg, ckpt, gbatch, cfg.num_blocks)
        print("  -- relax")
        info["relax"] = check_relax_cli(few, config, ckpt, cfg.num_blocks)
        print("  -- md")
        info["md"] = check_md_cli(cells, few, structures, config, ckpt, cfg.num_blocks, tmp)
        print("  -- elastic")
        info["elastic"] = check_elastic_cli(config, ckpt, cfg.num_blocks, tmp)
    return info


# ---------------------------------------------------------------------------
# Phase 11: data and graph parallelism, two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

# The ranks of phase 11 share one card (NCCL refuses two ranks on one GPU),
# so their collectives run over gloo, which stages CUDA tensors through the
# host: its times are correctness numbers, not scaling numbers.
PAR_RANKS, PAR_DEVICE, PAR_BACKEND, PAR_TIMEOUT_S = 2, "cuda:0", "gloo", 300
# The gp cell: a 10x10x10 fcc-Cu supercell (4,000 atoms, a = 3.62 A) with
# Gaussian displacements of GP_JITTER A from GP_SEED, labelled by phase 9's
# teacher, reordered along its longest axis and cut into PAR_RANKS slabs.
GP_REPS, GP_JITTER, GP_SEED = 10, 0.05, 3
# dp: phase 9's first DP_PER_RANK * PAR_RANKS mlearn training cells as one
# global batch, then DP_TAIL more as a tail that leaves rank 1 fully padded.
DP_PER_RANK, DP_TAIL = 4, 3


def gp_cell(reps: int = GP_REPS, seed: int = GP_SEED, device: str = "cuda", cfg=None):
    """The gp cell (``reps`` fcc cells a side, jitter from ``seed``),
    labelled by the teacher (``cfg``'s architecture, default the default
    model's) on ``device`` (its targets)."""
    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.data import Structure

    rng = np.random.default_rng(seed)
    base = Structure.from_frac_coords(
        np.eye(3) * 3.62, [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]],
        [29] * 4).supercell((reps,) * 3)
    cell = Structure(base.lattice, base.cart_coords + GP_JITTER * rng.standard_normal(
        base.cart_coords.shape), base.atomic_numbers)
    label_structures(cfg or M3GNetConfig(), [cell], device)
    return cell


def synchronize() -> None:
    """Wait for the card, where this process uses one (a CPU rehearsal of
    the rank code has none)."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def rank_times(step, reps: int = 5) -> float:
    """Median host ms of ``step()`` to its synchronise, after one warm-up
    (every rank calls it: the step's collectives pair the ranks up)."""
    step()
    synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def flat_grads(loss, params):
    import torch

    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def host_efs(out) -> dict:
    """E/F/S of a ``PotentialOutput`` as host arrays (they cross processes)."""
    return {f: getattr(out, f).detach().cpu().numpy() for f in ("energy", "forces", "stress")}


def recording(trainer_cls):
    """``trainer_cls`` that keeps the gradient it hands the optimizer
    (``grads``)."""

    class Recording(trainer_cls):
        def apply_gradients(self, grads):
            self.grads = [g.detach().clone() for g in grads]
            super().apply_gradients(grads)

    return Recording


def gp_step(trainer, batch, device, reps: int = 3) -> dict:
    """One step of a recording ``GraphParallelTrainer`` on ``batch``
    (every rank calls it): whether the weights after it are bitwise equal
    on every rank; on rank 0 the loss, the weights before and after it and
    the gradient the optimizer read (host arrays); then the step's ms
    (``rank_times``) on the shard already on ``device``."""
    import torch
    import torch.distributed as dist

    before = [p.detach().cpu().numpy().copy() for p in trainer.params]
    loss = float(trainer.train_step(batch, trainer.config.learning_rate)["loss"])
    flat = torch.cat([p.detach().reshape(-1) for p in trainer.params])
    every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(every, flat)
    out = {"weights_bitwise_equal_across_ranks": all(torch.equal(every[0], f) for f in every)}
    if dist.get_rank() == 0:
        out.update(loss=loss, before=before, grads=[g.cpu().numpy() for g in trainer.grads],
                   after=[p.detach().cpu().numpy().copy() for p in trainer.params])
    card = trainer.gp.to_device(batch, device, index=trainer.potential.model.batch_index)
    out["step_ms"] = rank_times(lambda: trainer.train_step(card), reps=reps)
    return out


def one_device_step(cfg, batch, device) -> dict:
    """The seed-0 model's ``Trainer`` step on the whole graph ``batch`` on
    ``device``: the reference of a gp step (``check_gp_step``)."""
    import torch

    from torch_m3gnet_tpu_torch.models import build_model

    pot = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    before, grads, _, loss = trainer_step(pot, cfg, batch)
    return {"cfg": cfg, "loss": loss, "before": [b.cpu() for b in before],
            "grads": [g.cpu() for g in grads]}


def check_gp_step(label: str, got: dict, ref: dict, equal: list, controls=None) -> dict:
    """A gp train step (``gp_step``: rank 0's ``got``, every rank's bitwise
    flag in ``equal``) against the one-device step ``ref``
    (``one_device_step``, or the mean of several): the same start, the loss
    within ``MODEL_TOL``, the gradient the optimizer read within
    ``TRAIN_TOL``, the update within ``UPDATE_TOL`` of Adam given that
    gradient, the weights bitwise equal on every rank; each gradient of
    ``controls`` (name -> gradient) must fail the gradient check."""
    import torch

    def host(xs):
        return [torch.as_tensor(np.asarray(x)) for x in xs]

    before, grads, after = host(got["before"]), host(got["grads"]), host(got["after"])
    same_start = all(torch.equal(b, torch.as_tensor(np.asarray(w)))
                     for b, w in zip(before, ref["before"]))
    grad_err, update_err = step_errors(ref["cfg"], host(ref["grads"]), before, grads, after)
    loss_err = abs(got["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-30)
    control = {name: step_errors(ref["cfg"], host(c), before, grads, after)[0]
               for name, c in (controls or {}).items()}
    print(f"  {label}: loss {got['loss']:.6e} vs one device {ref['loss']:.6e} (rel "
          f"{loss_err:.3e}), worst gradient rel {grad_err:.3e} tol {TRAIN_TOL:.0e}, update "
          f"{update_err:.3e} lr tol {UPDATE_TOL:.0e}; same start {same_start}; weights bitwise "
          f"equal across ranks {equal}" + "".join(f"; control ({k}) gradient rel {v:.3e}"
                                                   for k, v in control.items()))
    if not (same_start and loss_err <= MODEL_TOL and grad_err <= TRAIN_TOL
            and update_err <= UPDATE_TOL and all(equal)):
        raise AssertionError(f"{label}: loss {loss_err:.3e}, gradient {grad_err:.3e}, update "
                             f"{update_err:.3e}, same start {same_start}, bitwise {equal}")
    passed = [k for k, v in control.items() if v <= TRAIN_TOL]
    if passed:
        raise AssertionError(f"{label}: the controls {passed} passed the gradient check")
    return {"loss": got["loss"], "one_device_loss": ref["loss"], "loss_rel_err": loss_err,
            "grad_rel_err": grad_err, "update_err_lr": update_err,
            "weights_bitwise_equal_across_ranks": equal,
            **({"control_grad_rel_err": control} if control else {})}


def dp_gp_reference(steps: list) -> tuple:
    """The dp x gp step's one-device reference from each dp row's
    ``one_device_step``: the mean of their losses and gradients; and its
    controls, which must fail the gradient check: the first row's gradient
    alone (a dp row dropped), and the sum of the rows' in place of their
    mean."""
    mean = {**steps[0], "loss": sum(s["loss"] for s in steps) / len(steps),
            "grads": [sum(g) / len(steps) for g in zip(*(s["grads"] for s in steps))]}
    return mean, {"first_row_alone": steps[0]["grads"],
                  "sum_of_rows": [sum(g) for g in zip(*(s["grads"] for s in steps))]}


def dp_gp_rank(inputs: dict) -> dict:
    """dp x gp on one rank of a 2 x 2 ("dp", "gp") mesh (see
    ``check_dp_gp``), the default model (seed 0) on ``inputs["device"]``:
    the gp eval of its dp row (launches, E/F/S on gp rank 0, ms), then one
    ``GraphParallelTrainer(..., dp_axis="dp")`` step over both rows
    (``gp_step``), the trainer's ``eval_loss`` (no grad) before it.
    ``inputs["batch"]``: both rows' partitions stacked
    (``stack_partitions``), or this rank's shard."""
    import torch

    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.parallel import GraphParallelPotential, GraphParallelTrainer
    from torch_m3gnet_tpu_torch.parallel import make_mesh

    device, cfg, batch = torch.device(inputs["device"]), inputs["config"], inputs["batch"]
    mesh = make_mesh((2, 2), ("dp", "gp"), device.type, device=device)
    pot = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    gp = GraphParallelPotential(pot, mesh, "gp")
    cuda = device.type == "cuda"
    reset_launches()
    res = gp.apply(batch)
    synchronize()
    out = {"dp_row": mesh.get_local_rank("dp"), "gp_rank": mesh.get_local_rank("gp"),
           "launches": all_launches() if cuda else None,
           "expected": expected_launches(pot.model.threebody_mode, cfg.num_blocks, False)}
    if out["gp_rank"] == 0:
        out["efs"] = host_efs(res)
    card = gp.to_device(batch, device, index=pot.model.batch_index)
    out["eval_ms"] = rank_times(lambda: gp(card))
    trainer = recording(GraphParallelTrainer)(pot, cfg, mesh, "gp", dp_axis="dp")
    out["eval_loss"] = float(trainer.eval_loss(batch))
    out["train"] = gp_step(trainer, batch, device)
    return out


def check_dp_gp(ranks, evals: list, steps: list, label: str = "dp x gp 2 x 2") -> dict:
    """``dp_gp_rank`` on four ranks: each rank's launches one eval's; each
    dp row's E/F/S (its gp rank 0's, every shard's forces) against its cell
    on one device (``evals[row]``, ``MODEL_TOL``); the trainer's
    ``eval_loss`` equal on every rank and within ``MODEL_TOL`` of the
    step's loss; the step against the mean of the rows' one-device steps
    (``steps``), each control failing (``dp_gp_reference``)."""
    import torch

    errs = {}
    for r in ranks:
        if r["launches"] is not None and r["launches"] != r["expected"]:
            raise AssertionError(f"{label}: launches {r['launches']}, expected one eval's "
                                 f"{r['expected']}")
        if r["gp_rank"] == 0:
            d = r["dp_row"]
            errs[d] = {}
            for f in ("energy", "forces", "stress"):
                want = torch.as_tensor(np.asarray(evals[d][f]))
                errs[d][f] = rel_err(torch.as_tensor(r["efs"][f])[: len(want)], want)[1]
                print(f"  {label}, dp row {d} {f}: rel={errs[d][f]:.3e} tol={MODEL_TOL:.0e}")
                if not errs[d][f] <= MODEL_TOL:
                    raise AssertionError(f"{label} row {d} {f}: relative error {errs[d][f]:.3e}")
    if sorted(errs) != [0, 1]:
        raise AssertionError(f"{label}: rows reported {sorted(errs)}")
    ref, controls = dp_gp_reference(steps)
    train = check_gp_step(f"{label} train step", ranks[0]["train"], ref,
                          [r["train"]["weights_bitwise_equal_across_ranks"] for r in ranks],
                          controls)
    losses = [r["eval_loss"] for r in ranks]
    eval_err = abs(losses[0] - train["loss"]) / max(abs(train["loss"]), 1e-30)
    print(f"  {label} eval_loss (no grad) {losses[0]:.6e}, rel {eval_err:.3e} of the step's loss")
    if any(x != losses[0] for x in losses) or not eval_err <= MODEL_TOL:
        raise AssertionError(f"{label}: eval_loss per rank {losses} against the step's loss "
                             f"{train['loss']}")
    return {"rel_err": errs, "launches_per_rank": ranks[0]["launches"],
            "eval_ms": [r["eval_ms"] for r in ranks], "train": train,
            "eval_loss_rel_err": eval_err, "step_ms": [r["train"]["step_ms"] for r in ranks]}


def gp_rank(inputs: dict) -> dict:
    """Phase 11's gp checks on one rank (see ``check_parallel``)."""
    import torch
    import torch.distributed as dist

    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.ops.halo import halo_exchange_fm
    from torch_m3gnet_tpu_torch.parallel import GraphParallelPotential, GraphParallelTrainer
    from torch_m3gnet_tpu_torch.parallel import make_mesh

    rank = dist.get_rank()
    mesh = make_mesh(None, "gp", "cuda", device=PAR_DEVICE)
    sharded, full = inputs["sharded"], inputs["full"]
    out = {"rank": rank, "device": str(torch.device("cuda", torch.cuda.current_device()))}
    for mode in ("factorized", "fused"):
        cfg = M3GNetConfig(threebody_mode=mode)
        pot = build_model(cfg, device=PAR_DEVICE, generator=torch.Generator().manual_seed(0))
        gp = GraphParallelPotential(pot, mesh)
        reset_launches()
        res = gp.apply(sharded)  # every shard's forces, gathered
        torch.cuda.synchronize()
        row = {"launches": all_launches(),
               "expected": expected_launches(mode, cfg.num_blocks, False),
               "gp_eval_ms": rank_times(lambda: gp(sharded))}
        if rank == 0:
            ref = pot(full)
            row["single_eval_ms"] = rank_times(lambda: pot(full))
            row["rel_err"] = {f: rel_err(getattr(res, f)[: len(getattr(ref, f))],
                                         getattr(ref, f).detach())[1]
                              for f in ("energy", "forces", "stress")}
        dist.barrier()
        out[mode] = row

    # the halo exchange of one block's node features (D = 64 columns)
    shard = gp.local(sharded)
    send, recv = (torch.as_tensor(getattr(shard, k), device=PAR_DEVICE).to(torch.int32)
                  for k in ("halo_send_idx", "halo_recv_idx"))
    x = torch.randn(cfg.embedding_dim, shard.num_nodes, device=PAR_DEVICE)
    out["exchange_ms"] = rank_times(
        lambda: halo_exchange_fm(x, send, recv, shard.halo_offsets, gp.group), reps=20)

    # one GraphParallelTrainer step in each mode (checked against one
    # device's Trainer step by the parent: check_gp_step)
    out["train"] = {}
    for mode in ("factorized", "fused"):
        cfg = M3GNetConfig(threebody_mode=mode)
        trainer = recording(GraphParallelTrainer)(build_model(
            cfg, device=PAR_DEVICE, generator=torch.Generator().manual_seed(0)), cfg, mesh)
        out["train"][mode] = gp_step(trainer, sharded, PAR_DEVICE)
    return out


def dp_rank(inputs: dict) -> dict:
    """Phase 11's dp checks on one rank (see ``check_parallel``), on
    ``inputs["device"]`` (default ``PAR_DEVICE``, the card both ranks
    share)."""
    import torch
    import torch.distributed as dist

    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.parallel import DataParallel, make_mesh
    from torch_m3gnet_tpu_torch.train import Trainer, loss_and_metrics

    rank, device = dist.get_rank(), inputs.get("device", PAR_DEVICE)
    mesh = make_mesh(None, "dp", torch.device(device).type, device=device)
    cfg = inputs["config"]
    out = {"rank": rank}
    for label, stack in inputs["stacks"].items():
        pot = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
        dp = recording(DataParallel)(pot, cfg, mesh)
        before = [p.detach().clone() for p in dp.params]
        dp.train_step(stack, cfg.learning_rate)
        after = [p.detach().clone() for p in dp.params]
        row = {}
        if rank == 0:  # the same weighted gradient on one rank, row by row
            ref = build_model(cfg, device=device)
            with torch.no_grad():
                for p, b in zip(ref.parameters(), before):
                    p.copy_(b)
            rows = [stack.row(r) for r in range(len(stack.positions))]
            w = [float(np.asarray(r.graph_mask, np.float32).sum()) for r in rows]
            per_row = [flat_grads(loss_and_metrics(ref, r, cfg)[0], list(ref.parameters()))
                       for r in rows]
            weighted = [sum(wi / sum(w) * g[i] for wi, g in zip(w, per_row))
                        for i in range(len(before))]
            unweighted = [sum(g[i] for g in per_row) / len(rows) for i in range(len(before))]
            row["grad_rel_err"], row["update_err_lr"] = step_errors(
                cfg, [g.cpu() for g in weighted], before, dp.grads, after)
            row["control_unweighted_grad_rel_err"] = step_errors(
                cfg, [g.cpu() for g in unweighted], before, dp.grads, after)[0]
            row["real_graphs_per_rank"] = w
        dist.barrier()
        out[label] = row
    stack = inputs["stacks"]["full"]
    out["dp_step_ms"] = rank_times(lambda: dp.train_step(stack))
    if rank == 0:
        one = Trainer(build_model(cfg, device=device), cfg)
        out["one_rank_step_ms"] = rank_times(lambda: one.train_step(stack.row(0)))
    dist.barrier()
    return out


def cli_rank(inputs: dict) -> dict:
    """``train_mlearn --mesh 2`` on this rank (the process group is up, so
    the CLI joins it): its printed test metrics and wall time."""
    from torch_m3gnet_tpu_torch.cli import train_mlearn

    t0 = time.perf_counter()
    test = cli_metrics(train_mlearn.main, [
        "--mesh", str(PAR_RANKS), "--device", PAR_DEVICE, "--path", inputs["mlearn"],
        "--config", inputs["config"], "--root", inputs["root"], "--max-epochs", "1"])
    return {"test": test, "wall_s": time.perf_counter() - t0}


def stream_producer_ms(structures, cfg, cache_dir: str, ranks: int = PAR_RANKS) -> dict:
    """Host ms per batch of the dp streaming producers, on the host alone:
    a rank's stream as ``train_model`` runs it (every shard read and
    decoded, the rank's row kept, so that the row is row ``rank`` of the
    global batch), one device's stream of the same global batches, and a
    rank that reads only its stride of the shards (``HostShardView``, a
    different batch order); the median of 3 passes over the split."""
    from torch_m3gnet_tpu_torch.data.streaming import (HostShardView, StreamingGraphDataset,
                                                       stream_batches, stream_sharded_batches)

    ds = StreamingGraphDataset(structures, cfg.cutoff, cfg.threebody_cutoff, cache_dir,
                               shard_size=WF_SHARD)
    bucket = ds.bucket(DP_PER_RANK, cfg.pad_multiple)
    producers = {
        "dp_rank_full_stream": lambda: stream_sharded_batches(ds, DP_PER_RANK, ranks,
                                                              bucket, rank=0),
        "one_device": lambda: stream_batches(ds, DP_PER_RANK * ranks, ds.bucket(
            DP_PER_RANK * ranks, cfg.pad_multiple)),
        "dp_rank_shard_stride": lambda: stream_sharded_batches(
            HostShardView(ds, 0, ranks), DP_PER_RANK, 1, bucket, rank=0),
    }
    out = {"graphs": len(ds), "shards": ds.n_shards, "per_rank_batch": DP_PER_RANK,
           "ranks": ranks}
    for label, make in producers.items():
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            n = sum(1 for _ in make())
            times.append((time.perf_counter() - t0) * 1e3 / n)
        out[label] = {"batches": n, "host_ms_per_batch": statistics.median(times)}
    return out


def parallel_rank(inputs: dict) -> dict:
    """What each rank of phase 11 runs; with each part's end in seconds
    from the job's start (``t0``, the parent's clock)."""
    out = {"timeline_s": {"rank_up": time.time() - inputs["t0"]}}
    for part, fn in (("gp", gp_rank), ("dp", dp_rank), ("cli", cli_rank)):
        out[part] = fn(inputs[part])
        out["timeline_s"][part] = time.time() - inputs["t0"]
    return out


def check_mesh_cli(ranks, inputs: dict, n_ranks: int = PAR_RANKS) -> dict:
    """The CLI's run (``cli_rank``): both ranks printed the same test
    metrics, rank 0 alone logged (one row for one epoch), and its ``last``
    checkpoint loads into the default model and evaluates a batch."""
    import os

    import torch

    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.train import Trainer

    printed = [r["cli"]["test"] for r in ranks]
    rows = open(os.path.join(inputs["root"], "logs", "metrics.jsonl")).read().splitlines()
    print(f"  train_mlearn --mesh {n_ranks}: {ranks[0]['cli']['wall_s']:.1f} s; test loss per "
          f"rank {[m['loss'] for m in printed]}; metrics.jsonl rows {len(rows)}")
    if any(m != printed[0] for m in printed) or len(rows) != 1:
        raise AssertionError(f"ranks printed {printed}; metrics.jsonl holds {len(rows)} rows")
    ckpt = os.path.join(inputs["root"], "checkpoints", "last")
    meta = Trainer.load_meta(ckpt)
    pot = build_model(M3GNetConfig.from_yaml(inputs["config"]), device="cuda",
                      elemental_energies=meta["elemental_energies"],
                      energy_scale=meta["energy_scale"])
    pot.load_state_dict(Trainer.load_params(ckpt))
    energy = pot(inputs["batch"]).energy.detach()
    if not torch.isfinite(energy).all():
        raise AssertionError("the rank-0 checkpoint evaluates to non-finite energies")
    return {"wall_s": ranks[0]["cli"]["wall_s"], "test": printed[0], "ranks_printed_equal": True,
            "metrics_rows": len(rows), "checkpoint_loads": True}


def check_dp(dp: dict) -> dict:
    """``dp_rank``'s rank 0: each step's gradient and update against the
    weighted gradient on one rank, the unweighted-mean control failing the
    tail's check; returns its part of the ``parallel`` line."""
    for label in ("full", "tail"):
        row = dp[label]
        print(f"  dp {label} (real graphs per rank {row['real_graphs_per_rank']}): gradient rel "
              f"{row['grad_rel_err']:.3e} tol {TRAIN_TOL:.0e}, update {row['update_err_lr']:.3e} "
              f"lr tol {UPDATE_TOL:.0e}; control (unweighted mean) gradient rel "
              f"{row['control_unweighted_grad_rel_err']:.3e}")
        if not (row["grad_rel_err"] <= TRAIN_TOL and row["update_err_lr"] <= UPDATE_TOL):
            raise AssertionError(f"dp {label} step: {row}")
    if dp["tail"]["control_unweighted_grad_rel_err"] <= TRAIN_TOL:
        raise AssertionError("the unweighted-mean control passed the dp tail check")
    return {k: dp[k] for k in ("full", "tail", "dp_step_ms", "one_rank_step_ms")}


def nccl_one_rank(inputs: dict) -> dict:
    """A one-rank NCCL job on ``cuda:0`` (``launch.run(..., backend="nccl")``):
    the card bound before the process group started, ``broadcast_parameters``
    over NCCL, and one ``DataParallel`` step against the ``Trainer`` step on
    the same batch from the same weights, deterministic algorithms on (the
    weight w / w_total is 1 and a one-rank all-reduce copies: bitwise
    equal)."""
    import torch
    import torch.distributed as dist

    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.parallel import DataParallel, make_mesh
    from torch_m3gnet_tpu_torch.parallel.dp import broadcast_parameters
    from torch_m3gnet_tpu_torch.train import Trainer

    cfg, batch = inputs["config"], inputs["batch"]
    out = {"backend": dist.get_backend(),
           "bound_device": str(getattr(dist.group.WORLD, "bound_device_id", None)),
           "current_device": torch.cuda.current_device()}
    mesh = make_mesh(None, "dp", "cuda")
    weights = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label in ("dp", "trainer"):
            pot = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
            if label == "dp":
                t0 = time.perf_counter()
                broadcast_parameters(pot)
                torch.cuda.synchronize()
                out["broadcast_ms"] = (time.perf_counter() - t0) * 1e3
                DataParallel(pot, cfg, mesh).train_step(batch)
            else:
                Trainer(pot, cfg).train_step(batch)
            weights[label] = [p.detach().clone() for p in pot.parameters()]
    finally:
        torch.use_deterministic_algorithms(False)
    out["bitwise_equal"] = all(torch.equal(a, b) for a, b in zip(*weights.values()))
    out["max_abs_diff"] = max(float((a - b).abs().max()) for a, b in zip(*weights.values()))
    return out


def check_nccl_one_rank(cfg, batch) -> dict:
    """Run :func:`nccl_one_rank` and hold it: bound to ``cuda:0``, bitwise
    equal to the ``Trainer`` step."""
    from torch_m3gnet_tpu_torch.parallel import launch

    t0 = time.time()
    (out,) = launch.run("chip_smoke:nccl_one_rank", 1, {"config": cfg, "batch": batch},
                        backend="nccl", timeout_s=PAR_TIMEOUT_S)
    out["job_s"] = time.time() - t0
    print(f"  one-rank NCCL job: {out}")
    if not (out["backend"] == "nccl" and out["bound_device"] == "cuda:0"
            and out["current_device"] == 0 and out["bitwise_equal"]):
        raise AssertionError(f"one-rank NCCL job: {out}")
    return out


def check_parallel(name, smi, mlearn: str) -> dict:
    """Phase 11 (see the module docstring); returns the ``parallel`` line."""
    import os
    import shutil
    import tempfile

    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.data import BucketSpec, graph_from_structure
    from torch_m3gnet_tpu_torch.data.dataset import build_graphs, stack_global_batch
    from torch_m3gnet_tpu_torch.data.io import load_mlearn_json
    from torch_m3gnet_tpu_torch.parallel import halo_stats, launch, partition_graph
    from torch_m3gnet_tpu_torch.parallel.graph_shard import spatial_reorder

    info = {"card": name, "nvidia_smi": smi, "ranks": PAR_RANKS, "device": PAR_DEVICE,
            "backend": PAR_BACKEND,
            "note": "gloo on one shared card: correctness numbers, not scaling"}
    t0 = time.perf_counter()
    cell = gp_cell()
    full, _ = spatial_reorder(graph_from_structure(cell, 5.0, 4.0), "axis")
    sharded = partition_graph(full, PAR_RANKS)
    info["gp_cell"] = {"atoms": full.num_nodes, "edges": full.num_edges,
                       "triplets": full.num_triplets,
                       "shard_padded": [int(sharded.positions.shape[1]),
                                        int(sharded.edge_src.shape[1]),
                                        int(sharded.triplet_e1.shape[1])],
                       "halo_stats": halo_stats(sharded),
                       "host_build_s": time.perf_counter() - t0}
    print(f"  gp cell: {info['gp_cell']}")
    cfg = M3GNetConfig.from_yaml(os.path.join(os.path.dirname(__file__), "configs",
                                              "mlearn_Cu.yaml")).replace(accumulate_grad_batches=1)
    n = DP_PER_RANK * PAR_RANKS
    graphs = list(build_graphs(load_mlearn_json(os.path.join(mlearn, "training.json"))[: n + DP_TAIL],
                               cfg.cutoff, cfg.threebody_cutoff))
    bucket = BucketSpec.for_batches(graphs, DP_PER_RANK, cfg.pad_multiple)
    stacks = {"full": stack_global_batch(graphs[:n], DP_PER_RANK, PAR_RANKS, bucket),
              "tail": stack_global_batch(graphs[n:], DP_PER_RANK, PAR_RANKS, bucket)}
    tmp = tempfile.mkdtemp()
    info["dp_stream_producer"] = stream_producer_ms(
        load_mlearn_json(os.path.join(mlearn, "training.json")), cfg, os.path.join(tmp, "shards"))
    print(f"  dp streaming producer, host ms per batch: {info['dp_stream_producer']}")
    cli = {"mlearn": mlearn, "root": os.path.join(tmp, "run_mesh"),
           "config": os.path.join(os.path.dirname(__file__), "configs", "mlearn_Cu.yaml")}
    t0 = time.time()
    try:
        ranks = launch.run("chip_smoke:parallel_rank", PAR_RANKS,
                           {"t0": t0, "gp": {"sharded": sharded, "full": full},
                            "dp": {"config": cfg, "stacks": stacks}, "cli": cli},
                           backend=PAR_BACKEND, timeout_s=PAR_TIMEOUT_S)
        info["job_s"] = time.time() - t0
        info["timeline_s"] = [r["timeline_s"] for r in ranks]
        print(f"  job {info['job_s']:.1f} s; each rank's parts ended at (s) {info['timeline_s']}")
        info["cli"] = check_mesh_cli(ranks, {**cli, "batch": stacks["full"].row(0)})
    finally:
        shutil.rmtree(tmp)
    gp, dp = ranks[0]["gp"], ranks[0]["dp"]
    info["nccl_one_rank"] = check_nccl_one_rank(cfg, stacks["full"].row(0))
    info["gp"] = {}
    for mode in ("factorized", "fused"):
        for r in ranks:
            got = r["gp"][mode]["launches"]
            print(f"  rank {r['gp']['rank']} ({r['gp']['device']}), {mode}: launches {got}")
            if got != r["gp"][mode]["expected"]:
                raise AssertionError(f"gp {mode} rank launches {got}, expected one eval's "
                                     f"{r['gp'][mode]['expected']}")
        for field, err in gp[mode]["rel_err"].items():
            print(f"  gp {mode} {field} vs one device: rel={err:.3e} tol={MODEL_TOL:.0e}")
            if not err <= MODEL_TOL:
                raise AssertionError(f"gp {mode} {field}: relative error {err:.3e}")
        info["gp"][mode] = {k: gp[mode][k] for k in ("launches", "gp_eval_ms",
                                                      "single_eval_ms", "rel_err")}
    info["exchange_ms"] = gp["exchange_ms"]
    info["gp_train"] = {}
    for mode in ("factorized", "fused"):
        info["gp_train"][mode] = check_gp_step(
            f"gp train step, {mode}", gp["train"][mode],
            one_device_step(M3GNetConfig(threebody_mode=mode), full, "cuda"),
            [r["gp"]["train"][mode]["weights_bitwise_equal_across_ranks"] for r in ranks])
        info["gp_train"][mode]["step_ms"] = gp["train"][mode]["step_ms"]
    info["dp"] = check_dp(dp)
    info["dp_gp"] = check_dp_gp_phase(full)
    print(f"  times ({name} | {smi}; {info['note']}): gp eval ms "
          f"{ {m: round(info['gp'][m]['gp_eval_ms'], 2) for m in info['gp']} } vs one device "
          f"{ {m: round(info['gp'][m]['single_eval_ms'], 2) for m in info['gp']} }; exchange "
          f"{info['exchange_ms']:.3f} ms a call of "
          f"{info['gp_cell']['halo_stats']['halo_rows_per_shard']} rows; gp train step ms "
          f"{ {m: round(t['step_ms'], 1) for m, t in info['gp_train'].items()} }; dp step "
          f"{dp['dp_step_ms']:.1f} ms vs one rank {dp['one_rank_step_ms']:.1f} ms; dp x gp "
          f"(4 ranks) eval {info['dp_gp']['eval_ms'][0]:.1f} ms, train step "
          f"{info['dp_gp']['step_ms'][0]:.1f} ms")
    return info


def check_dp_gp_phase(full) -> dict:
    """Phase 11's dp x gp job: four gloo ranks on ``PAR_DEVICE``, a 2 x 2
    ("dp", "gp") mesh, the gp cell ``full`` and its second jitter (seed
    ``GP_SEED + 1``, labelled by the teacher) one a dp row, each cut into
    two slabs at common shapes (``dp_gp_rank``, ``check_dp_gp``)."""
    import torch

    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.data import graph_from_structure
    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.parallel import launch, stack_partitions
    from torch_m3gnet_tpu_torch.parallel.graph_shard import spatial_reorder

    cfg = M3GNetConfig()
    t0 = time.perf_counter()
    second, _ = spatial_reorder(graph_from_structure(gp_cell(seed=GP_SEED + 1), cfg.cutoff,
                                                     cfg.threebody_cutoff), "axis")
    cells = (full, second)
    stack = stack_partitions(cells, 2)
    pot = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    evals = [host_efs(pot(g)) for g in cells]
    steps = [one_device_step(cfg, g, "cuda") for g in cells]
    host_s = time.perf_counter() - t0
    t0 = time.time()
    ranks = launch.run("chip_smoke:dp_gp_rank", 4, {"batch": stack, "device": PAR_DEVICE,
                                                    "config": cfg},
                       backend=PAR_BACKEND, timeout_s=PAR_TIMEOUT_S)
    info = {"ranks": 4, "mesh": {"dp": 2, "gp": 2}, "set_up_s": host_s,
            "job_s": time.time() - t0, **check_dp_gp(ranks, evals, steps)}
    print(f"  dp x gp job (4 ranks on {PAR_DEVICE}, {PAR_BACKEND}): {info['job_s']:.1f} s")
    return info


# ---------------------------------------------------------------------------
# Phase 12: compute_dtype="bfloat16" and remat_triplets=True
# ---------------------------------------------------------------------------

# Card vs CPU under bf16, as a fraction of the card's own bf16-f32 gap (the
# largest magnitude of each field, of the loss, of the whole weight
# gradient). Both run the same rounding points; their f32 sums go in other
# orders (kernels, cuBLAS, index_add's atomics), and every such difference
# that straddles a bf16 rounding boundary moves a value by a bf16 ulp, as
# the gap's own roundings do, only far more rarely. The CPU tests hold the
# port to JAX at 5 % of JAX's gap (tests/test_torch_precision_remat.py:
# <= 0.2 % on E/F/S, ~3e-4 on the whole gradient).
BF16_GAP_FRACTION = 0.1
# The card's bf16-f32 gap against the CPU's: the casts act on the card.
BF16_CONTROL = (0.5, 2.0)
# bf16 energies against f32: the JAX package's own bound
# (tests/test_perf_options.py: rtol 0.05, atol 0.05).
BF16_ENERGY_TOL = 0.05
FIELDS = ("energy", "forces", "stress")


def detached(out) -> dict:
    return {f: getattr(out, f).detach() for f in FIELDS}


def grad_vector(grads: dict):
    """Every weight gradient of ``grads`` (by name) as one f64 CPU vector."""
    import torch

    return torch.cat([grads[k].reshape(-1).double().cpu() for k in sorted(grads)])


def gap_check(label: str, card16, cpu16, card32, cpu32) -> dict:
    """``card16`` within BF16_GAP_FRACTION of the card's bf16-f32 gap of
    ``cpu16``, both gaps non-zero and within BF16_CONTROL of each other."""
    import torch

    card16, cpu16, card32, cpu32 = (torch.as_tensor(x).detach().double().cpu()
                                    for x in (card16, cpu16, card32, cpu32))
    gap = float((card16 - card32).abs().max())
    cpu_gap = float((cpu16 - cpu32).abs().max())
    err = float((card16 - cpu16).abs().max())
    frac = err / gap if gap > 0 else float("inf")
    control = gap / cpu_gap if cpu_gap > 0 else float("inf")
    ok = frac <= BF16_GAP_FRACTION and BF16_CONTROL[0] <= control <= BF16_CONTROL[1]
    print(f"  {label}: bf16 card vs CPU {err:.3e} = {frac:.3e} of the card's bf16-f32 gap "
          f"{gap:.3e} (tol {BF16_GAP_FRACTION}); card gap / CPU gap {control:.3f} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: bf16 card vs CPU {frac:.3e} of the gap, "
                             f"control {control:.3f}")
    return {"err": err, "gap": gap, "frac_of_gap": frac, "cpu_gap": cpu_gap, "control": control}


def check_bf16_eval(state, batch, gbatch, cfg, cpu_f32: dict) -> dict:
    """bf16 E/F/S in each mode on the card (phase 4's weights) against the
    CPU's bf16 and the card's f32, the launches those of the f32 eval, the
    energies within the JAX package's bound of f32, and each eval timed
    beside f32's."""
    import torch

    from torch_m3gnet_tpu_torch.models import build_model

    out = {}
    for mode in ("factorized", "fused", "gather"):
        c32 = cfg.replace(threebody_mode=mode)
        c16 = c32.replace(compute_dtype="bfloat16")
        expected = expected_launches(mode, cfg.num_blocks, False)
        pots = {}
        for label, c in (("f32", c32), ("bf16", c16)):
            pots[label] = build_model(c, device="cuda")
            pots[label].load_state_dict(state)
        o32, _ = counted_eval(pots["f32"], gbatch, expected)
        o16, launches = counted_eval(pots["bf16"], gbatch, expected)
        if o16.energy.dtype != torch.float32 or o16.forces.dtype != torch.float32:
            raise AssertionError(f"{mode} bf16: outputs in {o16.energy.dtype}, not float32")
        cpu16 = detached(cpu_reference(c16, pots["bf16"], batch))
        cpu32 = cpu_f32.get(mode) or detached(cpu_reference(c32, pots["f32"], batch))
        o32, o16 = detached(o32), detached(o16)
        row = {f: gap_check(f"{mode} {f}", o16[f], cpu16[f], o32[f], cpu32[f]) for f in FIELDS}
        e_err = float(((o16["energy"] - o32["energy"]).abs()
                       - BF16_ENERGY_TOL * o32["energy"].abs()).max())
        print(f"  {mode} bf16 energies vs f32 (card): largest |dE| - 0.05 |E| = {e_err:.3e} "
              f"eV (tol {BF16_ENERGY_TOL})")
        if e_err > BF16_ENERGY_TOL:
            raise AssertionError(f"{mode} bf16 energies beyond rtol/atol 0.05 of f32")
        for label, p in pots.items():
            row[f"eval_{label}"] = step_times(lambda: p(gbatch))
        print(f"  {mode} eval: f32 {row['eval_f32']}, bf16 {row['eval_bf16']}")
        row["launches"] = launches
        out[mode] = row
        del pots, o16, o32, cpu16
    return out


def step_times(step, reps: int = 20) -> dict:
    """``step``'s median ms (CUDA events, ``reps`` after 3) and, from the
    profiler, its device busy ms and CUDA kernels a step: the work itself,
    which the host's speed does not move."""
    step_ms, wall_ms = time_step(step, reps=reps, warmup=3)
    prof = profile_step(step, step_ms, steps=2)
    return {"step_ms": step_ms, "wall_ms": wall_ms,
            "device_busy_ms": prof["device_busy_ms_per_step"],
            "kernels_per_step": prof["kernel_launches_per_step"]}


def peak_gb(step) -> dict:
    """The peak memory of one call of ``step``: absolute, and above what was
    allocated before it."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"peak_gb": peak / 1e9, "step_peak_gb": (peak - before) / 1e9}


def peak_and_ms(trainer, card_train) -> dict:
    """One train step's :func:`peak_gb` and :func:`step_times`."""
    def step():
        trainer.train_step(card_train)

    return {**peak_gb(step), **step_times(step)}


def student(cfg, device="cuda"):
    import torch

    from torch_m3gnet_tpu_torch.models import build_model

    return build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))


def check_bf16_train(cfg, host_train, card_train, cpu_f32_steps: dict) -> dict:
    """The seed-0 student under bf16 in the factorized and the fused mode:
    one step's loss and weight gradient against the same step on the CPU in
    bf16 (the gap rule, against phase 6's f32 step on either side), the
    launches of one train step, five steps that lower the loss and stay
    finite, the step's ms and peak."""
    import torch

    from torch_m3gnet_tpu_torch.train import Trainer

    out = {}
    for mode in ("factorized", "fused"):
        c32 = cfg.replace(threebody_mode=mode)
        c16 = c32.replace(compute_dtype="bfloat16")
        loss32, g32 = loss_and_grads(student(c32), card_train, c32)
        pot = student(c16)
        loss16, g16 = loss_and_grads(pot, card_train, c16)
        cpu_pot = student(c16, "cpu")
        t0 = time.perf_counter()
        cpu_loss16, cpu_g16 = loss_and_grads(cpu_pot, host_train, c16)
        print(f"  CPU bf16 loss and gradients: {time.perf_counter() - t0:.1f} s")
        del cpu_pot
        cpu_loss32, cpu_g32 = cpu_f32_steps[mode]
        row = {"loss": gap_check(f"{mode} bf16 step-1 loss", loss16, cpu_loss16, loss32,
                                 cpu_loss32),
               "gradient": gap_check(f"{mode} bf16 weight gradient (all tensors)",
                                     *map(grad_vector, (g16, cpu_g16, g32, cpu_g32)))}
        trainer = Trainer(pot, c16)
        expected = expected_launches(mode, cfg.num_blocks, True)
        reset_launches()
        losses = [float(trainer.train_step(card_train)["loss"])]
        torch.cuda.synchronize()
        row["launches"] = all_launches()
        if row["launches"] != expected:
            raise AssertionError(f"{mode} bf16 train step launches {row['launches']}, "
                                 f"expected {expected}")
        losses += [float(trainer.train_step(card_train)["loss"]) for _ in range(4)]
        finite = all(bool(p.isfinite().all()) for p in pot.parameters())
        print(f"  {mode} bf16 losses over 5 steps: {losses}")
        if not (finite and all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{mode} bf16 training: finite weights {finite}, losses {losses}")
        row.update(losses=losses, **peak_and_ms(trainer, card_train))
        print(f"  {mode} bf16 train step {row['step_ms']:.2f} ms (device busy "
              f"{row['device_busy_ms']:.2f} ms, {row['kernels_per_step']:.0f} kernels), peak "
              f"{row['peak_gb']:.2f} GB")
        row["grads"] = (loss16, g16)
        out[mode] = row
    return out


def check_remat(cfg, gbatch, card_train, bf16_step) -> dict:
    """``remat_triplets`` in each mode: one step's loss and every weight
    gradient against the step without it (``TRAIN_TOL``), the exact
    launches of one eval and one train step with the recompute, and each
    train step's peak and ms beside the step without remat. Then bf16 and
    remat together (factorized) against the bf16 step."""
    import torch

    from torch_m3gnet_tpu_torch.train import Trainer

    nb, out = cfg.num_blocks, {}
    for mode in ("factorized", "fused", "gather"):
        c = cfg.replace(threebody_mode=mode)
        cr = c.replace(remat_triplets=True)
        pot, pot_r = student(c), student(cr)
        loss, grads = loss_and_grads(pot, card_train, c)
        loss_r, grads_r = loss_and_grads(pot_r, card_train, cr)
        check(f"{mode} remat step-1 loss vs without", loss_r.cpu(), loss.cpu(), MODEL_TOL)
        worst = max((rel_err(grads_r[n], grads[n])[1], n) for n in grads)
        print(f"  {mode} remat weight gradients vs without (card): worst {worst[1]} "
              f"rel={worst[0]:.3e} over {len(grads)} tensors, tol={TRAIN_TOL:.0e}")
        if worst[0] > TRAIN_TOL:
            raise AssertionError(f"{mode} remat gradient {worst[1]}: {worst[0]:.3e}")
        row = {"grad_rel_err": worst[0], "worst_tensor": worst[1],
               "loss_rel_err": rel_err(loss_r.cpu(), loss.cpu())[1]}
        _, row["launches_eval"] = counted_eval(pot_r, gbatch,
                                               expected_launches(mode, nb, False, True))
        # an eval keeps no graph of its backward pass, so there the
        # recomputed stage is freed as soon as it is used
        row["eval_peak"] = {label: peak_gb(lambda: p(gbatch))
                            for label, p in (("plain", pot), ("remat", pot_r))}
        print(f"  {mode} eval peak: {row['eval_peak']}")
        trainers = {"plain": Trainer(pot, c), "remat": Trainer(pot_r, cr)}
        expected = expected_launches(mode, nb, True, True)
        reset_launches()
        trainers["remat"].train_step(card_train)
        torch.cuda.synchronize()
        row["launches_train"] = all_launches()
        print(f"  {mode} remat launches: eval {row['launches_eval']}, train step "
              f"{row['launches_train']}")
        if row["launches_train"] != expected:
            raise AssertionError(f"{mode} remat train launches {row['launches_train']}, "
                                 f"expected {expected}")
        for label, trainer in trainers.items():
            row[label] = peak_and_ms(trainer, card_train)
        print(f"  {mode} train step with remat: {row['remat']}; without: {row['plain']}")
        out[mode] = row
        del pot, pot_r, trainers

    # bf16 and remat together: the bf16 step again, the stage recomputed
    c16r = cfg.replace(compute_dtype="bfloat16", remat_triplets=True)
    loss16, g16 = bf16_step["grads"]
    reset_launches()
    loss_b, g_b = loss_and_grads(student(c16r), card_train, c16r)
    torch.cuda.synchronize()
    launches = all_launches()
    expected = expected_launches("factorized", nb, True, True)
    if launches != expected:
        raise AssertionError(f"bf16 + remat step launches {launches}, expected {expected}")
    gap = bf16_step["gradient"]["gap"]
    err = float((grad_vector(g_b) - grad_vector(g16)).abs().max())
    loss_err = abs(float(loss_b) - float(loss16))
    print(f"  bf16 + remat vs bf16 (factorized, card): loss {loss_err:.3e} (bf16 gap "
          f"{bf16_step['loss']['gap']:.3e}), gradient {err:.3e} = {err / gap:.3e} of its gap "
          f"(tol {BF16_GAP_FRACTION}); launches {launches}")
    if not (err <= BF16_GAP_FRACTION * gap
            and loss_err <= BF16_GAP_FRACTION * bf16_step["loss"]["gap"]):
        raise AssertionError("bf16 + remat step differs from the bf16 step")
    out["bf16_remat"] = {"loss_err": loss_err, "grad_err": err, "grad_frac_of_gap": err / gap}
    return out


def check_precision_remat(name, smi, state, batch, gbatch, cfg, host_train, card_train,
                          cpu_f32: dict, cpu_f32_steps: dict) -> dict:
    """Phase 12 (see the module docstring); returns the ``precision_remat``
    line."""
    info = {"card": name, "nvidia_smi": smi}
    print("  -- bf16 eval (phase 4's weights, the bench batch)")
    info["bf16_eval"] = check_bf16_eval(state, batch, gbatch, cfg, cpu_f32)
    print("  -- bf16 train step (the seed-0 student, phase 6's teacher batch)")
    info["bf16_train"] = check_bf16_train(cfg, host_train, card_train, cpu_f32_steps)
    print("  -- remat train step")
    info["remat"] = check_remat(cfg, gbatch, card_train, info["bf16_train"]["factorized"])
    for row in info["bf16_train"].values():
        del row["grads"]
    return info


def main() -> int:
    import os
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.data import to_torch
    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.ops import _cuda

    print("== 1. card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"  {name} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    print("== 2. build")
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    print(f"  built {lib_path.name} from {[p.name for p in _cuda.sources()]} "
          f"in {time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".so.log").read_text().splitlines()
    for i, line in enumerate(log):  # ptxas report of the kernels the default model runs
        if "Compiling entry function" in line and (
            any(k in line for k in ("Li3ELi3E", "Li9E", "windowed", "segment_sum_block"))
            or ("segment_sum_tiled" in line and any(k in line for k in ("Li1E", "Li4E")))
        ):
            print("\n".join("  " + x.strip() for x in log[i : i + 4]))

    print("== 3. kernels against their plain versions (bench shapes)")
    t0 = time.perf_counter()
    batch = build_batch()
    shapes = (batch.num_nodes, batch.num_edges, batch.num_triplets)
    real = (int(batch.edge_mask.sum()), int(batch.triplet_mask.sum()))
    print(f"  bench batch built in {time.perf_counter() - t0:.1f} s: N, E, T = {shapes}, "
          f"real edges, triplets = {real}")
    if shapes != BENCH_SHAPES or real != BENCH_REAL:
        raise AssertionError(f"bench batch differs from {BENCH_SHAPES}, {BENCH_REAL}")
    cfg = M3GNetConfig()
    gbatch = to_torch(batch, "cuda", torch.float32)
    errs = check_kernels(gbatch.edge_src, gbatch.edge_src_offsets, gbatch.num_nodes,
                         cfg.l_max, cfg.n_max)
    errs.update(check_triplet_kernels(gbatch, cfg.l_max * cfg.n_max))
    errs["sorted_segment_sum"] = check_sorted_segment(gbatch)
    check_sorted_index_cases()
    check_member_rules(gbatch, cfg)
    check_grid_slices()
    for sizes in BATCH_CHECK_SIZES.values():
        check_batch_index(sizes)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda").zero_()  # 256 MB > L2
    time_batch_check(name, flush)
    check_norm_gate()
    check_norm_gate_second_order()
    time_norm_gate(name, flush)
    del flush

    print("== 4. model, factorized mode (default config, seeded weights, bench batch)")
    pot = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in pot.parameters())
    print(f"  parameters: {n_params}")
    if n_params != N_PARAMS:
        raise AssertionError(f"{n_params} parameters, expected {N_PARAMS}")
    state0 = {k: v.detach().clone() for k, v in pot.state_dict().items()}
    out, launches, cpu_f32 = check_model(pot, batch, gbatch, cfg)

    print("== 5. model, fused mode (same weights, same batch)")
    pot_f, out_f, launches_f, cpu_f32_fused = check_fused_model(pot, out, batch, gbatch, cfg)
    cpu_f32 = {"factorized": cpu_f32, "fused": cpu_f32_fused}
    del out, out_f

    print("== 6. training (teacher labels, seed-0 student)")
    host_train, card_train = teacher_batch(cfg, batch, gbatch)
    trainers, first_loss, train_launches, cpu_steps = {}, {}, {}, {}
    for mode in ("factorized", "fused"):
        trainers[mode], first_loss[mode], train_launches[mode], cpu_steps[mode] = check_training(
            mode, cfg, host_train, card_train)
    check("step-1 loss fused vs factorized (card)", torch.tensor(first_loss["fused"]),
          torch.tensor(first_loss["factorized"]), MODE_TOL)

    print("== 7. times")
    eval_ms = {}
    for label, p in (("eval", pot), ("eval_fused", pot_f)):
        eval_ms[label] = step_line(label, lambda: p(gbatch), gbatch, name, smi, real)
    for label, mode, eval_label in (("train", "factorized", "eval"),
                                    ("train_fused", "fused", "eval_fused")):
        trainer = trainers[mode]
        step_line(label, lambda: trainer.train_step(card_train), gbatch, name, smi, real,
                  reps=20, warmup=3, mode=mode, eval_ms=eval_ms[eval_label])
    # the same steps from the host batch: each step copies it to the card,
    # checks its indices and builds the kernel index its mode reads
    for label, mode in (("train_host", "factorized"), ("train_fused_host", "fused")):
        trainer = trainers[mode]
        step_line(label, lambda: trainer.train_step(host_train), gbatch, name, smi, real,
                  reps=10, warmup=2, mode=mode)
    # each kernel's launches from the evaluation of its own mode
    counts = {k: launches[k] or launches_f[k] for k in launches}
    rows = time_kernels(gbatch, cfg, name, counts, errs)
    for row in rows:
        row["launches_train"] = (train_launches["factorized"][row["name"]]
                                 or train_launches["fused"][row["name"]])

    print("== 8. simulate (native data, MD, relaxation, elastic constants)")
    structures = bench_structures()
    sim = {"card": name, "nvidia_smi": smi}
    sim.update(check_native_data(structures))
    sim.update(check_md(pot, cfg, structures))
    sim.update(md_step_times(pot, structures))
    sim.update(check_relax(pot, structures[:RELAX_GRAPHS]))
    sim.update(check_elastic(pot, cfg))
    print(json.dumps({"simulate": sim}))

    print("== 9. train workflow (CLIs, train_model, streams, prefetch)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as keep:
        print(json.dumps({"workflow": check_workflow(name, smi, keep)}))
        print(f"  phase 9: {time.perf_counter() - t0:.1f} s")
        print("== 10. user CLIs and the committee, from phase 9's checkpoint")
        t0 = time.perf_counter()
        cli = check_cli(name, smi, os.path.join(keep, "best"), gbatch)
        cli["phase_s"] = time.perf_counter() - t0
        print(json.dumps({"cli": cli}))
        print(f"== 11. parallel: {PAR_RANKS} ranks (4 for dp x gp) on {PAR_DEVICE} over "
              f"{PAR_BACKEND}")
        t0 = time.perf_counter()
        par = check_parallel(name, smi, os.path.join(keep, "mlearn_Cu"))
        par["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"parallel": par}))

    print("== 12. bf16 and remat")
    t0 = time.perf_counter()
    del trainers
    prec = check_precision_remat(name, smi, state0, batch, gbatch, cfg, host_train, card_train,
                                 cpu_f32, cpu_steps)
    prec["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"precision_remat": prec}))
    print(f"  phase 12: {prec['phase_s']:.1f} s")
    for row in rows:
        row["launches_predict"] = next(r["launches"][row["name"]] for r in
                                       cli["predict"]["runs"].values() if r["launches"][row["name"]])
        row["launches_gp_rank"] = next(par["gp"][m]["launches"][row["name"]] for m in
                                       ("factorized", "fused") if par["gp"][m]["launches"][row["name"]])
        # with remat_triplets: per mode whose step runs the kernel, (eval, train step)
        remat = {m: prec["remat"][m] for m in ("factorized", "fused", "gather")}
        row["launches_remat"] = {
            m: [r["launches_eval"][row["name"]], r["launches_train"][row["name"]]]
            for m, r in remat.items() if r["launches_train"][row["name"]]}
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
