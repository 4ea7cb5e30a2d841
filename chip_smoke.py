"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. card: the device name and ``nvidia-smi``'s name and power limit;
2. build: ``nvcc`` compiles every CUDA source of the port (``csrc/*.cu``),
   one process per source, all at once, into one library;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the bench shapes (the ``src``, ``triplet_e1`` and ``triplet_e2`` of the
   real bench batch, seeded inputs), forward and VJP: the composed
   factorized stage (B1-B3), ``fused_triplet_gate_sum`` through
   ``backward_pair`` (B4, B5) and ``windowed_take_fm`` through
   ``windowed_scatter_fm`` (B6, B7);
4. model: the default 227,549-parameter M3GNet (seeded weights) evaluates
   energy, forces and stress on the bench batch (32 perturbed 108-atom fcc
   Cu cells, ``pad_multiple=512``) in the factorized mode through B1-B3;
   the same weights on the CPU through the plain versions give the
   reference; B1-B3 must each have launched 2 x num_blocks times in that one
   evaluation, and B4-B7 never;
5. fused model: the same weights in ``threebody_mode="fused"`` evaluate the
   same batch through B4-B7 (full width, full depth); held against the CPU's
   fused mode and against the factorized mode on the card; B4 and B5 must
   each have launched num_blocks times, B6 and B7 twice, B1-B3 never;
6. times: each mode's eval step (CUDA events, median of 50) with a profiler
   breakdown, and each kernel beside its plain version, its bound and,
   where one PyTorch call computes the same function, that call (cold L2,
   median of 30).

The last line is ``{"ok": true, "device": {...}}``; the ``{"kernels": [...]}``
line and the card's ``nvidia-smi`` line come just before it.
"""

from __future__ import annotations

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


def build_batch(n_graphs: int = N_GRAPHS, n_cells: int = N_CELLS, pad_multiple: int = PAD_MULTIPLE):
    """The bench batch, built as bench.py builds it, with the port's data code."""
    from torch_m3gnet_tpu_torch.data import Structure, pack_structures

    rng = np.random.default_rng(0)
    base = Structure.from_frac_coords(
        np.eye(3) * 3.62,
        [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]],
        [29] * 4,
    ).supercell((n_cells, n_cells, n_cells))
    structures = [
        Structure(
            base.lattice,
            base.cart_coords + 0.05 * rng.standard_normal(base.cart_coords.shape),
            base.atomic_numbers,
        )
        for _ in range(n_graphs)
    ]
    return pack_structures(structures, 5.0, 4.0, pad_multiple=pad_multiple)


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


def check_kernels(src, num_nodes: int, l_max: int, n_max: int) -> dict[str, float]:
    """Each kernel against its plain version, forward and composed VJP."""
    import torch

    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs

    e = src.shape[0]
    sh, gm, a = stage_inputs(num_nodes, e, l_max, n_max, src.device)
    errs = {}
    with torch.no_grad():
        errs["q_scatter"] = check(
            "q_scatter", fs.q_scatter(sh, gm, src, num_nodes, l_max, n_max),
            fs.q_scatter_plain(sh, gm, src, num_nodes, l_max, n_max), FWD_TOL)
        errs["r1_gather"] = check(
            "r1_gather", fs.r1_gather(a, sh, src, l_max, n_max),
            fs.r1_gather_plain(a, sh, src, l_max, n_max), FWD_TOL)
        errs["r2_gather"] = check(
            "r2_gather", fs.r2_gather(a, gm, src, l_max, n_max),
            fs.r2_gather_plain(a, gm, src, l_max, n_max), FWD_TOL)

    def stage_grads(q, r1):
        s, g = sh.clone().requires_grad_(True), gm.clone().requires_grad_(True)
        proj = r1(q(s, g, src, num_nodes, l_max, n_max), s, src, l_max, n_max)
        return torch.autograd.grad(torch.sin(proj - g).sum(), (s, g))

    got = stage_grads(fs.q_scatter, fs.r1_gather)
    want = stage_grads(fs.q_scatter_plain, fs.r1_gather_plain)
    check("stage VJP d_sh (r2 + r2 kernels)", got[0], want[0], VJP_TOL)
    check("stage VJP d_gm (r1 + q kernels)", got[1], want[1], VJP_TOL)
    return errs


def reset_launches() -> None:
    from torch_m3gnet_tpu_torch.ops import factorized_stage, fused_triplet, windowed_take

    for mod in (factorized_stage, fused_triplet, windowed_take):
        mod.reset_launch_counts()


def all_launches() -> dict[str, int]:
    from torch_m3gnet_tpu_torch.ops import factorized_stage, fused_triplet, windowed_take

    return {**factorized_stage.LAUNCHES, **fused_triplet.LAUNCHES, **windowed_take.LAUNCHES}


def check_triplet_kernels(gbatch, ln: int, f: int = 4) -> dict[str, float]:
    """B4-B7 against their plain versions on the batch's real triplet_e1
    (sorted) and triplet_e2 (unsorted), forward and VJP."""
    import torch

    from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
    from torch_m3gnet_tpu_torch.ops import windowed_take as wt

    basis, gate, g, data, vals = triplet_inputs(gbatch, ln, f)
    e1, e2, e = gbatch.triplet_e1, gbatch.triplet_e2, gbatch.num_edges
    errs = {}
    with torch.no_grad():
        errs["fused_triplet_gate_sum"] = check(
            "fused_triplet_gate_sum", ft.fused_triplet_gate_sum(basis, gate, e1, e2, e),
            ft.fused_triplet_gate_sum_plain(basis, gate, e1, e2, e), FWD_TOL)
        got = ft.backward_pair(basis, gate, g, e1, e2, e)
        want = ft.backward_pair_plain(basis, gate, g, e1, e2, e)
        errs["backward_pair"] = max(check("backward_pair d_basis", got[0], want[0], FWD_TOL),
                                    check("backward_pair d_gate", got[1], want[1], FWD_TOL))
        take_errs, scatter_errs = [], []
        for label, idx in (("e1", e1), ("e2", e2)):
            take_errs.append(check(f"windowed_take_fm ({label})", wt.windowed_take_fm(data, idx),
                                   wt.take_fm_plain(data, idx), FWD_TOL))
            scatter_errs.append(check(
                f"windowed_scatter_fm ({label})", wt.windowed_scatter_fm(vals, idx, e),
                wt.scatter_fm_plain(vals, idx, e), FWD_TOL))
        errs["windowed_take_fm"], errs["windowed_scatter_fm"] = max(take_errs), max(scatter_errs)

    def fused_grads(fused):
        b, gt = basis.clone().requires_grad_(True), gate.clone().requires_grad_(True)
        return torch.autograd.grad(torch.sin(fused(b, gt, e1, e2, e)).sum(), (b, gt))

    got = fused_grads(ft.fused_triplet_gate_sum)
    want = fused_grads(ft.fused_triplet_gate_sum_plain)
    check("fused VJP d_basis (backward_pair kernel)", got[0], want[0], VJP_TOL)
    check("fused VJP d_gate (backward_pair kernel)", got[1], want[1], VJP_TOL)

    def take_grad(take):
        d = data.clone().requires_grad_(True)
        y = torch.sin(take(d, e1)) * take(d, e2)
        return torch.autograd.grad(y.sum(), d)[0]

    check("take VJP (windowed_scatter_fm kernel, e1 and e2)",
          take_grad(wt.windowed_take_fm), take_grad(wt.take_fm_plain), VJP_TOL)
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
    """One counted factorized evaluation on the card, compared with the CPU."""
    nb = cfg.num_blocks
    expected = {name: 0 for name in all_launches()}
    expected.update(q_scatter=2 * nb, r1_gather=2 * nb, r2_gather=2 * nb)
    out, launches = counted_eval(pot, gbatch, expected)
    check_outputs("card vs CPU", out, cpu_reference(cfg, pot, batch), gbatch, MODEL_TOL)
    e = out.energy.detach().cpu().numpy()
    print(f"  energy[:4] (eV) = {e[:4].tolist()}")
    return out, launches


def check_fused_model(pot, out_factorized, batch, gbatch, cfg):
    """The same weights in the fused mode: one counted evaluation on the
    card, compared with the CPU's fused mode and the card's factorized mode."""
    from torch_m3gnet_tpu_torch.models import build_model

    cfg_f = cfg.replace(threebody_mode="fused")
    pot_f = build_model(cfg_f, device="cuda")
    pot_f.load_state_dict(pot.state_dict())
    nb = cfg.num_blocks
    expected = {name: 0 for name in all_launches()}
    expected.update(fused_triplet_gate_sum=nb, backward_pair=nb,
                    windowed_take_fm=2, windowed_scatter_fm=2)
    out, launches = counted_eval(pot_f, gbatch, expected)
    check_outputs("fused card vs CPU", out, cpu_reference(cfg_f, pot_f, batch), gbatch, MODEL_TOL)
    for name in ("energy", "forces", "stress", "atomic_energy"):
        check(f"{name} fused vs factorized (card)", getattr(out, name).detach(),
              getattr(out_factorized, name).detach(), MODE_TOL)
    return pot_f, launches


def time_eval(pot, gbatch, reps: int = 50, warmup: int = 5) -> tuple[float, float]:
    """Median eval-step time (ms): CUDA events around each call from an idle
    device, and host wall time to the end of the same call."""
    import torch

    for _ in range(warmup):
        pot(gbatch)
    torch.cuda.synchronize()
    dev_ms, wall_ms = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        pot(gbatch)
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return statistics.median(dev_ms), statistics.median(wall_ms)


def profile_eval(pot, gbatch, step_ms: float, steps: int = 5) -> dict:
    """Device time per eval step by kernel (torch.profiler over ``steps``
    steps) and the device's busy share of the unprofiled step time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            pot(gbatch)
        torch.cuda.synchronize()
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


def time_cold(fn, flush, reps: int = 30) -> float:
    """Median device time (ms) of ``fn`` with the L2 cache flushed before
    each call. A spin kernel after the flush keeps the device busy while the
    host enqueues the timed call, so the events see device time only, not
    the wrapper's host overhead."""
    import torch

    fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)  # ~1 ms of clock cycles
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_kernels(gbatch, cfg, card_name, launches, errs) -> list[dict]:
    """One row per kernel: its time, its plain version's, its bound and,
    where one PyTorch call computes the same function, that call's."""
    import torch

    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs
    from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
    from torch_m3gnet_tpu_torch.ops import windowed_take as wt

    src, num_nodes, l_max, n_max = gbatch.edge_src, gbatch.num_nodes, cfg.l_max, cfg.n_max
    e, t = gbatch.num_edges, gbatch.num_triplets
    e1, e2 = gbatch.triplet_e1, gbatch.triplet_e2
    m, ln, mn = l_max * l_max, l_max * n_max, l_max * l_max * n_max
    sh, gm, a = stage_inputs(num_nodes, e, l_max, n_max, src.device)
    f = 4
    basis, gate, g, data, vals = triplet_inputs(gbatch, ln, f)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=src.device)  # 256 MB > L2
    bw = bandwidth(card_name)
    a_bytes, src_bytes, idx_bytes = 4 * mn * num_nodes, 4 * e, 4 * t
    fs_src = "torch_m3gnet_tpu_torch/csrc/factorized_stage.cu"
    ft_src = "torch_m3gnet_tpu_torch/csrc/fused_triplet.cu"
    wt_src = "torch_m3gnet_tpu_torch/csrc/windowed_take.cu"

    def both(fn):
        """The path calls the take and the scatter once with e1, once with e2."""
        return [lambda: fn(e1), lambda: fn(e2)]

    specs = {
        # name: (source, kernel calls, plain calls, library calls or None,
        #        bytes moved: inputs once + outputs once, flops, TPU kernel)
        "q_scatter": (
            fs_src, [lambda: fs.q_scatter(sh, gm, src, num_nodes, l_max, n_max)],
            [lambda: fs.q_scatter_plain(sh, gm, src, num_nodes, l_max, n_max)], None,
            4 * (m + ln) * e + src_bytes + a_bytes, 2 * mn * e,
            "torch_m3gnet_tpu/ops/pallas_factorized_stage.py:230",
        ),
        "r1_gather": (
            fs_src, [lambda: fs.r1_gather(a, sh, src, l_max, n_max)],
            [lambda: fs.r1_gather_plain(a, sh, src, l_max, n_max)], None,
            a_bytes + 4 * (m + ln) * e + src_bytes, 2 * mn * e,
            "torch_m3gnet_tpu/ops/pallas_factorized_stage.py:340",
        ),
        "r2_gather": (
            fs_src, [lambda: fs.r2_gather(a, gm, src, l_max, n_max)],
            [lambda: fs.r2_gather_plain(a, gm, src, l_max, n_max)], None,
            a_bytes + 4 * (ln + m) * e + src_bytes, 2 * mn * e,
            "torch_m3gnet_tpu/ops/pallas_factorized_stage.py:340",
        ),
        "fused_triplet_gate_sum": (
            ft_src, [lambda: ft.fused_triplet_gate_sum(basis, gate, e1, e2, e)],
            [lambda: ft.fused_triplet_gate_sum_plain(basis, gate, e1, e2, e)], None,
            4 * ln * t + 2 * idx_bytes + 4 * 2 * ln * e, 2 * ln * t,
            "torch_m3gnet_tpu/ops/pallas_fused_triplet.py:381",
        ),
        "backward_pair": (
            ft_src, [lambda: ft.backward_pair(basis, gate, g, e1, e2, e)],
            [lambda: ft.backward_pair_plain(basis, gate, g, e1, e2, e)], None,
            4 * 2 * ln * t + 2 * idx_bytes + 4 * 3 * ln * e, 3 * ln * t,
            "torch_m3gnet_tpu/ops/pallas_fused_triplet.py:513",
        ),
        "windowed_take_fm": (
            wt_src, both(lambda idx: wt.windowed_take_fm(data, idx)),
            both(lambda idx: wt.take_fm_plain(data, idx)),
            both(lambda idx: torch.index_select(data, 1, idx)),
            4 * f * e + idx_bytes + 4 * f * t, 0,
            "torch_m3gnet_tpu/ops/pallas_windowed_take.py:166",
        ),
        "windowed_scatter_fm": (
            wt_src, both(lambda idx: wt.windowed_scatter_fm(vals, idx, e)),
            both(lambda idx: wt.scatter_fm_plain(vals, idx, e)),
            both(lambda idx: torch.zeros((f, e), device=vals.device).index_add_(1, idx, vals)),
            4 * f * t + idx_bytes + 4 * f * e, f * t,
            "torch_m3gnet_tpu/ops/pallas_windowed_take.py:240",
        ),
    }

    def mean_ms(fns):
        return None if fns is None else statistics.mean(time_cold(fn, flush) for fn in fns)

    rows = []
    with torch.no_grad():
        for name, (source, kernel, plain, library, nbytes, flops, replaces) in specs.items():
            ms, plain_ms, library_ms = mean_ms(kernel), mean_ms(plain), mean_ms(library)
            bytes_ms = nbytes / bw * 1e3
            ops_ms = flops / F32_FLOPS * 1e3
            rows.append({
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": errs[name],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": library_ms,
                "bytes": nbytes,
            })
            lib = "" if library_ms is None else f", library {library_ms * 1e3:.1f} us"
            print(f"  {name}: {ms * 1e3:.1f} us (plain {plain_ms * 1e3:.1f} us{lib}, "
                  f"bound {max(bytes_ms, ops_ms) * 1e3:.2f} us for {nbytes / 1e6:.2f} MB)")
    return rows


def eval_line(label, pot, gbatch, name, smi, real) -> float:
    """Print the eval-step line and the profile line of one mode."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    step_ms, wall_ms = time_eval(pot, gbatch)
    print(json.dumps({label: {
        "card": name, "nvidia_smi": smi, "step_ms": step_ms, "wall_ms": wall_ms,
        "items_per_s": sum(real) / (step_ms * 1e-3), "edges": real[0], "triplets": real[1],
        "graphs": gbatch.num_graphs, "reps": 50,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }}))
    print(json.dumps({label.replace("eval", "profile"): profile_eval(pot, gbatch, step_ms)}))
    return step_ms


def main() -> int:
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
        if "Compiling entry function" in line and any(
            k in line for k in ("Li3ELi3E", "Li9E", "windowed", "backward_pair")
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
    errs = check_kernels(gbatch.edge_src, gbatch.num_nodes, cfg.l_max, cfg.n_max)
    errs.update(check_triplet_kernels(gbatch, cfg.l_max * cfg.n_max))

    print("== 4. model, factorized mode (default config, seeded weights, bench batch)")
    pot = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in pot.parameters())
    print(f"  parameters: {n_params}")
    if n_params != N_PARAMS:
        raise AssertionError(f"{n_params} parameters, expected {N_PARAMS}")
    out, launches = check_model(pot, batch, gbatch, cfg)

    print("== 5. model, fused mode (same weights, same batch)")
    pot_f, launches_f = check_fused_model(pot, out, batch, gbatch, cfg)
    del out

    print("== 6. times")
    eval_line("eval", pot, gbatch, name, smi, real)
    eval_line("eval_fused", pot_f, gbatch, name, smi, real)
    # each kernel's launches from the evaluation of its own mode
    counts = {k: launches[k] or launches_f[k] for k in launches}
    rows = time_kernels(gbatch, cfg, name, counts, errs)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
