"""The port's factorized-stage ops (torch_m3gnet_tpu_torch.ops.factorized_stage)
against the JAX package's Pallas kernels, run in TPU interpret mode on the
CPU as tests/test_pallas_factorized.py runs them.

On the CPU the port's autograd Functions run the plain versions of the CUDA
kernels; chip_smoke.py holds the kernels against those on the card.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_m3gnet_tpu.ops.pallas_factorized_stage import q_scatter as jq
from torch_m3gnet_tpu.ops.pallas_factorized_stage import q_scatter_xla
from torch_m3gnet_tpu.ops.pallas_factorized_stage import r1_gather as jr1
from torch_m3gnet_tpu.ops.pallas_factorized_stage import r1_gather_xla
from torch_m3gnet_tpu.ops.pallas_factorized_stage import r2_gather as jr2
from torch_m3gnet_tpu.ops.pallas_factorized_stage import r2_gather_xla
from torch_m3gnet_tpu_torch.ops import factorized_stage as fs
from torch_m3gnet_tpu_torch.ops.sorted_segment import sorted_segment_offsets
from torch_m3gnet_tpu_torch.utils import profiling

L_MAX, N_MAX = 3, 3
M, LN, MN = L_MAX * L_MAX, L_MAX * N_MAX, L_MAX * L_MAX * N_MAX


def _data(e=700, n=40, seed=0, dtype=np.float32, l_max=L_MAX, n_max=N_MAX):
    """Sorted src with empty nodes and a long last run, like a padded batch."""
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
    src[-e // 8 :] = n - 1  # the padded tail points at the last node
    m, ln, mn = l_max * l_max, l_max * n_max, l_max * l_max * n_max
    sh = rng.standard_normal((m, e)).astype(dtype)
    gm = rng.standard_normal((ln, e)).astype(dtype)
    a = rng.standard_normal((mn, n)).astype(dtype)
    return sh, gm, a, src, n, e


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _off(src, n):
    """The run offsets of the sorted ``src`` over ``n`` nodes, as the batch
    carries them (``edge_src_offsets``)."""
    return sorted_segment_offsets(torch.as_tensor(src), n)


def test_forward_matches_pallas(interpret):
    """Each op (Function and plain version) equals the Pallas kernel; f32
    sums of a few hundred terms in another order: atol 2e-5, as
    test_pallas_factorized.py holds the kernels against their XLA twins."""
    sh, gm, a, src, n, e = _data()
    tsh, tgm, ta, tsrc = _t(sh, gm, a, src)
    off = _off(src, n)
    cases = [
        (jq(*map(jnp.asarray, (sh, gm, src)), n, L_MAX, N_MAX),
         fs.q_scatter(tsh, tgm, tsrc, off, n, L_MAX, N_MAX),
         fs.q_scatter_plain(tsh, tgm, tsrc, n, L_MAX, N_MAX), (MN, n)),
        (jr1(*map(jnp.asarray, (a, sh, src)), e, L_MAX, N_MAX),
         fs.r1_gather(ta, tsh, tsrc, off, L_MAX, N_MAX),
         fs.r1_gather_plain(ta, tsh, tsrc, L_MAX, N_MAX), (LN, e)),
        (jr2(*map(jnp.asarray, (a, gm, src)), e, L_MAX, N_MAX),
         fs.r2_gather(ta, tgm, tsrc, off, L_MAX, N_MAX),
         fs.r2_gather_plain(ta, tgm, tsrc, L_MAX, N_MAX), (M, e)),
    ]
    for want, got, plain, shape in cases:
        assert tuple(got.shape) == shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=2e-5)
    # nodes without edges get exact zeros
    empty = np.setdiff1d(np.arange(n), src)
    assert empty.size and not cases[0][1][:, empty].any()


def _stage(q, r1, src, n):
    """s, g -> R1(Q(s, g), s): the factorized stage's projection."""
    return lambda s, g: r1(q(s, g, src, n, L_MAX, N_MAX), s, src, L_MAX, N_MAX)


def _port_stage(src, n):
    """:func:`_stage` of the port's Functions, with the offsets of ``src``."""
    off = _off(src, n)
    return _stage(lambda s, g, i, n_, l, nm: fs.q_scatter(s, g, i, off, n_, l, nm),
                  lambda a_, s_, i, l, nm: fs.r1_gather(a_, s_, i, off, l, nm), src, n)


def _f64_failure_record(request, got, want, tensors, port_terms, jax_terms, again) -> str:
    """What a failure of the f64 scalar below needs recorded, since it has
    failed once in a full parallel run and never alone: the state that could
    carry between the tests of one worker (default dtype, thread counts,
    deterministic mode, the C rounding mode, the tests this worker ran
    before), the dtype of every tensor of the stage, and the sum's terms
    sin(P - gm) compared one by one with JAX's, and with the port's own
    terms recomputed in the same process."""
    reporter = request.config.pluginmanager.get_plugin("terminalreporter")
    earlier = [] if reporter is None else list(dict.fromkeys(
        r.nodeid for reports in reporter.stats.values() for r in reports
        if hasattr(r, "when") and r.nodeid != request.node.nodeid))  # run, not deselected
    diff = np.abs(port_terms - jax_terms)
    worst = np.argsort(diff, axis=None)[::-1][:5]
    rows = [f"{tuple(map(int, np.unravel_index(i, diff.shape)))}: port "
            f"{float(port_terms.flat[i])!r} jax {float(jax_terms.flat[i])!r}" for i in worst]
    return "\n".join([
        f"f64 scalar: port {got!r}, JAX {want!r} (rel {abs(got - want) / abs(want):.3e})",
        f"worker {os.environ.get('PYTEST_XDIST_WORKER')}, default dtype "
        f"{torch.get_default_dtype()}, threads {torch.get_num_threads()}, interop "
        f"{torch.get_num_interop_threads()}, deterministic "
        f"{torch.are_deterministic_algorithms_enabled()}, C rounding mode "
        f"{ctypes.CDLL(None).fegetround()}",
        "dtypes: " + ", ".join(f"{k} {v.dtype}" for k, v in tensors.items()),
        f"terms: {int((diff > 0).sum())} of {diff.size} differ from JAX's, largest "
        f"{float(diff.max()):.3e}, sum of differences {float((port_terms - jax_terms).sum()):.3e}; "
        f"recomputed now, the port's terms move by {float(np.abs(again - port_terms).max()):.3e}",
        *rows,
        f"{len(earlier)} earlier tests in this worker: {earlier}",
    ])


def test_stage_vjp_matches_jax_grad(interpret, request):
    """The composed stage P = R1(Q(sh, gm), sh) and its VJP, two ways.

    float64: the scalar sum(sin(P - gm)) and its gradients with respect to
    sh and gm through the port's Functions against JAX's XLA twins
    (q_scatter_xla, r1_gather_xla) at x64: rtol 1e-12 on the value, and on
    each gradient atol 1e-12 of its largest magnitude (5,400 terms summed
    in other orders leave ~1e-14 relative).

    On a failure of the f64 scalar the test records the worker's state and
    the terms one by one (``_f64_failure_record``).

    float32, element by element, against the Pallas kernels in interpret
    mode: P, and the VJP of P for a standard-normal cotangent c. Every one
    of these numbers is a sum of products of the inputs, so each side's f32
    result lies within gamma_k * F(|sh|, |gm|, |c|) of the exact value,
    where F is the same function evaluated in f64 on absolute values (the
    sum of |term|) and gamma_k = k * 2^-24 / (1 - k * 2^-24), with k the
    longest chain of roundings: 2 * (largest node degree + l_max^2) + 2. The
    two sides may differ by twice that. (The f32 scalar itself is not
    compared: sin of P up to ~77 turns each P's rounding into an error of
    the sum, and its value moved by 2.7e-3 between runs of the same code.)
    """
    sh, gm, a, src, n, e = _data(e=600, n=32, seed=2)
    tsrc = torch.as_tensor(src)

    # float64: the port's Functions against the XLA twins at x64
    tsh, tgm = (torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (sh, gm))
    stage = _port_stage(tsrc, n)
    p64 = stage(tsh, tgm)
    terms = torch.sin(p64 - tgm)
    val = terms.sum()
    got_g = torch.autograd.grad(val, (tsh, tgm))
    with jax.enable_x64(True):
        jstage = _stage(q_scatter_xla, lambda a_, s_, src_, l, nm: r1_gather_xla(
            a_, s_, src_, e, l, nm), jnp.asarray(src), n)
        loss = lambda s, g: jnp.sum(jnp.sin(jstage(s, g) - g))  # noqa: E731
        args = (jnp.asarray(sh, jnp.float64), jnp.asarray(gm, jnp.float64))
        want = float(loss(*args))
        want_g = [np.asarray(w) for w in jax.grad(loss, argnums=(0, 1))(*args)]
        jax_terms = np.asarray(jnp.sin(jstage(*args) - args[1]))
    if float(val.detach()) != pytest.approx(want, rel=1e-12):
        with torch.no_grad():
            a64 = fs.q_scatter(tsh, tgm, tsrc, _off(src, n), n, L_MAX, N_MAX)
            again = torch.sin(stage(tsh, tgm) - tgm).numpy()
        pytest.fail(_f64_failure_record(
            request, float(val.detach()), want,
            {"sh": tsh, "gm": tgm, "A": a64, "P": p64, "terms": terms, "value": val},
            terms.detach().numpy(), jax_terms, again))
    for got, w in zip(got_g, want_g):
        assert w.dtype == np.float64
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max())

    # float32, element by element: the Function and the Pallas kernels
    cot = np.random.default_rng(7).standard_normal((LN, e)).astype(np.float32)
    tsh, tgm = (torch.tensor(x, requires_grad=True) for x in (sh, gm))
    proj = _port_stage(tsrc, n)(tsh, tgm)
    got = [proj.detach(), *torch.autograd.grad(proj, (tsh, tgm), torch.as_tensor(cot))]
    jproj, vjp = jax.vjp(_stage(jq, lambda a_, s_, src_, l, nm: jr1(a_, s_, src_, e, l, nm),
                                jnp.asarray(src), n), jnp.asarray(sh), jnp.asarray(gm))
    want = [jproj, *vjp(jnp.asarray(cot))]
    abs_sh, abs_gm = (torch.tensor(np.abs(x), dtype=torch.float64, requires_grad=True)
                      for x in (sh, gm))
    abs_proj = _port_stage(tsrc, n)(abs_sh, abs_gm)
    bound = [abs_proj.detach(), *torch.autograd.grad(
        abs_proj, (abs_sh, abs_gm), torch.as_tensor(np.abs(cot), dtype=torch.float64))]
    k = 2 * (int(np.bincount(src).max()) + L_MAX * L_MAX) + 2
    gamma = k * 2.0**-24 / (1 - k * 2.0**-24)
    for name, g, w, b in zip(("P", "d_sh", "d_gm"), got, want, bound):
        assert g.dtype == torch.float32
        err = np.abs(g.numpy().astype(np.float64) - np.asarray(w, np.float64))
        assert (err <= 2 * gamma * b.numpy()).all(), (name, float(err.max()))


@pytest.mark.parametrize("sizes", [(1, 1), (3, 3), (4, 4)])
@pytest.mark.parametrize("case", chip_smoke.SORTED_CASES)
def test_q_scatter_sorted_index_cases(case, sizes):
    """Q (Function and plain version) against q_scatter_xla on the sorted
    indices that chip_smoke.py holds the kernel to: one node owning every
    edge, a 20,480-edge run, runs across the kernel's chunk boundaries, a
    node count that is not a multiple of its 4-node blocks, long stretches
    of empty nodes. Dyadic data, so every f32 sum is exact in any order;
    atol 2e-5 as above."""
    l_max, n_max = sizes
    sh, gm, src, n = chip_smoke.q_case_inputs(case, l_max, n_max)
    want = np.asarray(q_scatter_xla(*map(jnp.asarray, (sh, gm, src)), n, l_max, n_max))
    tsh, tgm, tsrc = _t(sh, gm, src)
    got = fs.q_scatter(tsh, tgm, tsrc, _off(src, n), n, l_max, n_max)
    plain = fs.q_scatter_plain(tsh, tgm, tsrc, n, l_max, n_max)
    for x in (got, plain):
        assert tuple(x.shape) == (l_max * l_max * n_max, n) and x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), want, atol=2e-5)
    empty = np.setdiff1d(np.arange(n), src)
    assert empty.size and not got[:, empty].any()


@pytest.mark.parametrize("sizes", [(1, 1), (3, 3), (4, 4)])
@pytest.mark.parametrize("case", chip_smoke.SORTED_CASES)
@pytest.mark.parametrize("op", ["r1_gather", "r2_gather"])
def test_r_gather_sorted_index_cases(op, case, sizes):
    """R1 and R2 (Function and plain version) against r1_gather_xla and
    r2_gather_xla on the sorted indices that chip_smoke.py holds the kernels
    to: one node under every edge, a 20,480-edge run, runs of up to 160
    edges, a ragged node count, long stretches of empty nodes. Dyadic data
    and A of shape (MN, S) from a seed; atol 2e-5 as above."""
    l_max, n_max = sizes
    a, x, src, n = chip_smoke.r_case_inputs(case, op, l_max, n_max)
    xla = r1_gather_xla if op == "r1_gather" else r2_gather_xla
    want = np.asarray(xla(*map(jnp.asarray, (a, x, src)), src.shape[0], l_max, n_max))
    ta, tx, tsrc = _t(a, x, src)
    plain = getattr(fs, f"{op}_plain")
    rows = l_max * n_max if op == "r1_gather" else l_max * l_max
    got = getattr(fs, op)(ta, tx, tsrc, _off(src, n), l_max, n_max)
    for got in (got, plain(ta, tx, tsrc, l_max, n_max)):
        assert tuple(got.shape) == (rows, src.shape[0]) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("op", ["q_scatter", "r1_gather", "r2_gather"])
def test_functions_close_under_differentiation(op):
    """gradcheck and gradgradcheck at f64 (their default tolerances): each
    Function's backward is built from the other Functions, so it is itself
    differentiable, as training's gradient of a gradient needs."""
    l_max, n_max = 2, 2
    sh, gm, a, src, n, e = _data(e=14, n=5, seed=4, dtype=np.float64, l_max=l_max, n_max=n_max)
    tsrc, off = torch.as_tensor(src), _off(src, n)
    x, y = {
        "q_scatter": (sh, gm),
        "r1_gather": (a, sh),
        "r2_gather": (a, gm),
    }[op]
    x, y = (torch.tensor(v, requires_grad=True) for v in (x, y))
    if op == "q_scatter":
        fn = lambda s, g: fs.q_scatter(s, g, tsrc, off, n, l_max, n_max)  # noqa: E731
    else:
        fn = lambda p, q: getattr(fs, op)(p, q, tsrc, off, l_max, n_max)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x, y))
    assert torch.autograd.gradgradcheck(fn, (x, y))


def test_wrappers_reject_wrong_shapes():
    sh, gm, a, src, n, e = _data(e=20, n=4)
    tsh, tgm, ta, tsrc = _t(sh, gm, a, src)
    off = _off(src, n)
    with pytest.raises(ValueError, match="gm has shape"):
        fs.q_scatter(tsh, tgm[:, :-1], tsrc, off, n, L_MAX, N_MAX)
    with pytest.raises(ValueError, match="A has shape"):
        fs.r1_gather(ta[:-1], tsh, tsrc, off, L_MAX, N_MAX)
    with pytest.raises(ValueError, match="operand has shape"):
        fs.r2_gather(ta, tsh[:, :3], tsrc, off, L_MAX, N_MAX)
    with pytest.raises(ValueError, match="src must be 1-D"):
        fs.r2_gather(ta, tgm, tsrc[None], off, L_MAX, N_MAX)
    with pytest.raises(ValueError, match="offsets has shape"):
        fs.r1_gather(ta, tsh, tsrc, off[:-1], L_MAX, N_MAX)


def test_cpu_path_launches_no_kernel():
    profiling.reset_counts("launch.")
    sh, gm, a, src, n, e = _data(e=50, n=6)
    tsh, tgm, tsrc = _t(sh, gm, src)
    off = _off(src, n)
    fs.r1_gather(fs.q_scatter(tsh, tgm, tsrc, off, n, L_MAX, N_MAX), tsh, tsrc, off, L_MAX, N_MAX)
    assert not [k for k in profiling.counts() if k.startswith("launch.")]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port (the simulation path, the native loader, the
    training workflow, every CLI, the ensemble and ``utils/`` with its numpy
    oracle, ``parallel/`` with ``ops.halo`` and the rank launcher among them),
    imported in a fresh interpreter, loads no module of jax, flax or
    torch_m3gnet_tpu, and no logging package (the Trainer
    imports TensorBoard only when asked; ``utils.profiling`` imports
    torch.profiler's trace handler only inside ``device_trace``)."""
    code = """
import importlib, pkgutil, sys
import torch_m3gnet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "torch_m3gnet_tpu"))
print(len(names), bad)
assert not bad, bad
for name in ("ops.fused_triplet", "ops.windowed_take", "ops.factorized_stage", "models.m3gnet",
             "ops.sorted_segment", "data.dataset", "train.loop", "train.metrics",
             "train.elemental", "native", "data.neighborlist", "data.triplets", "simulate",
             "simulate.relax", "simulate.md", "simulate.observables", "simulate.eos",
             "simulate.elastic", "data.io", "data.streaming", "train.prefetch", "train.run",
             "cli", "cli.train_mlearn", "cli.train_mpf", "cli.common", "cli.predict",
             "cli.relax", "cli.md", "cli.elastic", "cli.bessel_zeros", "models.ensemble",
             "utils", "utils.cells", "utils.debug", "utils.oracle", "utils.profiling",
             "ops.halo", "parallel", "parallel.mesh", "parallel.distributed", "parallel.dp",
             "parallel.graph_shard", "parallel.launch"):
    assert pkg.__name__ + "." + name in names, name
assert len(names) >= 56, names
logging = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("tensorboard", "tensorboardX", "wandb", "mlflow"))
assert not logging, logging
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr
