"""The port's factorized-stage ops (torch_m3gnet_tpu_torch.ops.factorized_stage)
against the JAX package's Pallas kernels, run in TPU interpret mode on the
CPU as tests/test_pallas_factorized.py runs them.

On the CPU the port's autograd Functions run the plain versions of the CUDA
kernels; chip_smoke.py holds the kernels against those on the card.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.ops.pallas_factorized_stage import q_scatter as jq
from torch_m3gnet_tpu.ops.pallas_factorized_stage import r1_gather as jr1
from torch_m3gnet_tpu.ops.pallas_factorized_stage import r2_gather as jr2
from torch_m3gnet_tpu_torch.ops import factorized_stage as fs

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


def test_forward_matches_pallas(interpret):
    """Each op (Function and plain version) equals the Pallas kernel; f32
    sums of a few hundred terms in another order: atol 2e-5, as
    test_pallas_factorized.py holds the kernels against their XLA twins."""
    sh, gm, a, src, n, e = _data()
    tsh, tgm, ta, tsrc = _t(sh, gm, a, src)
    cases = [
        (jq(*map(jnp.asarray, (sh, gm, src)), n, L_MAX, N_MAX),
         fs.q_scatter(tsh, tgm, tsrc, n, L_MAX, N_MAX),
         fs.q_scatter_plain(tsh, tgm, tsrc, n, L_MAX, N_MAX), (MN, n)),
        (jr1(*map(jnp.asarray, (a, sh, src)), e, L_MAX, N_MAX),
         fs.r1_gather(ta, tsh, tsrc, L_MAX, N_MAX),
         fs.r1_gather_plain(ta, tsh, tsrc, L_MAX, N_MAX), (LN, e)),
        (jr2(*map(jnp.asarray, (a, gm, src)), e, L_MAX, N_MAX),
         fs.r2_gather(ta, tgm, tsrc, L_MAX, N_MAX),
         fs.r2_gather_plain(ta, tgm, tsrc, L_MAX, N_MAX), (M, e)),
    ]
    for want, got, plain, shape in cases:
        assert tuple(got.shape) == shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=2e-5)
    # nodes without edges get exact zeros
    empty = np.setdiff1d(np.arange(n), src)
    assert empty.size and not cases[0][1][:, empty].any()


def test_stage_vjp_matches_jax_grad(interpret):
    """sum(sin(R1(Q(sh, gm), sh) - gm)) and its gradients with respect to sh
    and gm, at the tolerances of test_pallas_factorized.py: abs 5e-4 on the
    cancellation-heavy f32 value; atol 5e-4, rtol 1e-3 on the gradients
    (two chained f32 segment reductions in different orders)."""
    sh, gm, a, src, n, e = _data(e=600, n=32, seed=2)

    def jstage(s, g):
        proj = jr1(jq(s, g, jnp.asarray(src), n, L_MAX, N_MAX), s, jnp.asarray(src), e, L_MAX, N_MAX)
        return jnp.sum(jnp.sin(proj - g))

    want = float(jstage(jnp.asarray(sh), jnp.asarray(gm)))
    want_g = jax.grad(jstage, argnums=(0, 1))(jnp.asarray(sh), jnp.asarray(gm))

    tsh, tgm = (torch.tensor(x, requires_grad=True) for x in (sh, gm))
    tsrc = torch.as_tensor(src)
    proj = fs.r1_gather(fs.q_scatter(tsh, tgm, tsrc, n, L_MAX, N_MAX), tsh, tsrc, L_MAX, N_MAX)
    val = torch.sin(proj - tgm).sum()
    got_g = torch.autograd.grad(val, (tsh, tgm))
    assert float(val.detach()) == pytest.approx(want, abs=5e-4)
    for got, w in zip(got_g, want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("op", ["q_scatter", "r1_gather", "r2_gather"])
def test_functions_close_under_differentiation(op):
    """gradcheck and gradgradcheck at f64 (their default tolerances): each
    Function's backward is built from the other Functions, so it is itself
    differentiable, as training's gradient of a gradient needs."""
    l_max, n_max = 2, 2
    sh, gm, a, src, n, e = _data(e=14, n=5, seed=4, dtype=np.float64, l_max=l_max, n_max=n_max)
    tsrc = torch.as_tensor(src)
    x, y = {
        "q_scatter": (sh, gm),
        "r1_gather": (a, sh),
        "r2_gather": (a, gm),
    }[op]
    x, y = (torch.tensor(v, requires_grad=True) for v in (x, y))
    if op == "q_scatter":
        fn = lambda s, g: fs.q_scatter(s, g, tsrc, n, l_max, n_max)  # noqa: E731
    else:
        fn = lambda p, q: getattr(fs, op)(p, q, tsrc, l_max, n_max)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x, y))
    assert torch.autograd.gradgradcheck(fn, (x, y))


def test_wrappers_reject_wrong_shapes():
    sh, gm, a, src, n, e = _data(e=20, n=4)
    tsh, tgm, ta, tsrc = _t(sh, gm, a, src)
    with pytest.raises(ValueError, match="gm has shape"):
        fs.q_scatter(tsh, tgm[:, :-1], tsrc, n, L_MAX, N_MAX)
    with pytest.raises(ValueError, match="A has shape"):
        fs.r1_gather(ta[:-1], tsh, tsrc, L_MAX, N_MAX)
    with pytest.raises(ValueError, match="operand has shape"):
        fs.r2_gather(ta, tsh[:, :3], tsrc, L_MAX, N_MAX)
    with pytest.raises(ValueError, match="src must be 1-D"):
        fs.r2_gather(ta, tgm, tsrc[None], L_MAX, N_MAX)


def test_cpu_path_launches_no_kernel():
    fs.reset_launch_counts()
    sh, gm, a, src, n, e = _data(e=50, n=6)
    tsh, tgm, tsrc = _t(sh, gm, src)
    fs.r1_gather(fs.q_scatter(tsh, tgm, tsrc, n, L_MAX, N_MAX), tsh, tsrc, L_MAX, N_MAX)
    assert fs.LAUNCHES == {"q_scatter": 0, "r1_gather": 0, "r2_gather": 0}


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, imported in a fresh interpreter, loads no
    module of jax, flax or torch_m3gnet_tpu."""
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
for name in ("ops.fused_triplet", "ops.windowed_take", "ops.factorized_stage", "models.m3gnet"):
    assert pkg.__name__ + "." + name in names, name
assert len(names) >= 14, names
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr
