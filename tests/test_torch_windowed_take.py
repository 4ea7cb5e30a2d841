"""The port's windowed take/scatter (torch_m3gnet_tpu_torch.ops.windowed_take)
against the JAX package's Pallas kernels, run in TPU interpret mode on the
CPU as tests/test_pallas_windowed_take.py runs them.

On the CPU the port's autograd Functions run the plain versions of the CUDA
kernels; chip_smoke.py holds the kernels against those on the card. The
indices are the real triplet_e1 (sorted) and triplet_e2 (unsorted) of a
packed batch, a synthetic e2 whose tiles span many windows, and a padded
tail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.ops.pallas_windowed_take import windowed_scatter_fm as jscatter
from torch_m3gnet_tpu.ops.pallas_windowed_take import windowed_take_fm as jtake
from torch_m3gnet_tpu_torch.ops import windowed_take as wt

# Pallas interpret mode contracts one-hot matrices in f32 on the CPU; the
# plain versions gather exactly and add in another order: f32 sums of up to
# ~700 terms of magnitude ~1 (the padded tail) differ by a few ulp of the
# sum: atol 1e-5 plus rtol 1e-6.
TOL = dict(atol=1e-5, rtol=1e-6)


def real_indices():
    """(e1, e2, E) of two perturbed 32-atom fcc-Cu cells, as the JAX tests
    build them."""
    rng = np.random.default_rng(0)
    base = JaxStructure.from_frac_coords(
        np.eye(3) * 3.62, [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], [29] * 4,
    ).supercell((2, 2, 2))
    s = JaxStructure(
        base.lattice, base.cart_coords + 0.05 * rng.standard_normal(base.cart_coords.shape),
        base.atomic_numbers,
    )
    batch = jax_pack([s, s], 5.0, 4.0, pad_multiple=256)
    return np.asarray(batch.triplet_e1), np.asarray(batch.triplet_e2), batch.num_edges


def synthetic_indices(seed=3):
    """All ordered pairs of distinct edges per node, node degrees 1..64, so
    that single 512-triplet tiles span several 256-edge windows."""
    degs = np.random.default_rng(seed).integers(1, 65, 120)
    e1, e2, off = [], [], 0
    for d in degs:
        a, b = np.meshgrid(np.arange(off, off + d), np.arange(off, off + d), indexing="ij")
        keep = a != b
        e1.append(a[keep])
        e2.append(b[keep])
        off += d
    return np.concatenate(e1).astype(np.int32), np.concatenate(e2).astype(np.int32), off


def _index(case):
    if case == "e1-sorted":
        e1, _, e = real_indices()
        return e1, e
    if case == "e2-unsorted":
        _, e2, e = real_indices()
        return e2, e
    if case == "synthetic-e2":
        _, e2, e = synthetic_indices()
        return e2, e
    # padded tail: index rows past the real ones all point at edge 0
    idx = np.concatenate([np.repeat(np.arange(40), 6), np.zeros(700)]).astype(np.int32)
    return idx, 100


CASES = ["e1-sorted", "e2-unsorted", "synthetic-e2", "padding-tail"]


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("case", CASES)
def test_forward_and_vjp_match_pallas(interpret, case):
    """take and scatter (Functions and plain versions) and each one's VJP,
    which is the other op, against the Pallas kernels and jax.grad."""
    idx, e = _index(case)
    f, t = 4, idx.shape[0]
    rng = np.random.default_rng(1)
    data = rng.standard_normal((f, e)).astype(np.float32)
    vals = rng.standard_normal((f, t)).astype(np.float32)
    w_take = rng.standard_normal((f, t)).astype(np.float32)
    w_scat = rng.standard_normal((f, e)).astype(np.float32)
    jidx = jnp.asarray(idx)
    tidx = torch.as_tensor(idx)

    want_take = np.asarray(jtake(jnp.asarray(data), jidx))
    want_scat = np.asarray(jscatter(jnp.asarray(vals), jidx, e))
    td = torch.tensor(data, requires_grad=True)
    tv = torch.tensor(vals, requires_grad=True)
    got_take = wt.windowed_take_fm(td, tidx)
    got_scat = wt.windowed_scatter_fm(tv, tidx, e)
    for got, plain, want in (
        (got_take, wt.take_fm_plain(td, tidx), want_take),
        (got_scat, wt.scatter_fm_plain(tv, tidx, e), want_scat),
    ):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
        np.testing.assert_allclose(plain.detach().numpy(), want, **TOL)

    want_dd = jax.grad(lambda d: jnp.sum(jtake(d, jidx) * w_take))(jnp.asarray(data))
    want_dv = jax.grad(lambda v: jnp.sum(jscatter(v, jidx, e) * w_scat))(jnp.asarray(vals))
    (got_dd,) = torch.autograd.grad((got_take * torch.as_tensor(w_take)).sum(), td)
    (got_dv,) = torch.autograd.grad((got_scat * torch.as_tensor(w_scat)).sum(), tv)
    np.testing.assert_allclose(got_dd.numpy(), np.asarray(want_dd), **TOL)
    np.testing.assert_allclose(got_dv.numpy(), np.asarray(want_dv), **TOL)


def test_grad_of_grad_matches_pallas(interpret):
    """Force-loss style double differentiation through the take (its VJP is
    the scatter, whose VJP is the take again), against JAX's; atol 5e-4 as
    test_pallas_windowed_take.py's closure test."""
    e1, _, e = real_indices()
    data = np.random.default_rng(7).standard_normal((4, e)).astype(np.float32)
    jidx, tidx = jnp.asarray(e1), torch.as_tensor(e1)

    def jloss(d):
        g = jax.grad(lambda x: jnp.sum(jnp.sin(jtake(x, jidx)) * jtake(x, jidx)))(d)
        return jnp.sum(g * g)

    want = jax.grad(jloss)(jnp.asarray(data))
    x = torch.tensor(data, requires_grad=True)
    y = wt.windowed_take_fm(x, tidx)
    (g,) = torch.autograd.grad((torch.sin(y) * y).sum(), x, create_graph=True)
    (got,) = torch.autograd.grad((g * g).sum(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("op", ["take", "scatter"])
def test_functions_close_under_differentiation(op):
    """gradcheck and gradgradcheck at f64 on an unsorted index with repeats
    and an edge that no index hits."""
    idx = torch.tensor([3, 0, 3, 1, 4, 4, 0, 3], dtype=torch.int32)
    rng = np.random.default_rng(4)
    if op == "take":
        x = torch.tensor(rng.standard_normal((3, 6)), requires_grad=True)
        fn = lambda d: wt.windowed_take_fm(d, idx)  # noqa: E731
    else:
        x = torch.tensor(rng.standard_normal((3, 8)), requires_grad=True)
        fn = lambda v: wt.windowed_scatter_fm(v, idx, 6)  # noqa: E731
    assert fn(x).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


def test_wrappers_reject_wrong_shapes_and_launch_nothing_on_cpu():
    wt.reset_launch_counts()
    idx = torch.tensor([0, 2, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="vals has shape"):
        wt.windowed_scatter_fm(torch.zeros(2, 4), idx, 3)
    with pytest.raises(ValueError, match="idx must be 1-D"):
        wt.windowed_take_fm(torch.zeros(2, 3), idx[None])
    with pytest.raises(ValueError, match="data has shape"):
        wt.windowed_take_fm(torch.zeros(3), idx)
    wt.windowed_scatter_fm(wt.windowed_take_fm(torch.ones(2, 3), idx), idx, 3)
    assert wt.LAUNCHES == {"windowed_take_fm": 0, "windowed_scatter_fm": 0}
