"""The port's windowed take/scatter (torch_m3gnet_tpu_torch.ops.windowed_take)
against the JAX package's Pallas kernels, run in TPU interpret mode on the
CPU as tests/test_pallas_windowed_take.py runs them.

On the CPU the port's autograd Functions run the plain versions of the CUDA
kernels; chip_smoke.py holds the kernels against those on the card. The
indices are the real triplet_e1 (sorted) and triplet_e2 (unsorted) of a
packed batch, a synthetic e2 whose tiles span many windows, and a padded
tail; and the sorted-index cases of chip_smoke.SORTED_CASES, with uniform
random e2. The scatter kernel sums each edge's run of its index's owners
(the stable order and its offsets, or the offsets of a sorted index), as
_scatter_by_owners does here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.ops.pallas_windowed_take import windowed_scatter_fm as jscatter
from torch_m3gnet_tpu.ops.pallas_windowed_take import windowed_take_fm as jtake
from torch_m3gnet_tpu_torch.ops import windowed_take as wt
from torch_m3gnet_tpu_torch.ops.fused_triplet import triplet_e2_order
from torch_m3gnet_tpu_torch.ops.sorted_segment import sorted_segment_offsets
from torch_m3gnet_tpu_torch.utils import profiling

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


def _owners(idx: torch.Tensor, num_edges: int) -> list:
    """The owners a caller may pass for ``idx``: its stable order with the
    order's offsets, and, for a sorted idx, its offsets alone (the identity
    order)."""
    owners = [triplet_e2_order(idx, num_edges)]
    if bool((idx[1:] >= idx[:-1]).all()):
        owners.append((None, sorted_segment_offsets(idx, num_edges)))
    return owners


def _scatter_by_owners(vals, order, offsets):
    """The scatter as the CUDA kernel sums it: for edge e, vals[:, order[i]]
    over i in [offsets[e], offsets[e + 1]), in that order (order None: the
    identity); here an f64 cumulative sum read at the run ends."""
    v = vals.double() if order is None else vals.double()[:, order.long()]
    cs = torch.nn.functional.pad(torch.cumsum(v, 1), (1, 0))
    off = offsets.long()
    return cs[:, off[1:]] - cs[:, off[:-1]]


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


# test_grad_of_grad_matches_pallas: each element is a sum over its edge's
# run of products of f32 sums, and where those cancel (h = 2 cos y - y sin y
# has a root near |y| = 1.08) one ulp of a sin, a cos or a summand moves the
# result by far more than the result. So both sides are held to the same
# chain in float64 (plain torch ops) element by element, within
# GRAD_GRAD_C f32 epsilons of the sum of the absolute values of that
# element's terms (each difference's terms counted apart). Measured on the
# CPU: the port's plain versions at most 6.0 of them, JAX's interpret mode
# 1.8; a flat 5e-4 left a few such elements to the luck of one ulp.
GRAD_GRAD_C = 8


def test_grad_of_grad_matches_pallas(interpret):
    """Force-loss style double differentiation through the take (its VJP is
    the scatter, whose VJP is the take again): JAX's and the port's, each
    against float64 within GRAD_GRAD_C * eps * sum |terms| per element."""
    e1, _, e = real_indices()
    data = np.random.default_rng(7).standard_normal((4, e)).astype(np.float32)
    jidx, tidx = jnp.asarray(e1), torch.as_tensor(e1)
    owners = (None, sorted_segment_offsets(tidx, e))  # as the model passes e1's

    def jloss(d):
        g = jax.grad(lambda x: jnp.sum(jnp.sin(jtake(x, jidx)) * jtake(x, jidx)))(d)
        return jnp.sum(g * g)

    want_jax = np.asarray(jax.grad(jloss)(jnp.asarray(data)))
    x = torch.tensor(data, requires_grad=True)
    y = wt.windowed_take_fm(x, tidx, owners)
    (g,) = torch.autograd.grad((torch.sin(y) * y).sum(), x, create_graph=True)
    (got,) = torch.autograd.grad((g * g).sum(), x)

    # the same chain in float64: g = scatter(y cos y + sin y), then
    # scatter(h * 2 g[idx]) with h the derivative of y cos y + sin y
    idx = tidx.long()
    y64 = torch.as_tensor(data, dtype=torch.float64)[:, idx]

    def scatter(v):
        return torch.zeros((4, e), dtype=torch.float64).index_add_(1, idx, v)

    g64 = scatter(torch.cos(y64) * y64 + torch.sin(y64))
    h64 = 2 * torch.cos(y64) - y64 * torch.sin(y64)
    ref = scatter(h64 * 2 * g64[:, idx]).numpy()
    g_abs = scatter((torch.cos(y64) * y64).abs() + torch.sin(y64).abs())
    terms = scatter(((2 * torch.cos(y64)).abs() + (y64 * torch.sin(y64)).abs())
                    * 2 * g_abs[:, idx]).numpy()
    bound = GRAD_GRAD_C * np.finfo(np.float32).eps * terms
    for label, v in (("port", got.numpy()), ("JAX", want_jax)):
        err = np.abs(v - ref)
        assert (err <= bound).all(), (
            f"{label}: {(err > bound).sum()} elements outside the bound, worst "
            f"{(err / np.maximum(bound, 1e-300)).max():.2f} of it")


@pytest.mark.parametrize("op", ["take", "scatter"])
def test_functions_close_under_differentiation(op):
    """gradcheck and gradgradcheck at f64 on an unsorted index with repeats
    and an edge that no index hits, with the index's owners (which each
    Function hands to its VJP), equal to the call without them."""
    idx = torch.tensor([3, 0, 3, 1, 4, 4, 0, 3], dtype=torch.int32)
    owners = triplet_e2_order(idx, 6)
    rng = np.random.default_rng(4)
    if op == "take":
        x = torch.tensor(rng.standard_normal((3, 6)), requires_grad=True)
        fn = lambda d, o=owners: wt.windowed_take_fm(d, idx, o)  # noqa: E731
    else:
        x = torch.tensor(rng.standard_normal((3, 8)), requires_grad=True)
        fn = lambda v, o=owners: wt.windowed_scatter_fm(v, idx, 6, o)  # noqa: E731
    assert fn(x).dtype == torch.float64
    assert torch.equal(fn(x), fn(x, None))
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


def test_wrappers_reject_wrong_shapes_and_launch_nothing_on_cpu():
    profiling.reset_counts("launch.")
    idx = torch.tensor([0, 2, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="vals has shape"):
        wt.windowed_scatter_fm(torch.zeros(2, 4), idx, 3)
    with pytest.raises(ValueError, match="idx must be 1-D"):
        wt.windowed_take_fm(torch.zeros(2, 3), idx[None])
    with pytest.raises(ValueError, match="data has shape"):
        wt.windowed_take_fm(torch.zeros(3), idx)
    order, offsets = triplet_e2_order(idx, 3)
    with pytest.raises(ValueError, match="order has shape"):
        wt.windowed_scatter_fm(torch.zeros(2, 3), idx, 3, (order[:2], offsets))
    with pytest.raises(ValueError, match="offsets has shape"):
        wt.windowed_take_fm(torch.zeros(2, 3), idx, (None, offsets[:3]))
    wt.windowed_scatter_fm(torch.ones(2, 3), idx, 3, (order, offsets))
    wt.windowed_scatter_fm(wt.windowed_take_fm(torch.ones(2, 3), idx), idx, 3)
    assert not [k for k in profiling.counts() if k.startswith("launch.")]


@pytest.mark.parametrize("case", CASES)
def test_scatter_by_owners_matches_pallas(interpret, case):
    """The scatter along each owners of the index (the stable order, and
    the offsets alone where the index is sorted), as the CUDA kernel sums
    it and through the Function, against the Pallas kernel; and the take's
    VJP with the same owners against jax.grad. TOL as above."""
    idx, e = _index(case)
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((4, idx.shape[0])).astype(np.float32)
    w = rng.standard_normal((4, idx.shape[0])).astype(np.float32)
    data = rng.standard_normal((4, e)).astype(np.float32)
    jidx, tidx = jnp.asarray(idx), torch.as_tensor(idx)
    want = np.asarray(jscatter(jnp.asarray(vals), jidx, e))
    want_dd = np.asarray(jax.grad(lambda d: jnp.sum(jtake(d, jidx) * w))(jnp.asarray(data)))
    owners = _owners(tidx, e)
    assert len(owners) == (1 + (case == "e1-sorted"))
    for order, offsets in owners:
        by_owners = _scatter_by_owners(torch.as_tensor(vals), order, offsets)
        got = wt.windowed_scatter_fm(torch.as_tensor(vals), tidx, e, (order, offsets))
        np.testing.assert_allclose(by_owners.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        x = torch.tensor(data, requires_grad=True)
        y = wt.windowed_take_fm(x, tidx, (order, offsets))
        (dd,) = torch.autograd.grad((y * torch.as_tensor(w)).sum(), x)
        np.testing.assert_allclose(dd.numpy(), want_dd, **TOL)


@pytest.mark.parametrize("index", ["e1", "e1-order", "e2"])
@pytest.mark.parametrize("case", chip_smoke.SORTED_CASES)
def test_scatter_sorted_index_cases(interpret, case, index):
    """The scatter on the sorted-index cases that chip_smoke.py holds the
    kernel to (one edge owning every entry, a 20,480-entry run, runs across
    chunk boundaries, a ragged edge count, long stretches of edges without
    entries), by the sorted ids with their offsets, by the same ids with
    their (identity) order, and by uniform random ids with their order: the
    Pallas kernel, the sum by owners, the Function and the plain version
    all equal (dyadic data, every f32 sum exact in any order), and zeros on
    the edges that no id hits."""
    vals, e1, e2, e = chip_smoke.scatter_case_inputs(case)
    idx = e2 if index == "e2" else e1
    tidx, tv = torch.as_tensor(idx), torch.as_tensor(vals)
    owners = ((None, sorted_segment_offsets(tidx, e)) if index == "e1"
              else triplet_e2_order(tidx, e))
    if index == "e1-order":  # a stable sort of sorted ids: the identity
        assert torch.equal(owners[0], torch.arange(idx.shape[0], dtype=torch.int32))
    want = np.asarray(jscatter(jnp.asarray(vals), jnp.asarray(idx), e))
    for got in (_scatter_by_owners(tv, *owners), wt.windowed_scatter_fm(tv, tidx, e, owners),
                wt.scatter_fm_plain(tv, tidx, e)):
        assert tuple(got.shape) == (4, e)
        np.testing.assert_array_equal(got.float().numpy(), want)
    empty = np.setdiff1d(np.arange(e), idx)
    assert not want[:, empty].any()
    assert empty.size or index == "e2"  # every sorted case leaves edges empty
