"""The port's fused three-body stage (torch_m3gnet_tpu_torch.ops.fused_triplet)
against the JAX package's Pallas kernels, run in TPU interpret mode on the
CPU as tests/test_pallas_fused_triplet.py runs them, and against
``reference_triplet_gate_sum``.

On the CPU the port's autograd Functions run the plain versions of the CUDA
kernels; chip_smoke.py holds the kernels against those on the card. The
indices are the real triplets of a packed batch (sorted e1, unsorted e2,
padded tail), synthetic triplets whose tiles span many windows, and a
hand-built padded tail.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.ops.pallas_fused_triplet import backward_pair as jpair
from torch_m3gnet_tpu.ops.pallas_fused_triplet import fused_triplet_gate_sum as jfused
from torch_m3gnet_tpu.ops.pallas_fused_triplet import reference_triplet_gate_sum
from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
from torch_m3gnet_tpu_torch.utils import profiling

# Pallas interpret mode contracts one-hot matrices in f32 on the CPU; the
# plain versions gather exactly and add in another order: f32 sums of up to
# ~60 products of magnitude ~1 per edge: atol 1e-5 plus rtol 1e-6.
TOL = dict(atol=1e-5, rtol=1e-6)


def _indices(case, nodes=120):
    """(e1, e2, E, triplet mask); ``nodes``: the synthetic case's first
    nodes only."""
    if case == "real":
        rng = np.random.default_rng(0)
        base = JaxStructure.from_frac_coords(
            np.eye(3) * 3.62, [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]],
            [29] * 4,
        ).supercell((2, 2, 2))
        s = JaxStructure(
            base.lattice, base.cart_coords + 0.05 * rng.standard_normal(base.cart_coords.shape),
            base.atomic_numbers,
        )
        b = jax_pack([s, s], 5.0, 4.0, pad_multiple=256)
        return (np.asarray(b.triplet_e1), np.asarray(b.triplet_e2), b.num_edges,
                np.asarray(b.triplet_mask, dtype=np.float32))
    if case == "synthetic":
        # all ordered pairs of distinct edges per node, degrees 1..64
        degs = np.random.default_rng(3).integers(1, 65, 120)[:nodes]
        e1, e2, off = [], [], 0
        for d in degs:
            a, c = np.meshgrid(np.arange(off, off + d), np.arange(off, off + d), indexing="ij")
            e1.append(a[a != c])
            e2.append(c[a != c])
            off += d
        e1, e2 = np.concatenate(e1).astype(np.int32), np.concatenate(e2).astype(np.int32)
        return e1, e2, off, np.ones(e1.shape, np.float32)
    # padded tail: e1 = E - 1 (sorted), e2 = 0, zero basis; edges 40..98 own nothing
    e1 = np.concatenate([np.repeat(np.arange(40), 6), np.full(700, 99)]).astype(np.int32)
    e2 = np.concatenate([np.repeat(np.arange(40), 6) + 1, np.zeros(700)]).astype(np.int32)
    return e1, e2, 100, np.concatenate([np.ones(240), np.zeros(700)]).astype(np.float32)


def _inputs(case, ln=9, seed=0, dtype=np.float32, nodes=120):
    e1, e2, e, mask = _indices(case, nodes)
    rng = np.random.default_rng(seed)
    basis = (rng.standard_normal((ln, e1.shape[0])) * mask).astype(dtype)
    gate = rng.uniform(0, 1, (ln, e)).astype(dtype)
    g = rng.standard_normal((ln, e)).astype(dtype)
    return basis, gate, g, e1, e2, e


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _t(*xs, grad=False):
    return [torch.tensor(x, requires_grad=grad) for x in xs]


@pytest.mark.parametrize("case", ["real", "synthetic", "padding-tail"])
def test_forward_and_vjp_match_pallas(interpret, case):
    """The forward (Function and plain version) against the Pallas kernel
    and the XLA reference; its VJP (one backward_pair) against jax.grad
    through the Pallas backward kernel."""
    basis, gate, _, e1, e2, e = _inputs(case)
    w = np.random.default_rng(5).standard_normal((basis.shape[0], e)).astype(np.float32)
    jargs = (jnp.asarray(basis), jnp.asarray(gate), jnp.asarray(e1), jnp.asarray(e2))
    want = np.asarray(jfused(*jargs, e))
    ref = np.asarray(reference_triplet_gate_sum(*jargs, e))
    tb, tg = _t(basis, gate, grad=True)
    te1, te2 = torch.as_tensor(e1), torch.as_tensor(e2)
    got = ft.fused_triplet_gate_sum(tb, tg, te1, te2, e, ft.triplet_e2_order(te2, e))
    plain = ft.fused_triplet_gate_sum_plain(tb, tg, te1, te2, e)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    for x in (got, plain):
        np.testing.assert_allclose(x.detach().numpy(), want, **TOL)
        np.testing.assert_allclose(x.detach().numpy(), ref, **TOL)
    # edges that own no triplet get exact zeros
    empty = np.setdiff1d(np.arange(e), e1)
    assert empty.size and not got[:, empty].any()

    want_g = jax.grad(lambda b, g: jnp.sum(jfused(b, g, *jargs[2:], e) * w), argnums=(0, 1))(
        *jargs[:2]
    )
    got_g = torch.autograd.grad((got * torch.as_tensor(w)).sum(), (tb, tg))
    for x, y in zip(got_g, want_g):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


@pytest.mark.parametrize("ln", [1, 9, 16])
@pytest.mark.parametrize("case", chip_smoke.SORTED_CASES)
def test_forward_sorted_index_cases(case, ln):
    """The forward (Function and plain version) against
    reference_triplet_gate_sum on the sorted e1 that chip_smoke.py holds the
    kernel to: one edge owning every triplet, a 20,480-triplet run, runs
    across the kernel's chunk boundaries, an edge count that is not a
    multiple of its 256-edge blocks, long stretches of edges without
    triplets; e2 uniform over the edges. Dyadic data, so every f32 sum is
    exact in any order; TOL as above."""
    basis, gate, e1, e2, e = chip_smoke.triplet_case_inputs(case, ln)
    want = np.asarray(reference_triplet_gate_sum(*map(jnp.asarray, (basis, gate, e1, e2)), e))
    tb, tg, te1, te2 = _t(basis, gate, e1, e2)
    got = ft.fused_triplet_gate_sum(tb, tg, te1, te2, e, ft.triplet_e2_order(te2, e))
    plain = ft.fused_triplet_gate_sum_plain(tb, tg, te1, te2, e)
    for x in (got, plain):
        assert tuple(x.shape) == (ln, e) and x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), want, **TOL)
    empty = np.setdiff1d(np.arange(e), e1)
    assert empty.size and not got[:, empty].any()


def _d_gate_by_order(basis, g, e1, order, off2):
    """dG as the backward kernel sums it: for edge e, the products
    g[:, e1[t]] * basis[:, t] over t = order[off2[e]:off2[e + 1]], in that
    order (here an f64 cumulative sum read at the run ends)."""
    o = order.long()
    prod = (g.double()[:, e1.long()[o]] * basis.double()[:, o])
    cs = torch.nn.functional.pad(torch.cumsum(prod, 1), (1, 0))
    off = off2.long()
    return cs[:, off[1:]] - cs[:, off[:-1]]


@pytest.mark.parametrize("case, ln", [
    pytest.param(c, ln, id=c if ln == 9 else f"{c}-ln{ln}")
    for ln in (9, 1, 16) for c in ("real", "padding-tail", "synthetic")
])
def test_backward_pair_matches_pallas(interpret, case, ln):
    """backward_pair with the batch's e2 order (Function and plain version)
    against the Pallas backward kernel; dG also as the CUDA kernel sums it,
    each edge's run of the e2 order, which holds the order and its offsets
    (the padding tail puts 700 triplets on edge 0). TOL as above."""
    basis, gate, g, e1, e2, e = _inputs(case, ln=ln, seed=1)
    want = jpair(*map(jnp.asarray, (basis, gate, g, e1, e2)), e)
    tb, tg, tgg = _t(basis, gate, g)
    te1, te2 = torch.as_tensor(e1), torch.as_tensor(e2)
    order = ft.triplet_e2_order(te2, e)
    got = ft.backward_pair(tb, tg, tgg, te1, te2, e, order)
    plain = ft.backward_pair_plain(tb, tg, tgg, te1, te2, e)
    for x, p, y in zip(got, plain, want):
        assert x.dtype == torch.float32 and tuple(x.shape) == y.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)
        np.testing.assert_allclose(p.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(_d_gate_by_order(tb, tgg, te1, *order).numpy(),
                               np.asarray(want[1]), **TOL)


@pytest.mark.parametrize("ln", [1, 9, 16])
@pytest.mark.parametrize("case", chip_smoke.SORTED_CASES)
def test_backward_pair_sorted_index_cases(case, ln):
    """backward_pair on the sorted e1 and uniform random e2 of every case
    that chip_smoke.py holds the kernel to (one edge owning every triplet, a
    20,480-triplet run, runs across chunk boundaries, a ragged edge count,
    long stretches of empty edges): dyadic data, so every f32 sum is exact
    in any order, and the Function, the plain version and the sum by the
    e2 order agree exactly; edges that no e2 points at get zeros."""
    basis, gate, e1, e2, e = chip_smoke.triplet_case_inputs(case, ln)
    g = chip_smoke.dyadic(np.random.default_rng(60 + ln), gate.shape)
    tb, tg, tgg, te1, te2 = _t(basis, gate, g, e1, e2)
    order = ft.triplet_e2_order(te2, e)
    d_basis, d_gate = ft.backward_pair(tb, tg, tgg, te1, te2, e, order)
    want_b, want_g = ft.backward_pair_plain(tb, tg, tgg, te1, te2, e)
    assert tuple(d_basis.shape) == (ln, e1.shape[0]) and tuple(d_gate.shape) == (ln, e)
    assert torch.equal(d_basis, want_b) and torch.equal(d_gate, want_g)
    by_order = _d_gate_by_order(tb, tgg, te1, *order)
    assert torch.equal(by_order, want_g.double())
    unowned = np.setdiff1d(np.arange(e), e2)
    assert not d_gate[:, unowned].any()


def test_grad_of_grad_matches_jax(interpret):
    """A force-loss style second derivative: differentiate a loss on the
    first gradients (d basis, d gate) of sum(sin(fused(basis, gate))). JAX
    takes it through _pair_bwd (backward_pair + two forward calls), the port
    through BackwardPair.backward; atol 5e-4 as the JAX closure tests."""
    basis, gate, _, e1, e2, e = _inputs("real", seed=2)
    rng = np.random.default_rng(6)
    wb = rng.standard_normal(basis.shape).astype(np.float32)
    wg = rng.standard_normal(gate.shape).astype(np.float32)
    je1, je2 = jnp.asarray(e1), jnp.asarray(e2)

    def jloss(b, g):
        db, dg = jax.grad(lambda x, y: jnp.sum(jnp.sin(jfused(x, y, je1, je2, e))),
                          argnums=(0, 1))(b, g)
        return jnp.sum(db * db * wb) + jnp.sum(dg * wg)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(basis), jnp.asarray(gate))
    tb, tg = _t(basis, gate, grad=True)
    te1, te2 = torch.as_tensor(e1), torch.as_tensor(e2)
    order = ft.triplet_e2_order(te2, e)
    out = torch.sin(ft.fused_triplet_gate_sum(tb, tg, te1, te2, e, order)).sum()
    db, dg = torch.autograd.grad(out, (tb, tg), create_graph=True)
    loss = (db * db * torch.as_tensor(wb)).sum() + (dg * torch.as_tensor(wg)).sum()
    got = torch.autograd.grad(loss, (tb, tg))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("op", ["fused_triplet_gate_sum", "backward_pair"])
def test_functions_close_under_differentiation(op):
    """gradcheck and gradgradcheck at f64: each Function's backward is built
    from the two Functions, so it is itself differentiable, as training's
    gradient of a gradient needs; every backward carries the e2 order on."""
    e1 = torch.tensor([0, 0, 0, 2, 2, 3, 5, 5], dtype=torch.int32)  # sorted; 1 and 4 own none
    e2 = torch.tensor([2, 3, 5, 0, 3, 5, 0, 2], dtype=torch.int32)
    order = ft.triplet_e2_order(e2, 6)
    rng = np.random.default_rng(4)
    basis, gate, g = (torch.tensor(rng.standard_normal(s), requires_grad=True)
                      for s in ((3, 8), (3, 6), (3, 6)))
    if op == "fused_triplet_gate_sum":
        fn = lambda b, G: ft.fused_triplet_gate_sum(b, G, e1, e2, 6, order)  # noqa: E731
        args = (basis, gate)
    else:
        fn = lambda b, G, c: ft.backward_pair(b, G, c, e1, e2, 6, order)  # noqa: E731
        args = (basis, gate, g)
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


def test_wrappers_reject_wrong_shapes_and_launch_nothing_on_cpu():
    profiling.reset_counts("launch.")
    e1 = torch.tensor([0, 1, 1], dtype=torch.int32)
    e2 = torch.tensor([1, 0, 2], dtype=torch.int32)
    b, gate = torch.ones(2, 3), torch.ones(2, 3)
    order, offsets = ft.triplet_e2_order(e2, 3)
    with pytest.raises(ValueError, match="gate_e has shape"):
        ft.fused_triplet_gate_sum(b, gate[:, :2], e1, e2, 3, (order, offsets))
    with pytest.raises(ValueError, match="basis has shape"):
        ft.backward_pair(b[:, :2], gate, gate, e1, e2, 3, (order, offsets))
    with pytest.raises(ValueError, match="e1 and e2"):
        ft.fused_triplet_gate_sum(b, gate, e1, e2[:2], 3, (order, offsets))
    with pytest.raises(ValueError, match="the e2 order must be"):
        ft.backward_pair(b, gate, gate, e1, e2, 3, (order[:2], offsets))
    with pytest.raises(ValueError, match="the e2 order must be"):
        ft.fused_triplet_gate_sum(b, gate, e1, e2, 3, (order, offsets[:3]))
    out = ft.fused_triplet_gate_sum(b, gate, e1, e2, 3, (order, offsets))
    ft.backward_pair(b, gate, out, e1, e2, 3, (order, offsets))
    assert not [k for k in profiling.counts() if k.startswith("launch.")]


def _patterns(n):
    """Every in_dims of ``n`` float operands with at least one batched: each
    operand shared (None) or with the member axis in front (0)."""
    return [p for p in itertools.product((None, 0), repeat=n) if any(d == 0 for d in p)]


@pytest.mark.parametrize("op, case, in_dims", [
    pytest.param(op, case, dims, id=f"{op}-{case}-{'-'.join(map(str, dims))}")
    for op, n in (("fused_triplet_gate_sum", 2), ("backward_pair", 3))
    for case in ("real", "synthetic", "padding-tail") for dims in _patterns(n)
])
def test_member_axis_matches_jax_vmap(interpret, op, case, in_dims):
    """``torch.func.vmap`` of the port's op at K = 3 members against
    ``jax.vmap`` of the Pallas kernel, which JAX runs as one ``pallas_call``
    with a member grid axis (the committee's forward shares the basis, its
    VJP the basis too, a Hessian's rows batch it): every pattern of shared
    and batched float operands. The port's Function takes the members as one
    (K, rows, cols) call: one launch on the card, the plain version per
    member here, where nothing launches. The synthetic case keeps its first
    16 nodes (14,462 triplets), so that interpret mode takes a few seconds
    at K = 3. TOL as above."""
    k = 3
    basis, gate, g, e1, e2, e = zip(*(_inputs(case, seed=20 + i, nodes=16) for i in range(k)))
    e1, e2, e = e1[0], e2[0], e[0]
    floats = [np.stack(x) for x in ((basis, gate) if op == "fused_triplet_gate_sum"
                                     else (basis, gate, g))]
    floats = [x if d == 0 else x[0] for x, d in zip(floats, in_dims)]
    je1, je2 = jnp.asarray(e1), jnp.asarray(e2)
    te1, te2 = torch.as_tensor(e1), torch.as_tensor(e2)
    order = ft.triplet_e2_order(te2, e)
    if op == "fused_triplet_gate_sum":
        jfn = lambda b, q: jfused(b, q, je1, je2, e)  # noqa: E731
        tfn = lambda b, q: ft.fused_triplet_gate_sum(b, q, te1, te2, e, order)  # noqa: E731
    else:
        jfn = lambda b, q, c: jpair(b, q, c, je1, je2, e)  # noqa: E731
        tfn = lambda b, q, c: ft.backward_pair(b, q, c, te1, te2, e, order)  # noqa: E731
    want = jax.vmap(jfn, in_axes=in_dims)(*map(jnp.asarray, floats))
    profiling.reset_counts("launch.")
    got = torch.func.vmap(tfn, in_dims=in_dims)(*map(torch.as_tensor, floats))
    assert not [k for k in profiling.counts() if k.startswith("launch.")]
    want, got = (x if isinstance(x, tuple) else (x,) for x in (want, got))
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and tuple(x.shape) == y.shape and y.shape[0] == k
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


def test_member_axis_mismatch_raises_and_launches_nothing_on_cpu():
    """(K, LN, cols) operands go to the Function as one call; two member
    counts, a member axis on an operand of the wrong shape, or a fourth
    axis raise before anything runs."""
    profiling.reset_counts("launch.")
    e1 = torch.tensor([0, 1, 1], dtype=torch.int32)
    e2 = torch.tensor([1, 0, 2], dtype=torch.int32)
    order = ft.triplet_e2_order(e2, 3)
    b, gate = torch.ones(2, 3), torch.ones(2, 3)
    b3, gate3, gate4 = torch.ones(3, 2, 3), torch.ones(3, 2, 3), torch.ones(4, 2, 3)
    with pytest.raises(ValueError, match="different member counts"):
        ft.fused_triplet_gate_sum(b3, gate4, e1, e2, 3, order)
    with pytest.raises(ValueError, match="different member counts"):
        ft.backward_pair(b, gate3, gate4, e1, e2, 3, order)
    with pytest.raises(ValueError, match="different member counts"):
        ft.backward_pair(b3, gate, gate4, e1, e2, 3, order)
    with pytest.raises(ValueError, match="gate_e has shape"):
        ft.fused_triplet_gate_sum(b, torch.ones(3, 2, 4), e1, e2, 3, order)
    with pytest.raises(ValueError, match="basis has shape"):
        ft.backward_pair(torch.ones(3, 2, 2), gate3, gate3, e1, e2, 3, order)
    with pytest.raises(ValueError, match="g has shape"):
        ft.backward_pair(b3, gate3, torch.ones(3, 1, 3), e1, e2, 3, order)
    with pytest.raises(ValueError, match=r"must be \(rows, cols\) or \(K, rows, cols\)"):
        ft.fused_triplet_gate_sum(torch.ones(1, 3, 2, 3), gate3, e1, e2, 3, order)
    out = ft.fused_triplet_gate_sum(b, gate3, e1, e2, 3, order)
    d_basis, d_gate = ft.backward_pair(b, gate3, out, e1, e2, 3, order)
    assert out.shape == (3, 2, 3) and d_basis.shape == (3, 2, 3) and d_gate.shape == (3, 2, 3)
    assert not [k for k in profiling.counts() if k.startswith("launch.")]
