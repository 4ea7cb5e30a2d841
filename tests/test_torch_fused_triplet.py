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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.ops.pallas_fused_triplet import backward_pair as jpair
from torch_m3gnet_tpu.ops.pallas_fused_triplet import fused_triplet_gate_sum as jfused
from torch_m3gnet_tpu.ops.pallas_fused_triplet import reference_triplet_gate_sum
from torch_m3gnet_tpu_torch.ops import fused_triplet as ft

# Pallas interpret mode contracts one-hot matrices in f32 on the CPU; the
# plain versions gather exactly and add in another order: f32 sums of up to
# ~60 products of magnitude ~1 per edge: atol 1e-5 plus rtol 1e-6.
TOL = dict(atol=1e-5, rtol=1e-6)


def _indices(case):
    """(e1, e2, E, triplet mask)."""
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
        degs = np.random.default_rng(3).integers(1, 65, 120)
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


def _inputs(case, ln=9, seed=0, dtype=np.float32):
    e1, e2, e, mask = _indices(case)
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
    got = ft.fused_triplet_gate_sum(tb, tg, te1, te2, e)
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


@pytest.mark.parametrize("case", ["real", "padding-tail"])
def test_backward_pair_matches_pallas(interpret, case):
    basis, gate, g, e1, e2, e = _inputs(case, seed=1)
    want = jpair(*map(jnp.asarray, (basis, gate, g, e1, e2)), e)
    tb, tg, tgg = _t(basis, gate, g)
    te1, te2 = torch.as_tensor(e1), torch.as_tensor(e2)
    got = ft.backward_pair(tb, tg, tgg, te1, te2, e)
    plain = ft.backward_pair_plain(tb, tg, tgg, te1, te2, e)
    for x, p, y in zip(got, plain, want):
        assert x.dtype == torch.float32 and tuple(x.shape) == y.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)
        np.testing.assert_allclose(p.numpy(), np.asarray(y), **TOL)


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
    out = torch.sin(ft.fused_triplet_gate_sum(tb, tg, te1, te2, e)).sum()
    db, dg = torch.autograd.grad(out, (tb, tg), create_graph=True)
    loss = (db * db * torch.as_tensor(wb)).sum() + (dg * torch.as_tensor(wg)).sum()
    got = torch.autograd.grad(loss, (tb, tg))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("op", ["fused_triplet_gate_sum", "backward_pair"])
def test_functions_close_under_differentiation(op):
    """gradcheck and gradgradcheck at f64: each Function's backward is built
    from the two Functions, so it is itself differentiable, as training's
    gradient of a gradient needs."""
    e1 = torch.tensor([0, 0, 0, 2, 2, 3, 5, 5], dtype=torch.int32)  # sorted; 1 and 4 own none
    e2 = torch.tensor([2, 3, 5, 0, 3, 5, 0, 2], dtype=torch.int32)
    rng = np.random.default_rng(4)
    basis, gate, g = (torch.tensor(rng.standard_normal(s), requires_grad=True)
                      for s in ((3, 8), (3, 6), (3, 6)))
    if op == "fused_triplet_gate_sum":
        fn, args = (lambda b, G: ft.fused_triplet_gate_sum(b, G, e1, e2, 6)), (basis, gate)
    else:
        fn, args = (lambda b, G, c: ft.backward_pair(b, G, c, e1, e2, 6)), (basis, gate, g)
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


def test_wrappers_reject_wrong_shapes_and_launch_nothing_on_cpu():
    ft.reset_launch_counts()
    e1 = torch.tensor([0, 1, 1], dtype=torch.int32)
    e2 = torch.tensor([1, 0, 2], dtype=torch.int32)
    b, gate = torch.ones(2, 3), torch.ones(2, 3)
    with pytest.raises(ValueError, match="gate_e has shape"):
        ft.fused_triplet_gate_sum(b, gate[:, :2], e1, e2, 3)
    with pytest.raises(ValueError, match="basis has shape"):
        ft.backward_pair(b[:, :2], gate, gate, e1, e2, 3)
    with pytest.raises(ValueError, match="e1 and e2"):
        ft.fused_triplet_gate_sum(b, gate, e1, e2[:2], 3)
    ft.backward_pair(b, gate, ft.fused_triplet_gate_sum(b, gate, e1, e2, 3), e1, e2, 3)
    assert ft.LAUNCHES == {"fused_triplet_gate_sum": 0, "backward_pair": 0}
