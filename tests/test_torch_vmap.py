"""The port's nine kernel Functions under ``torch.func``, on the CPU.

Each Function (B1-B3 ``QScatter``/``R1Gather``/``R2Gather``, B4/B5
``FusedTripletGateSum``/``BackwardPair``, B6/B7 ``WindowedTake``/
``WindowedScatter``, B8 ``SortedSegmentSum`` and its VJP ``SortedTake``)
defines ``setup_context`` and an explicit ``vmap`` rule, as JAX's
``custom_vjp`` kernels run under ``jax.vmap`` and ``jax.grad``. The CPU runs
the same rules as the card; only the launch below them is the plain
version. At f64, on small adversarial ids (empty segments, a run of four,
an unsorted index with repeats and an edge that no index hits):

- ``gradcheck`` and ``gradgradcheck`` with ``check_batched_grad=True``
  (torch maps those batched gradients with its older ``_vmap_internals``,
  which knows no Function's vmap rule: on the CPU the plain versions take
  its batched tensors; the card's path is the next item's);
- ``vmap`` against a Python loop over the members (1e-12), for every
  pattern of the float operands' ``in_dims``: each batched (member axis at
  0 or at 1) or shared, at least one batched; a batched index raises, and
  so does a second vmap level (the Functions take one member axis);
- ``torch.func.grad`` and ``vjp`` against ``torch.autograd.grad``; ``vmap``
  of ``grad`` (a committee's per-member force pass) and ``vmap`` of the
  VJP over batched cotangents with the saved tensors shared (a Hessian's
  rows, ``simulate.elastic``) against loops.
"""

import itertools

import numpy as np
import pytest
import torch

from torch_m3gnet_tpu_torch.ops import factorized_stage as fs
from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
from torch_m3gnet_tpu_torch.ops import sorted_segment as ss
from torch_m3gnet_tpu_torch.ops import windowed_take as wt

K = 3
TOL = dict(rtol=1e-12, atol=1e-12)
# sorted ids over 7 segments: 0, 3 and 6 own nothing, 4 owns a run of four
SEG = torch.tensor([1, 1, 2, 4, 4, 4, 4, 5], dtype=torch.int32)
NSEG = 7
# unsorted ids over 6 edges, with repeats; edge 2 and 5 are hit by none
IDX = torch.tensor([3, 0, 3, 1, 4, 4, 0, 3], dtype=torch.int32)
NIDX = 6
# sorted triplet_e1 over those 6 edges
E1 = torch.tensor([0, 0, 1, 3, 3, 3, 3, 5], dtype=torch.int32)
# the factorized stage at l_max = n_max = 2: M = 4, LN = 4, MN = 8
L, NM = 2, 2


def _specs():
    """name -> (float operand shapes, function of the float operands)."""
    off = ss.sorted_segment_offsets(SEG, NSEG)
    owners = ft.triplet_e2_order(IDX, NIDX)
    e1, e1_off = E1, ss.sorted_segment_offsets(E1, NIDX)
    e2_order = ft.triplet_e2_order(IDX, NIDX)
    m, ln, mn, e = L * L, L * NM, L * L * NM, SEG.shape[0]
    return {
        "sorted_segment_sum": ([(3, 8)], lambda d: ss.sorted_segment_sum_fm(d, SEG, NSEG, off)),
        "sorted_take": ([(3, NSEG)], lambda x: ss.sorted_take_fm(x, SEG, off)),
        "windowed_take": ([(3, NIDX)], lambda d: wt.windowed_take_fm(d, IDX, owners)),
        "windowed_scatter": ([(3, 8)], lambda v: wt.windowed_scatter_fm(v, IDX, NIDX, owners)),
        "q_scatter": ([(m, e), (ln, e)],
                      lambda sh, gm: fs.q_scatter(sh, gm, SEG, off, NSEG, L, NM)),
        "r1_gather": ([(mn, NSEG), (m, e)], lambda a, sh: fs.r1_gather(a, sh, SEG, off, L, NM)),
        "r2_gather": ([(mn, NSEG), (ln, e)], lambda a, gm: fs.r2_gather(a, gm, SEG, off, L, NM)),
        "fused_triplet_gate_sum": (
            [(ln, 8), (ln, NIDX)],
            lambda b, g: ft.fused_triplet_gate_sum(b, g, e1, IDX, NIDX, e1_off, e2_order)),
        "backward_pair": (
            [(ln, 8), (ln, NIDX), (ln, NIDX)],
            lambda b, g, c: ft.backward_pair(b, g, c, e1, IDX, NIDX, e1_off, e2_order)),
    }


SPECS = _specs()
NAMES = list(SPECS)


def _inputs(name, members=None, seed=0):
    """Seeded f64 operands of ``name`` (with a leading member axis of
    ``members``)."""
    rng = np.random.default_rng(seed)
    lead = () if members is None else (members,)
    return [torch.tensor(rng.standard_normal(lead + s)) for s in SPECS[name][0]]


def _loss(out):
    """A scalar that weighs every output element differently."""
    outs = out if isinstance(out, tuple) else (out,)
    return sum((torch.sin(o) * torch.arange(1, o.numel() + 1, dtype=o.dtype).reshape(o.shape)
                ).sum() for o in outs)


def _stack(outs):
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(p) for p in zip(*outs))
    return torch.stack(outs)


def _assert_close(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_gradcheck_with_batched_grad(name):
    args = [x.requires_grad_(True) for x in _inputs(name)]
    fn = SPECS[name][1]
    assert torch.autograd.gradcheck(fn, args, check_batched_grad=True)
    assert torch.autograd.gradgradcheck(fn, args, check_batched_grad=True)


def _patterns(n):
    """Every in_dims of n float operands (None, 0 or 1), one batched at least."""
    return [p for p in itertools.product((None, 0, 1), repeat=n) if any(d is not None for d in p)]


@pytest.mark.parametrize("name,in_dims", [(n, p) for n in NAMES
                                          for p in _patterns(len(SPECS[n][0]))])
def test_vmap_matches_a_loop(name, in_dims):
    fn = SPECS[name][1]
    batched = _inputs(name, K, seed=1)
    shared = _inputs(name, seed=2)
    args = [s if d is None else b.movedim(0, d) for b, s, d in zip(batched, shared, in_dims)]
    got = torch.func.vmap(fn, in_dims=in_dims)(*args)
    want = _stack([fn(*(s if d is None else b[k] for b, s, d in zip(batched, shared, in_dims)))
                   for k in range(K)])
    _assert_close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_batched_index_raises(name):
    """The members share one graph: an index batched by vmap is refused."""
    args = _inputs(name)
    index = SEG if name in ("sorted_segment_sum", "sorted_take", "q_scatter", "r1_gather",
                            "r2_gather") else IDX
    batched_index = index.expand(K, -1)
    off, e1_off = ss.sorted_segment_offsets(SEG, NSEG), ss.sorted_segment_offsets(E1, NIDX)
    e2_order = ft.triplet_e2_order(IDX, NIDX)

    def with_index(idx, *xs):
        spec = {
            "sorted_segment_sum": lambda d: ss.sorted_segment_sum_fm(d, idx, NSEG, off),
            "sorted_take": lambda x: ss.sorted_take_fm(x, idx, off),
            "windowed_take": lambda d: wt.windowed_take_fm(d, idx, e2_order),
            "windowed_scatter": lambda v: wt.windowed_scatter_fm(
                v, idx, NIDX, (None, torch.zeros(NIDX + 1, dtype=torch.int32))),
            "q_scatter": lambda sh, gm: fs.q_scatter(sh, gm, idx, off, NSEG, L, NM),
            "r1_gather": lambda a, sh: fs.r1_gather(a, sh, idx, off, L, NM),
            "r2_gather": lambda a, gm: fs.r2_gather(a, gm, idx, off, L, NM),
            "fused_triplet_gate_sum": lambda b, g: ft.fused_triplet_gate_sum(
                b, g, idx, IDX, NIDX, e1_off, e2_order),
            "backward_pair": lambda b, g, c: ft.backward_pair(
                b, g, c, idx, IDX, NIDX, e1_off, e2_order),
        }[name]
        return spec(*xs)

    with pytest.raises(ValueError, match="must be shared"):
        torch.func.vmap(with_index, in_dims=(0,) + (None,) * len(args))(batched_index, *args)


@pytest.mark.parametrize("name", NAMES)
def test_batched_offsets_raise(name):
    """The run offsets are part of the shared index: each op refuses them
    batched by vmap, as it refuses batched ids (the offsets of the sorted
    ids, of the e2 order for the windowed ops, of e1 for the fused pair)."""
    args = _inputs(name)
    seg_off, e1_off = ss.sorted_segment_offsets(SEG, NSEG), ss.sorted_segment_offsets(E1, NIDX)
    order, e2_off = ft.triplet_e2_order(IDX, NIDX)
    batched = {"windowed_take": e2_off, "windowed_scatter": e2_off,
               "fused_triplet_gate_sum": e1_off, "backward_pair": e1_off}.get(name, seg_off)

    def with_offsets(off, *xs):
        spec = {
            "sorted_segment_sum": lambda d: ss.sorted_segment_sum_fm(d, SEG, NSEG, off),
            "sorted_take": lambda x: ss.sorted_take_fm(x, SEG, off),
            "windowed_take": lambda d: wt.windowed_take_fm(d, IDX, (order, off)),
            "windowed_scatter": lambda v: wt.windowed_scatter_fm(v, IDX, NIDX, (order, off)),
            "q_scatter": lambda sh, gm: fs.q_scatter(sh, gm, SEG, off, NSEG, L, NM),
            "r1_gather": lambda a, sh: fs.r1_gather(a, sh, SEG, off, L, NM),
            "r2_gather": lambda a, gm: fs.r2_gather(a, gm, SEG, off, L, NM),
            "fused_triplet_gate_sum": lambda b, g: ft.fused_triplet_gate_sum(
                b, g, E1, IDX, NIDX, off, (order, e2_off)),
            "backward_pair": lambda b, g, c: ft.backward_pair(
                b, g, c, E1, IDX, NIDX, off, (order, e2_off)),
        }[name]
        return spec(*xs)

    with pytest.raises(ValueError, match="offsets is batched under vmap"):
        torch.func.vmap(with_offsets, in_dims=(0,) + (None,) * len(args))(
            batched.expand(K, -1), *args)


@pytest.mark.parametrize("name", NAMES)
def test_second_vmap_level_raises(name):
    """The Functions take one member axis: a vmap nested in another raises,
    and so does an operand with two leading axes outside vmap."""
    fn = SPECS[name][1]
    args = _inputs(name, K, seed=5)
    nested = [x.expand(2, *x.shape) for x in args]
    with pytest.raises(ValueError, match="one vmap level"):
        torch.func.vmap(torch.func.vmap(fn))(*nested)
    with pytest.raises(ValueError, match=r"\(\[K,\] |\(K, rows, cols\)"):
        fn(*nested)


@pytest.mark.parametrize("name", NAMES)
def test_func_grad_and_vjp_match_autograd(name):
    fn = SPECS[name][1]
    args = _inputs(name, seed=3)
    n = len(args)
    argnums = tuple(range(n))
    leaves = [x.clone().requires_grad_(True) for x in args]
    want = torch.autograd.grad(_loss(fn(*leaves)), leaves)
    got = torch.func.grad(lambda *xs: _loss(fn(*xs)), argnums=argnums)(*args)
    _assert_close(tuple(got), tuple(want))
    out, vjp_fn = torch.func.vjp(fn, *args)
    leaves = [x.clone().requires_grad_(True) for x in args]
    cot = tuple(torch.cos(o) for o in (out if isinstance(out, tuple) else (out,)))
    ref = fn(*leaves)
    ref = ref if isinstance(ref, tuple) else (ref,)
    want_vjp = torch.autograd.grad(ref, leaves, cot)
    got_vjp = vjp_fn(cot if isinstance(out, tuple) else cot[0])
    _assert_close(tuple(got_vjp), tuple(want_vjp))
    # the VJP over K cotangents at once, its saved tensors shared
    cots = tuple(torch.stack([torch.cos(k + c) for k in range(K)]) for c in cot)
    got = torch.func.vmap(vjp_fn)(cots if isinstance(out, tuple) else cots[0])
    for k in range(K):
        one = tuple(c[k] for c in cots)
        _assert_close(tuple(g[k] for g in got),
                      tuple(vjp_fn(one if isinstance(out, tuple) else one[0])))
    # vmap of grad over the first operand's members, the others shared: a
    # committee's per-member backward pass
    members = _inputs(name, K, seed=4)[0]
    got = torch.func.vmap(torch.func.grad(lambda x0, *xs: _loss(fn(x0, *xs)), argnums=argnums),
                          in_dims=(0,) + (None,) * (n - 1))(members, *args[1:])
    for k in range(K):
        leaves = [members[k].clone().requires_grad_(True)] + [
            x.clone().requires_grad_(True) for x in args[1:]]
        want = torch.autograd.grad(_loss(fn(*leaves)), leaves)
        _assert_close(tuple(g[k] for g in got), tuple(want))
