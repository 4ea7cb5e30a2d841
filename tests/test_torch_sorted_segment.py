"""The port's sorted segment sum (torch_m3gnet_tpu_torch.ops.sorted_segment)
against the JAX package's Pallas kernels ``sorted_segment_sum`` and
``sorted_segment_sum_any``, run in TPU interpret mode on the CPU as
tests/test_pallas_segment.py runs them.

On the CPU the port's autograd Functions run the plain version of the CUDA
kernel; chip_smoke.py holds the kernel against it on the card. The port is
feature-major, (F, M) -> (F, S); the JAX kernels are entity-major, (M, F) ->
(S, F), so the comparisons transpose. The kernels are called directly, never
through ``enable_pallas``, which would switch the JAX package's segment sums
for the whole process. The last test holds every sorted op of the port to
its required index (the batch's run offsets or owners).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.ops.pallas_segment import sorted_segment_sum, sorted_segment_sum_any
from torch_m3gnet_tpu_torch.ops import sorted_segment as ss
from torch_m3gnet_tpu_torch.utils import profiling

# As tests/test_pallas_segment.py: interpret mode contracts one-hot matrices
# in f32 through a bf16 hi/lo split; the plain version adds in another order.
TOL = dict(atol=1e-3, rtol=1e-4)
JAX_KERNELS = {"sorted_segment_sum": sorted_segment_sum,
               "sorted_segment_sum_any": sorted_segment_sum_any}


def _ids(case, rng):
    """(sorted int32 ids, number of segments) of one index pattern."""
    if case == "short-runs-gaps":
        # runs of 0..5 rows: many empty segments between short ones
        counts = rng.integers(0, 6, 400)
    elif case == "long-run":
        # one run longer than a 1,024-row TPU tile among short ones
        counts = rng.integers(1, 4, 300)
        counts[150] = 1500
    else:  # "padded-tail": the last segment owns a long padded tail
        counts = np.concatenate([rng.integers(1, 8, 200), [700]])
    seg = np.repeat(np.arange(counts.size), counts).astype(np.int32)
    return seg, int(counts.size)


CASES = ["short-runs-gaps", "long-run", "padded-tail"]


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("f", [3, 9, 64])
@pytest.mark.parametrize("case", CASES)
def test_forward_and_vjp_match_pallas(interpret, case, f):
    """The Function and the plain version against both Pallas kernels, and
    the VJP (the gather) against jax.vjp."""
    rng = np.random.default_rng(f)
    seg, s = _ids(case, rng)
    data = rng.standard_normal((seg.size, f)).astype(np.float32)
    cot = rng.standard_normal((s, f)).astype(np.float32)
    jseg = jnp.asarray(seg)
    tseg = torch.as_tensor(seg)
    x = torch.tensor(data.T.copy(), requires_grad=True)
    got = ss.sorted_segment_sum_fm(x, tseg, s, ss.sorted_segment_offsets(tseg, s))
    plain = ss.sorted_segment_sum_fm_plain(x.detach(), tseg, s)
    assert got.dtype == torch.float32 and tuple(got.shape) == (f, s)
    (d_x,) = torch.autograd.grad((got * torch.as_tensor(cot.T.copy())).sum(), x)
    for name, kernel in JAX_KERNELS.items():
        want, vjp = jax.vjp(lambda d: kernel(d, jseg, s), jnp.asarray(data))
        want = np.asarray(want).T
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL, err_msg=name)
        np.testing.assert_allclose(plain.numpy(), want, **TOL, err_msg=name)
        np.testing.assert_allclose(d_x.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]).T,
                                   **TOL, err_msg=name)


def test_grad_of_grad_matches_jax():
    """Force-loss style double differentiation: the VJP is the gather, whose
    VJP is the segment sum again. JAX's Pallas kernel cannot be
    differentiated twice when its output enters nonlinearly (the outer
    derivative traces the inner forward call, and interpret mode has no
    rule for a pallas_call with a dynamic grid), so the reference is the
    function it computes, ``jax.ops.segment_sum`` over sorted ids."""
    rng = np.random.default_rng(5)
    seg, s = _ids("long-run", rng)
    data = rng.standard_normal((seg.size, 9)).astype(np.float32)
    jseg, tseg = jnp.asarray(seg), torch.as_tensor(seg)

    def jloss(d):
        g = jax.grad(lambda x: jnp.sum(jnp.sin(jax.ops.segment_sum(
            x, jseg, num_segments=s, indices_are_sorted=True))))(d)
        return jnp.sum(g * g)

    want = jax.grad(jloss)(jnp.asarray(data))
    x = torch.tensor(data.T.copy(), requires_grad=True)
    off = ss.sorted_segment_offsets(tseg, s)
    (g,) = torch.autograd.grad(torch.sin(ss.sorted_segment_sum_fm(x, tseg, s, off)).sum(), x,
                               create_graph=True)
    (got,) = torch.autograd.grad((g * g).sum(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, **TOL)


@pytest.mark.parametrize("op", ["sum", "take"])
def test_functions_close_under_differentiation(op):
    """gradcheck and gradgradcheck at f64, with empty segments (ids 0 and 3
    have no rows) and a run of four; every backward carries the offsets
    on."""
    seg = torch.tensor([1, 1, 2, 4, 4, 4, 4, 5], dtype=torch.int32)
    off = ss.sorted_segment_offsets(seg, 7)
    rng = np.random.default_rng(4)
    if op == "sum":
        x = torch.tensor(rng.standard_normal((3, 8)), requires_grad=True)
        fn = lambda d: ss.sorted_segment_sum_fm(d, seg, 7, off)  # noqa: E731
    else:
        x = torch.tensor(rng.standard_normal((3, 7)), requires_grad=True)
        fn = lambda d: ss.sorted_take_fm(d, seg, off)  # noqa: E731
    assert fn(x).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


def test_wrapper_rejects_wrong_shapes_and_launches_nothing_on_cpu():
    profiling.reset_counts("launch.")
    seg = torch.tensor([0, 0, 2], dtype=torch.int32)
    off = ss.sorted_segment_offsets(seg, 3)
    with pytest.raises(ValueError, match="seg must be 1-D"):
        ss.sorted_segment_sum_fm(torch.zeros(2, 3), seg[None], 3, off)
    with pytest.raises(ValueError, match="data has shape"):
        ss.sorted_segment_sum_fm(torch.zeros(2, 4), seg, 3, off)
    with pytest.raises(ValueError, match="data has shape"):
        ss.sorted_segment_sum_fm(torch.zeros(3), seg, 3, off)
    with pytest.raises(ValueError, match="offsets has shape"):
        ss.sorted_segment_sum_fm(torch.zeros(2, 3), seg, 3, torch.zeros(3, dtype=torch.int32))
    out = ss.sorted_segment_sum_fm(torch.ones(2, 3), seg, 3, off)
    assert out.tolist() == [[2.0, 0.0, 1.0], [2.0, 0.0, 1.0]]
    assert not [k for k in profiling.counts() if k.startswith("launch.")]



@pytest.mark.parametrize("case", CASES)
def test_offsets_are_the_kernel_offsets_pass(case):
    """sorted_segment_offsets, which the batch carries for edge_src and
    triplet_e1 and along which every sorted kernel sums, is each segment's
    run: offsets[s] = the first m with seg[m] >= s (np.searchsorted),
    offsets[S] = M, each segment's rows [offsets[s], offsets[s + 1])."""
    seg, s = _ids(case, np.random.default_rng(3))
    off = ss.sorted_segment_offsets(torch.as_tensor(seg), s)
    assert off.dtype == torch.int32 and tuple(off.shape) == (s + 1,)
    np.testing.assert_array_equal(off.numpy(), np.searchsorted(seg, np.arange(s + 1)))
    counts = np.bincount(seg, minlength=s)
    np.testing.assert_array_equal(np.diff(off.numpy()), counts)


def _without_index():
    """op -> a call of each sorted op of the port without its run offsets
    or owners (None where the batch's would go): what a caller that forgets
    them would make."""
    from torch_m3gnet_tpu_torch.ops import factorized_stage as fs
    from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
    from torch_m3gnet_tpu_torch.ops import windowed_take as wt

    seg = torch.tensor([0, 0, 2, 2], dtype=torch.int32)  # sorted, over 3
    e2 = torch.tensor([2, 0, 1, 0], dtype=torch.int32)
    x = torch.ones(1, 4)
    return {
        "q_scatter": lambda: fs.q_scatter(x, x, seg, None, 3, 1, 1),
        "r1_gather": lambda: fs.r1_gather(torch.ones(1, 3), x, seg, None, 1, 1),
        "r2_gather": lambda: fs.r2_gather(torch.ones(1, 3), x, seg, None, 1, 1),
        "fused_triplet_gate_sum": lambda: ft.fused_triplet_gate_sum(
            x, torch.ones(1, 3), seg, e2, 3, None, ft.triplet_e2_order(e2, 3)),
        "sorted_segment_sum_fm": lambda: ss.sorted_segment_sum_fm(x, seg, 3, None),
        "sorted_take_fm": lambda: ss.sorted_take_fm(torch.ones(1, 3), seg, None),
        "windowed_take_fm": lambda: wt.windowed_take_fm(torch.ones(1, 3), e2, None),
        "windowed_scatter_fm": lambda: wt.windowed_scatter_fm(x, e2, 3, None),
    }


@pytest.mark.parametrize("op", list(_without_index()))
def test_sorted_ops_refuse_a_call_without_the_batch_index(op):
    """Every sorted op takes its run offsets (or, for the windowed ops, its
    index's owners) from the batch on every path: a call without them is
    refused on the CPU as on the card, before anything runs."""
    call = _without_index()[op]
    profiling.reset_counts("launch.")
    with pytest.raises(ValueError, match="offsets is required"):
        call()
    assert not [k for k in profiling.counts() if k.startswith("launch.")]
