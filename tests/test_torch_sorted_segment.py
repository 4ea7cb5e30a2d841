"""The port's sorted segment sum (torch_m3gnet_tpu_torch.ops.sorted_segment)
against the JAX package's Pallas kernels ``sorted_segment_sum`` and
``sorted_segment_sum_any``, run in TPU interpret mode on the CPU as
tests/test_pallas_segment.py runs them.

On the CPU the port's autograd Functions run the plain version of the CUDA
kernel; chip_smoke.py holds the kernel against it on the card. The port is
feature-major, (F, M) -> (F, S); the JAX kernels are entity-major, (M, F) ->
(S, F), so the comparisons transpose. The kernels are called directly, never
through ``enable_pallas``, which would switch the JAX package's segment sums
for the whole process.
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
    got = ss.sorted_segment_sum_fm(x, tseg, s)
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
    (g,) = torch.autograd.grad(torch.sin(ss.sorted_segment_sum_fm(x, tseg, s)).sum(), x,
                               create_graph=True)
    (got,) = torch.autograd.grad((g * g).sum(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, **TOL)


@pytest.mark.parametrize("op, with_offsets", [
    pytest.param(op, w, id=f"{op}-offsets" if w else op)
    for w in (False, True) for op in ("sum", "take")
])
def test_functions_close_under_differentiation(op, with_offsets):
    """gradcheck and gradgradcheck at f64, with empty segments (ids 0 and 3
    have no rows) and a run of four; with the offsets passed in, every
    backward carries them on."""
    seg = torch.tensor([1, 1, 2, 4, 4, 4, 4, 5], dtype=torch.int32)
    off = ss.sorted_segment_offsets(seg, 7) if with_offsets else None
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
    with pytest.raises(ValueError, match="seg must be 1-D"):
        ss.sorted_segment_sum_fm(torch.zeros(2, 3), seg[None], 3)
    with pytest.raises(ValueError, match="data has shape"):
        ss.sorted_segment_sum_fm(torch.zeros(2, 4), seg, 3)
    with pytest.raises(ValueError, match="data has shape"):
        ss.sorted_segment_sum_fm(torch.zeros(3), seg, 3)
    with pytest.raises(ValueError, match="offsets has shape"):
        ss.sorted_segment_sum_fm(torch.zeros(2, 3), seg, 3, torch.zeros(3, dtype=torch.int32))
    out = ss.sorted_segment_sum_fm(torch.ones(2, 3), seg, 3)
    assert out.tolist() == [[2.0, 0.0, 1.0], [2.0, 0.0, 1.0]]
    assert not [k for k in profiling.counts() if k.startswith("launch.")]



@pytest.mark.parametrize("case", CASES)
def test_offsets_are_the_kernel_offsets_pass(case):
    """sorted_segment_offsets, which the batch carries for edge_src and
    triplet_e1 so that the kernel skips its offsets pass, is what that pass
    writes: offsets[s] = the first m with seg[m] >= s (np.searchsorted),
    offsets[S] = M, each segment's rows [offsets[s], offsets[s + 1])."""
    seg, s = _ids(case, np.random.default_rng(3))
    off = ss.sorted_segment_offsets(torch.as_tensor(seg), s)
    assert off.dtype == torch.int32 and tuple(off.shape) == (s + 1,)
    np.testing.assert_array_equal(off.numpy(), np.searchsorted(seg, np.arange(s + 1)))
    counts = np.bincount(seg, minlength=s)
    np.testing.assert_array_equal(np.diff(off.numpy()), counts)
