"""The factorized three-body stage: CUDA kernels, plain versions, autograd.

Counterpart of ``torch_m3gnet_tpu.ops.pallas_factorized_stage``. Per block
the factorized stage (``models/m3gnet.py``) computes

    A[(m,n), i]   = sum_{e: src[e]=i} sh[m, e] * gm[(l_m,n), e]   Q   (E -> N)
    out[(l,n), e] = sum_{m: l_m=l} sh[m, e] * A[(m,n), src[e]]     R1  (N -> E)

and the VJPs need the companion

    out[m, e]     = sum_n gm[(l_m,n), e] * A[(m,n), src[e]]        R2

with sh the real harmonics (M = l_max^2 rows grouped by degree, so
l_m = floor(sqrt(m))), gm with LN = l_max*n_max rows and A with
MN = M*n_max rows, all feature-major (rows, entities). ``src`` is sorted
ascending with values in [0, N); the kernels rely on both (``q_scatter``
takes each node's edge range from an offsets pass over ``src``).

Each op has a hand-written CUDA kernel (``csrc/factorized_stage.cu``), a
plain torch version (``*_plain``) and an ``autograd.Function``. The Function
runs the kernel on a CUDA tensor and the plain version on a CPU tensor; on
CUDA there is no fallback. Every op is bilinear in its two tensor operands
and each one's VJP is written with the other Functions:

    dQ/d(sh) = R2(dA, gm),  dQ/d(gm) = R1(dA, sh)
    dR1/d(A) = Q(sh, cot),  dR1/d(sh) = R2(A, cot)
    dR2/d(A) = Q(cot, gm),  dR2/d(gm) = R1(A, cot)

so the family is closed under differentiation and ``create_graph=True``
works to any order.

Each Function takes each of its two float operands as (rows, cols), shared,
or with a leading member axis, (K, rows, cols) (``ops._vmap``), and has a
``torch.func.vmap`` rule that calls it so: a committee's K members
(``models.ensemble``), or the rows of a batched Hessian, run in ONE launch
of each kernel, whose member axis reads a shared operand once (member
stride 0). ``src`` is never batched. On the CPU each member runs the plain
version.

Each kernel launch adds one to the counter ``launch.<op>`` of
``utils.profiling`` (CUDA path only).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from torch_m3gnet_tpu_torch.ops import _cuda, _vmap
from torch_m3gnet_tpu_torch.ops.segment import segment_sum_fm, take_fm

# The kernels are instantiated for these sizes (csrc/factorized_stage.cu).
KERNEL_MAX_L = 4
KERNEL_MAX_N = 4


@lru_cache(maxsize=None)
def _row_maps(l_max: int, n_max: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For row r = m*n_max + n of the expanded product: sh_rows[r] = m and
    gm_rows[r] = l_m*n_max + n; also l_idx[m] = l_m."""
    l_idx = np.concatenate([np.full(2 * ell + 1, ell) for ell in range(l_max)])
    sh_rows = np.repeat(np.arange(l_max * l_max), n_max)
    gm_rows = (l_idx[:, None] * n_max + np.arange(n_max)[None, :]).reshape(-1)
    return sh_rows, gm_rows, l_idx


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.long, device=device)


# ---------------------------------------------------------------------------
# Plain versions (the counterparts of q_scatter_xla, r1_gather_xla and
# r2_gather_xla). The CPU path runs these; on the card they are the
# reference that chip_smoke.py holds the kernels against.
# ---------------------------------------------------------------------------


def q_scatter_plain(sh, gm, src, num_nodes: int, l_max: int, n_max: int):
    """(M, E), (LN, E), (E,) -> (MN, num_nodes)."""
    sh_rows, gm_rows, _ = _row_maps(l_max, n_max)
    w = sh.index_select(0, _index(sh_rows, sh.device)) * gm.index_select(
        0, _index(gm_rows, gm.device)
    )
    return segment_sum_fm(w, src, num_nodes)


def r1_gather_plain(a, sh, src, l_max: int, n_max: int):
    """(MN, N), (M, E), (E,) -> (LN, E)."""
    prod = sh[:, None, :] * take_fm(a, src).reshape(l_max * l_max, n_max, -1)
    return torch.stack(
        [prod[ell * ell : (ell + 1) * (ell + 1)].sum(0) for ell in range(l_max)]
    ).reshape(l_max * n_max, -1)


def r2_gather_plain(a, gm, src, l_max: int, n_max: int):
    """(MN, N), (LN, E), (E,) -> (M, E)."""
    _, _, l_idx = _row_maps(l_max, n_max)
    g = gm.reshape(l_max, n_max, -1).index_select(0, _index(l_idx, gm.device))
    return (g * take_fm(a, src).reshape(l_max * l_max, n_max, -1)).sum(1)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check(name, l_max, n_max, src, pairs):
    """Validate shapes (every path): each operand (rows, cols) or (K, rows,
    cols) with the trailing shape given. Returns (K or None, True when the
    operands are on CUDA and fit the kernels, False for the CPU path)."""
    if src.dim() != 1:
        raise ValueError(f"{name}: src must be 1-D, got shape {tuple(src.shape)}")
    k = _vmap.members(name, [(label, t) for label, t, _ in pairs])
    for label, t, shape in pairs:
        if tuple(t.shape[-2:]) != shape:
            raise ValueError(
                f"{name}: {label} has shape {tuple(t.shape)}, expected ([K,] "
                f"{shape[0]}, {shape[1]}) (l_max={l_max}, n_max={n_max}, E={src.shape[0]})"
            )
    if not _cuda.is_cuda(name, [(label, t) for label, t, _ in pairs], [("src", src)]):
        return k, False
    if not (1 <= l_max <= KERNEL_MAX_L and 1 <= n_max <= KERNEL_MAX_N):
        raise ValueError(
            f"{name}: the CUDA kernel is built for l_max, n_max in "
            f"1..{KERNEL_MAX_L}, got ({l_max}, {n_max})"
        )
    return k, True


def _launch(name, in0, in1, src, scratch, out_shape, k, num_edges, num_nodes, l_max, n_max):
    """One launch for every member: each operand once, with its member
    stride (0 where the members share it)."""
    lead = () if k is None else (k,)
    out = torch.empty((*lead, *out_shape), dtype=torch.float32, device=in0.device)
    if out.numel() == 0:  # nothing to compute: a zero-size grid is an error
        return out
    (x, x_stride), (y, y_stride) = (_vmap.kernel_operand(t) for t in (in0, in1))
    _cuda.launch(name, f"m3g_{name}", out.device, x.data_ptr(), y.data_ptr(),
                 src.data_ptr(), *scratch, out.data_ptr(), num_edges, num_nodes, l_max, n_max,
                 k or 1, x_stride, y_stride)
    return out


def _q_forward(sh, gm, src, num_nodes, l_max, n_max):
    m, ln, mn, e = l_max * l_max, l_max * n_max, l_max * l_max * n_max, src.shape[0]
    k, cuda = _check("q_scatter", l_max, n_max, src, [("sh", sh, (m, e)), ("gm", gm, (ln, e))])
    if not cuda:
        return _vmap.per_member(q_scatter_plain, k, (sh, gm), (src, num_nodes, l_max, n_max))
    # the offsets pass runs once for every member: src is shared
    offsets = torch.empty(num_nodes + 1, dtype=torch.int32, device=sh.device)
    return _launch("q_scatter", sh, gm, src, [offsets.data_ptr()],
                   (mn, num_nodes), k, e, num_nodes, l_max, n_max)


def _r_forward(name, a, other, src, l_max, n_max):
    m, ln, mn, e = l_max * l_max, l_max * n_max, l_max * l_max * n_max, src.shape[0]
    rows_in, rows_out = (m, ln) if name == "r1_gather" else (ln, m)
    num_nodes = a.shape[-1]
    k, cuda = _check(name, l_max, n_max, src,
                     [("A", a, (mn, num_nodes)), ("operand", other, (rows_in, e))])
    if not cuda:
        plain = r1_gather_plain if name == "r1_gather" else r2_gather_plain
        return _vmap.per_member(plain, k, (a, other), (src, l_max, n_max))
    return _launch(name, a, other, src, [], (rows_out, e), k, e, num_nodes, l_max, n_max)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class QScatter(torch.autograd.Function):
    @staticmethod
    def forward(sh, gm, src, num_nodes, l_max, n_max):
        return _q_forward(sh, gm, src, num_nodes, l_max, n_max)

    @staticmethod
    def setup_context(ctx, inputs, output):
        sh, gm, src, _, l_max, n_max = inputs
        ctx.save_for_backward(sh, gm, src)
        ctx.sizes = (l_max, n_max)

    @staticmethod
    def backward(ctx, d_a):
        sh, gm, src = ctx.saved_tensors
        l_max, n_max = ctx.sizes
        d_sh = r2_gather(d_a, gm, src, l_max, n_max) if ctx.needs_input_grad[0] else None
        d_gm = r1_gather(d_a, sh, src, l_max, n_max) if ctx.needs_input_grad[1] else None
        return (_vmap.reduce_to(d_sh, sh), _vmap.reduce_to(d_gm, gm),
                None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, sh, gm, src, num_nodes, l_max, n_max):
        _vmap.shared_index("q_scatter", in_dims, {"src": 2})
        sh, gm = _vmap.batch_first("q_scatter", in_dims[:2], (sh, gm))
        return QScatter.apply(sh, gm, src, num_nodes, l_max, n_max), 0


class R1Gather(torch.autograd.Function):
    @staticmethod
    def forward(a, sh, src, l_max, n_max):
        return _r_forward("r1_gather", a, sh, src, l_max, n_max)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, sh, src, l_max, n_max = inputs
        ctx.save_for_backward(a, sh, src)
        ctx.sizes = (l_max, n_max)

    @staticmethod
    def backward(ctx, cot):
        a, sh, src = ctx.saved_tensors
        l_max, n_max = ctx.sizes
        d_a = (q_scatter(sh, cot, src, a.shape[-1], l_max, n_max)
               if ctx.needs_input_grad[0] else None)
        d_sh = r2_gather(a, cot, src, l_max, n_max) if ctx.needs_input_grad[1] else None
        return _vmap.reduce_to(d_a, a), _vmap.reduce_to(d_sh, sh), None, None, None

    @staticmethod
    def vmap(info, in_dims, a, sh, src, l_max, n_max):
        _vmap.shared_index("r1_gather", in_dims, {"src": 2})
        a, sh = _vmap.batch_first("r1_gather", in_dims[:2], (a, sh))
        return R1Gather.apply(a, sh, src, l_max, n_max), 0


class R2Gather(torch.autograd.Function):
    @staticmethod
    def forward(a, gm, src, l_max, n_max):
        return _r_forward("r2_gather", a, gm, src, l_max, n_max)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, gm, src, l_max, n_max = inputs
        ctx.save_for_backward(a, gm, src)
        ctx.sizes = (l_max, n_max)

    @staticmethod
    def backward(ctx, cot):
        a, gm, src = ctx.saved_tensors
        l_max, n_max = ctx.sizes
        d_a = (q_scatter(cot, gm, src, a.shape[-1], l_max, n_max)
               if ctx.needs_input_grad[0] else None)
        d_gm = r1_gather(a, cot, src, l_max, n_max) if ctx.needs_input_grad[1] else None
        return _vmap.reduce_to(d_a, a), _vmap.reduce_to(d_gm, gm), None, None, None

    @staticmethod
    def vmap(info, in_dims, a, gm, src, l_max, n_max):
        _vmap.shared_index("r2_gather", in_dims, {"src": 2})
        a, gm = _vmap.batch_first("r2_gather", in_dims[:2], (a, gm))
        return R2Gather.apply(a, gm, src, l_max, n_max), 0


def q_scatter(sh, gm, src, num_nodes: int, l_max: int, n_max: int) -> torch.Tensor:
    """A = Q(sh, gm): (M, E), (LN, E), sorted int32 (E,) -> (MN, num_nodes);
    with a member axis (K, ...) on either operand, one A per member."""
    return QScatter.apply(sh, gm, src, num_nodes, l_max, n_max)


def r1_gather(a, sh, src, l_max: int, n_max: int) -> torch.Tensor:
    """R1(A, sh): (MN, N), (M, E), sorted int32 (E,) in [0, N) -> (LN, E);
    with a member axis on either operand, one output per member."""
    return R1Gather.apply(a, sh, src, l_max, n_max)


def r2_gather(a, gm, src, l_max: int, n_max: int) -> torch.Tensor:
    """R2(A, gm): (MN, N), (LN, E), sorted int32 (E,) in [0, N) -> (M, E);
    with a member axis on either operand, one output per member."""
    return R2Gather.apply(a, gm, src, l_max, n_max)
