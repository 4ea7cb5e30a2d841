"""CHGNet's gated-MLP tail, feature-major: CUDA kernels, plain version,
autograd.

    norm_gate_fm(core (F, M), gate (F, M), core_bias, gate_bias, core_scale,
                 core_shift, gate_scale, gate_shift, eps)
        = SiLU(LN_c(core + core_bias)) * sigmoid(LN_g(gate + gate_bias))

LN normalises each column over its F features (biased variance, ``eps``)
and applies its scale and shift per feature: ``nn.LayerNorm(F)`` of the
transposed rows. The biases (F,) are those of the last Dense layer of each
stack (``models.layers.NormGatedMLPFM``), taken in here so that the Dense
products stay bias-free GEMMs on (F, M). No JAX counterpart: CHGNet is the
port's own.

The op has two hand-written CUDA kernels (``csrc/norm_gate.cu``: the
forward, and the backward with a second pass that sums the parameters'
gradients over the column tiles in a fixed order, so two calls give the
same bits), a plain torch version of each (:func:`norm_gate_fm_plain`,
:func:`norm_gate_backward_plain`, the same arithmetic along dim 0) and two
``autograd.Function``\\ s over the kernels: :class:`NormGate`, whose
backward is :class:`NormGateBackward`, whose own backward (second order:
the force loss's double backward) differentiates the plain first-order
backward. :func:`norm_gate_fm` decides the path once (``_cuda.is_cuda``):
the plain version for CPU tensors (so any order of derivative and
``torch.func`` work there), the Functions for CUDA tensors, whose
first-order path is the two kernels; on CUDA there is no fallback. The
kernels take float32 (CHGNet computes only in float32), contiguous operands
and F up to :data:`MAX_FEATURES`; other operands raise.

Each kernel call adds one to the counter ``launch.norm_gate_fwd`` or
``launch.norm_gate_bwd`` of ``utils.profiling`` (CUDA path only).
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from torch_m3gnet_tpu_torch.ops import _cuda

# The kernels' widest feature axis.
MAX_FEATURES = 256
PARAMS = ("core_bias", "gate_bias", "core_scale", "core_shift", "gate_scale", "gate_shift")


def _normalised(x, bias, eps):
    """(x + bias) normalised over dim 0, and the columns' 1 / std."""
    x = x + bias[:, None]
    centred = x - x.mean(0)
    rstd = torch.rsqrt((centred * centred).mean(0) + eps)
    return centred * rstd, rstd


def _gates(core, gate, core_bias, gate_bias, core_scale, core_shift, gate_scale, gate_shift, eps):
    xc, rc = _normalised(core, core_bias, eps)
    xg, rg = _normalised(gate, gate_bias, eps)
    return (xc, rc, core_scale[:, None] * xc + core_shift[:, None],
            xg, rg, gate_scale[:, None] * xg + gate_shift[:, None])


def norm_gate_fm_plain(core, gate, core_bias, gate_bias, core_scale, core_shift, gate_scale,
                       gate_shift, eps):
    """(F, M), (F, M), six (F,) -> (F, M): the op in torch, differentiable
    to any order."""
    _, _, yc, _, _, yg = _gates(core, gate, core_bias, gate_bias, core_scale, core_shift,
                                gate_scale, gate_shift, eps)
    return F.silu(yc) * torch.sigmoid(yg)


def norm_gate_backward_plain(g, core, gate, core_bias, gate_bias, core_scale, core_shift,
                             gate_scale, gate_shift, eps):
    """The gradient ``g`` (F, M) of the op's output taken back to (d core,
    d gate, and the six parameters' gradients, in their argument order), in
    closed form: what the backward kernel computes."""
    xc, rc, yc, xg, rg, yg = _gates(core, gate, core_bias, gate_bias, core_scale, core_shift,
                                    gate_scale, gate_shift, eps)
    sc, sg = torch.sigmoid(yc), torch.sigmoid(yg)
    dyc = g * sg * sc * (1 + yc * (1 - sc))
    dyg = g * yc * sc * sg * (1 - sg)

    def through_norm(dy, xhat, rstd, scale):
        dxhat = dy * scale[:, None]
        return rstd * (dxhat - dxhat.mean(0) - xhat * (dxhat * xhat).mean(0))

    d_core, d_gate = through_norm(dyc, xc, rc, core_scale), through_norm(dyg, xg, rg, gate_scale)
    return (d_core, d_gate, d_core.sum(1), d_gate.sum(1), (dyc * xc).sum(1), dyc.sum(1),
            (dyg * xg).sum(1), dyg.sum(1))


def _check(name, arrays, params):
    """Raise for what the kernels do not take, on any device (the device
    and the operands' sameness by ``_cuda.is_cuda``). ``arrays``: (label,
    (F, M)) pairs; ``params``: (F,) tensors in :data:`PARAMS` order."""
    first, x = arrays[0]
    if x.dim() != 2:
        raise ValueError(f"{name}: {first} must be (F, M), got shape {tuple(x.shape)}")
    f, m = x.shape
    labelled = [*arrays, *zip(PARAMS, params)]
    for label, t in arrays:
        if tuple(t.shape) != (f, m):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, expected {first}'s "
                             f"{(f, m)}")
    for label, t in labelled[len(arrays):]:
        if tuple(t.shape) != (f,):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, expected ({f},)")
    if not 1 <= f <= MAX_FEATURES:
        raise ValueError(f"{name}: the kernels take 1 to {MAX_FEATURES} features, got {f}")
    for label, t in labelled:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernels take float32 {label}, got {t.dtype}")
    for label, t in labelled:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if not _cuda.is_cuda(name, labelled, []):
        raise ValueError(f"{name}: the kernels take CUDA tensors, got {x.device}")


def _pointers(tensors):
    """A host array of the tensors' device pointers (held by the caller
    until the launch has read it)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _vec(m, tensors) -> int:
    """1 where the kernels may move 16-byte vectors: M a multiple of 4 and
    every (F, M) operand 16-byte aligned."""
    return int(m % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def norm_gate_fwd_cuda(core, gate, params, eps):
    """The forward kernel: ``params`` in :data:`PARAMS` order."""
    name = "norm_gate_fwd"
    _check(name, [("core", core), ("gate", gate)], params)
    f, m = core.shape
    out = torch.empty_like(core)
    ptrs = _pointers(params)
    _cuda.launch(name, "m3g_norm_gate_fwd", core.device, core.data_ptr(), gate.data_ptr(),
                 ctypes.addressof(ptrs), out.data_ptr(), f, m, _vec(m, (core, gate, out)),
                 float(eps))
    return out


def norm_gate_bwd_cuda(g, core, gate, params, eps):
    """The backward kernels: (d core, d gate, and the six parameters'
    gradients in :data:`PARAMS` order)."""
    name = "norm_gate_bwd"
    _check(name, [("g", g), ("core", core), ("gate", gate)], params)
    f, m = core.shape
    d_core, d_gate = torch.empty_like(core), torch.empty_like(gate)
    grads = [torch.empty_like(p) for p in params]
    dev, vec = core.device, _vec(m, (g, core, gate, d_core, d_gate))
    rows = ctypes.c_int(0)  # the kernel's blocks, one row of partial sums each
    _cuda.call(name, "m3g_norm_gate_bwd_rows", dev, f, m, vec, ctypes.byref(rows))
    partial = torch.empty((rows.value, len(PARAMS), f), dtype=torch.float32, device=dev)
    ptrs, grad_ptrs = _pointers(params), _pointers(grads)
    _cuda.launch(name, "m3g_norm_gate_bwd", dev, g.data_ptr(), core.data_ptr(), gate.data_ptr(),
                 ctypes.addressof(ptrs), d_core.data_ptr(), d_gate.data_ptr(), partial.data_ptr(),
                 rows.value, ctypes.addressof(grad_ptrs), f, m, vec, float(eps))
    return (d_core, d_gate, *grads)


class NormGate(torch.autograd.Function):
    @staticmethod
    def forward(core, gate, core_bias, gate_bias, core_scale, core_shift, gate_scale, gate_shift,
                eps):
        params = (core_bias, gate_bias, core_scale, core_shift, gate_scale, gate_shift)
        return norm_gate_fwd_cuda(core, gate, params, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        *tensors, ctx.eps = inputs
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, g):
        return (*NormGateBackward.apply(g.contiguous(), *ctx.saved_tensors, ctx.eps), None)


class NormGateBackward(torch.autograd.Function):
    @staticmethod
    def forward(g, core, gate, core_bias, gate_bias, core_scale, core_shift, gate_scale,
                gate_shift, eps):
        params = (core_bias, gate_bias, core_scale, core_shift, gate_scale, gate_shift)
        return norm_gate_bwd_cuda(g, core, gate, params, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        *tensors, ctx.eps = inputs
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        # second order: the plain first-order backward, differentiated
        _, vjp = torch.func.vjp(lambda *xs: norm_gate_backward_plain(*xs, ctx.eps),
                                *ctx.saved_tensors)
        return (*vjp(grads), None)


def norm_gate_fm(core, gate, core_bias, gate_bias, core_scale, core_shift, gate_scale,
                 gate_shift, eps: float = 1e-5):
    """SiLU(LN_c(core + core_bias)) * sigmoid(LN_g(gate + gate_bias)) of
    (F, M) stacks, normalised over the features (dim 0): the plain version
    for CPU tensors, the kernels for CUDA tensors."""
    tensors = (core, gate, core_bias, gate_bias, core_scale, core_shift, gate_scale, gate_shift)
    if not _cuda.is_cuda("norm_gate_fm", list(zip(("core", "gate", *PARAMS), tensors)), []):
        return norm_gate_fm_plain(*tensors, eps)
    return NormGate.apply(*tensors, eps)
