"""Feature-major dense and gated-MLP layers.

Counterparts of ``DenseFM`` and ``GatedMLPFM`` in
``torch_m3gnet_tpu.models.layers``: activations are (features, entities).
Kernels are stored in the Flax orientation (in_features, features), so a
Flax parameter tree maps onto these modules by name alone; a layer computes
``kernel.T @ x (+ bias[:, None])``, the same contraction as the JAX
``einsum("io,im->om")``.

:class:`NormGatedMLPFM` is CHGNet's (no JAX counterpart): the gated MLP
whose twin stacks each end in a LayerNorm over the features,
SiLU(LN(core(x))) * sigmoid(LN(gate(x))), its tail one op
(``ops.norm_gate``).

The JAX package can fuse the twin dense/gate stacks into wider matmuls
(``fuse_first``/``fuse_second``); that changes floating-point association
only. The port runs the plain twin stacks.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from torch_m3gnet_tpu_torch.ops.norm_gate import norm_gate_fm

# Flax's lecun_normal: a normal truncated at two standard deviations, whose
# std is rescaled by this factor so the variance is 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator | None) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Embed(nn.Module):
    """Embedding table ``embedding`` (num_embeddings, features), as Flax's
    ``nn.Embed``; initialised like it, normal with variance 1 / features."""

    def __init__(self, num_embeddings: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.empty(num_embeddings, features).normal_(
                0.0, 1.0 / math.sqrt(features), generator=generator
            )
        )

    def forward(self, idx: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """The rows of ``idx``, in ``dtype`` if given: the table is cast
        first, as Flax's ``nn.Embed(dtype=...)`` does, so the gradient is
        summed by row in that dtype and then cast back."""
        table = self.embedding if dtype is None else self.embedding.to(dtype)
        return table.index_select(0, idx)


class DenseFM(nn.Module):
    """Feature-major Dense: (in_features, M) -> (features, M), computed in
    the promoted dtype of input and kernel, as Flax's ``promote_dtype``
    (``dtype=None``): a bfloat16 input meets float32 weights in float32."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(in_features, features), in_features, generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x_fm: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x_fm.dtype, self.kernel.dtype)
        y = self.kernel.to(dtype).t() @ x_fm.to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)[:, None]
        return y


class GatedMLPFM(nn.Module):
    """Twin dense/gate stacks, output = dense(x) * gate(x).

    Dense layers are Linear+SiLU (the last one linear if ``is_output``);
    gate layers are Linear+SiLU with a final sigmoid.
    """

    def __init__(self, in_features: int, dimensions: Sequence[int], is_output: bool = False,
                 use_bias: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.is_output = is_output
        dims = [in_features, *dimensions]
        for i in range(len(dimensions)):
            self.add_module(f"dense_{i}", DenseFM(dims[i], dims[i + 1], use_bias, generator))
            self.add_module(f"gate_{i}", DenseFM(dims[i], dims[i + 1], use_bias, generator))
        self.depth = len(dimensions)

    def forward(self, x_fm: torch.Tensor) -> torch.Tensor:
        d = g = x_fm
        last = self.depth - 1
        for i in range(self.depth):
            d = getattr(self, f"dense_{i}")(d)
            if not (self.is_output and i == last):
                d = F.silu(d)
            g = getattr(self, f"gate_{i}")(g)
            g = torch.sigmoid(g) if i == last else F.silu(g)
        return d * g


class NormGatedMLPFM(nn.Module):
    """CHGNet's gated MLP, (in_features, M) -> (features, M):
    SiLU(LN(core(x))) * sigmoid(LN(gate(x))), where ``core`` and ``gate``
    are each Dense -> SiLU per hidden width of ``hidden``, then Dense to
    ``features`` (one Dense where ``hidden`` is empty), and each LayerNorm
    normalises a column over its features.

    Every layer runs feature-major. The last Dense of each stack is a
    bias-free product; its bias, both LayerNorms, the SiLU, the sigmoid and
    the product are ``ops.norm_gate`` (one kernel each way on the card).
    ``core_norm`` and ``gate_norm`` hold the LayerNorms' weight, bias and
    eps, so the parameters keep ``nn.LayerNorm``'s names."""

    def __init__(self, in_features: int, features: int, hidden: Sequence[int] = (),
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [in_features, *hidden, features]
        self.depth = len(dims) - 1
        for part in ("core", "gate"):
            for i in range(self.depth):
                self.add_module(f"{part}_{i}", DenseFM(dims[i], dims[i + 1], generator=generator))
            self.add_module(f"{part}_norm", nn.LayerNorm(features))

    def forward(self, x_fm: torch.Tensor) -> torch.Tensor:
        pre, bias = [], []
        for part in ("core", "gate"):
            h = x_fm
            for i in range(self.depth - 1):
                h = F.silu(getattr(self, f"{part}_{i}")(h))
            last = getattr(self, f"{part}_{self.depth - 1}")
            pre.append(last.kernel.to(h.dtype).t() @ h)
            bias.append(last.bias)
        core, gate = self.core_norm, self.gate_norm
        return norm_gate_fm(*pre, *bias, core.weight, core.bias, gate.weight, gate.bias, core.eps)
