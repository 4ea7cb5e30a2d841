"""Feature-major dense and gated-MLP layers.

Counterparts of ``DenseFM`` and ``GatedMLPFM`` in
``torch_m3gnet_tpu.models.layers``: activations are (features, entities).
Kernels are stored in the Flax orientation (in_features, features), so a
Flax parameter tree maps onto these modules by name alone; a layer computes
``kernel.T @ x (+ bias[:, None])``, the same contraction as the JAX
``einsum("io,im->om")``.

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

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embedding.index_select(0, idx)


class DenseFM(nn.Module):
    """Feature-major Dense: (in_features, M) -> (features, M)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(in_features, features), in_features, generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x_fm: torch.Tensor) -> torch.Tensor:
        y = self.kernel.t() @ x_fm
        if self.bias is not None:
            y = y + self.bias[:, None]
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
