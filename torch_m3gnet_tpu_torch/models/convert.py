"""Weights carried across from the JAX package's Flax parameter tree.

The port's modules carry the Flax names and keep every kernel in the Flax
orientation (in_features, features), so the map is by name alone: the
nested path ``atom_embed/embedding`` becomes the ``state_dict`` key
``atom_embed.embedding``, ``conv_edge_0/dense_1/kernel`` becomes
``conv_edge_0.dense_1.kernel``, and so on. Nothing is transposed.
:func:`flax_from_params` maps back.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_flax(params: Mapping, dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """``{"params": {...}}`` (or the inner tree) of numpy arrays -> the
    ``state_dict`` of :class:`~torch_m3gnet_tpu_torch.models.m3gnet.M3GNet`.

    Load it with ``potential.model.load_state_dict(...)``, whose strict key
    and shape checks catch a tree of another configuration. ``dtype`` casts
    the weights (the Flax tree is float32).
    """
    tree = params["params"] if "params" in params else params
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for name, child in node.items():
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(child, Mapping):
                walk(child, key)
            else:
                t = torch.as_tensor(np.array(child))
                out[key] = t.to(dtype) if dtype is not None else t

    walk(tree, "")
    return out


def flax_from_params(state_dict: Mapping) -> dict:
    """The inverse of :func:`params_from_flax`: a ``state_dict`` of the model
    (or of the potential, whose keys carry a ``model.`` prefix) -> the nested
    Flax-layout tree of float64 numpy arrays (the ``params`` subtree), as
    ``utils.oracle.reference_energy_numpy`` reads it."""
    tree: dict = {}
    for key, value in state_dict.items():
        *path, leaf = key.removeprefix("model.").split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value.detach().cpu().double().numpy()
    return tree
