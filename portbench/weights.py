"""Seeded weights of an M3GNet configuration, made on the device.

One normal draw of all 227,549 numbers (at the published widths) from a
``torch.Generator`` on the run's device, cut into leaves and scaled:
kernels by 1 / sqrt(fan_in) (LeCun), the species embedding by
1 / sqrt(width), biases by 0.1 (non-zero, so that their gradients are
exercised). The names are those of the program's ``state_dict``; the
reference reads the same dict by the same names.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def layout(cfg: dict) -> list[tuple[str, tuple, float]]:
    """(name, shape, std) of every weight, kernels as (in, out)."""
    d, n, ln = cfg["embedding_dim"], cfg["n_max"], cfg["l_max"] * cfg["n_max"]
    leaves = [("model.atom_embed.embedding", (cfg["num_types"], d), 1 / math.sqrt(d)),
              ("model.edge_init.kernel", (n, d), None)]

    def gated(name, dims, bias):
        for i in range(len(dims) - 1):
            for part in ("dense", "gate"):
                leaves.append((f"{name}.{part}_{i}.kernel", (dims[i], dims[i + 1]), None))
                if bias:
                    leaves.append((f"{name}.{part}_{i}.bias", (dims[i + 1],), 0.1))

    for b in range(cfg["num_blocks"]):
        leaves += [(f"model.three_gate_{b}.kernel", (d, ln), None),
                   (f"model.three_gate_{b}.bias", (ln,), 0.1)]
        gated(f"model.three_mlp_{b}", [ln, d], False)
        gated(f"model.conv_edge_{b}", [3 * d, d, d], True)
        leaves.append((f"model.conv_edge_w_{b}.kernel", (n, d), None))
        gated(f"model.conv_node_{b}", [3 * d, d, d], True)
        leaves.append((f"model.conv_node_w_{b}.kernel", (n, d), None))
    gated("model.readout", [d, d, d, 1], True)
    return [(name, shape, 1 / math.sqrt(shape[0]) if std is None else std)
            for name, shape, std in leaves]


def make_weights(cfg: dict, seed: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    leaves = layout(cfg)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for (name, shape, std), size in zip(leaves, sizes):
        out[name] = (flat[off:off + size] * std).reshape(shape)
        off += size
    return out


def elemental_energies(cfg: dict, seed: int) -> np.ndarray:
    """Seeded per-species reference energies, uniform in the range that
    ``cfg["elemental_energy_range"]`` gives (eV/atom)."""
    lo, hi = cfg["elemental_energy_range"]
    return np.random.default_rng([seed, 1]).uniform(lo, hi, cfg["num_types"])
