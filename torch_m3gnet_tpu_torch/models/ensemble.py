"""Committee (deep-ensemble) evaluation: K parameter sets of one potential.

Counterpart of ``torch_m3gnet_tpu.models.ensemble``: train K potentials
(different seeds or splits), stack their weights, and get the committee's
mean prediction and its disagreement, the usual active-learning and
uncertainty signal.

JAX maps one jitted forward over the members with ``jax.vmap``. The port's
kernel Functions (B1-B8) are written in the ``ctx`` style, with no
``setup_context`` and so no vmap rule; the port loops over the members
instead, each through ``torch.func.functional_call`` on the one potential
module, so an evaluation of K members launches exactly K evaluations'
kernels. The batch moves to the device, with its kernel index, once for
all members. A vmapped version waits until the Functions move to
``setup_context``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch
from torch.func import functional_call

from torch_m3gnet_tpu_torch.data.graph import to_torch
from torch_m3gnet_tpu_torch.models.m3gnet import PotentialOutput

_FIELDS = tuple(f.name for f in dataclasses.fields(PotentialOutput))


def stack_params(state_dicts: Sequence[Mapping[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """Stack K ``state_dict`` s of one architecture along a new leading axis."""
    keys = list(state_dicts[0])
    for sd in state_dicts[1:]:
        if list(sd) != keys:
            raise ValueError("the state_dicts have different keys")
    return {k: torch.stack([sd[k] for sd in state_dicts]) for k in keys}


class EnsemblePotential:
    """K-member committee over one :class:`M3GNetPotential` architecture.

    ``apply(stacked, batch)`` takes :func:`stack_params` of K ``state_dict``
    s of ``potential`` and returns ``(mean, std)`` as
    :class:`PotentialOutput` s: the elementwise committee mean and
    population standard deviation of energy, forces, stress, energy per
    atom and atomic energy. Padded entries stay zero in both. The members
    share the potential's constants (elemental energies, energy scale) and
    its three-body mode; their weights are cast to its device and dtype.
    """

    def __init__(self, potential):
        self.potential = potential

    def apply(self, stacked: Mapping[str, torch.Tensor], batch) -> tuple[PotentialOutput,
                                                                        PotentialOutput]:
        model = self.potential.model
        param = model.edge_init.kernel
        graph = to_torch(batch, param.device, param.dtype, model.batch_index)
        stacked = {k: v.to(param.device, param.dtype) for k, v in stacked.items()}
        k = next(iter(stacked.values())).shape[0]
        outs = [functional_call(self.potential, {name: v[i] for name, v in stacked.items()},
                                (graph,))
                for i in range(k)]
        per_field = {f: torch.stack([getattr(o, f).detach() for o in outs]) for f in _FIELDS}
        mean = PotentialOutput(**{f: x.mean(0) for f, x in per_field.items()})
        std = PotentialOutput(**{f: x.std(0, correction=0) for f, x in per_field.items()})
        return mean, std
