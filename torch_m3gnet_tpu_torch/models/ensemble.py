"""Committee (deep-ensemble) evaluation: K parameter sets of one potential.

Counterpart of ``torch_m3gnet_tpu.models.ensemble``: train K potentials
(different seeds or splits), stack their weights, and get the committee's
mean prediction and its disagreement, the usual active-learning and
uncertainty signal.

As JAX maps one jitted forward over the members with ``jax.vmap``, the
port maps one: ``torch.func.vmap`` of ``torch.func.functional_call`` over
the stacked weights, with the batch (and its kernel index) moved to the
device once and shared, not batched. Each member takes its forces and
stress from the potential's functional pass (``M3GNetPotential.forward``
with ``functional=True``: ``torch.func.vjp`` of the energy). Every kernel
Function has a vmap rule (``ops._vmap``), so each kernel call of the
evaluation runs once for all K members: B1-B5 on their member axis (a
shared operand, such as the geometry or the triplet basis, passed once at
stride 0), B6-B8 with the members' rows folded into one call. The dense
layers run as batched matrix products. A committee thus launches one
evaluation's kernels, not K, in either kernel mode.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch
from torch.func import functional_call, vmap

from torch_m3gnet_tpu_torch.data.graph import to_torch
from torch_m3gnet_tpu_torch.models.m3gnet import PotentialOutput

# Every field of the output but the magnetic moments, which M3GNet lacks.
_FIELDS = tuple(f.name for f in dataclasses.fields(PotentialOutput) if f.name != "magmom")


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
    ``remat_triplets`` does not apply to the committee: see the functional
    pass of :class:`M3GNetPotential`.

    Memory: the one pass holds every member's activations at once. On an
    H100 (the default model, the 32-cell bench batch, f32) a committee of 3
    peaked at 7.16 GB against 3.56 GB for one evaluation (the loop it
    replaced peaked near one evaluation's), so a batch whose single
    evaluation needs more than about half the card no longer fits a
    committee of 3: evaluate it in smaller batches, or fewer members a call.
    """

    def __init__(self, potential):
        self.potential = potential

    def apply(self, stacked: Mapping[str, torch.Tensor], batch) -> tuple[PotentialOutput,
                                                                        PotentialOutput]:
        model = self.potential.model
        param = model.edge_init.kernel
        graph = to_torch(batch, param.device, param.dtype, model.batch_index)
        stacked = {k: v.to(param.device, param.dtype) for k, v in stacked.items()}

        def member(params):
            out = functional_call(self.potential, params, (graph,), {"functional": True})
            return tuple(getattr(out, f) for f in _FIELDS)

        per_field = dict(zip(_FIELDS, (x.detach() for x in vmap(member)(stacked))))
        mean = PotentialOutput(**{f: x.mean(0) for f, x in per_field.items()})
        std = PotentialOutput(**{f: x.std(0, correction=0) for f, x in per_field.items()})
        return mean, std
