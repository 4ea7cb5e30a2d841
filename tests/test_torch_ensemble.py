"""The port's committee evaluation (``models.ensemble``) against the JAX
package's ``EnsemblePotential``, with the same K = 3 weight sets.

Three JAX initialisations carried over by ``params_from_flax`` at float64
(JAX in x64), on a padded two-graph batch: the committee mean and
population std of energy, forces, stress, energy per atom and atomic energy
agree at rtol 1e-8 (atol 1e-12: the std of a padded entry is 0 on both
sides), with the padded entries zero in both; a K = 1 committee has std
exactly 0. JAX runs its factorized mode, the port its default (the same).
"""

import jax
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.config import M3GNetConfig as JaxConfig
from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.models import EnsemblePotential as JaxEnsemble
from torch_m3gnet_tpu.models import build_model as jax_build_model
from torch_m3gnet_tpu.models import stack_params as jax_stack
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data import pack_structures
from torch_m3gnet_tpu_torch.models import (
    EnsemblePotential,
    build_model,
    params_from_flax,
    stack_params,
)

jax.config.update("jax_enable_x64", True)

SMALL = dict(l_max=2, n_max=2, embedding_dim=8, num_blocks=2)
FIELDS = ("energy", "forces", "stress", "energy_per_atom", "atomic_energy")
FCC = [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]
K = 3


@pytest.fixture(scope="module")
def setup():
    """(JAX batch, port batch, JAX members, the port's potential, their
    state_dicts): two rattled Cu cells, padded."""
    rng = np.random.default_rng(7)
    base = JaxStructure.from_frac_coords(np.eye(3) * 3.62, FCC, [29] * 4)
    js = [JaxStructure(base.lattice, base.cart_coords + 0.1 * rng.standard_normal((4, 3)),
                       base.atomic_numbers) for _ in range(2)]
    jb = jax_pack(js, 5.0, 4.0, pad_multiple=64, dtype=np.float64)
    pb = pack_structures(js, 5.0, 4.0, pad_multiple=64, dtype=np.float64)
    jpot = jax_build_model(JaxConfig(threebody_mode="factorized", layout="fm", **SMALL),
                           elemental_energies=[0.0] * 29 + [-3.7], energy_scale=1.3)
    init = jax.jit(jpot.init)
    members = [jax.tree.map(lambda x: x.astype(np.float64), init(jax.random.PRNGKey(k), jb))
               for k in range(K)]
    pot = build_model(M3GNetConfig(**SMALL), elemental_energies=[0.0] * 29 + [-3.7],
                      energy_scale=1.3, device="cpu").double()
    state_dicts = [{"model." + k: v for k, v in params_from_flax(
        jax.tree.map(np.asarray, p), dtype=torch.float64).items()} for p in members]
    return jpot, jb, pb, members, pot, state_dicts


def test_mean_and_std_match_jax(setup):
    jpot, jb, pb, members, pot, state_dicts = setup
    want = JaxEnsemble(jpot).apply(jax_stack(members), jb)
    got = EnsemblePotential(pot).apply(stack_params(state_dicts), pb)
    real = pb.node_mask
    for w, g, label in zip(want, got, ("mean", "std")):
        for f in FIELDS:
            a, b = getattr(g, f).numpy(), np.asarray(getattr(w, f))
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12, err_msg=f"{label} {f}")
        assert (g.forces[~real] == 0).all() and (g.atomic_energy[~real] == 0).all()
    assert (got[1].energy > 0).all()  # different seeds disagree
    # the mean is that of K single evaluations of the port
    singles = []
    for sd in state_dicts:
        pot.load_state_dict(sd)
        singles.append(pot(pb).energy.detach())
    np.testing.assert_allclose(got[0].energy.numpy(), torch.stack(singles).mean(0).numpy(),
                               rtol=1e-12)


def test_one_member_has_zero_std(setup):
    _, _, pb, _, pot, state_dicts = setup
    mean, std = EnsemblePotential(pot).apply(stack_params(state_dicts[:1]), pb)
    for f in FIELDS:
        assert (getattr(std, f) == 0).all(), f
    pot.load_state_dict(state_dicts[0])
    np.testing.assert_array_equal(mean.energy.numpy(), pot(pb).energy.detach().numpy())
    with pytest.raises(ValueError, match="different keys"):
        stack_params([state_dicts[0], {k: v for k, v in list(state_dicts[1].items())[1:]}])
