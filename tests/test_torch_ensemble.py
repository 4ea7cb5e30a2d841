"""The port's committee evaluation (``models.ensemble``) against the JAX
package's ``EnsemblePotential``, with the same K = 3 weight sets.

Three JAX initialisations carried over by ``params_from_flax`` at float64
(JAX in x64), on a padded two-graph batch: the committee mean and
population std of energy, forces, stress, energy per atom and atomic energy
agree at rtol 1e-8 (atol 1e-12: the std of a padded entry is 0 on both
sides), with the padded entries zero in both; a K = 1 committee has std
exactly 0. JAX runs its factorized mode, the port its default (the same);
then the fused mode (JAX's Pallas kernels in TPU interpret mode) and the
gather mode, with the same members (the parameter tree does not depend on
the mode).

The port's committee is one ``torch.func.vmap`` over the members: each
kernel Function runs once per call site for all K members, so a
committee's Function calls equal one evaluation's in every mode. With
``remat_triplets=True`` the committee runs the stage without the
checkpoint (``torch.func`` refuses its hooks) and equals the committee
without it (1e-12).
"""

import contextlib
from collections import Counter

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
from torch_m3gnet_tpu_torch.data import pack_structures, to_torch
from torch_m3gnet_tpu_torch.ops import factorized_stage as fs
from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
from torch_m3gnet_tpu_torch.ops import sorted_segment as ss
from torch_m3gnet_tpu_torch.ops import windowed_take as wt
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
MODES = ("factorized", "fused", "gather")
FUNCTIONS = (fs.QScatter, fs.R1Gather, fs.R2Gather, ft.FusedTripletGateSum, ft.BackwardPair,
             wt.WindowedTake, wt.WindowedScatter, ss.SortedSegmentSum, ss.SortedTake)


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


def _pot(mode, **kw):
    return build_model(M3GNetConfig(threebody_mode=mode, **SMALL, **kw),
                       elemental_energies=[0.0] * 29 + [-3.7], energy_scale=1.3,
                       device="cpu").double()


@pytest.mark.parametrize("mode", ["fused", "gather"])
def test_mean_and_std_match_jax_in_each_mode(setup, mode):
    """The same members in the per-triplet modes; JAX's fused mode through
    its Pallas kernels in TPU interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    _, jb, pb, members, _, state_dicts = setup
    jpot = jax_build_model(JaxConfig(threebody_mode=mode, **SMALL),
                           elemental_energies=[0.0] * 29 + [-3.7], energy_scale=1.3)
    pot = _pot(mode)
    assert pot.model.threebody_mode == mode
    with pltpu.force_tpu_interpret_mode() if mode == "fused" else contextlib.nullcontext():
        want = JaxEnsemble(jpot).apply(jax_stack(members), jb)
    got = EnsemblePotential(pot).apply(stack_params(state_dicts), pb)
    for w, g, label in zip(want, got, ("mean", "std")):
        for f in FIELDS:
            np.testing.assert_allclose(getattr(g, f).numpy(), np.asarray(getattr(w, f)),
                                       rtol=1e-8, atol=1e-12, err_msg=f"{mode} {label} {f}")
    _, std1 = EnsemblePotential(pot).apply(stack_params(state_dicts[:1]), pb)
    assert all((getattr(std1, f) == 0).all() for f in FIELDS)


@pytest.fixture
def function_calls(monkeypatch):
    """Counts each kernel Function's forward: under vmap the rule calls it
    once for every member, as one evaluation calls it once."""
    calls = Counter()

    def counting(name, forward):
        def counted(*args):
            calls[name] += 1
            return forward(*args)
        return staticmethod(counted)

    for fn in FUNCTIONS:
        monkeypatch.setattr(fn, "forward", counting(fn.__name__, fn.forward))
    return calls


@pytest.mark.parametrize("mode", MODES)
def test_committee_calls_each_function_as_one_evaluation(setup, mode, function_calls):
    _, _, pb, _, _, state_dicts = setup
    pot = _pot(mode)
    pot.load_state_dict(state_dicts[0])
    single = pot(pb)
    one_eval = Counter(function_calls)
    function_calls.clear()
    mean, std = EnsemblePotential(pot).apply(stack_params(state_dicts), pb)
    assert function_calls == one_eval
    kernels = {"factorized": ("QScatter", "R1Gather", "R2Gather"),
               "fused": ("FusedTripletGateSum", "BackwardPair", "WindowedTake",
                         "WindowedScatter")}.get(mode, ())
    assert all(one_eval[k] > 0 for k in kernels + ("SortedSegmentSum",)), one_eval
    # the committee's members are the single evaluations: member 0 is one
    singles = []
    for sd in state_dicts:
        pot.load_state_dict(sd)
        singles.append(pot(pb))
    for f in FIELDS:
        x = torch.stack([getattr(o, f).detach() for o in singles])
        torch.testing.assert_close(getattr(mean, f), x.mean(0), rtol=1e-12, atol=1e-15)
        torch.testing.assert_close(getattr(std, f), x.std(0, correction=0), rtol=1e-9,
                                   atol=1e-15)
    torch.testing.assert_close(singles[0].energy, single.energy, rtol=0, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_remat_committee_matches_committee(setup, mode):
    _, _, pb, _, _, state_dicts = setup
    stacked = stack_params(state_dicts)
    want = EnsemblePotential(_pot(mode)).apply(stacked, pb)
    remat = _pot(mode, remat_triplets=True)
    assert remat.model.remat_triplets
    got = EnsemblePotential(remat).apply(stacked, pb)
    for w, g in zip(want, got):
        for f in FIELDS:
            torch.testing.assert_close(getattr(g, f), getattr(w, f), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("mode", MODES)
def test_functional_pass_matches_eager(setup, mode):
    """One member: the functional pass (torch.func.vjp of the energy, as
    the committee runs it) against the eager one (torch.autograd.grad);
    with create_graph=True its forces differentiate to the positions as
    the eager ones do (the first rows of the force constants, 1e-12)."""
    _, _, pb, _, _, state_dicts = setup
    pot = _pot(mode)
    pot.load_state_dict(state_dicts[1])
    want, got = pot(pb), pot(pb, functional=True)
    for f in FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(want, f).detach(), rtol=1e-12,
                                   atol=1e-15)

    graph = to_torch(pb, "cpu", torch.float64, pot.model.batch_index)

    def force_rows(functional):
        positions = graph.positions.clone().requires_grad_(True)
        out = pot(graph.replace(positions=positions), create_graph=True, functional=functional)
        return torch.stack([torch.autograd.grad(out.forces[0, i], positions,
                                                retain_graph=True)[0] for i in range(3)])

    torch.testing.assert_close(force_rows(True), force_rows(False), rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="no process group"):
        pot(pb, functional=True, group=object())
