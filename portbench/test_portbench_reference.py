"""The plain reference against the port's plain CPU path, both in float64,
on a tiny mp-mix batch: E/F/S in the factorized and the fused mode, one
train step, one NVE step. The reference shares no code with the port; the
two agree to rounding."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, labels, mpmix, weights
from portbench.reference import drive

HERE = Path(__file__).resolve().parent
RECIPE = [["Cu", 2, 2, 2], ["NaCl", 1, 1, 2], ["Mg", 3, 3, 2], ["SrTiO3", 2, 2, 3]]


def config(mode):
    cfg = json.loads((HERE / "configs" / f"m3gnet-mp-{mode}.json").read_text())
    cfg["embedding_dim"] = 16
    return cfg


def program(cfg, seed):
    from torch_m3gnet_tpu_torch import build_model

    w = weights.make_weights(cfg, seed, "cpu", torch.float64)
    elem = weights.elemental_energies(cfg, seed)
    pot = build_model(harness.model_config(cfg), elemental_energies=list(elem),
                      energy_scale=cfg["energy_scale"], device="cpu").double()
    pot.load_state_dict(w)
    return pot, w, elem


def structures(seed):
    return mpmix.batches(RECIPE, 1, seed, 0.02, 0.05)[0]


@pytest.mark.parametrize("mode", ["factorized", "fused"])
def test_efs_matches_port(mode):
    from torch_m3gnet_tpu_torch.data import Structure, pack_structures

    cfg = config(mode)
    pot, w, elem = program(cfg, 11)
    structs = structures(11)
    out = pot(pack_structures([Structure(*s) for s in structs], cfg["cutoff"],
                              cfg["threebody_cutoff"], pad_multiple=64, dtype=np.float64))
    ref = drive.efs(w, cfg, structs, elem, block_atoms=100)
    n = sum(len(s[2]) for s in structs)
    assert np.allclose(out.energy[: len(structs)].detach().numpy(), [r[0] for r in ref],
                       rtol=1e-12, atol=0)
    forces = np.concatenate([r[1] for r in ref])
    assert np.abs(out.forces[:n].detach().numpy() - forces).max() <= 1e-10 * np.abs(forces).max()
    stress = np.stack([r[2] for r in ref])
    assert np.abs(out.stress[: len(structs)].detach().numpy() - stress).max() <= (
        1e-10 * np.abs(stress).max())


def test_train_step_matches_port():
    from torch_m3gnet_tpu_torch.data import Structure, pack_structures
    from torch_m3gnet_tpu_torch.train import Trainer

    cfg = config("factorized")
    pot, w, elem = program(cfg, 12)
    structs = structures(12)
    labs = labels.morse_labels(structs, cfg["cutoff"], 12, "cpu")
    batch = pack_structures(
        [Structure(*s, properties={"energy": e, "forces": f, "stress": st})
         for s, (e, f, st) in zip(structs, labs)],
        cfg["cutoff"], cfg["threebody_cutoff"], pad_multiple=64, dtype=np.float64)
    trainer = Trainer(pot, harness.model_config(cfg), prefetch=0)
    loss = float(trainer.train_step(batch)["loss"])
    losses, first, after = drive.train_steps(w, cfg, [list(zip(structs, labs))], elem, 1,
                                             block_atoms=100)
    assert abs(loss - losses[0]) <= 1e-10 * abs(losses[0])
    params = dict(pot.named_parameters())
    for name, g in first.items():
        moment = trainer.optimizer.state[params[name]]["exp_avg"] / 0.1
        assert torch.allclose(moment, g, rtol=1e-8, atol=1e-12 * g.abs().max()), name
        assert torch.allclose(params[name].detach(), after[name], rtol=0, atol=1e-12), name


def test_md_step_matches_port():
    from torch_m3gnet_tpu_torch.data import Structure
    from torch_m3gnet_tpu_torch.simulate.md import MDConfig, run_md

    cfg = config("factorized")
    pot, w, elem = program(cfg, 13)
    lattice, pos, numbers = mpmix.crystal("Cu", (3, 3, 3), np.random.default_rng(13), 0.0, 0.05)
    vel = np.random.default_rng(14).standard_normal(pos.shape) * 2e-3
    md = {"dt": 1.0, "rebuild_every": 2, "skin": 0.3}
    res = run_md(pot, [Structure(lattice, pos, numbers)], cfg["cutoff"], cfg["threebody_cutoff"],
                 MDConfig(dt=1.0, n_steps=2, rebuild_every=2, skin=0.3), velocities=[vel],
                 pad_multiple=64, dtype=np.float64)
    x, v, e = drive.md_chunk(w, cfg, (lattice, pos, numbers), vel, mpmix.masses(numbers), elem, md)
    end = res.structures[0]
    assert np.abs(drive.min_image(end.cart_coords - x, lattice)).max() <= 1e-12
    assert np.abs(end.properties["velocities"] - v).max() <= 1e-8 * np.abs(v - vel).max()
    assert np.allclose(res.energies[:, 0], e, rtol=1e-12, atol=0)
