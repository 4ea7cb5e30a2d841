"""The port's ``relax`` and ``md`` CLIs against the JAX package's on the same
files, on the CPU, from JAX's seeded initial weights (recorded and written
as a port checkpoint, as in ``test_torch_cli_predict.py``), both in float32
and in the factorized mode: every printed number within rtol 1e-4, atol
1e-6.

- relax: FIRE with the cell. (L-BFGS is held to the port's own
  ``relax_structures``: JAX's L-BFGS zeroes a ring slot's alpha while its
  history fills, a recorded JAX deviation, so the two differ by design.)
- md: NVE at 300 K (the velocities come from the same seeded numpy draw),
  NVT and NPT at 0 K, where the Langevin noise is zero and both
  trajectories are deterministic. The NPT ``--traj-out`` frames are held to
  the volumes of JAX's ``run_md``, which its CLI prints (``volume_a3``):
  JAX's own CLI cannot write them (its NPT frames call ``np.linalg.det`` in
  a module that never imports numpy).
- With a port checkpoint both CLIs apply its sidecar: their energies are
  those of ``build_model(config, **meta)`` with the checkpoint's weights.
"""

import json

import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.cli import md as jax_md_cli
from torch_m3gnet_tpu.cli import relax as jax_relax_cli
from torch_m3gnet_tpu_torch.cli import md, relax
from torch_m3gnet_tpu_torch.cli.common import load_structures
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.models import build_model
from torch_m3gnet_tpu_torch.simulate import FireConfig, LbfgsConfig, MDConfig, relax_structures
from torch_m3gnet_tpu_torch.simulate import run_md
from torch_m3gnet_tpu_torch.train import Trainer

from chip_smoke import read_extxyz_lattices
from test_torch_cli_predict import (
    RTOL,
    assert_close,
    record_jax_init,
    run_jax,
    run_port,
    write_cells,
    write_config,
    write_port_checkpoint,
)

FACTORIZED = "threebody_mode: factorized\nlayout: fm\n"
MD_ARGS = ["--steps", "6", "--rebuild-every", "3", "--seed", "1", "--friction", "0.05",
           "--pressure", "1.0", "--tau-p", "20", "--compressibility", "0.01"]


def both(tmp_path, monkeypatch, capsys, jax_main, port_main, args, port_extra=()):
    """(port output, JAX output) of one CLI on ``args``: JAX from its seeded
    weights, the port from a checkpoint of them."""
    params = record_jax_init(monkeypatch)
    want = run_jax(monkeypatch, capsys, jax_main, args)
    ckpt = write_port_checkpoint(tmp_path / "best", params[0])
    got = run_port(capsys, port_main, [*args, *port_extra, "--checkpoint", ckpt,
                                       "--device", "cpu"])
    return got, want


def test_relax_fire_with_cell_matches_jax(tmp_path, monkeypatch, capsys):
    args = ["--structures", write_cells(tmp_path, rattle=0.1),
            "--config", write_config(tmp_path, FACTORIZED), "--relax-cell",
            "--max-steps", "20", "--fmax", "1e-4"]
    got, want = both(tmp_path, monkeypatch, capsys, jax_relax_cli.main, relax.main, args)
    assert len(want) == 3
    assert_close(got, want)


def test_relax_lbfgs_is_relax_structures(tmp_path, capsys):
    cfg = write_config(tmp_path)
    cells = write_cells(tmp_path, rattle=0.1)
    got = run_port(capsys, relax.main, ["--structures", cells, "--config", cfg,
                                        "--optimizer", "lbfgs", "--max-steps", "20",
                                        "--seed", "2", "--device", "cpu"])
    pot = build_model(M3GNetConfig.from_yaml(cfg), device="cpu",
                      generator=torch.Generator().manual_seed(2))
    relaxed, energies, fmax = relax_structures(pot, load_structures(cells), 5.0, 4.0,
                                               LbfgsConfig(max_steps=20))
    np.testing.assert_array_equal([r["energy"] for r in got], energies)
    np.testing.assert_array_equal([r["fmax"] for r in got], fmax)
    np.testing.assert_array_equal(got[0]["cart_coords"], relaxed[0].cart_coords)


@pytest.mark.parametrize("ensemble,temperature", [("nve", "300"), ("nvt", "0"), ("npt", "0")])
def test_md_matches_jax(tmp_path, monkeypatch, capsys, ensemble, temperature):
    args = ["--structures", write_cells(tmp_path), "--config", write_config(tmp_path, FACTORIZED),
            "--ensemble", ensemble, "--temperature", temperature, *MD_ARGS]
    traj = str(tmp_path / "traj")
    extra = ["--traj-out", traj] if ensemble == "npt" else []
    got, want = both(tmp_path, monkeypatch, capsys, jax_md_cli.main, md.main, args, extra)
    assert len(want["times_fs"]) == 6
    assert_close(got, want)
    if ensemble != "npt":
        return
    structures = load_structures(args[1])
    volumes = np.asarray(want["volume_a3"])  # JAX's run_md volumes, (steps, B)
    assert not np.allclose(volumes, volumes[:1])
    for i, s in enumerate(structures):
        frames = read_extxyz_lattices(f"{traj}.{i}.extxyz")
        assert len(frames) == 6
        v0 = abs(np.linalg.det(s.lattice))
        want_cells = s.lattice[None] * ((volumes[:, i] / v0) ** (1 / 3))[:, None, None]
        np.testing.assert_allclose(frames, want_cells, rtol=RTOL)


def test_relax_and_md_apply_the_sidecar(tmp_path, capsys):
    """The sidecar's elemental energies and energy scale reach the
    potential: the CLIs' energies are those of the potential built with
    them and loaded with the checkpoint's weights, on the CPU bitwise, and
    far from those of the same weights without them."""
    cfg_path = write_config(tmp_path, FACTORIZED)
    cfg = M3GNetConfig.from_yaml(cfg_path)
    cells = write_cells(tmp_path)
    meta = {"elemental_energies": [0.0] * 28 + [-3.7], "energy_scale": 1.7}
    pot = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    ckpt = str(tmp_path / "best")
    torch.save({"params": pot.state_dict()}, ckpt)
    with open(ckpt + ".meta.json", "w") as f:
        json.dump(meta, f)

    want = build_model(cfg, **meta, device="cpu")
    want.load_state_dict(Trainer.load_params(ckpt))
    bare = build_model(cfg, device="cpu")
    bare.load_state_dict(Trainer.load_params(ckpt))
    structures = load_structures(cells)

    common = ["--structures", cells, "--config", cfg_path, "--checkpoint", ckpt,
              "--device", "cpu"]
    got = run_port(capsys, relax.main, [*common, "--max-steps", "20"])
    energies = [relax_structures(p, structures, 5.0, 4.0, FireConfig(max_steps=20))[1]
                for p in (want, bare)]
    np.testing.assert_array_equal([r["energy"] for r in got], energies[0])
    assert np.abs(energies[0] - energies[1]).min() > 1.0

    got = run_port(capsys, md.main, [*common, "--ensemble", "nve", "--steps", "4"])
    res = run_md(want, structures, 5.0, 4.0, MDConfig(n_steps=4, ensemble="nve",
                                                       rebuild_every=20))
    np.testing.assert_array_equal(got["potential_energy_ev"], res.energies)
