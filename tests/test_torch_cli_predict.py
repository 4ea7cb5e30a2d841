"""The port's ``predict`` and ``bessel_zeros`` CLIs against the JAX
package's on the same files, on the CPU, and what every new CLI of the port
shares (``cli/common.py``): the checkpoint's sidecar, ``--device``.

The JAX CLI runs through ``sys.argv`` from its own seeded initial weights,
which the test records and writes as a port checkpoint (``torch.save`` of
the potential's ``state_dict`` with a ``.meta.json`` sidecar) for the port's
CLI. Both compute in float32 (JAX's gather mode on its CPU against the
port's factorized mode, sums in other orders): every printed number within
rtol 1e-4, atol 1e-6, as ``tests/test_torch_cli.py`` holds the training
CLIs. The helpers here serve the other ``test_torch_cli_*`` files too.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.cli import bessel_zeros as jax_bessel_zeros
from torch_m3gnet_tpu.cli import predict as jax_predict
from torch_m3gnet_tpu.models import m3gnet as jax_m3gnet
from torch_m3gnet_tpu_torch.cli import bessel_zeros, predict
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.models import build_model, params_from_flax

RTOL, ATOL = 1e-4, 1e-6
MLEARN = "tests/fixtures/synthetic_mlearn_Cu/test.json"
FCC = [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]
SMALL = "l_max: 2\nn_max: 2\nembedding_dim: 8\nnum_blocks: 1\n"


def write_config(tmp_path, extra: str = "") -> str:
    path = tmp_path / "config.yaml"
    path.write_text(SMALL + extra)
    return str(path)


def write_cells(tmp_path, n: int = 3, rattle: float = 0.05, seed: int = 0) -> str:
    """``n`` rattled fcc Cu cells as the CLIs' JSON: 4-atom cells by
    fractional coordinates, every third a 2x1x1 supercell by cartesian ones."""
    rng = np.random.default_rng(seed)
    cells = []
    for i in range(n):
        if i % 3 == 2:
            lattice = np.diag([7.24, 3.62, 3.62])
            cart = np.concatenate([np.array(FCC) * 3.62, np.array(FCC) * 3.62 + [3.62, 0, 0]])
            cart = cart + rattle * rng.standard_normal(cart.shape)
            cells.append({"lattice": lattice.tolist(), "cart_coords": cart.tolist(),
                          "atomic_numbers": [29] * 8})
        else:
            frac = np.array(FCC) + rattle / 3.62 * rng.standard_normal((4, 3))
            cells.append({"lattice": (np.eye(3) * 3.62).tolist(), "frac_coords": frac.tolist(),
                          "atomic_numbers": [29] * 4})
    path = tmp_path / "cells.json"
    path.write_text(json.dumps(cells))
    return str(path)


def record_jax_init(monkeypatch) -> list:
    """Record the parameters of every JAX ``M3GNetPotential.init`` call."""
    captured = []
    init = jax_m3gnet.M3GNetPotential.init

    def recording(self, rng, graph):
        params = init(self, rng, graph)
        captured.append(params)
        return params

    monkeypatch.setattr(jax_m3gnet.M3GNetPotential, "init", recording)
    return captured


def write_port_checkpoint(path, params, elemental=(), energy_scale: float = 1.0) -> str:
    """A port checkpoint of a Flax tree, as ``Trainer.save_checkpoint``
    writes one: the potential's ``state_dict`` and the sidecar."""
    state = {"model." + k: v
             for k, v in params_from_flax(jax.tree.map(np.asarray, params)).items()}
    torch.save({"params": state}, str(path))
    with open(f"{path}.meta.json", "w") as f:
        json.dump({"elemental_energies": list(elemental), "energy_scale": energy_scale}, f)
    return str(path)


def run_jax(monkeypatch, capsys, main, args):
    """A JAX CLI's ``main()`` on ``args`` through ``sys.argv``; its JSON."""
    monkeypatch.setattr(sys, "argv", ["prog", *args])
    main()
    return json.loads(capsys.readouterr().out)


def run_port(capsys, main, args):
    main(args)
    return json.loads(capsys.readouterr().out)


def assert_close(got, want, path=""):
    """Equal structure; numbers within RTOL/ATOL, integers exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list) and want and isinstance(want[0], (dict, str)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, (int, str)) and not isinstance(want, bool):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                   np.asarray(want, dtype=np.float64),
                                   rtol=RTOL, atol=ATOL, err_msg=path)


def test_predict_packs_the_bond_pairs_chgnet_reads(tmp_path, capsys):
    """A narrow CHGNet config through the ``predict`` CLI: it packs each
    batch with the bond pairs (``edge_reverse``) that CHGNet's
    ``batch_index`` names, and prints E/F/S and the per-atom magnetic
    moments, equal to the seeded potential on the same batches."""
    from torch_m3gnet_tpu_torch.cli.common import load_structures
    from torch_m3gnet_tpu_torch.data.graph import pack_structures

    cfg = tmp_path / "chgnet.yaml"
    cfg.write_text("architecture: chgnet\nthreebody_cutoff: 3.0\nembedding_dim: 8\n"
                   "num_blocks: 4\n")
    cells = write_cells(tmp_path)
    got = run_port(capsys, predict.main, ["--structures", cells, "--config", str(cfg),
                                          "--seed", "3", "--batch-size", "2", "--device", "cpu"])
    config = M3GNetConfig.from_yaml(str(cfg))
    pot = build_model(config, device="cpu", generator=torch.Generator().manual_seed(3))
    structs = load_structures(cells)
    want = []
    for lo in (0, 2):
        batch = pack_structures(structs[lo:lo + 2], config.cutoff, config.threebody_cutoff,
                                bond_pairs=True)
        out = pot(batch)
        for gi, s in enumerate(structs[lo:lo + 2]):
            sel = (batch.node_graph == gi) & batch.node_mask
            want.append({"energy": float(out.energy.detach()[gi]),
                         "energy_per_atom": float(out.energy_per_atom.detach()[gi]),
                         "forces": out.forces.detach()[sel].tolist(),
                         "stress_voigt": out.stress.detach()[gi].tolist(),
                         "num_atoms": len(s),
                         "magmom": out.magmom.detach()[sel].tolist()})
    assert len(got) == 3 and all(len(r["magmom"]) == r["num_atoms"] for r in got)
    assert_close(got, want)


@pytest.mark.parametrize("fmt", ["json", "mlearn"])
def test_predict_matches_jax(tmp_path, monkeypatch, capsys, fmt):
    """Three structures in batches of two (json), or the mlearn fixture."""
    cfg = write_config(tmp_path)
    path = write_cells(tmp_path) if fmt == "json" else MLEARN
    params = record_jax_init(monkeypatch)
    args = ["--structures", path, "--format", fmt, "--config", cfg, "--batch-size", "2"]
    want = run_jax(monkeypatch, capsys, jax_predict.main, args)
    ckpt = write_port_checkpoint(tmp_path / "best", params[0])
    got = run_port(capsys, predict.main, [*args, "--checkpoint", ckpt, "--device", "cpu"])
    assert len(want) == (3 if fmt == "json" else 12)
    assert_close(got, want)


def test_predict_seeded_weights_are_reproducible(tmp_path, capsys):
    """Without a checkpoint the weights come from ``--seed``."""
    args = ["--structures", write_cells(tmp_path), "--config", write_config(tmp_path),
            "--device", "cpu"]
    a, b, c = (run_port(capsys, predict.main, [*args, "--seed", s]) for s in ("3", "3", "4"))
    assert a == b and a != c


def test_checkpoint_without_sidecar_exits(tmp_path):
    """As JAX's predict: a checkpoint without its sidecar cannot be used."""
    cfg = write_config(tmp_path)
    pot = build_model(M3GNetConfig.from_yaml(cfg), device="cpu")
    torch.save({"params": pot.state_dict()}, str(tmp_path / "best"))
    with pytest.raises(SystemExit, match="no sidecar"):
        predict.main(["--structures", write_cells(tmp_path), "--config", cfg,
                      "--checkpoint", str(tmp_path / "best"), "--device", "cpu"])


def test_device_defaults_to_the_card(tmp_path, monkeypatch):
    """``--device`` defaults to ``cuda``: with no card the CLI raises, it
    does not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(["--structures", write_cells(tmp_path), "--config",
                      write_config(tmp_path)])


@pytest.mark.parametrize("args", [[], ["--l-max", "4", "--n-max", "3"]])
def test_bessel_zeros_prints_jax_table(monkeypatch, capsys, args):
    monkeypatch.setattr(sys, "argv", ["prog", *args])
    jax_bessel_zeros.main()
    want = capsys.readouterr().out
    bessel_zeros.main(args)
    assert capsys.readouterr().out == want
