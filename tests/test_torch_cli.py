"""The port's training CLIs (``cli/train_mlearn.py``, ``cli/train_mpf.py``)
against the JAX package's on the same files, on the CPU (``--device cpu``):
the printed test metrics, the ``metrics.jsonl`` logs, the checkpoints'
``last.meta.json`` and the caches; the MPF CLI streaming and
``--in-memory``; ``--resume``; ``--mesh 2`` raises outside torchrun.

Both sides start from JAX's initial weights (the port's ``Trainer`` is
patched in the test to load them) and compute in float32, as the CLIs do:
JAX's gather mode on its CPU against the port's factorized mode, with sums
in other orders. Tolerance on every logged and printed value: rtol 1e-4,
with atol 1e-6 for the energy terms, whose per-atom energies (~3.5 eV,
where a float32 ulp is 2.4e-7) carry a few ulps of rounding against an
energy RMSE of ~4e-4 eV/atom. Adam spreads float32 rounding into the
weights at each step; the bound leaves room for the summation orders.
"""

import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest

from torch_m3gnet_tpu.cli import train_mlearn as jax_mlearn
from torch_m3gnet_tpu.cli import train_mpf as jax_mpf
from torch_m3gnet_tpu.train import loop as jax_loop
from torch_m3gnet_tpu_torch.cli import predict, train_mlearn, train_mpf
from torch_m3gnet_tpu_torch.models import params_from_flax
from torch_m3gnet_tpu_torch.train import loop, run

from chip_smoke import cif_of
from test_torch_run import cu_structures

RTOL, ATOL = 1e-4, 1e-6
MLEARN = "tests/fixtures/synthetic_mlearn_Cu"
SETTINGS = """# small widths for the CPU; the training settings of configs/{name}.yaml
l_max: 2
n_max: 2
embedding_dim: 8
num_blocks: 1
cutoff: 4.0
threebody_cutoff: 3.0
pad_multiple: 32
batch_size: 8
accumulate_grad_batches: {accumulate}
stress_weight: 0.0
{extra}"""


@pytest.fixture
def shared_weights(monkeypatch):
    """JAX's initial parameters (jitted init: Flax's op-by-op init takes
    ~10 s on the CPU), loaded into the port's model before training."""
    captured = {}

    def init_state(self, rng, example):
        params = jax.jit(self.potential.init)(rng, example)
        captured["params"] = params
        return jax_loop.TrainState(params=params, opt_state=self.opt.init(params))

    def trainer(pot, config, **kw):
        pot.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                                captured["params"])))
        return loop.Trainer(pot, config, **kw)

    monkeypatch.setattr(jax_loop.Trainer, "init_state", init_state)
    monkeypatch.setattr(run, "Trainer", trainer)
    return captured


def run_both(monkeypatch, capsys, jax_main, port_main, args, tmp_path):
    """Both CLIs on ``args``, each with its own root; returns the printed
    (port, JAX) test metrics."""
    monkeypatch.setattr(sys, "argv", ["prog", *args, "--root", str(tmp_path / "jax")])
    jax_main()
    want = json.loads(capsys.readouterr().out)["test"]
    port_main([*args, "--root", str(tmp_path / "port"), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)["test"]
    return got, want


def assert_close(got, want):
    assert set(got) == set(want) and want
    for k in want:
        if k != "time":
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def assert_runs_match(tmp_path, got, want):
    assert_close(got, want)
    rows = [[json.loads(line) for line in (tmp_path / side / "logs" / "metrics.jsonl")
             .read_text().splitlines()] for side in ("port", "jax")]
    assert len(rows[0]) == len(rows[1]) > 0
    for g, w in zip(*rows):
        assert_close(g, w)
    metas = [json.loads((tmp_path / side / "checkpoints" / "last.meta.json").read_text())
             for side in ("port", "jax")]
    assert metas[0]["epoch"] == metas[1]["epoch"] and metas[0]["step"] == metas[1]["step"]
    np.testing.assert_allclose(metas[0]["elemental_energies"], metas[1]["elemental_energies"],
                               rtol=1e-12, atol=1e-12)
    assert metas[0]["energy_scale"] == pytest.approx(metas[1]["energy_scale"], rel=1e-12)
    assert (tmp_path / "port" / "checkpoints" / "best").exists()


def write_config(tmp_path, name, accumulate, extra=""):
    path = tmp_path / f"{name}.yaml"
    path.write_text(SETTINGS.format(name=name, accumulate=accumulate, extra=extra))
    return str(path)


def test_train_mlearn_matches_jax(tmp_path, monkeypatch, capsys, shared_weights):
    cfg = write_config(tmp_path, "mlearn_Cu", 2, "test_ratio: 0.0\n")
    args = ["--path", MLEARN, "--config", cfg, "--max-epochs", "2"]
    got, want = run_both(monkeypatch, capsys, jax_mlearn.main, train_mlearn.main, args, tmp_path)
    assert_runs_match(tmp_path, got, want)
    for side, prefix, ext in (("port", "torch_graphs_", ".npz"), ("jax", "graphs_", ".pkl")):
        names = sorted(os.listdir(tmp_path / side / "cache"))
        assert [n.split("_")[-2] for n in names] == ["test", "train"], names
        assert all(n.startswith(prefix) and n.endswith(ext) for n in names), names
    assert [n[-12:-4] for n in sorted(os.listdir(tmp_path / "port" / "cache"))] == \
        [n[-12:-4] for n in sorted(os.listdir(tmp_path / "jax" / "cache"))]  # one cache key

    # --resume: a third epoch from the last checkpoint
    train_mlearn.main([*args[:-1], "3", "--root", str(tmp_path / "port"), "--device", "cpu",
                       "--resume", str(tmp_path / "port" / "checkpoints")])
    capsys.readouterr()
    meta = json.loads((tmp_path / "port" / "checkpoints" / "last.meta.json").read_text())
    assert meta["epoch"] == 3
    lines = (tmp_path / "port" / "logs" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1, 2]


def write_mpf(path, n_ids=10, frames=3):
    """Block pickles of ``n_ids`` trajectories of ``frames`` perturbed Cu
    cells each, as CIF strings, with E/F and kbar stresses."""
    rng = np.random.default_rng(13)
    structs = cu_structures(n_ids * frames, seed=14)
    blocks = [{}, {}]
    for m in range(n_ids):
        traj = structs[m * frames : (m + 1) * frames]
        blocks[m % 2][f"mp-{100 + m}"] = {
            "structure": [cif_of(s) for s in traj],
            "energy": [s.properties["energy"] for s in traj],
            "force": [s.properties["forces"] for s in traj],
            "stress": [rng.normal(0, 10, (3, 3)) for _ in traj],
        }
    os.makedirs(path)
    for i, block in enumerate(blocks):
        with open(os.path.join(path, f"block_{i}_cif.p"), "wb") as f:
            pickle.dump(block, f)


@pytest.mark.parametrize("in_memory", [False, True], ids=["streaming", "in-memory"])
def test_train_mpf_matches_jax(tmp_path, monkeypatch, capsys, shared_weights, in_memory):
    write_mpf(tmp_path / "mpf")
    cfg = write_config(tmp_path, "mpf", 4, "val_ratio: 0.2\ntest_ratio: 0.2\n")
    args = ["--path", str(tmp_path / "mpf"), "--config", cfg, "--max-epochs", "1",
            "--shard-size", "4", *(["--in-memory"] if in_memory else [])]
    got, want = run_both(monkeypatch, capsys, jax_mpf.main, train_mpf.main, args, tmp_path)
    assert_runs_match(tmp_path, got, want)
    caches = [sorted(os.listdir(tmp_path / side / "cache")) for side in ("port", "jax")]
    if in_memory:
        assert caches[0] == ["torch_" + n.replace(".pkl", ".npz") for n in caches[1]]
    else:  # the same shard directories, file for file
        assert caches[0] == caches[1] and len(caches[0]) == 3
        for d in caches[0]:
            assert sorted(os.listdir(tmp_path / "port" / "cache" / d)) == \
                sorted(os.listdir(tmp_path / "jax" / "cache" / d))


def test_mesh_raises(tmp_path):
    """``--mesh 2`` outside torchrun (no process group, no WORLD_SIZE)
    raises rather than train on one rank."""
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        train_mlearn.main(["--path", MLEARN, "--config", write_config(tmp_path, "m", 1),
                           "--root", str(tmp_path / "r"), "--device", "cpu", "--mesh", "2"])


def test_bf16_config_trains_and_predicts(tmp_path, capsys):
    """A config with ``compute_dtype: bfloat16`` trains one step (one epoch
    of one batch) and predicts from its checkpoint on the CPU; the same
    checkpoint under the float32 config predicts energies within 1 % and
    not equal (the casts act)."""
    text = SETTINGS.format(name="bf16", accumulate=1, extra="compute_dtype: bfloat16\n")
    configs = {}
    for dtype in ("bfloat16", "float32"):
        configs[dtype] = tmp_path / f"{dtype}.yaml"
        configs[dtype].write_text(text.replace("batch_size: 8", "batch_size: 64")
                                  .replace("bfloat16", dtype))
    root = tmp_path / "bf16"
    train_mlearn.main(["--path", MLEARN, "--config", str(configs["bfloat16"]), "--max-epochs", "1",
                       "--root", str(root), "--device", "cpu"])
    test = json.loads(capsys.readouterr().out)["test"]
    assert all(np.isfinite(v) for v in test.values())
    assert json.loads((root / "checkpoints" / "last.meta.json").read_text())["step"] == 1
    energies = {}
    for dtype, cfg in configs.items():
        predict.main(["--structures", f"{MLEARN}/test.json", "--format", "mlearn", "--config",
                      str(cfg), "--checkpoint", str(root / "checkpoints" / "best"),
                      "--device", "cpu"])
        energies[dtype] = np.array([r["energy"] for r in json.loads(capsys.readouterr().out)])
    assert np.isfinite(energies["bfloat16"]).all() and len(energies["bfloat16"]) == 12
    np.testing.assert_allclose(energies["bfloat16"], energies["float32"], rtol=1e-2)
    assert not np.array_equal(energies["bfloat16"], energies["float32"])
