"""The port's ``train_model`` against the JAX package's, at float64 on the
CPU: its in-memory branches (one bucket, the ``BucketLadder``), the split
by ratios, and a resumed run. ``test_torch_run_streaming.py`` holds the
streaming branches with the helpers of this file.

Both sides start from the same weights: JAX's ``Trainer.init_state`` is
patched in the test to cast its initial parameters to float64 (and to
re-initialise the optimizer on them), and those parameters go to the port
through ``params_from_flax``. Both sides log parameter norms
(``log_param_stats=True``, patched into each package's ``Trainer`` for the
test). The graphs are built in float64 on both sides, so the model computes
in float64 throughout. Nothing of the JAX package changes.

Tolerance: final weights rtol 1e-8 / atol 1e-12, every ``metrics.jsonl``
value but ``time`` and the test metrics rtol 1e-8, as for the three Adam
steps of ``test_torch_train_loop.py``: two epochs are 4-8 Adam steps, and
the two packages part by ~1e-13 relative (JAX's gather mode on its CPU,
the port's factorized mode; the same function at float64).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.config import M3GNetConfig as JaxConfig
from torch_m3gnet_tpu.data import streaming as jax_streaming
from torch_m3gnet_tpu.data.graph import graph_from_structure as jax_graph
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.train import loop as jax_loop
from torch_m3gnet_tpu.train import run as jax_run
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data import Structure, graph_from_structure
from torch_m3gnet_tpu_torch.models import params_from_flax
from torch_m3gnet_tpu_torch.train import loop, run

jax.config.update("jax_enable_x64", True)

CUTOFF, CUTOFF3 = 4.0, 3.0
SETTINGS = dict(l_max=2, n_max=2, embedding_dim=8, num_blocks=1, cutoff=CUTOFF,
                threebody_cutoff=CUTOFF3, batch_size=3, pad_multiple=32, learning_rate=5e-3,
                decay_steps=4, early_stopping_patience=100, max_epochs=2)
RTOL, ATOL = 1e-8, 1e-12


def cu_structures(n, seed=0, with_targets=True):
    """Perturbed, strained fcc-Cu cells of 4, 8 and 16 atoms (JAX
    structures), with seeded E/F/S targets."""
    rng = np.random.default_rng(seed)
    base = JaxStructure.from_frac_coords(
        np.eye(3) * 3.62, [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], [29] * 4)
    out = []
    for i in range(n):
        cell = base.supercell(((1, 1, 1), (2, 1, 1), (2, 2, 1))[i % 3])
        s = JaxStructure(cell.lattice * (1 + 0.01 * rng.standard_normal()),
                         cell.cart_coords + 0.05 * rng.standard_normal(cell.cart_coords.shape),
                         cell.atomic_numbers)
        if with_targets:
            s.properties.update(energy=float(-3.5 * len(s) + 0.1 * rng.standard_normal()),
                                forces=0.2 * rng.standard_normal((len(s), 3)),
                                stress=0.01 * rng.standard_normal(6))
        out.append(s)
    return out


def as_port(s: JaxStructure) -> Structure:
    return Structure(s.lattice, s.cart_coords, s.atomic_numbers, dict(s.properties))


def graphs_f64(structs):
    """(JAX graphs, port graphs) of ``structs``, float64."""
    return ([jax_graph(s, CUTOFF, CUTOFF3, dtype=np.float64) for s in structs],
            [graph_from_structure(as_port(s), CUTOFF, CUTOFF3, dtype=np.float64)
             for s in structs])


@pytest.fixture
def f64_runs(monkeypatch):
    """Patch both packages for a float64 comparison; returns the dict where
    JAX's initial parameters land."""
    captured = {}

    def init_state(self, rng, example):
        # jitted: Flax's init op by op takes ~10 s on the CPU
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              jax.jit(self.potential.init)(rng, example))
        captured["params"] = params
        return jax_loop.TrainState(params=params, opt_state=self.opt.init(params))

    monkeypatch.setattr(jax_loop.Trainer, "init_state", init_state)
    monkeypatch.setattr(jax_run, "Trainer",
                        functools.partial(jax_loop.Trainer, log_param_stats=True))
    monkeypatch.setattr(run, "Trainer", functools.partial(loop.Trainer, log_param_stats=True))
    # Streams built by either package hold float64 graphs.
    monkeypatch.setattr(jax_streaming, "graph_from_structure",
                        functools.partial(jax_graph, dtype=np.float64))
    return captured


def port_params(captured):
    return params_from_flax(jax.tree.map(np.asarray, captured["params"]), dtype=torch.float64)


def assert_weights_match(trainer, jax_state):
    want = params_from_flax(jax.tree.map(np.asarray, jax_state.params), dtype=torch.float64)
    got = trainer.potential.model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def read_rows(root):
    return [json.loads(line) for line in (root / "logs" / "metrics.jsonl").read_text().splitlines()]


def assert_rows_match(got_root, want_root):
    got, want = read_rows(got_root), read_rows(want_root)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w), set(g) ^ set(w)
        assert any(k.startswith("param_norm/params/") for k in g)
        for k in w:
            if k != "time":
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL, err_msg=k)


def assert_metrics_match(got, want):
    assert set(got) == set(want) and want
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def configs(tmp_path, tag, **kw):
    kw = {**SETTINGS, **kw}
    return (JaxConfig(root=str(tmp_path / f"jax_{tag}"), **kw),
            M3GNetConfig(root=str(tmp_path / f"port_{tag}"), **kw))


@pytest.mark.parametrize("bucket_classes", [1, 2], ids=["one-bucket", "ladder"])
def test_in_memory_matches_jax(tmp_path, f64_runs, bucket_classes):
    """Given val and test sets: the batch order of every epoch (the example
    draw before fit included), the losses, the parameter norms, the final
    weights and the test metrics."""
    jgraphs, graphs = graphs_f64(cu_structures(14))
    jcfg, cfg = configs(tmp_path, "mem", bucket_classes=bucket_classes)
    _, jstate, jtest = jax_run.train_model(jcfg, jgraphs[:8], jgraphs[8:11], jgraphs[11:])
    trainer, state, test = run.train_model(cfg, graphs[:8], graphs[8:11], graphs[11:],
                                           device="cpu", dtype=torch.float64,
                                           params=port_params(f64_runs))
    assert state.epoch == int(jstate.epoch) == 2 and state.step == int(jstate.step)
    assert_weights_match(trainer, jstate)
    assert_rows_match(tmp_path / "port_mem", tmp_path / "jax_mem")
    assert_metrics_match(test, jtest)
    assert (tmp_path / "port_mem" / "checkpoints" / "last.meta.json").exists()


def test_split_and_resume_match_jax(tmp_path, f64_runs):
    """No val or test set given: the ``val_ratio``/``test_ratio`` split of
    ``split_dataset``; then a run resumed from ``last`` for a third epoch
    against JAX's resumed run."""
    jgraphs, graphs = graphs_f64(cu_structures(15, seed=1))
    jcfg, cfg = configs(tmp_path, "split", val_ratio=0.2, test_ratio=0.2)
    _, jstate, jtest = jax_run.train_model(jcfg, jgraphs)
    trainer, state, test = run.train_model(cfg, graphs, device="cpu", dtype=torch.float64,
                                           params=port_params(f64_runs))
    assert_weights_match(trainer, jstate)
    assert_metrics_match(test, jtest)

    ckpt = str(tmp_path / "port_split" / "checkpoints")
    jckpt = str(tmp_path / "jax_split" / "checkpoints")
    _, jstate, jtest = jax_run.train_model(jcfg, jgraphs, resume_checkpoint=jckpt, max_epochs=3)
    # The resumed port run starts from other weights, which ``last`` replaces.
    trainer, state, test = run.train_model(cfg, graphs, device="cpu", dtype=torch.float64,
                                           resume_checkpoint=ckpt, max_epochs=3)
    assert state.epoch == int(jstate.epoch) == 3 and state.step == int(jstate.step)
    assert_weights_match(trainer, jstate)
    assert_rows_match(tmp_path / "port_split", tmp_path / "jax_split")
    assert_metrics_match(test, jtest)


def test_more_than_one_device_raises(tmp_path):
    """``num_devices=2`` with no process group of two ranks raises rather
    than train on one (``test_torch_parallel_dp.py`` runs it on two)."""
    _, graphs = graphs_f64(cu_structures(3))
    cfg = M3GNetConfig(root=str(tmp_path), num_devices=2, **{**SETTINGS, "batch_size": 4})
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        run.train_model(cfg, graphs, device="cpu")

