"""The port's training loop (torch_m3gnet_tpu_torch.train, data.dataset)
against the JAX package's: Adam steps with and without gradient
accumulation, the cosine schedule, metric accumulation, the elemental fit,
the dataset split and batch streams; and, inside the port, checkpoints and
a short fit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.config import M3GNetConfig as JaxConfig
from torch_m3gnet_tpu.data import dataset as jax_dataset
from torch_m3gnet_tpu.data.graph import graph_from_structure as jax_graph
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.models import build_model as jax_build_model
from torch_m3gnet_tpu.train import Trainer as JaxTrainer
from torch_m3gnet_tpu.train import fit_elemental_energies as jax_fit_elemental
from torch_m3gnet_tpu.train.loop import TrainState as JaxTrainState
from torch_m3gnet_tpu.train.loop import cosine_annealing_lr as jax_cosine
from torch_m3gnet_tpu.train.metrics import MetricAccumulator as JaxAccumulator
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data import (
    BucketSpec,
    GraphBatch,
    Structure,
    batch_iterator,
    graph_from_structure,
    split_dataset,
)
from torch_m3gnet_tpu_torch.data.graph import BATCH_INDEX_FIELDS
from torch_m3gnet_tpu_torch.models import build_model, params_from_flax
from torch_m3gnet_tpu_torch.train import MetricAccumulator, Trainer, fit_elemental_energies
from torch_m3gnet_tpu_torch.train.loop import cosine_annealing_lr

from test_torch_train import METRICS, SMALL, target_batch

jax.config.update("jax_enable_x64", True)


def fcc_set(n, seed=0):
    """Perturbed, slightly strained 4-atom fcc-Cu cells (JAX structures)."""
    rng = np.random.default_rng(seed)
    base = JaxStructure.from_frac_coords(
        np.eye(3) * 3.62, [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], [29] * 4)
    return [JaxStructure(base.lattice * (1 + 0.02 * rng.standard_normal()),
                         base.cart_coords + 0.08 * rng.standard_normal((4, 3)),
                         base.atomic_numbers) for _ in range(n)]


def port_graphs(structs, cutoff=4.5, threebody_cutoff=4.0):
    return [graph_from_structure(Structure(s.lattice, s.cart_coords, s.atomic_numbers),
                                 cutoff, threebody_cutoff) for s in structs]


def teacher_graphs(graphs, cfg, seed=1):
    """Each graph labelled with the E/F/S of a port teacher (seed ``seed``)."""
    pot = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    out = []
    for g in graphs:
        o = pot(next(batch_iterator([g], 1, BucketSpec.for_batches([g], 1, pad_multiple=32))))
        n = g.num_nodes
        out.append(g.replace(energy=o.energy[:1].detach().numpy(),
                             forces=o.forces[:n].detach().numpy(),
                             stress=o.stress[:1].detach().numpy()))
    return out


@pytest.mark.parametrize("mode, accumulate",
                         [("factorized", 1), ("factorized", 2), ("gather", 1)])
def test_train_steps_match_jax_trainer_f64(al_fcc, tio2_rutile, mode, accumulate):
    """Three train steps from the same weights, f64: per-step metrics and
    the final weights against the JAX Trainer (Adam eps=1e-7; with
    accumulation, optax.MultiSteps), rtol 1e-8. The gather mode adds the
    triplet->edge sorted sum to the double backward."""
    batch = target_batch([al_fcc, tio2_rutile], np.float64)
    kw = dict(SMALL, accumulate_grad_batches=accumulate, learning_rate=2e-3)
    jcfg = JaxConfig(threebody_mode=mode, **({"layout": "fm"} if mode == "factorized" else {}),
                     **kw)
    jpot = jax_build_model(jcfg)
    jtrainer = JaxTrainer(jpot, jcfg, log_dir="unused")
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jpot.init(jax.random.PRNGKey(0), batch))
    state = JaxTrainState(params=params, opt_state=jtrainer.opt.init(params))

    cfg = M3GNetConfig(threebody_mode=mode, **kw)
    pot = build_model(cfg, device="cpu").double()
    pot.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params),
                                               dtype=torch.float64))
    trainer = Trainer(pot, cfg, log_dir="unused")
    initial = {k: v.clone() for k, v in pot.state_dict().items()}
    for step, lr in enumerate((2e-3, 2e-3, 1e-3)):
        state, want = jtrainer.train_step(state, batch, jnp.asarray(lr))
        got = trainer.train_step(batch, lr)
        for k in METRICS:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-8,
                                       err_msg=f"step {step} {k}")
    assert trainer.step == int(state.step) == 3
    want_params = params_from_flax(jax.tree.map(np.asarray, state.params), dtype=torch.float64)
    moved = 0
    for name, w in want_params.items():
        got = pot.state_dict()[f"model.{name}"]
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-8, atol=1e-12, err_msg=name)
        # unused embedding rows (zero gradient) stay exactly where they were
        if name == "atom_embed.embedding":
            unused = torch.ones(got.shape[0], dtype=torch.bool)
            unused[torch.as_tensor(np.unique(batch.atom_types))] = False
            assert torch.equal(got[unused], initial[f"model.{name}"][unused])
        moved += int(not torch.equal(got, initial[f"model.{name}"]))
    assert moved == len(want_params)


def test_cosine_schedule_matches_jax():
    for epoch in range(0, 260, 13):
        assert cosine_annealing_lr(epoch, 1e-3, 200, 1e-2) == jax_cosine(epoch, 1e-3, 200, 1e-2)
    assert cosine_annealing_lr(200, 1e-3, 200, 1e-2) == pytest.approx(1e-5)


def test_metric_accumulator_matches_jax():
    got, want = MetricAccumulator(), JaxAccumulator()
    for acc in (got, want):
        acc.update({"loss": 1.0, "mae": 0.5}, weight=3)
        acc.update({"loss": 5.0}, weight=1)
    assert got.compute() == want.compute()
    assert got.compute()["loss"] == pytest.approx(2.0)
    got.reset()
    assert got.compute() == {}


def test_elemental_fit_matches_jax():
    rng = np.random.default_rng(0)
    structs = fcc_set(6)
    jgraphs = [jax_graph(s, 4.0, 3.0) for s in structs]
    energies = rng.normal(-15.0, 0.3, len(structs)).astype(np.float32)
    jgraphs = [g.replace(energy=np.array([e])) for g, e in zip(jgraphs, energies)]
    graphs = [g.replace(energy=np.array([e])) for g, e in
              zip(port_graphs(structs, 4.0, 3.0), energies)]
    got_e, got_s = fit_elemental_energies(graphs, 95)
    want_e, want_s = jax_fit_elemental(jgraphs, 95)
    np.testing.assert_allclose(got_e, want_e, rtol=1e-12, atol=1e-12)
    assert got_s == pytest.approx(want_s, rel=1e-12)
    with pytest.raises(ValueError, match="energy targets"):
        fit_elemental_energies([graphs[0].replace(energy=None)], 95)


def test_split_bucket_and_batches_match_jax():
    for args in ((100, 0.1, 0.2, 1), (7, 0.3, 0.0, 5)):
        for got, want in zip(split_dataset(*args), jax_dataset.split_dataset(*args)):
            np.testing.assert_array_equal(got, want)
    structs = fcc_set(5)
    graphs = port_graphs(structs)
    jgraphs = [jax_graph(s, 4.5, 4.0) for s in structs]
    bucket = BucketSpec.for_batches(graphs, 2, pad_multiple=32)
    jbucket = jax_dataset.BucketSpec.for_batches(jgraphs, 2, pad_multiple=32)
    assert dataclasses.asdict(bucket) == dataclasses.asdict(jbucket)
    got = list(batch_iterator(graphs, 2, bucket, np.random.default_rng(3)))
    want = list(jax_dataset.batch_iterator(jgraphs, 2, jbucket, np.random.default_rng(3)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.num_graphs_real == w.num_graphs_real
        for f in dataclasses.fields(GraphBatch):
            a = getattr(g, f.name)
            if f.name in BATCH_INDEX_FIELDS + ("edge_reverse",):  # the port's own, not asked for
                assert a is None, f.name
                continue
            b = getattr(w, f.name)
            if b is None or isinstance(b, int):
                assert a == b, f.name
            else:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
    assert len(list(batch_iterator(graphs, 2, bucket, drop_last=True))) == 2


CONFIG = M3GNetConfig(l_max=2, n_max=2, embedding_dim=8, num_blocks=1, batch_size=2,
                      learning_rate=5e-3, decay_steps=100, early_stopping_patience=1000)


def test_checkpoint_round_trip_and_predict_rebuild(tmp_path):
    """save/restore of the training state (torch.save), the meta sidecar,
    and a predict-time rebuild from config + sidecar + params alone."""
    graphs = teacher_graphs(port_graphs(fcc_set(2), 4.0, 3.0), CONFIG)
    bucket = BucketSpec.for_batches(graphs, 2, pad_multiple=32)
    batch = next(batch_iterator(graphs, 2, bucket))
    elemental = [0.0] * CONFIG.num_types
    elemental[28] = -3.7
    pot = build_model(CONFIG, elemental_energies=elemental, energy_scale=1.9, device="cpu")
    trainer = Trainer(pot, CONFIG, log_dir=str(tmp_path))
    trainer.train_step(batch, 1e-3)
    path = trainer.save_checkpoint(str(tmp_path / "ckpt"), tag="best")
    want = pot(batch)
    saved = trainer.state()
    trainer.train_step(batch, 1e-3)  # move away, then restore

    restored = trainer.restore_checkpoint(str(tmp_path / "ckpt"), tag="best")
    assert restored.step == trainer.step == 1
    for k, v in saved.params.items():
        assert torch.equal(pot.state_dict()[k], v), k
    opt = trainer.optimizer.state_dict()["state"]
    for i, st in saved.opt_state["optimizer"]["state"].items():
        assert torch.equal(opt[i]["exp_avg"], st["exp_avg"])

    meta = Trainer.load_meta(path)
    assert meta["energy_scale"] == pytest.approx(1.9) and meta["step"] == 1
    assert meta["elemental_energies"][28] == pytest.approx(-3.7)
    assert json.loads((tmp_path / "ckpt" / "best.meta.json").read_text()) == meta
    pot2 = build_model(CONFIG, elemental_energies=meta["elemental_energies"],
                       energy_scale=meta["energy_scale"], device="cpu")
    pot2.load_state_dict(Trainer.load_params(path))
    got = pot2(batch)
    for name in ("energy", "forces", "stress"):
        np.testing.assert_array_equal(getattr(got, name).detach().numpy(),
                                      getattr(want, name).detach().numpy(), err_msg=name)
    assert Trainer.load_meta(str(tmp_path / "missing")) is None


def test_fit_overfits_and_logs(tmp_path):
    """A short fit on one batch of teacher-labelled cells: the loss falls, metrics
    rows carry the JAX loop's keys, best and last checkpoints exist."""
    graphs = teacher_graphs(port_graphs(fcc_set(4)), CONFIG)
    pot = build_model(CONFIG, device="cpu")
    trainer = Trainer(pot, CONFIG, log_dir=str(tmp_path / "logs"))
    bucket = BucketSpec.for_batches(graphs, 4, pad_multiple=32)
    batches = lambda epoch: batch_iterator(graphs, 4, bucket)  # noqa: E731
    m0 = trainer.evaluate(batches(0))
    state = trainer.fit(batches, val_batches=lambda: batches(0), max_epochs=30,
                        checkpoint_dir=str(tmp_path / "ckpt"))
    m1 = trainer.evaluate(batches(0))
    assert m1["loss"] < 0.2 * m0["loss"], (m0["loss"], m1["loss"])
    assert state.epoch == trainer.epoch == 30 and state.step == 30
    rows = [json.loads(line) for line in (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 30
    assert set(rows[0]) == {"epoch", "lr", "time", *(f"train_{k}" for k in METRICS),
                            *(f"val_{k}" for k in METRICS)}
    assert rows[1]["lr"] == cosine_annealing_lr(1, 5e-3, 100, 1e-2)
    assert (tmp_path / "ckpt" / "best").exists() and (tmp_path / "ckpt" / "last").exists()
