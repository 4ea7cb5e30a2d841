"""The port's graph-parallel training against the JAX package's, at float64
on the CPU: the gp loss with forces and stress and every weight gradient
(the double backward crosses the halo exchange twice), the dp x gp loss on
a 2 x 2 mesh, and ``GraphParallelTrainer`` steps: gp in two modes, and
dp x gp on the 2 x 2 mesh.

JAX runs on the 8-device virtual CPU mesh (4 devices, and a 2 x 2 mesh);
the port on four gloo ranks spawned once for the file, running
``tests/_torch_parallel_ranks.py:gp_train``. Set-up as in
``test_torch_parallel_gp.py``. The weights' gradient of the port's gp loss
is the mean over the ranks of their local gradients (``ops.halo``).

Tolerance: rtol 1e-8, each gradient with atol 1e-12 of its largest
magnitude (entries that cancel to ~0); the three Trainer steps' weights
rtol 1e-8, atol 1e-12, as ``test_torch_train_loop.py``'s Adam steps.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_m3gnet_tpu.config import M3GNetConfig as JaxConfig
from torch_m3gnet_tpu.parallel import graph_shard as jax_gs
from torch_m3gnet_tpu.train.loop import TrainState as JaxTrainState
from torch_m3gnet_tpu.train.loop import loss_and_metrics as jax_loss
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data.graph import pad_batch
from torch_m3gnet_tpu_torch.models import build_model, params_from_flax
from torch_m3gnet_tpu_torch.parallel import graph_shard, launch
from torch_m3gnet_tpu_torch.train import loss_and_metrics

from test_torch_parallel_gp import MODES, SETTINGS, cu_cell, graphs, jax_setup

RTOL, ATOL = 1e-8, 1e-12
STEPS = dict(n=3, lr=5e-3, config=dict(stress_weight=0.0, learning_rate=5e-3))


def with_targets(pair, seed, energy):
    rng = np.random.default_rng(seed)
    n = pair[0].num_nodes
    t = dict(energy=np.array([energy]), forces=0.1 * rng.standard_normal((n, 3)),
             stress=0.01 * rng.standard_normal((1, 6)))
    return tuple(g.replace(**t) for g in pair)


def port_tree(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(jax.tree.map(np.asarray, tree)).items()}


def assert_tree(got: dict, want: dict, rtol=RTOL):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=rtol,
                                   atol=ATOL * max(np.abs(w).max(), 1e-30), err_msg=name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jg, g = with_targets(graphs(cu_cell((3, 3, 2), 8, 0.05)), 6, -210.0)
    pairs = [with_targets(graphs(cu_cell((3, 3, 2), seed, 0.05)), seed, -150.0 - seed)
             for seed in (11, 12)]
    pot, params, single = jax_setup(jg)
    state = port_tree(params)
    sharded = graph_shard.partition_graph(g, 4)
    stack2d = graph_shard.stack_partitions([p[1] for p in pairs], 2)
    ckpt = str(tmp_path_factory.mktemp("gp_ckpt"))
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(launch.run, "tests._torch_parallel_ranks:gp_train", 4, SETTINGS,
                          state, MODES, sharded, stack2d, STEPS, ckpt, timeout_s=600)
        cfg = JaxConfig(**SETTINGS)
        mesh4 = Mesh(np.array(jax.devices("cpu")[:4]), ("gp",))
        mesh2d = Mesh(np.array(jax.devices("cpu")[:4]).reshape(2, 2), ("dp", "gp"))
        jsharded = jax_gs.partition_graph(jg, 4)
        loss_fn = jax_gs.GraphParallelPotential(pot.model, mesh4).make_loss(cfg)
        loss, grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jsharded)))(params)
        jstack = jax_gs.stack_partitions([p[0] for p in pairs], 2)
        loss2 = jax_gs.GraphParallelPotential(pot.model, mesh2d).make_loss(cfg, dp_axis="dp")
        loss2d, grads2d = jax.jit(jax.value_and_grad(lambda p: loss2(p, jstack)))(params)
        single_loss, single_grads = jax.jit(jax.value_and_grad(
            lambda p: jax_loss(pot, p, single, cfg)[0]))(params)
        tcfg = cfg.replace(**STEPS["config"])
        trainer = jax_gs.GraphParallelTrainer(pot, tcfg, mesh4)
        jstate = JaxTrainState(params=params, opt_state=trainer.opt.init(params))
        step_losses = []
        for _ in range(STEPS["n"]):
            jstate, m = trainer.train_step(jstate, jsharded, STEPS["lr"])
            step_losses.append(float(m["loss"]))
        trainer2d = jax_gs.GraphParallelTrainer(pot, tcfg, mesh2d, dp_axis="dp")
        jstate2d = JaxTrainState(params=params, opt_state=trainer2d.opt.init(params))
        step_losses2d = []
        for _ in range(STEPS["n"]):
            jstate2d, m = trainer2d.train_step(jstate2d, jstack, STEPS["lr"])
            step_losses2d.append(float(m["loss"]))
        want = dict(loss=float(loss), grads=port_tree(grads), loss2d=float(loss2d),
                    grads2d=port_tree(grads2d), single_loss=float(single_loss),
                    single_grads=port_tree(single_grads), step_losses=step_losses,
                    params=port_tree(jstate.params), step_losses2d=step_losses2d,
                    params2d=port_tree(jstate2d.params))
        ranks = job.result()
    return dict(ranks=ranks, want=want, state=state, g=g, ckpt=ckpt)


@pytest.mark.parametrize("mode", MODES)
def test_gp_loss_and_gradients_match_jax(runs, mode):
    """E/atom, force and stress terms summed over four shards; every weight
    gradient through the double backward of the halo exchange, against
    JAX's ``make_loss`` (gather mode; the port's modes compute the same
    function)."""
    got, want = runs["ranks"][0], runs["want"]
    np.testing.assert_allclose(got["loss"][mode], want["loss"], rtol=RTOL)
    assert_tree(got["grads"][mode], want["grads"])


def test_gp_loss_matches_single_device_loss(runs):
    """The gp loss and its gradient are the single-device loss's (the
    port's ``loss_and_metrics`` on the unpartitioned graph, and JAX's)."""
    g = runs["g"]
    pot = build_model(M3GNetConfig(**SETTINGS), device="cpu").double()
    pot.model.load_state_dict({k: torch.as_tensor(v) for k, v in runs["state"].items()})
    loss, _ = loss_and_metrics(pot, pad_batch(g, g.num_nodes, g.num_edges, g.num_triplets, 1),
                               M3GNetConfig(**SETTINGS))
    names, ws = zip(*pot.model.named_parameters())
    grads = dict(zip(names, (x.numpy() for x in torch.autograd.grad(loss, ws))))
    got = runs["ranks"][0]
    np.testing.assert_allclose(got["loss"]["factorized"], float(loss.detach()), rtol=RTOL)
    np.testing.assert_allclose(runs["want"]["single_loss"], float(loss.detach()), rtol=RTOL)
    assert_tree(got["grads"]["factorized"], grads)


def test_dp_gp_loss_matches_jax_mesh2d(runs):
    """Two graphs, each on two gp shards, on a 2 x 2 (dp, gp) mesh: the
    dp mean of the gp losses and its gradient, against JAX's ``mesh2d``."""
    got, want = runs["ranks"][0], runs["want"]
    np.testing.assert_allclose(got["loss2d"], want["loss2d"], rtol=RTOL)
    assert_tree(got["grads2d"], want["grads2d"])


def test_gp_trainer_steps_match_jax(runs):
    """Three ``GraphParallelTrainer`` steps (Adam, lr 5e-3): each step's
    loss and the weights after them, against JAX's trainer."""
    got, want = runs["ranks"][0], runs["want"]
    np.testing.assert_allclose(got["step_losses"], want["step_losses"], rtol=RTOL)
    for name, w in want["params"].items():
        np.testing.assert_allclose(got["params"][name], w, rtol=RTOL, atol=ATOL, err_msg=name)


def assert_steps(got: dict, losses, params):
    np.testing.assert_allclose(got["step_losses"], losses, rtol=RTOL)
    for name, w in params.items():
        np.testing.assert_allclose(got["params"][name], w, rtol=RTOL, atol=ATOL, err_msg=name)


def test_gp_fused_trainer_steps_match_jax(runs):
    """The same three steps in the fused mode (B4-B7's double backward
    through the halo exchange) against the same JAX steps: the modes
    compute one function."""
    assert_steps(runs["ranks"][0]["fused_steps"], runs["want"]["step_losses"],
                 runs["want"]["params"])


def test_dp_gp_trainer_steps_match_jax_mesh2d(runs):
    """Three ``GraphParallelTrainer(..., dp_axis="dp")`` steps on the 2 x 2
    (dp, gp) mesh, one graph a dp row (factorized mode): each step's loss
    and the weights after them, against JAX's trainer on its ``mesh2d``."""
    assert_steps(runs["ranks"][0]["dp_gp_steps"], runs["want"]["step_losses2d"],
                 runs["want"]["params2d"])


def test_gp_weights_and_losses_equal_across_ranks(runs):
    """Every rank holds the same loss, the same mean gradient and, after
    the steps, bitwise the same weights."""
    r0 = runs["ranks"][0]
    for r in runs["ranks"]:
        for steps in (r, r["fused_steps"], r["dp_gp_steps"]):
            assert steps["params_equal_across_ranks"]
        assert r["loss"] == r0["loss"] and r["step_losses"] == r0["step_losses"]
        assert r["dp_gp_steps"]["step_losses"] == r0["dp_gp_steps"]["step_losses"]
        for mode in MODES:
            for name, g in r0["grads"][mode].items():
                np.testing.assert_array_equal(r["grads"][mode][name], g)


def test_gp_trainer_checkpoint_round_trip(runs):
    """Rank 0 alone writes the checkpoint; a fresh trainer restored from it
    on every rank evaluates the loss as the live one does."""
    assert runs["ranks"][0]["files"] == ["last", "last.meta.json"]
    for r in runs["ranks"]:
        assert r["eval_restored"] == r["eval_live"] == runs["ranks"][0]["eval_live"]
