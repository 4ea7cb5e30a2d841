"""The port's data parallelism against the JAX package's, at float64 on the
CPU: three ``DataParallel`` steps on two ranks (the third a short tail
batch that leaves rank 1 fully padded), and ``train_model`` with
``num_devices=2`` in memory and streaming (one bucket, a two-class ladder);
then the training CLI with ``--mesh 2`` under torchrun.

JAX runs on two devices of the 8-device virtual CPU mesh; the port on two
gloo ranks spawned once for the file (``tests/_torch_parallel_ranks.py``),
while the pytest process runs JAX's side. Each rank builds or takes only
its own row of every global batch. Both sides start from JAX's initial
weights, cast to float64 (JAX's ``DataParallel.init_state`` is patched in
the test to cast them), and both log parameter norms. Data and settings
are ``test_torch_run.py``'s, at batch 4 (2 graphs a rank).

JAX's ``DataParallel`` is built here with ``jax.shard_map(...,
check_vma=False)``. Under JAX 0.9's default the replicated weights are
typed invariant across the mesh, so ``jax.grad`` inside its step already
sums the shards' gradients, and its explicit weighted ``psum`` then gives
the plain sum over shards: S times the weighted mean on full batches
(ROADMAP.md, section C). With the check off its step computes the weighted
mean that its code and docstring describe, which the port computes; the
metrics are the same either way.

Tolerance: rtol 1e-8, atol 1e-12, as ``test_torch_run.py``.
"""

import functools
import glob
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_m3gnet_tpu.data import streaming as jax_streaming
from torch_m3gnet_tpu.data.dataset import BucketSpec as JaxBucketSpec
from torch_m3gnet_tpu.data.dataset import sharded_batch_iterator as jax_sharded
from torch_m3gnet_tpu.data.graph import graph_from_structure as jax_graph
from torch_m3gnet_tpu.models import build_model as jax_build
from torch_m3gnet_tpu.parallel import dp as jax_dp
from torch_m3gnet_tpu.train import loop as jax_loop
from torch_m3gnet_tpu.train import run as jax_run
from torch_m3gnet_tpu.train.loop import TrainState as JaxTrainState
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data.dataset import BucketSpec, sharded_batch_iterator
from torch_m3gnet_tpu_torch.models import build_model, params_from_flax
from torch_m3gnet_tpu_torch.parallel import launch
from torch_m3gnet_tpu_torch.train import Trainer, loss_and_metrics

from test_torch_run import CUTOFF, CUTOFF3, SETTINGS, configs, cu_structures, graphs_f64

RTOL, ATOL = 1e-8, 1e-12
DP = {**SETTINGS, "batch_size": 4, "num_devices": 2}
STEP_LR = 5e-3
MLEARN = "tests/fixtures/synthetic_mlearn_Cu"


def f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def port_tree(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(jax.tree.map(np.asarray, tree)).items()}


def assert_tree(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL, err_msg=name)


def jax_dp_as_written(mp: pytest.MonkeyPatch) -> None:
    """Build JAX's DataParallel steps with ``check_vma=False`` (above)."""
    mp.setattr(jax, "shard_map", functools.partial(jax.shard_map, check_vma=False))


def step_batches():
    """Three global batches of 2 x 2 graphs (JAX stacks, port stacks): two
    full ones, then a tail of one graph, which leaves rank 1 empty."""
    jgraphs, graphs = graphs_f64(cu_structures(9, seed=4))
    jb = JaxBucketSpec.for_batches(jgraphs, 2, 32)
    b = BucketSpec(jb.max_nodes, jb.max_edges, jb.max_triplets, jb.max_graphs)
    return list(jax_sharded(jgraphs, 2, 2, jb)), list(sharded_batch_iterator(graphs, 2, 2, b))


def streaming_splits(tmp_path, shard_size=4):
    """JAX-written float64 shard caches of three splits, and the port's
    handles on them ``(cache, name, shard_size, count)``."""
    structs = cu_structures(17, seed=2)
    cache = str(tmp_path / "cache")
    splits = {"train": structs[:11], "val": structs[11:14], "test": structs[14:]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_streaming, "graph_from_structure",
                   functools.partial(jax_graph, dtype=np.float64))
        jds = [jax_streaming.StreamingGraphDataset(s, CUTOFF, CUTOFF3, cache_dir=cache,
                                                   name=n, shard_size=shard_size)
               for n, s in splits.items()]
    return jds, [(cache, n, shard_size, len(s)) for n, s in splits.items()]


def cli_config(tmp_path) -> str:
    path = tmp_path / "mesh.yaml"
    path.write_text("l_max: 2\nn_max: 2\nembedding_dim: 8\nnum_blocks: 1\ncutoff: 4.0\n"
                    "threebody_cutoff: 3.0\npad_multiple: 32\nbatch_size: 8\n"
                    "stress_weight: 0.0\nmax_epochs: 1\n")
    return str(path)


def torchrun_cli(tmp_path) -> subprocess.CompletedProcess:
    """``train_mlearn --mesh 2`` on two CPU ranks under torchrun, each
    rank's output in its own file under ``tmp_path/torchrun``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "--log-dir", str(tmp_path / "torchrun"), "--redirects", "3", "-m",
           "torch_m3gnet_tpu_torch.cli.train_mlearn", "--mesh", "2", "--device", "cpu",
           "--path", MLEARN, "--config", cli_config(tmp_path), "--root", str(tmp_path / "cli")]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    jsteps, steps = step_batches()
    jcfg_mem, cfg_mem = configs(tmp, "mem", **DP)
    jcfg_str, _ = configs(tmp, "stream", **DP)
    jcfg_lad, _ = configs(tmp, "ladder", **DP, bucket_classes=2)
    jgraphs, graphs = graphs_f64(cu_structures(14))
    jds, port_ds = streaming_splits(tmp)
    # JAX's initial weights depend on the seed and the shapes only
    pot = jax_build(jcfg_mem)
    params = f64(jax.jit(pot.init)(jax.random.PRNGKey(0),
                                   jax.tree.map(lambda x: np.asarray(x)[0], jsteps[0])))
    state = port_tree(params)
    port_runs = {
        "memory": (DP, str(tmp / "port_mem"), (graphs[:8], graphs[8:11], graphs[11:]), state),
        "stream": (DP, str(tmp / "port_stream"), port_ds, state),
        "ladder": ({**DP, "bucket_classes": 2}, str(tmp / "port_ladder"), port_ds, state),
    }
    with ThreadPoolExecutor(3) as pool:
        job_steps = pool.submit(launch.run, "tests._torch_parallel_ranks:dp_steps", 2,
                                SETTINGS, state, steps, STEP_LR, timeout_s=600)
        job_train = pool.submit(launch.run, "tests._torch_parallel_ranks:dp_train_model", 2,
                                port_runs, timeout_s=900)
        job_cli = pool.submit(torchrun_cli, tmp)

        with pytest.MonkeyPatch.context() as mp:
            jax_dp_as_written(mp)
            dp = jax_dp.DataParallel(pot, jcfg_mem, Mesh(np.array(jax.devices("cpu")[:2]),
                                                         ("dp",)))
        jstate = JaxTrainState(params=params, opt_state=dp.opt.init(params))
        want_steps = dict(metrics=[], params=[])
        for stacked in jsteps:
            jstate, m = dp.train_step(jstate, stacked, STEP_LR)
            want_steps["metrics"].append({k: float(v) for k, v in m.items()})
            want_steps["params"].append(port_tree(jstate.params))
        want_steps["eval"] = {k: float(v) for k, v in dp.eval_step(jstate.params,
                                                                   jsteps[-1]).items()}
        inits = []
        with pytest.MonkeyPatch.context() as mp:
            def init_state(self, rng, example):
                p = f64(jax.jit(self.potential.init)(rng, jax.tree.map(
                    lambda x: np.asarray(x)[0], example)))
                inits.append(port_tree(p))
                return JaxTrainState(params=p, opt_state=self.opt.init(p))

            mp.setattr(jax_dp.DataParallel, "init_state", init_state)
            jax_dp_as_written(mp)
            mp.setattr(jax_run, "Trainer", functools.partial(jax_loop.Trainer,
                                                             log_param_stats=True))
            want_train = {
                "memory": jax_run.train_model(jcfg_mem, jgraphs[:8], jgraphs[8:11],
                                              jgraphs[11:]),
                "stream": jax_run.train_model(jcfg_str, *jds),
                "ladder": jax_run.train_model(jcfg_lad, *jds),
            }
        got = dict(steps=job_steps.result(), train=job_train.result(), cli=job_cli.result())
    return dict(got=got, want_steps=want_steps, want_train=want_train, inits=inits,
                state=state, steps=steps, tmp=tmp)


@pytest.mark.parametrize("step", [0, 1, 2], ids=["full", "full-2", "tail"])
def test_dp_steps_match_jax(runs, step):
    """One ``DataParallel.train_step``: the weighted metrics and the weights
    after it, on both ranks, against JAX's on two devices."""
    want_m, want_p = runs["want_steps"]["metrics"][step], runs["want_steps"]["params"][step]
    for rank in runs["got"]["steps"]:
        assert set(rank["metrics"][step]) == set(want_m)
        for k, w in want_m.items():
            np.testing.assert_allclose(rank["metrics"][step][k], w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        assert_tree(rank["params"][step], want_p)


def test_dp_eval_step_matches_jax(runs):
    for rank in runs["got"]["steps"]:
        for k, w in runs["want_steps"]["eval"].items():
            np.testing.assert_allclose(rank["eval"][k], w, rtol=RTOL, atol=ATOL, err_msg=k)


def test_dp_tail_shard_does_not_dilute(runs):
    """The tail step (one real graph on rank 0, rank 1 fully padded): its
    metrics are the single-device metrics of that one graph, not half of
    them, which an unweighted mean over the ranks would give."""
    got = runs["got"]["steps"][0]
    pot = build_model(M3GNetConfig(**SETTINGS), device="cpu").double()
    pot.model.load_state_dict({k: torch.as_tensor(v) for k, v in got["params"][1].items()})
    tail = runs["steps"][2].row(0)
    _, single = loss_and_metrics(pot, tail, M3GNetConfig(**SETTINGS))
    for k, v in single.items():
        np.testing.assert_allclose(got["metrics"][2][k], float(v.detach()), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert abs(got["metrics"][2]["loss"] - float(single["loss"].detach()) / 2) > 0.1 * float(
        single["loss"].detach())


@pytest.mark.parametrize("name", ["memory", "stream", "ladder"])
def test_train_model_dp_matches_jax(runs, name):
    """``train_model`` with ``num_devices=2``: every value of every
    ``metrics.jsonl`` row (the weighted train and val metrics, the
    parameter norms) written once, by rank 0; the final weights and the
    test metrics on both ranks, against JAX's on two devices."""
    _, jstate, jtest = runs["want_train"][name]
    rows_want = [json.loads(x) for x in open(runs["tmp"] / f"jax_{name.replace('memory', 'mem')}"
                                             / "logs" / "metrics.jsonl")]
    for init in runs["inits"]:
        assert_tree(init, runs["state"])
    for rank in runs["got"]["train"]:
        got = rank[name]
        assert got["epoch"] == int(jstate.epoch) == 2 and got["step"] == int(jstate.step)
        assert_tree(got["params"], port_tree(jstate.params))
        assert set(got["test"]) == set(jtest)
        for k, w in jtest.items():
            np.testing.assert_allclose(got["test"][k], w, rtol=RTOL, atol=ATOL, err_msg=k)
        assert len(got["rows"]) == len(rows_want) == 2
        for g, w in zip(got["rows"], rows_want):
            assert set(g) == set(w) and any(k.startswith("param_norm/") for k in g)
            for k in w:
                if k != "time":
                    np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_cli_mesh_under_torchrun(runs):
    """``torchrun --standalone --nproc-per-node 2 -m ...cli.train_mlearn
    --mesh 2``: both ranks print the same test metrics, one
    ``metrics.jsonl`` row per epoch, and rank 0's checkpoint loads."""
    proc = runs["got"]["cli"]
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    outs = sorted(glob.glob(str(runs["tmp"] / "torchrun" / "**" / "stdout.log"), recursive=True))
    assert len(outs) == 2
    printed = [json.loads(open(p).read())["test"] for p in outs]
    assert printed[0] == printed[1] and np.isfinite(printed[0]["loss"])
    root = runs["tmp"] / "cli"
    assert len(open(root / "logs" / "metrics.jsonl").read().splitlines()) == 1
    params = Trainer.load_params(str(root / "checkpoints" / "last"))
    assert Trainer.load_meta(str(root / "checkpoints" / "last"))["epoch"] == 1
    pot = build_model(M3GNetConfig(l_max=2, n_max=2, embedding_dim=8, num_blocks=1, cutoff=4.0,
                                   threebody_cutoff=3.0), device="cpu")
    pot.load_state_dict(params)
