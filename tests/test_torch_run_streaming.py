"""The port's ``train_model`` against the JAX package's on its streaming
branches (one bucket, the ladder), at float64 on the CPU, with the set-up
and tolerances of ``test_torch_run.py``.
"""

import pytest
import torch

from torch_m3gnet_tpu.data import streaming as jax_streaming
from torch_m3gnet_tpu.train import run as jax_run
from torch_m3gnet_tpu_torch.data import streaming
from torch_m3gnet_tpu_torch.train import run

from test_torch_run import (  # noqa: F401  (f64_runs is a fixture)
    CUTOFF,
    CUTOFF3,
    assert_metrics_match,
    assert_rows_match,
    assert_weights_match,
    configs,
    cu_structures,
    f64_runs,
    port_params,
)


@pytest.mark.parametrize("bucket_classes", [1, 2], ids=["one-bucket", "ladder"])
def test_streaming_matches_jax(tmp_path, f64_runs, bucket_classes):
    """Streaming splits (the shards written by JAX, opened by the port):
    the shard and in-shard shuffles, the ladder's per-class buffers, the
    streaming elemental fit, the weights, logs and test metrics."""
    structs = cu_structures(17, seed=2)
    cache = str(tmp_path / "cache")
    splits = {"train": structs[:11], "val": structs[11:14], "test": structs[14:]}
    jds = {name: jax_streaming.StreamingGraphDataset(s, CUTOFF, CUTOFF3, cache_dir=cache,
                                                     name=name, shard_size=4)
           for name, s in splits.items()}
    ds = {name: streaming.StreamingGraphDataset(None, CUTOFF, CUTOFF3, cache_dir=cache,
                                                name=name, shard_size=4,
                                                expected_count=len(s))
          for name, s in splits.items()}
    assert ds["train"].dir == jds["train"].dir
    jcfg, cfg = configs(tmp_path, "stream", bucket_classes=bucket_classes)
    _, jstate, jtest = jax_run.train_model(jcfg, jds["train"], jds["val"], jds["test"])
    trainer, state, test = run.train_model(cfg, ds["train"], ds["val"], ds["test"],
                                           device="cpu", dtype=torch.float64,
                                           params=port_params(f64_runs))
    assert state.epoch == int(jstate.epoch) == 2 and state.step == int(jstate.step)
    assert_weights_match(trainer, jstate)
    assert_rows_match(tmp_path / "port_stream", tmp_path / "jax_stream")
    assert_metrics_match(test, jtest)
