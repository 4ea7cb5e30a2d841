"""The port's device prefetch (``train/prefetch.py``) on the CPU: the
producer runs ``to_torch`` (host checks, the kernel index) ahead of the
consumer; order and values are kept, ``size=0`` passes batches through, a
producer error re-raises, an abandoned consumer frees the producer thread
(the put of every item retries against the stop flag), and training with
and without prefetch gives bitwise equal weights. The CUDA-stream path runs
on the card in ``chip_smoke.py``."""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data import BucketSpec, GraphBatch, batch_iterator, to_torch
from torch_m3gnet_tpu_torch.models import build_model
from torch_m3gnet_tpu_torch.train import Trainer
from torch_m3gnet_tpu_torch.train.prefetch import device_prefetch

from test_torch_dataset import both_graphs
from test_torch_run import cu_structures

INDEX = ("edge_src_offsets", "triplet_e1_offsets", "triplet_e2_order", "triplet_e2_offsets")


@pytest.fixture(scope="module")
def host_batches():
    _, graphs = both_graphs(cu_structures(10, seed=12))
    bucket = BucketSpec.for_batches(graphs, 3, pad_multiple=32)
    return list(batch_iterator(graphs, 3, bucket, np.random.default_rng(0)))


def test_order_values_and_index(host_batches):
    out = list(device_prefetch(iter(host_batches), size=2, device="cpu", index=INDEX))
    assert len(out) == len(host_batches) == 4
    for got, b in zip(out, host_batches):
        want = to_torch(b, "cpu", index=INDEX)
        assert got.num_graphs_real == b.num_graphs_real
        for f in dataclasses.fields(GraphBatch):
            a, w = getattr(got, f.name), getattr(want, f.name)
            assert (a is None) == (w is None), f.name
            if isinstance(w, torch.Tensor):
                assert a.dtype == w.dtype and torch.equal(a, w), f.name
        assert got.triplet_e2_order is not None


def test_zero_size_passes_through(host_batches):
    out = list(device_prefetch(iter(host_batches), size=0))
    assert all(a is b for a, b in zip(out, host_batches))


def test_default_device_is_the_card(host_batches, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_prefetch(iter(host_batches)))


def test_producer_error_reraises(host_batches):
    def batches():
        yield host_batches[0]
        yield host_batches[1].replace(edge_src=host_batches[1].edge_src[::-1].copy())

    it = device_prefetch(batches(), size=2, device="cpu")
    next(it)
    with pytest.raises(ValueError, match="edge_src must be sorted"):
        next(it)


def test_abandoned_consumer_frees_the_producer(host_batches):
    """The step fails after one batch of an endless stream: the producer,
    blocked on a full queue, ends within 1 s once the consumer is gone."""
    def endless():
        while True:
            yield from host_batches

    baseline = threading.active_count()
    for finish in ("close", "drop", "raise"):
        it = device_prefetch(endless(), size=1, device="cpu")
        try:
            for _ in it:
                time.sleep(0.2)  # the producer fills the queue and blocks
                assert threading.active_count() == baseline + 1
                if finish == "raise":
                    raise RuntimeError("the step failed")
                break
        except RuntimeError:
            pass
        if finish == "close":
            it.close()
        del it
        deadline = time.monotonic() + 1.0
        while threading.active_count() > baseline and time.monotonic() < deadline:
            time.sleep(0.01)
        assert threading.active_count() == baseline, finish


@pytest.mark.parametrize("mode", ["factorized", "fused"])
def test_trainer_prefetch_is_bitwise_equal(host_batches, tmp_path, mode):
    """One epoch with ``prefetch=2`` and with ``prefetch=0``: bitwise equal
    weights, metrics rows and evaluation."""
    cfg = M3GNetConfig(l_max=2, n_max=2, embedding_dim=8, num_blocks=1, cutoff=4.0,
                       threebody_cutoff=3.0, threebody_mode=mode, learning_rate=5e-3)
    results = []
    for prefetch in (0, 2):
        pot = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        trainer = Trainer(pot, cfg, log_dir=str(tmp_path / f"logs{prefetch}"), prefetch=prefetch)
        trainer.fit(lambda epoch: iter(host_batches), lambda: iter(host_batches[:2]),
                    max_epochs=1)
        results.append((pot.state_dict(), trainer.evaluate(iter(host_batches))))
    (w0, m0), (w2, m2) = results
    assert m0 == m2
    for k in w0:
        assert torch.equal(w0[k], w2[k]), k
    rows = [(tmp_path / f"logs{p}" / "metrics.jsonl").read_text().splitlines() for p in (0, 2)]
    strip = [{k: v for k, v in json.loads(r[0]).items() if k != "time"} for r in rows]
    assert strip[0] == strip[1]
