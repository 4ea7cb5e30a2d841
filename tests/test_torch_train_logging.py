"""The Trainer's optional logging: TensorBoard scalars and histograms
(``log_tensorboard``; TensorBoard is imported only then) and per-weight
norms in ``metrics.jsonl`` (``log_param_stats``) under the JAX package's
key names, which ``test_torch_run.py`` holds key by key to JAX's rows."""

import os

import pytest

from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data import BucketSpec, batch_iterator
from torch_m3gnet_tpu_torch.models import build_model
from torch_m3gnet_tpu_torch.train import loop

from test_torch_run import SETTINGS, cu_structures, graphs_f64, read_rows


def test_tensorboard_and_parameter_norms(tmp_path):
    """``log_tensorboard`` writes an event file beside ``metrics.jsonl``;
    ``log_param_stats`` adds one ``param_norm/params/...`` value per weight,
    the norm of that weight."""
    _, graphs = graphs_f64(cu_structures(6))
    cfg = M3GNetConfig(root=str(tmp_path), **SETTINGS)
    pot = build_model(cfg, device="cpu")
    trainer = loop.Trainer(pot, cfg, log_tensorboard=True, log_param_stats=True)
    bucket = BucketSpec.for_batches(graphs, 3, pad_multiple=32)
    trainer.fit(lambda epoch: batch_iterator(graphs, 3, bucket), max_epochs=1)
    assert any(f.startswith("events.out.tfevents") and (tmp_path / "logs" / f).stat().st_size
               for f in os.listdir(tmp_path / "logs"))
    (row,) = read_rows(tmp_path)
    norms = {k: v for k, v in row.items() if k.startswith("param_norm/")}
    weights = dict(pot.model.named_parameters())
    assert len(norms) == len(weights) > 0
    for name, w in weights.items():
        assert norms["param_norm/params/" + name.replace(".", "/")] == pytest.approx(
            float(w.detach().norm()), rel=1e-12)
