"""Training from graphs to a trained potential: ``train_model``.

Own copy of ``torch_m3gnet_tpu.train.run`` for one device: seed -> split
-> elemental-energy fit -> model -> the epoch loop with early stopping and
checkpoints -> test metrics. The batches of each epoch come in the JAX
package's order (the same ``numpy`` draws), so with the same weights the
two packages train the same way.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data.dataset import (
    BucketLadder,
    BucketSpec,
    batch_iterator,
    ladder_batch_iterator,
    split_dataset,
)
from torch_m3gnet_tpu_torch.data.graph import GraphBatch
from torch_m3gnet_tpu_torch.data.streaming import (
    fit_elemental_energies_streaming,
    ladder_from_index,
    stream_batches,
    stream_ladder_batches,
)
from torch_m3gnet_tpu_torch.models import build_model
from torch_m3gnet_tpu_torch.train.elemental import fit_elemental_energies
from torch_m3gnet_tpu_torch.train.loop import Trainer, TrainState


def train_model(
    config: M3GNetConfig,
    train_graphs: Sequence[GraphBatch],
    val_graphs: Optional[Sequence[GraphBatch]] = None,
    test_graphs: Optional[Sequence[GraphBatch]] = None,
    resume_checkpoint: Optional[str] = None,
    max_epochs: Optional[int] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
    params: Optional[dict] = None,
) -> tuple[Trainer, TrainState, dict]:
    """Train a potential; returns (trainer, final state, test metrics).

    The splits are in-memory graph sequences or
    :class:`~torch_m3gnet_tpu_torch.data.streaming.StreamingGraphDataset` s
    (bounded memory, shard-level shuffling). Without ``val_graphs`` the
    graphs are split by ``config.val_ratio`` (and ``config.test_ratio``
    unless ``test_graphs`` is given). ``config.bucket_classes > 1`` pads by
    size class (``BucketLadder``) instead of one worst-case bucket.

    ``device`` defaults to the card; ``dtype`` casts the model (e.g.
    ``torch.float64``). The weights come from
    ``torch.Generator().manual_seed(config.seed)``, or from ``params``, a
    ``state_dict`` of the model (``potential.model``), e.g. from
    ``models.params_from_flax``. ``resume_checkpoint`` is a checkpoint
    directory whose ``last`` state training continues from.
    """
    if config.num_devices > 1:
        raise NotImplementedError(
            "num_devices > 1 (the data-parallel step) comes with the port's parallel slice"
        )
    if hasattr(train_graphs, "iter_graphs"):
        return _train_model_streaming(config, train_graphs, val_graphs, test_graphs,
                                      resume_checkpoint, max_epochs, device, dtype, params)
    if val_graphs is None:
        # Split a test set out too (config.test_ratio) unless one is given.
        test_ratio = 0.0 if test_graphs is not None else config.test_ratio
        tr_idx, va_idx, te_idx = split_dataset(
            len(train_graphs), config.val_ratio, test_ratio, config.seed
        )
        all_graphs = list(train_graphs)
        train_graphs = [all_graphs[i] for i in tr_idx]
        val_graphs = [all_graphs[i] for i in va_idx]
        if test_graphs is None and len(te_idx):
            test_graphs = [all_graphs[i] for i in te_idx]

    elemental, scale = fit_elemental_energies(train_graphs, config.num_types)
    trainer = _trainer(config, elemental, scale, device, dtype, params)
    all_for_bucket = list(train_graphs) + list(val_graphs or []) + list(test_graphs or [])
    rng = np.random.default_rng(config.seed)

    if config.bucket_classes > 1:
        ladder = BucketLadder.build(all_for_bucket, config.batch_size, config.bucket_classes,
                                    config.pad_multiple)
        n_train, n_val = len(train_graphs), len(val_graphs or [])
        tr_ladder = BucketLadder(ladder.buckets, ladder.assignments[:n_train])
        va_ladder = BucketLadder(ladder.buckets, ladder.assignments[n_train : n_train + n_val])
        bucket = ladder.buckets[-1]

        def train_batches(epoch: int):
            return ladder_batch_iterator(train_graphs, config.batch_size, tr_ladder, rng=rng)

        def val_batches():
            return ladder_batch_iterator(val_graphs, config.batch_size, va_ladder)
    else:
        bucket = BucketSpec.for_batches(all_for_bucket, config.batch_size, config.pad_multiple)

        def train_batches(epoch: int):
            return batch_iterator(train_graphs, config.batch_size, bucket, rng=rng)

        def val_batches():
            return batch_iterator(val_graphs, config.batch_size, bucket)

    state = _fit(trainer, config, train_batches, val_batches if val_graphs else None,
                 resume_checkpoint, max_epochs)
    test_metrics: dict = {}
    if test_graphs:
        # One worst-case bucket (the largest class's under a ladder), as in JAX.
        test_metrics = trainer.evaluate(batch_iterator(test_graphs, config.batch_size, bucket))
    return trainer, state, test_metrics


def _train_model_streaming(config, train_ds, val_ds, test_ds, resume_checkpoint, max_epochs,
                           device, dtype, params) -> tuple[Trainer, TrainState, dict]:
    """The streaming branch of :func:`train_model`: every split a
    StreamingGraphDataset (or None); one bucket, the elementwise max of the
    splits' worst cases, or a ladder per split from its index."""
    splits = [d for d in (train_ds, val_ds, test_ds) if d is not None]
    per_split = [d.bucket(config.batch_size, config.pad_multiple) for d in splits]
    bucket = BucketSpec(
        max_nodes=max(b.max_nodes for b in per_split),
        max_edges=max(b.max_edges for b in per_split),
        max_triplets=max(b.max_triplets for b in per_split),
        max_graphs=config.batch_size,
    )
    elemental, scale = fit_elemental_energies_streaming(train_ds)
    trainer = _trainer(config, elemental, scale, device, dtype, params)
    rng = np.random.default_rng(config.seed)

    if config.bucket_classes > 1:
        ladders = {id(d): ladder_from_index(d, config.batch_size, config.bucket_classes,
                                            config.pad_multiple) for d in splits}

        def batches(ds, rng=None):
            return stream_ladder_batches(ds, config.batch_size, ladders[id(ds)], rng=rng)
    else:
        def batches(ds, rng=None):
            return stream_batches(ds, config.batch_size, bucket, rng=rng)

    state = _fit(trainer, config, lambda epoch: batches(train_ds, rng),
                 (lambda: batches(val_ds)) if val_ds is not None else None,
                 resume_checkpoint, max_epochs)
    test_metrics = trainer.evaluate(batches(test_ds)) if test_ds is not None else {}
    return trainer, state, test_metrics


def _trainer(config, elemental, scale, device, dtype, params) -> Trainer:
    pot = build_model(config, elemental_energies=list(map(float, elemental)),
                      energy_scale=scale, device=device,
                      generator=torch.Generator().manual_seed(config.seed))
    if dtype is not None:
        pot = pot.to(dtype)
    if params is not None:
        pot.model.load_state_dict(params)
    return Trainer(pot, config, log_dir=os.path.join(config.root, "logs"))


def _fit(trainer, config, train_batches, val_batches, resume_checkpoint, max_epochs):
    # JAX draws an example batch before fit to initialise its parameters,
    # which consumes one draw of ``rng`` (a shuffle, or a class's
    # permutation); draw it the same way, so every epoch sees JAX's order.
    example = train_batches(0)
    next(example)
    example.close()
    if resume_checkpoint:
        trainer.restore_checkpoint(resume_checkpoint, tag="last")
    return trainer.fit(train_batches, val_batches, max_epochs=max_epochs,
                       checkpoint_dir=os.path.join(config.root, "checkpoints"))
