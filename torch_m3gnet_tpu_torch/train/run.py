"""Training from graphs to a trained potential: ``train_model``.

Own copy of ``torch_m3gnet_tpu.train.run``: seed -> split ->
elemental-energy fit -> model -> the epoch loop with early stopping and
checkpoints -> test metrics. The batches of each epoch come in the JAX
package's order (the same ``numpy`` draws), so with the same weights the
two packages train the same way.

With ``config.num_devices = N > 1`` it runs data-parallel on the N ranks of
the process group (``torchrun --nproc-per-node N``, or
``parallel.launch``), one per card: every rank calls it with the same
arguments, builds only its own row of each global batch of
``batch_size`` graphs (``batch_size / N`` a rank) and steps
``parallel.dp.DataParallel``; rank 0 writes the logs and checkpoints.
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
    sharded_batch_iterator,
    split_dataset,
)
from torch_m3gnet_tpu_torch.data.graph import GraphBatch
from torch_m3gnet_tpu_torch.data.streaming import (
    fit_elemental_energies_streaming,
    ladder_from_index,
    stream_batches,
    stream_ladder_batches,
    stream_ladder_sharded_batches,
    stream_sharded_batches,
)
from torch_m3gnet_tpu_torch.models import build_model
from torch_m3gnet_tpu_torch.models.m3gnet import resolve_device
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

    ``config.num_devices > 1`` needs that many ranks in the process group
    (it raises otherwise, and when ``batch_size`` does not divide among
    them); ``device`` then is each rank's card (``cuda:LOCAL_RANK``)
    unless it names one, which the ranks then share.
    """
    mesh = _dp_mesh(config, device) if config.num_devices > 1 else None
    if mesh is not None:
        from torch_m3gnet_tpu_torch.parallel.mesh import local_device

        device = local_device(mesh)
    if hasattr(train_graphs, "iter_graphs"):
        return _train_model_streaming(config, train_graphs, val_graphs, test_graphs,
                                      resume_checkpoint, max_epochs, device, dtype, params, mesh)
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
    trainer = _trainer(config, elemental, scale, device, dtype, params, mesh)
    all_for_bucket = list(train_graphs) + list(val_graphs or []) + list(test_graphs or [])
    rng = np.random.default_rng(config.seed)

    if mesh is not None:  # as in JAX, one bucket of batch_size / N graphs
        n_dev, rank = config.num_devices, mesh.get_local_rank("dp")
        per_dev = config.batch_size // n_dev
        bucket = BucketSpec.for_batches(all_for_bucket, per_dev, config.pad_multiple)

        def batches(graphs, rng=None):
            return sharded_batch_iterator(graphs, per_dev, n_dev, bucket, rng=rng, rank=rank)

        def train_batches(epoch: int):
            return batches(train_graphs, rng)

        def val_batches():
            return batches(val_graphs)
    elif config.bucket_classes > 1:
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
        test_metrics = trainer.evaluate(
            batches(test_graphs) if mesh is not None
            else batch_iterator(test_graphs, config.batch_size, bucket))
    return trainer, state, test_metrics


def _train_model_streaming(config, train_ds, val_ds, test_ds, resume_checkpoint, max_epochs,
                           device, dtype, params, mesh) -> tuple[Trainer, TrainState, dict]:
    """The streaming branch of :func:`train_model`: every split a
    StreamingGraphDataset (or None); one bucket, the elementwise max of the
    splits' worst cases, or a ladder per split from its index, both of
    ``batch_size / num_devices`` graphs.

    With a ``dp`` mesh every rank streams the whole split and keeps its own
    row of each global batch, so that a rank trains on row ``rank`` of the
    single-process run's batches (JAX's, whose metrics the port's match):
    N ranks read and decode every shard N times. A rank that read only its
    stride of the shards (``HostShardView``) would read 1/N of them, in a
    different batch order."""
    n_dev = max(1, config.num_devices)
    per_dev = config.batch_size // n_dev
    rank = None if mesh is None else mesh.get_local_rank("dp")
    splits = [d for d in (train_ds, val_ds, test_ds) if d is not None]
    per_split = [d.bucket(per_dev, config.pad_multiple) for d in splits]
    bucket = BucketSpec(
        max_nodes=max(b.max_nodes for b in per_split),
        max_edges=max(b.max_edges for b in per_split),
        max_triplets=max(b.max_triplets for b in per_split),
        max_graphs=per_dev,
    )
    elemental, scale = fit_elemental_energies_streaming(train_ds)
    trainer = _trainer(config, elemental, scale, device, dtype, params, mesh)
    rng = np.random.default_rng(config.seed)

    if config.bucket_classes > 1:
        ladders = {id(d): ladder_from_index(d, per_dev, config.bucket_classes,
                                            config.pad_multiple) for d in splits}
        if mesh is None:
            def batches(ds, rng=None):
                return stream_ladder_batches(ds, config.batch_size, ladders[id(ds)], rng=rng)
        else:
            def batches(ds, rng=None):
                return stream_ladder_sharded_batches(ds, per_dev, n_dev, ladders[id(ds)],
                                                     rng=rng, rank=rank)
    elif mesh is None:
        def batches(ds, rng=None):
            return stream_batches(ds, config.batch_size, bucket, rng=rng)
    else:
        def batches(ds, rng=None):
            return stream_sharded_batches(ds, per_dev, n_dev, bucket, rng=rng, rank=rank)

    state = _fit(trainer, config, lambda epoch: batches(train_ds, rng),
                 (lambda: batches(val_ds)) if val_ds is not None else None,
                 resume_checkpoint, max_epochs)
    test_metrics = trainer.evaluate(batches(test_ds)) if test_ds is not None else {}
    return trainer, state, test_metrics


def _dp_mesh(config, device):
    """The ``dp`` mesh over the process group's ranks, one per device."""
    import torch.distributed as dist

    from torch_m3gnet_tpu_torch.parallel.mesh import make_mesh

    n_dev = config.num_devices
    if config.batch_size % n_dev != 0:
        raise ValueError(
            f"batch_size ({config.batch_size}) must be divisible by "
            f"num_devices ({n_dev}) — a silent rewrite would change the "
            "global batch and the optimization dynamics"
        )
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_dev:
        raise ValueError(f"num_devices={n_dev} needs a process group of {n_dev} ranks "
                         f"(torchrun --nproc-per-node {n_dev}); this one has {world}")
    device = resolve_device(device)
    return make_mesh(n_dev, "dp", device.type, device if device.index is not None else None)


def _trainer(config, elemental, scale, device, dtype, params, mesh=None) -> Trainer:
    pot = build_model(config, elemental_energies=list(map(float, elemental)),
                      energy_scale=scale, device=device,
                      generator=torch.Generator().manual_seed(config.seed))
    if dtype is not None:
        pot = pot.to(dtype)
    if params is not None:
        pot.model.load_state_dict(params)
    log_dir = os.path.join(config.root, "logs")
    if mesh is None:
        return Trainer(pot, config, log_dir=log_dir)
    from torch_m3gnet_tpu_torch.parallel.dp import DataParallel

    return DataParallel(pot, config, mesh, log_dir=log_dir)


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
