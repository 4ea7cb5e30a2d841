"""Data-parallel training over the ranks of a ``dp`` mesh.

Counterpart of ``torch_m3gnet_tpu.parallel.dp``. Each rank holds one
self-contained padded batch (graphs are never split here), computes the
single-device loss and its gradient on it, and one all-reduce of a flat
buffer combines the gradients and the metrics with each rank's weight
``w / w_total``, ``w`` its count of real graphs (as JAX's ``psum`` of
``g * w / w_total``): a rank left fully padded by a short tail batch adds
nothing and dilutes nothing. DDP is not used: it averages uniformly, which
is not this weighting, and its reducer would have to sit beside the
``create_graph=True`` force gradient inside the loss.

A stacked batch (``shard_stack``, ``data.dataset.stack_global_batch``)
carries one row per rank along a leading axis; a rank may pass the whole
stack or build only its own row (``sharded_batch_iterator(..., rank=r)``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from torch_m3gnet_tpu_torch.data.graph import STATIC_FIELDS, GraphBatch, stack_rows
from torch_m3gnet_tpu_torch.parallel.distributed import host_local_to_global
from torch_m3gnet_tpu_torch.train.loop import Trainer, loss_and_metrics


def shard_stack(shards: Sequence[GraphBatch]) -> GraphBatch:
    """Stack identically padded batches along a new leading axis; every row
    carries the total count of real graphs."""
    first = shards[0]
    for s in shards[1:]:
        if (s.num_nodes, s.num_edges, s.num_triplets, s.num_graphs) != (
                first.num_nodes, first.num_edges, first.num_triplets, first.num_graphs):
            raise ValueError("all shards must share identical padded sizes")
    return stack_rows(shards, num_graphs_real=sum(s.num_graphs_real for s in shards))


def unshard(stacked: GraphBatch) -> GraphBatch:
    """Concatenate the leading device axis back (host-side convenience)."""
    return dataclasses.replace(stacked, **{
        f.name: np.concatenate(np.asarray(getattr(stacked, f.name)), axis=0)
        for f in dataclasses.fields(stacked)
        if f.name not in STATIC_FIELDS and getattr(stacked, f.name) is not None})


def broadcast_parameters(module: torch.nn.Module) -> None:
    """Every rank takes rank 0's weights."""
    for p in module.parameters():
        dist.broadcast(p.data, 0)


class ParallelTrainer(Trainer):
    """A :class:`~torch_m3gnet_tpu_torch.train.loop.Trainer` that runs on
    every rank of ``mesh`` with the same weights (rank 0's at construction)
    and the same updates: rank 0 alone writes the logs and checkpoints, and
    every rank waits until a checkpoint is written. Subclasses supply
    ``train_step``, ``eval_step`` and ``local`` (this rank's row of a
    batch)."""

    def __init__(self, potential, config, mesh, **trainer_kw):
        super().__init__(potential, config, **trainer_kw)
        self.mesh = mesh
        broadcast_parameters(potential)

    @property
    def is_writer(self) -> bool:
        return dist.get_rank() == 0

    def local(self, batch):
        raise NotImplementedError

    def _prefetched(self, batches):
        return super()._prefetched(self.local(b) for b in batches)

    def save_checkpoint(self, ckpt_dir: str, tag: str = "last") -> str:
        path = (super().save_checkpoint(ckpt_dir, tag) if self.is_writer
                else os.path.abspath(os.path.join(ckpt_dir, tag)))
        dist.barrier()
        return path


class DataParallel(ParallelTrainer):
    """Data-parallel train and eval steps of a potential over the ``axis``
    ranks of ``mesh``, with the single-device Trainer's loss, Adam,
    accumulation, epoch loop and checkpoints."""

    def __init__(self, potential, config, mesh, axis: str = "dp", **trainer_kw):
        super().__init__(potential, config, mesh, **trainer_kw)
        self.axis = axis
        self.group = mesh.get_group(axis)

    def local(self, batch):
        if batch.positions.ndim == 2:
            return batch
        return host_local_to_global(self.mesh, batch, self.axis)

    def _combine(self, shard, grads, metrics):
        """``sum over ranks of x * w / w_total`` of every gradient and
        metric, in one all-reduce."""
        keys = list(metrics)
        flat = torch.cat([g.reshape(-1) for g in grads] + [torch.stack([metrics[k] for k in keys])])
        # The weight in float32 whatever the weights' dtype, as JAX forms it.
        w = torch.as_tensor(shard.graph_mask, device=flat.device).sum().to(torch.float32)
        w_total = w.clone()
        dist.all_reduce(w_total, group=self.group)
        flat = flat * (w / torch.clamp(w_total, min=1.0)).to(flat.dtype)
        dist.all_reduce(flat, group=self.group)
        out = list(flat.split([g.numel() for g in grads] + [len(keys)]))
        grads = [o.view_as(g) for o, g in zip(out, grads)]
        return grads, dict(zip(keys, out[-1].unbind()))

    def train_step(self, batch, lr=None) -> dict[str, torch.Tensor]:
        if lr is not None:
            self.set_lr(lr)
        shard = self.local(batch)
        loss, metrics = loss_and_metrics(self.potential, shard, self.config, create_graph=True)
        grads, metrics = self._combine(shard, self.gradients(loss),
                                       {k: v.detach() for k, v in metrics.items()})
        self.apply_gradients(grads)
        return metrics

    def eval_step(self, batch) -> dict[str, torch.Tensor]:
        shard = self.local(batch)
        with torch.no_grad():
            _, metrics = loss_and_metrics(self.potential, shard, self.config, create_graph=False)
        return self._combine(shard, [], metrics)[1]
