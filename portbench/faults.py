"""Faults planted in the program under the harness, to show that the check
sees them (the CPU tests) and to read how far each moves the compared
numbers (``calibrate.py`` on the card). Each is a context manager that
patches the port and restores it.

- ``answer_altered``: one answer of an E/F/S request altered where it is
  produced (the first atom's force reversed);
- ``state_unchanged``: a step that returns its state unchanged (an MD
  chunk returns the positions and velocities it started from; a train step
  leaves the weights and Adam's state as they were);
- ``half_batch``: a train step on half of the batch, the means taken over
  the rest (the second half's graphs and atoms masked out of the loss).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np


@contextlib.contextmanager
def patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def answer_altered():
    from torch_m3gnet_tpu_torch.models import m3gnet

    def make(orig):
        def forward(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            forces = out.forces.clone()
            forces[0] = -forces[0]
            return dataclasses.replace(out, forces=forces)
        return forward

    return patched(m3gnet.M3GNetPotential, "forward", make)


def state_unchanged(kind: str):
    if kind == "md":
        from torch_m3gnet_tpu_torch.simulate import md

        def make(orig):
            def inner(potential, batch, vel, *args, **kwargs):
                _, _, lat, logs = orig(potential, batch, vel, *args, **kwargs)
                return batch.positions, vel, lat, logs
            return inner

        return patched(md, "_md_inner", make)
    from torch_m3gnet_tpu_torch.train.loop import Trainer

    return patched(Trainer, "apply_gradients", lambda orig: lambda self, grads: None)


def half_batch():
    from torch_m3gnet_tpu_torch.train import loop

    def make(orig):
        def loss_and_metrics(potential, batch, config, create_graph=True):
            keep = np.arange(batch.num_graphs) < batch.num_graphs_real // 2
            graph_mask = np.asarray(batch.graph_mask) & keep
            node_mask = np.asarray(batch.node_mask) & graph_mask[np.asarray(batch.node_graph)]
            return orig(potential, batch.replace(graph_mask=graph_mask, node_mask=node_mask),
                        config, create_graph)
        return loss_and_metrics

    return patched(loop, "loss_and_metrics", make)


FAULTS = {"answer_altered": lambda kind: answer_altered(),
          "state_unchanged": state_unchanged,
          "half_batch": lambda kind: half_batch()}
