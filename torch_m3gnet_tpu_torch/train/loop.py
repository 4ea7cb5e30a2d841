"""Training runtime: train and eval steps, the epoch loop, early stopping,
checkpoints, JSONL logging.

Counterpart of ``torch_m3gnet_tpu.train.loop``:

- loss = w_E MSE(E/atom) + w_F MSE(F) + w_S MSE(stress), masked means over
  padding that count components (a force row counts 3, a stress row 6);
- Adam(betas=(0.9, 0.999), eps=1e-7): the same update as optax's
  ``scale_by_adam(eps=1e-7)`` then ``scale(-lr)`` (both bias-corrected,
  eps outside the square root);
- ``accumulate_grad_batches = k > 1``: the running mean of k gradients
  (Welford, as ``optax.MultiSteps``) is applied once every k steps; the
  steps between leave the weights and Adam's moments alone;
- the per-epoch closed-form cosine schedule of torch's
  ``CosineAnnealingLR``, set on the optimizer's param groups;
- early stopping on ``val_loss`` with patience, best and last checkpoints
  (``torch.save``, with the ``.meta.json`` sidecar of the model constants);
- the epoch loops read their batches through ``train.prefetch`` (``prefetch``
  batches ahead; 0 turns it off); optional TensorBoard scalars and
  histograms, and per-tensor weight norms in ``metrics.jsonl`` under the
  JAX package's key names (``param_norm/params/atom_embed/embedding``).

A training step differentiates forces and stress, themselves a gradient:
the potential runs with ``create_graph=True`` and the loss's backward goes
through every kernel's VJP of a VJP.

The data- and graph-parallel trainers (``parallel.dp.DataParallel``,
``parallel.graph_shard.GraphParallelTrainer``) are Trainers whose
``train_step`` and ``eval_step`` combine the ranks' gradients and metrics
and pass the gradient to :meth:`Trainer.apply_gradients`; only their
writer rank (``is_writer``) writes logs and checkpoints.
"""

from __future__ import annotations

import copy
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data.graph import to_torch
from torch_m3gnet_tpu_torch.train.metrics import MetricAccumulator
from torch_m3gnet_tpu_torch.train.prefetch import device_prefetch


def masked_mse(pred, target, mask):
    """Mean over unmasked elements; ``mask`` broadcasts over trailing dims."""
    diff = (pred - target) ** 2 * mask
    denom = torch.clamp(mask.sum() * (pred.numel() / mask.numel()), min=1.0)
    return diff.sum() / denom


def masked_mae(pred, target, mask):
    diff = torch.abs(pred - target) * mask
    denom = torch.clamp(mask.sum() * (pred.numel() / mask.numel()), min=1.0)
    return diff.sum() / denom


def loss_and_metrics(potential, batch, config: M3GNetConfig, create_graph: bool = True):
    """Weighted E/F/S loss with per-element masked means, and the ten metrics
    (0-d tensors). ``create_graph=True`` keeps the graph of the forces and
    stress, so the loss differentiates to the weights."""
    param = next(potential.parameters())
    graph = to_torch(batch, param.device, param.dtype, index=())  # the potential builds its own
    out = potential(graph, create_graph=create_graph)
    dtype = out.energy.dtype
    gmask = graph.graph_mask.to(dtype)
    nmask = graph.node_mask.to(dtype)[:, None]

    n_node = torch.clamp(graph.n_node, min=1).to(dtype)
    target_epa = graph.energy / n_node
    pred_epa = out.energy / n_node
    e_loss = masked_mse(pred_epa, target_epa, gmask)
    e_mae = masked_mae(pred_epa, target_epa, gmask)

    zero = out.energy.new_zeros(())
    if graph.forces is not None:
        f_loss = masked_mse(out.forces, graph.forces, nmask)
        f_mae = masked_mae(out.forces, graph.forces, nmask)
    else:
        f_loss = f_mae = zero
    if graph.stress is not None:
        s_loss = masked_mse(out.stress, graph.stress, gmask[:, None])
        s_mae = masked_mae(out.stress, graph.stress, gmask[:, None])
    else:
        s_loss = s_mae = zero

    loss = (
        config.energy_weight * e_loss
        + config.force_weight * f_loss
        + config.stress_weight * s_loss
    )
    metrics = {
        "loss": loss,
        "energy_loss": e_loss,
        "forces_loss": f_loss,
        "stresses_loss": s_loss,
        "energy_rmse": torch.sqrt(e_loss),
        "forces_rmse": torch.sqrt(f_loss),
        "stresses_rmse": torch.sqrt(s_loss),
        "energy_mae": e_mae,
        "forces_mae": f_mae,
        "stresses_mae": s_mae,
    }
    return loss, metrics


def make_optimizer(params, config: M3GNetConfig) -> torch.optim.Adam:
    """Adam with eps=1e-7 at ``config.learning_rate`` (the schedule resets
    the rate per epoch)."""
    return torch.optim.Adam(params, lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-7)


def cosine_annealing_lr(epoch: int, lr: float, decay_steps: int, decay_alpha: float) -> float:
    """torch.optim.lr_scheduler.CosineAnnealingLR closed form (per epoch)."""
    eta_min = lr * decay_alpha
    return eta_min + (lr - eta_min) * (1 + math.cos(math.pi * epoch / decay_steps)) / 2


@dataclass
class TrainState:
    """A snapshot of training: the potential's ``state_dict``, the
    optimizer's (with the gradient-accumulation window), epoch and step."""

    params: dict[str, torch.Tensor]
    opt_state: dict[str, Any] = field(default_factory=dict)
    epoch: int = 0
    step: int = 0


class Trainer:
    """Epoch-based trainer of a potential over padded batch streams.

    The potential is trained in place; :meth:`state` takes a snapshot.
    Batches are host :class:`~torch_m3gnet_tpu_torch.data.GraphBatch` es
    (or ones already moved by ``to_torch``) with energy targets, and
    optionally forces and stress.
    """

    is_writer = True  # writes metrics.jsonl, TensorBoard and checkpoints

    def __init__(
        self,
        potential,
        config: M3GNetConfig,
        log_dir: Optional[str] = None,
        log_tensorboard: bool = False,
        log_param_stats: bool = False,
        prefetch: int = 2,
    ):
        self.potential = potential
        self.config = config
        self.log_dir = log_dir or os.path.join(config.root, "logs")
        self.log_param_stats = log_param_stats
        # Batches prepared ahead by train.prefetch in fit and evaluate; 0: none.
        self.prefetch = prefetch
        self._tb = None
        if log_tensorboard and self.is_writer:
            try:  # imported here: importing the port loads no logging package
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass  # as in the JAX package: no TensorBoard, no TensorBoard log
            else:
                self._tb = SummaryWriter(self.log_dir)
        self.params = list(potential.parameters())
        self.optimizer = make_optimizer(self.params, config)
        self.accumulate = max(int(config.accumulate_grad_batches), 1)
        self._acc: list[torch.Tensor] | None = None  # running mean of the window
        self._mini_step = 0
        self.epoch = 0
        self.step = 0

    def set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)

    # ------------------------------------------------------------------
    def train_step(self, batch, lr: Optional[float] = None) -> dict[str, torch.Tensor]:
        """One optimizer step (or one accumulation step) on ``batch``;
        returns the batch's metrics, computed before the update."""
        if lr is not None:
            self.set_lr(lr)
        loss, metrics = loss_and_metrics(self.potential, batch, self.config, create_graph=True)
        self.apply_gradients(self.gradients(loss))
        return _detached(metrics)

    def gradients(self, loss) -> list[torch.Tensor]:
        """The weights' gradient of ``loss``. A weight the loss does not
        reach gets a zero gradient, as in JAX: Adam then leaves it where it
        is and its step count stays in line."""
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]

    def apply_gradients(self, grads: list[torch.Tensor]) -> None:
        """One optimizer step with ``grads`` (one per weight), or one
        accumulation step: the running mean of the window's gradients is
        applied once every ``accumulate_grad_batches`` calls."""
        self.step += 1
        if self.accumulate > 1:
            n = self._mini_step
            acc = self._acc or [torch.zeros_like(p) for p in self.params]
            self._acc = [a + (g - a) / (n + 1) for a, g in zip(acc, grads)]
            self._mini_step = (n + 1) % self.accumulate
            if self._mini_step:
                return
            grads, self._acc = self._acc, None
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        for p in self.params:
            p.grad = None

    def eval_step(self, batch) -> dict[str, torch.Tensor]:
        with torch.no_grad():
            _, metrics = loss_and_metrics(self.potential, batch, self.config, create_graph=False)
        return _detached(metrics)

    # ------------------------------------------------------------------
    def fit(
        self,
        train_batches: Callable[[int], Iterable],
        val_batches: Optional[Callable[[], Iterable]] = None,
        max_epochs: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        log_every: int = 1,
    ) -> TrainState:
        """Run the epoch loop from ``self.epoch``.

        Args:
            train_batches: epoch index -> iterable of padded batches.
            val_batches: () -> iterable of padded validation batches; their
                ``val_loss`` drives early stopping and the best checkpoint.
            checkpoint_dir: if set, save best and last checkpoints there.
        """
        cfg = self.config
        max_epochs = max_epochs or cfg.max_epochs
        os.makedirs(self.log_dir, exist_ok=True)
        log_path = os.path.join(self.log_dir, "metrics.jsonl")
        best_val = float("inf")
        patience_left = cfg.early_stopping_patience

        for epoch in range(self.epoch, max_epochs):
            lr = cosine_annealing_lr(epoch, cfg.learning_rate, cfg.decay_steps, cfg.decay_alpha)
            t0 = time.time()
            acc = MetricAccumulator()
            for batch in self._prefetched(train_batches(epoch)):
                metrics = self.train_step(batch, lr)
                acc.update({k: float(v) for k, v in metrics.items()},
                           weight=max(batch.num_graphs_real, 1))
            self.epoch = epoch + 1
            row = {
                "epoch": epoch,
                "lr": lr,
                "time": time.time() - t0,
                **{f"train_{k}": v for k, v in acc.compute().items()},
            }

            if val_batches is not None:
                val_metrics = self.evaluate(val_batches())
                row.update({f"val_{k}": v for k, v in val_metrics.items()})
                if val_metrics["loss"] < best_val - 1e-12:
                    best_val = val_metrics["loss"]
                    patience_left = cfg.early_stopping_patience
                    if checkpoint_dir:
                        self.save_checkpoint(checkpoint_dir, tag="best")
                else:
                    patience_left -= 1

            if self.log_param_stats:
                for name, p in self._named_weights():
                    row[f"param_norm/{name}"] = float(torch.linalg.vector_norm(p.detach()))
            if self.is_writer and epoch % log_every == 0:
                with open(log_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
            if self._tb is not None:
                for k, val in row.items():
                    if isinstance(val, (int, float)):
                        self._tb.add_scalar(k, val, epoch)
                if self.log_param_stats:
                    for name, p in self._named_weights():
                        self._tb.add_histogram(name, p.detach().cpu().numpy(), epoch)
                self._tb.flush()
            if checkpoint_dir:
                self.save_checkpoint(checkpoint_dir, tag="last")
            if val_batches is not None and patience_left <= 0:
                break
        return self.state()

    def evaluate(self, batches: Iterable) -> dict[str, float]:
        acc = MetricAccumulator()
        for batch in self._prefetched(batches):
            acc.update({k: float(v) for k, v in self.eval_step(batch).items()},
                       weight=max(batch.num_graphs_real, 1))
        return acc.compute()

    def _prefetched(self, batches: Iterable) -> Iterator:
        """``batches`` prepared ``self.prefetch`` ahead on the weights'
        device, with the kernel index of the model's mode."""
        model = getattr(self.potential, "model", None)
        return device_prefetch(batches, self.prefetch, self.params[0].device,
                               index=getattr(model, "batch_index", ()))

    def _named_weights(self):
        """(name, weight) in the JAX package's spelling of the Flax path:
        ``model.atom_embed.embedding`` -> ``params/atom_embed/embedding``."""
        for name, p in self.potential.named_parameters():
            yield "params/" + name.removeprefix("model.").replace(".", "/"), p

    # ------------------------------------------------------------------
    def state(self) -> TrainState:
        """A copy of the weights, the optimizer state, epoch and step."""
        return TrainState(
            params={k: v.detach().clone() for k, v in self.potential.state_dict().items()},
            opt_state=copy.deepcopy({
                "optimizer": self.optimizer.state_dict(),
                "acc": self._acc,
                "mini_step": self._mini_step,
            }),
            epoch=self.epoch,
            step=self.step,
        )

    def load_state(self, state: TrainState) -> None:
        self.potential.load_state_dict(state.params)
        if state.opt_state:
            self.optimizer.load_state_dict(state.opt_state["optimizer"])
            dev = self.params[0].device
            acc = state.opt_state.get("acc")
            self._acc = None if acc is None else [a.to(dev) for a in acc]
            self._mini_step = int(state.opt_state.get("mini_step", 0))
        self.epoch, self.step = int(state.epoch), int(state.step)

    def save_checkpoint(self, ckpt_dir: str, tag: str = "last") -> str:
        """Save the training state to ``<ckpt_dir>/<tag>`` and the model
        constants that the state does not hold (fitted elemental energies,
        energy scale) to ``<ckpt_dir>/<tag>.meta.json``; returns the path."""
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(ckpt_dir, tag))
        state = self.state()
        torch.save({"params": state.params, "opt_state": state.opt_state,
                    "epoch": state.epoch, "step": state.step}, path)
        model = getattr(self.potential, "model", None)
        elem = getattr(model, "elemental_energies", None)
        meta = {
            "elemental_energies": [] if elem is None else [float(x) for x in elem.tolist()],
            "energy_scale": float(getattr(model, "energy_scale", 1.0)),
            "epoch": state.epoch,
            "step": state.step,
        }
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
        return path

    def restore_checkpoint(self, ckpt_dir: str, tag: str = "last") -> TrainState:
        """Load ``<ckpt_dir>/<tag>`` into the potential and the optimizer."""
        raw = torch.load(os.path.join(ckpt_dir, tag), map_location=self.params[0].device,
                         weights_only=True)
        state = TrainState(**raw)
        self.load_state(state)
        return state

    @staticmethod
    def load_params(ckpt_path: str) -> dict[str, torch.Tensor]:
        """The potential's ``state_dict`` of a checkpoint, on the CPU, with no
        optimizer needed (prediction-time restores)."""
        return torch.load(ckpt_path, map_location="cpu", weights_only=True)["params"]

    @staticmethod
    def load_meta(ckpt_path: str) -> Optional[dict]:
        """Read the :meth:`save_checkpoint` sidecar (elemental energies, scale)."""
        p = os.path.abspath(ckpt_path) + ".meta.json"
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)


def _detached(metrics: dict) -> dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in metrics.items()}
