from torch_m3gnet_tpu_torch.train.elemental import fit_elemental_energies
from torch_m3gnet_tpu_torch.train.loop import TrainState, Trainer, loss_and_metrics
from torch_m3gnet_tpu_torch.train.metrics import MetricAccumulator

__all__ = [
    "fit_elemental_energies",
    "TrainState",
    "Trainer",
    "loss_and_metrics",
    "MetricAccumulator",
]
