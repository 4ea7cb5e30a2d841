"""Weighted running means of scalar metrics (own copy of
``torch_m3gnet_tpu.train.metrics``)."""

from __future__ import annotations

from collections import defaultdict


class MetricAccumulator:
    """Weighted running means of scalar metrics."""

    def __init__(self) -> None:
        self._sums: dict[str, float] = defaultdict(float)
        self._weights: dict[str, float] = defaultdict(float)

    def update(self, metrics: dict, weight: float = 1.0) -> None:
        for k, v in metrics.items():
            self._sums[k] += float(v) * weight
            self._weights[k] += weight

    def compute(self) -> dict[str, float]:
        return {k: self._sums[k] / max(self._weights[k], 1e-12) for k in self._sums}

    def reset(self) -> None:
        self._sums.clear()
        self._weights.clear()
