"""Typed run configuration: the same fields as ``torch_m3gnet_tpu.config``.

The dataclass is an own copy, field for field, so ``configs/*.yaml`` load
into either package. Fields that exist only for the TPU build are accepted
and ignored by this port: ``fused_factorized``, ``pallas_segment``,
``fuse_gated_second``, ``matmul_precision`` and ``bucket_classes``; of
``layout`` only the check that ``"fm"`` goes with the factorized mode is
kept. The port always computes feature-major with full-f32 matmuls.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping


@dataclass(frozen=True)
class M3GNetConfig:
    """Single flat config for model, data, and training.

    Defaults follow the reference defaults (cutoff=5.0, threebody_cutoff=4.0,
    l_max=3, n_max=3, num_types=95, embedding_dim=64, num_blocks=3, ...).
    """

    # Where run artifacts (cache, checkpoints, logs) live.
    root: str = "."

    # --- featurization ---
    cutoff: float = 5.0
    threebody_cutoff: float = 4.0

    # --- model ---
    l_max: int = 3
    n_max: int = 3
    num_types: int = 95
    embedding_dim: int = 64
    num_blocks: int = 3

    # --- training ---
    max_epochs: int = 1000
    learning_rate: float = 1e-3
    decay_steps: int = 200
    decay_alpha: float = 1e-2
    batch_size: int = 32
    accumulate_grad_batches: int = 1
    val_ratio: float = 0.1
    test_ratio: float = 0.1
    early_stopping_patience: int = 200
    energy_weight: float = 1.0
    force_weight: float = 1.0
    stress_weight: float = 0.1
    seed: int = 0

    # --- batching ---
    # Padded bucket sizes per batch; ``None`` means auto-derived from data.
    max_nodes: int | None = None
    max_edges: int | None = None
    max_triplets: int | None = None
    pad_multiple: int = 128
    # "float32" only in this port; "bfloat16" raises in build_model.
    compute_dtype: str = "float32"
    # Ignored by the port (TPU matmul precision knob).
    matmul_precision: str = "default"
    # Rematerialize the three-body stage in backward; not yet in the port.
    remat_triplets: bool = False
    # Ignored by the port (TPU GatedMLP fusion knob; math is unchanged).
    fuse_gated_second: bool = True
    # Ignored by the port: the factorized stage always runs the CUDA
    # kernels on a CUDA device and their plain versions on the CPU.
    fused_factorized: str = "auto"
    # Ignored by the port (size-class bucketing of the data pipeline).
    bucket_classes: int = 1
    num_devices: int = 1
    # Ignored by the port (TPU Pallas segment-sum knob).
    pallas_segment: str = "auto"
    # Legacy three-body knob, read when threebody_mode is "auto": "on" selects
    # the fused mode, "off" the gather mode.
    fused_triplets: str = "auto"
    # "factorized", "fused" or "gather"; "auto" resolves through
    # fused_triplets, else to "factorized" (models.build_model).
    threebody_mode: str = "auto"
    # Activations are always feature-major; "fm" only requires the
    # factorized mode, as in the JAX package.
    layout: str = "auto"

    def replace(self, **kwargs: Any) -> "M3GNetConfig":
        return dataclasses.replace(self, **kwargs)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "M3GNetConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        return cls(**dict(d))

    @classmethod
    def from_yaml(cls, path: str, **overrides: Any) -> "M3GNetConfig":
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f) or {}
        d.update(overrides)
        return cls.from_dict(d)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
