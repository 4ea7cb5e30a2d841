"""What the port's prediction and simulation CLIs share: the structure
input format and the potential, from a checkpoint or from a seed."""

from __future__ import annotations

import argparse
import json

import torch

from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data.io import load_mlearn_json
from torch_m3gnet_tpu_torch.data.structure import Structure
from torch_m3gnet_tpu_torch.models import build_model
from torch_m3gnet_tpu_torch.train.loop import Trainer


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """The model flags of every prediction and simulation CLI."""
    ap.add_argument("--checkpoint", default=None,
                    help="port checkpoint file (e.g. <root>/checkpoints/best) with its "
                         ".meta.json sidecar")
    ap.add_argument("--config", default=None, help="YAML config for the model")
    ap.add_argument("--seed", type=int, default=0, help="init seed when no checkpoint (md also draws its "
                         "velocities and noise from it)")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")


def structure_from_dict(d: dict) -> Structure:
    """{"lattice": 3x3, "frac_coords" or "cart_coords": Nx3, "atomic_numbers": [...]}."""
    if "cart_coords" in d:
        return Structure(d["lattice"], d["cart_coords"], d["atomic_numbers"])
    return Structure.from_frac_coords(d["lattice"], d["frac_coords"], d["atomic_numbers"])


def load_structures(path: str, fmt: str = "json") -> list[Structure]:
    """A JSON list of structure dicts, or an mlearn-format file (``fmt="mlearn"``)."""
    if fmt == "mlearn":
        return load_mlearn_json(path)
    with open(path) as f:
        return [structure_from_dict(d) for d in json.load(f)]


def load_potential(args):
    """The config (``--config`` or the defaults) and the potential on
    ``--device``: with ``--checkpoint``, built with the constants of its
    sidecar (fitted elemental energies, energy scale; exits without one)
    and loaded with its weights; otherwise seeded weights."""
    config = M3GNetConfig.from_yaml(args.config) if args.config else M3GNetConfig()
    if args.checkpoint is None:
        return config, build_model(config, device=args.device,
                                   generator=torch.Generator().manual_seed(args.seed))
    meta = Trainer.load_meta(args.checkpoint)
    if meta is None:
        raise SystemExit(
            f"no sidecar {args.checkpoint}.meta.json — re-save the checkpoint with "
            "the port's Trainer, or pass a model built with explicit elemental energies"
        )
    pot = build_model(config, elemental_energies=meta["elemental_energies"],
                      energy_scale=meta["energy_scale"], device=args.device)
    pot.load_state_dict(Trainer.load_params(args.checkpoint))
    return config, pot
