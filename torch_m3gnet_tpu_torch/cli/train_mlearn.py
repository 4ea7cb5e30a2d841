"""Train on an mlearn element dataset (Cu/Ge/Li/Mo/Ni/Si) with the port.

The mlearn layout is ``<path>/training.json`` and ``test.json`` (pymatgen
structure dicts with E/F/S outputs); as upstream, the (train, test) pair is
used as (train, val) while fitting, and the test set gives the printed
metrics. Logs, checkpoints (``torch.save``) and the graph cache go under
``--root``.

Usage:
    python -m torch_m3gnet_tpu_torch.cli.train_mlearn \\
        --path mlearn/data/Cu --config configs/mlearn_Cu.yaml --root runs/cu

Data-parallel on N cards (``--mesh N``, one rank per card; NCCL on the
card by default, ``--backend`` picks another):
    torchrun --nproc-per-node N -m torch_m3gnet_tpu_torch.cli.train_mlearn \\
        --mesh N --path mlearn/data/Cu --config configs/mlearn_Cu.yaml
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data.dataset import GraphDataset
from torch_m3gnet_tpu_torch.data.io import load_mlearn_json
from torch_m3gnet_tpu_torch.train.run import train_model


def add_common_args(ap: argparse.ArgumentParser, root: str) -> None:
    """The flags both training entry points take."""
    ap.add_argument("--config", default=None, help="YAML config overriding defaults")
    ap.add_argument("--root", default=root, help="output root (logs/checkpoints/cache)")
    ap.add_argument("--max-epochs", type=int, default=None)
    ap.add_argument("--num-workers", type=int, default=1)
    ap.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="data-parallel ranks (overrides config.num_devices); more than 1 "
                         "runs under torchrun --nproc-per-node N")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; under --mesh, each rank's own "
                         "unless an index names one for all)")
    ap.add_argument("--backend", default=None,
                    help="process-group backend under --mesh (default: nccl on cuda, gloo on cpu)")


def config_from_args(args) -> M3GNetConfig:
    config = (M3GNetConfig.from_yaml(args.config, root=args.root) if args.config
              else M3GNetConfig(root=args.root))
    if args.mesh is not None:
        config = config.replace(num_devices=args.mesh)
    if config.num_devices > 1 and not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(f"--mesh {config.num_devices} runs on {config.num_devices} ranks: "
                             f"start it with torchrun --nproc-per-node {config.num_devices}")
        from torch_m3gnet_tpu_torch.parallel.distributed import initialize

        initialize(backend=args.backend, platform=torch.device(args.device).type)
    os.makedirs(config.root, exist_ok=True)
    return config


@contextlib.contextmanager
def rank_zero_first():
    """Under several ranks, rank 0 runs the block (builds a cache) before
    the others, which then read what it wrote."""
    ranks = dist.is_initialized()
    if ranks and dist.get_rank() != 0:
        dist.barrier()
    yield
    if ranks and dist.get_rank() == 0:
        dist.barrier()


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Run the CLI on ``argv`` (default: the command line); prints the test
    metrics as JSON."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--path", required=True, help="mlearn element dir with training.json/test.json")
    add_common_args(ap, "runs/mlearn")
    args = ap.parse_args(argv)
    config = config_from_args(args)

    cache = os.path.join(config.root, "cache")
    with rank_zero_first():
        train_ds, test_ds = (
            GraphDataset(load_mlearn_json(os.path.join(args.path, f"{split}.json")),
                         config.cutoff, config.threebody_cutoff, cache_dir=cache,
                         num_workers=args.num_workers, name=name)
            for split, name in (("training", "train"), ("test", "test"))
        )
    _, _, metrics = train_model(
        config, train_ds.graphs, val_graphs=test_ds.graphs, test_graphs=test_ds.graphs,
        resume_checkpoint=args.resume, max_epochs=args.max_epochs, device=args.device,
    )
    print(json.dumps({"test": metrics}, indent=2))


if __name__ == "__main__":
    main()
