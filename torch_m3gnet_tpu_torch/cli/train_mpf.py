"""Train on MPF.2021.2.8 (universal-potential pretraining) with the port.

Reads the block pickles ``block_0_cif.p`` / ``block_1_cif.p`` under
``--path``, splits by material id before flattening the trajectories, and
converts stresses from kbar to eV/A^3 Voigt. By default the graphs stream
from a sharded cache (``data.streaming``: MPF is ~187k structures);
``--in-memory`` holds them in one ``GraphDataset`` instead.

Usage:
    python -m torch_m3gnet_tpu_torch.cli.train_mpf \\
        --path MPF.2021.2.8 --config configs/mpf.yaml --root runs/mpf

``--mesh N`` runs data-parallel under ``torchrun --nproc-per-node N``
(see ``cli.train_mlearn``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from torch_m3gnet_tpu_torch.cli.train_mlearn import (
    add_common_args,
    config_from_args,
    rank_zero_first,
)
from torch_m3gnet_tpu_torch.data.dataset import GraphDataset
from torch_m3gnet_tpu_torch.data.io import load_mpf_pickles
from torch_m3gnet_tpu_torch.data.streaming import StreamingGraphDataset
from torch_m3gnet_tpu_torch.train.run import train_model


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Run the CLI on ``argv`` (default: the command line); prints the test
    metrics as JSON."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--path", required=True, help="dir containing block_{0,1}_cif.p")
    add_common_args(ap, "runs/mpf")
    ap.add_argument("--in-memory", action="store_true",
                    help="hold the graphs in one GraphDataset instead of the sharded stream")
    ap.add_argument("--shard-size", type=int, default=256)
    args = ap.parse_args(argv)
    config = config_from_args(args)

    blocks = [os.path.join(args.path, f"block_{i}_cif.p") for i in (0, 1)]
    splits = load_mpf_pickles([b for b in blocks if os.path.exists(b)],
                              config.val_ratio, config.test_ratio, config.seed)
    cache = os.path.join(config.root, "cache")

    def dataset(structs, name):
        if args.in_memory:
            return GraphDataset(structs, config.cutoff, config.threebody_cutoff,
                                cache_dir=cache, num_workers=args.num_workers, name=name).graphs
        return StreamingGraphDataset(structs, config.cutoff, config.threebody_cutoff,
                                     cache_dir=cache, name=name, shard_size=args.shard_size,
                                     num_workers=args.num_workers, num_types=config.num_types)

    with rank_zero_first():
        train, val, test = [dataset(s, n) for s, n in zip(splits, ("train", "val", "test"))]
    _, _, metrics = train_model(
        config, train, val_graphs=val, test_graphs=test, resume_checkpoint=args.resume,
        max_epochs=args.max_epochs, device=args.device,
    )
    print(json.dumps({"test": metrics}, indent=2))


if __name__ == "__main__":
    main()
