"""Print the spherical-Bessel zeros table as JSON (rows l = 0..l_max-1, the
first n_max positive roots of j_l each), as the model regenerates it
(``ops/basis.py``). Needs no card.

Usage:
    python -m torch_m3gnet_tpu_torch.cli.bessel_zeros --l-max 4 --n-max 3
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from torch_m3gnet_tpu_torch.ops.basis import spherical_bessel_zeros


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--l-max", type=int, default=10)
    ap.add_argument("--n-max", type=int, default=10)
    args = ap.parse_args(argv)
    print(json.dumps(spherical_bessel_zeros(args.l_max, args.n_max).tolist()))


if __name__ == "__main__":
    main()
