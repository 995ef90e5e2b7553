"""Gather demo: every rank's ``ones(1)`` gathered on rank 0.

    python -m tpu_dist_torch.demos.gather [--world 2] [--device cuda|cpu]

The port of ``demos/gather.py`` (the reference's misnamed ptp.py:21-28):
each rank contributes ``ones(1)``, rank 0 gathers the stack and sums it,
which must equal the world size; every other rank gets zeros from
`comm.gather`, so its sum is 0.0.  Every rank is a process started by
`comm.spmd`; the card is the default device.
"""

from __future__ import annotations

import argparse

import torch

from tpu_dist_torch import comm


def run(device_type: str) -> torch.Tensor:
    """One rank's body (the tutorial's ``run(rank, size)``)."""
    return comm.gather(torch.ones(1, device=device_type), dst=0).sum()


def main(argv: list[str] | None = None) -> torch.Tensor:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=2, help="number of ranks")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.world < 1:
        parser.error("--world must be >= 1")
    out = comm.spmd(run, args.device, world=args.world, device=args.device)
    for r in range(args.world):
        print(f"Rank {r} sum after gather: {float(out[r]):.1f} "
              f"(expect {args.world if r == 0 else 0}.0 — root holds the stack)")
    return out


if __name__ == "__main__":
    main()
