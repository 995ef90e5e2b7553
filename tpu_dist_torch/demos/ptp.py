"""Point-to-point demo: a blocking send/recv ping-pong.

    python -m tpu_dist_torch.demos.ptp [--world 2] [--device cuda|cpu]

The port of ``demos/ptp.py``: rank 0 increments its tensor and sends it to
rank 1, so both end with 1.0 (the tutorial's known answer); then rank 1
increments and sends it back, and both end with 2.0.  Every rank is a
process started by `comm.spmd`; the card is the default device.
"""

from __future__ import annotations

import argparse

import torch

from tpu_dist_torch import comm


def run(device_type: str):
    """One rank's body (the tutorial's ``run(rank, size)``)."""
    rank = comm.rank()
    t = torch.zeros(1, device=device_type)
    t = comm.send(t + 1 if rank == 0 else t, dst=1, src=0)  # ping
    ping = t.clone()
    t = comm.send(t + 1 if rank == 1 else t, dst=0, src=1)  # pong
    return ping, t


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=2, help="number of ranks (>= 2)")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.world < 2:
        parser.error("ptp needs --world >= 2: rank 0 sends to rank 1")
    ping, pong = comm.spmd(run, args.device, world=args.world, device=args.device)
    for r in range(args.world):
        want = (1.0, 2.0) if r < 2 else (0.0, 0.0)  # ranks past 1 take no part
        print(f"Rank {r} has data {float(ping[r][0]):.1f} after ping (expect {want[0]}), "
              f"{float(pong[r][0]):.1f} after pong (expect {want[1]})")
    return ping, pong


if __name__ == "__main__":
    main()
