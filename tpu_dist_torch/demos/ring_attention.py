"""Long-context demo: attention over a sequence sharded across ranks.

    python -m tpu_dist_torch.demos.ring_attention [--world 8] [--seq 2048] [--heads 8]
        [--dim 64] [--causal 1] [--device cuda|cpu]

The port of ``demos/ring_attention.py``: q, k and v ``(1, heads, seq,
dim)`` float32 from fixed seeds, split over ``--world`` ranks along the
sequence (rank r holds positions ``r * seq / world ..``), run through the
two sequence-parallel cores, `parallel.ring_attention` (K/V blocks rotate
around the ranks' ring) and `parallel.ulysses_attention` (heads resharded
by all_to_all; ``--heads`` must divide by ``--world``), and each gathered
output held against full attention computed once on the whole sequence:
``OK`` within 1e-4, else ``MISMATCH``.  The time is the slowest rank's
second call.  Every rank is a process started by `comm.spmd` (ranks share
a card when the world exceeds the cards); the card is the default device.
"""

from __future__ import annotations

import argparse
import time

import torch

from tpu_dist_torch import comm
from tpu_dist_torch.nn.attention import dot_product_attention
from tpu_dist_torch.parallel import ring_attention, ulysses_attention

CORES = {"ring": ring_attention, "ulysses": ulysses_attention}
TOL = 1e-4  # float32 sums in another order


def inputs(seq: int, heads: int, dim: int) -> list[torch.Tensor]:
    """q, k, v ``(1, heads, seq, dim)`` standard normal from seeds 0, 1, 2."""
    return [torch.randn(1, heads, seq, dim, generator=torch.Generator().manual_seed(i))
            for i in range(3)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(seq: int, heads: int, dim: int, causal: bool, device_type: str) -> dict:
    """One rank: its shard through each core twice; the second call timed."""
    n, r = comm.world_size(), comm.rank()
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    s_local = seq // n
    q, k, v = (t[:, :, r * s_local:(r + 1) * s_local].to(device)
               for t in inputs(seq, heads, dim))
    out = {}
    for name, core in CORES.items():
        core(q, k, v, causal=causal)
        _sync(device)
        comm.barrier()
        t0 = time.perf_counter()
        o = core(q, k, v, causal=causal)
        _sync(device)
        out[name] = {"out": o.cpu(), "seconds": time.perf_counter() - t0}
    return out


def main(argv: list[str] | None = None) -> dict[str, float]:
    """Run both cores; returns each one's largest difference from full
    attention."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=8, help="number of ranks")
    parser.add_argument("--seq", type=int, default=2048, help="global sequence length")
    parser.add_argument("--heads", type=int, default=8, help="attention heads")
    parser.add_argument("--dim", type=int, default=64, help="head dim")
    parser.add_argument("--causal", type=int, default=1,
                        help="1 = causal mask over global positions")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.world < 1 or args.seq % args.world:
        parser.error(f"--seq {args.seq} must split over --world {args.world} >= 1")
    if args.heads % args.world:
        parser.error(f"--heads {args.heads} must divide by --world {args.world} (Ulysses)")
    causal = bool(args.causal)
    print(f"ring attention: S={args.seq} over {args.world} ranks "
          f"({args.seq // args.world} tokens/rank), causal={causal}  [{args.device}]",
          flush=True)
    res = comm.spmd(run, args.seq, args.heads, args.dim, causal, args.device,
                    world=args.world, device=args.device)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    # one pass over the whole sequence: the O(S^2) work the cores exist to avoid
    full = dot_product_attention(*(t.to(device) for t in inputs(args.seq, args.heads,
                                                                args.dim)),
                                 causal=causal).cpu()
    errors = {}
    for name in CORES:
        got = torch.cat(list(res[name]["out"]), dim=2)  # ranks back along the sequence
        errors[name] = (got - full).abs().max().item()
        ms = res[name]["seconds"].max().item() * 1e3
        print(f"  {name:8s}: {ms:8.2f} ms   max|Δ| vs full attention: {errors[name]:.2e}  "
              f"({'OK' if errors[name] < TOL else 'MISMATCH'})", flush=True)
    return errors


if __name__ == "__main__":
    main()
