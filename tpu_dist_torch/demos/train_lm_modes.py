"""One trainer, a mode per flag: the port's counterpart of
demos/train_lm_modes.py.

    python -m tpu_dist_torch.demos.train_lm_modes --mode moe
    python -m tpu_dist_torch.demos.train_lm_modes --mode dp --world 2 --device cpu
    python -m tpu_dist_torch.demos.train_lm_modes --mode seq_ulysses --world 4 --device cpu
    python -m tpu_dist_torch.demos.train_lm_modes --mode seq_ring --world 4 --device cpu

``--mode dp`` trains the TransformerLM data-parallel, ``--mode moe``
expert-parallel (``LMTrainer(moe=True)``: ``moe_experts`` = the world, one
expert per rank, capacity factor ``2 * world`` so that no token drops),
``--mode seq_ring`` and ``--mode seq_ulysses`` sequence-parallel on the JAX
demo's (2, 2) data x seq mesh (``LMTrainer(sequence_parallel="ring")``,
the K/V ring, or ``"ulysses"``; world 4), at the JAX
demo's settings: vocab 64, dim 32, depth 4, heads 4, ``max_seq = --seq``,
``sgd(0.1)``, ``8 * --batch`` windows of the synthetic Markov corpus.
Every rank is a process started by `comm.spmd`, on the card by default
(ranks share it when the world exceeds the cards) or on the CPU with
``--device cpu``.  Rank 0 prints each epoch's mean loss, which should
fall.  The JAX demo's other modes are not ported yet: they exit before
starting, naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from tpu_dist_torch import comm, models
from tpu_dist_torch.train import LMTrainConfig, LMTrainer, sgd, sgd_rule

# mode -> (mesh shape and axes, None for the 1-D data mesh of any world;
# LMTrainConfig overrides)
MODES = {
    "dp": (None, {}),
    "moe": (None, {"moe": True}),
    "seq_ring": (((2, 2), ("data", "seq")), {"sequence_parallel": "ring"}),
    "seq_ulysses": (((2, 2), ("data", "seq")), {"sequence_parallel": "ulysses"}),
}
NOT_PORTED = ("fsdp", "zero1", "tp_psum", "tp_sp", "fsdp_tp_sp", "pipe_gpipe", "pipe_1f1b")


def run(mode: str, epochs: int, seq: int, batch: int, device_type: str) -> torch.Tensor:
    """One rank: build, fit, and return every epoch's mean loss."""
    world = comm.world_size()
    layout, overrides = MODES[mode]
    mesh = None if layout is None else comm.make_mesh(*layout)
    extra = dict(moe_experts=world, moe_capacity_factor=2.0 * world) if mode == "moe" else {}
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    lm = models.TransformerLM(vocab=64, dim=32, depth=4, heads=4, max_seq=seq, **extra,
                              generator=torch.Generator().manual_seed(0)).to(device)
    log = print if comm.rank() == 0 else (lambda line: None)
    cfg = LMTrainConfig(epochs=epochs, global_batch=batch, log=log, **overrides)
    trainer = LMTrainer(lm, cfg, optimizer=sgd_rule(sgd(lm.parameters(), 0.1)),
                        device=device, mesh=mesh)
    windows = np.asarray(models.synthetic_tokens(8 * batch, seq, 64))
    return torch.tensor([stats.mean_loss for stats in trainer.fit(windows)])


def main(argv: list[str] | None = None) -> list[float]:
    """Train; returns rank 0's epoch losses."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", default="dp",
                        help=f"one of: {', '.join(sorted([*MODES, *NOT_PORTED]))}")
    parser.add_argument("--world", type=int, default=4, help="number of ranks")
    parser.add_argument("--epochs", type=int, default=2, help="training epochs")
    parser.add_argument("--seq", type=int, default=16, help="sequence length")
    parser.add_argument("--batch", type=int, default=16,
                        help="global batch (token windows per step)")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.mode in NOT_PORTED:
        raise SystemExit(
            f"--mode {args.mode}: not ported yet (ROADMAP queue 1, item 10, the parallel "
            "strategies); the port runs --mode dp, --mode moe, --mode seq_ring and --mode "
            "seq_ulysses"
        )
    if args.mode not in MODES:
        raise SystemExit(f"--mode must be one of {sorted([*MODES, *NOT_PORTED])}, got "
                         f"{args.mode!r}")
    layout = MODES[args.mode][0]
    if layout is not None and args.world != math.prod(layout[0]):
        parser.error(f"--mode {args.mode} uses a {layout[0]} mesh ({math.prod(layout[0])} "
                     f"ranks); pass --world {math.prod(layout[0])}")
    if args.world < (2 if args.mode == "moe" else 1):
        parser.error(f"--mode {args.mode} needs --world >= {2 if args.mode == 'moe' else 1}")
    print(f"mode={args.mode}  world={args.world}  [{args.device}]", flush=True)
    losses = comm.spmd(run, args.mode, args.epochs, args.seq, args.batch, args.device,
                       world=args.world, device=args.device)[0].tolist()
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} epochs "
          "(expect decreasing)", flush=True)
    return losses


if __name__ == "__main__":
    main()
