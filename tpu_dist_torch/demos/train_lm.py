"""Language-model training demo: the port's counterpart of demos/train_lm.py
on its data-parallel path.

    python -m tpu_dist_torch.demos.train_lm --steps 60
    python -m tpu_dist_torch.demos.train_lm --corpus docs/tutorial.md --seq 128
    python -m tpu_dist_torch.demos.train_lm --device cpu --corpus docs/tutorial.md
    torchrun --nproc-per-node 4 -m tpu_dist_torch.demos.train_lm

The TransformerLM at the JAX demo's settings (vocab 64, or 256 with
``--corpus``; dim 64, depth 2, heads 4, ``max_seq = --seq``), AdamW under
``cosine(3e-3, steps, warmup_steps=steps // 10)``, ``--bf16`` for bfloat16
compute.  Without ``--corpus`` every step sees the same batch of a
synthetic Markov corpus, so a falling loss means the model learned its
transition table; with it, batches of byte windows drawn by
``default_rng(1234).integers``, the same on every rank, each rank taking
its rows, and the held-out perplexity at the end.  Each process drives one
card (``cuda:$LOCAL_RANK``) over NCCL; ``--device cpu`` runs on the CPU
over Gloo.  With ``TPU_DIST_FLASH=1`` attention runs through the flash
kernels where it is eligible (``--seq`` at least 128).  ``--tp`` waits for
tensor parallelism (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from tpu_dist_torch import comm, data, models
from tpu_dist_torch.device import resolve_device, to_device
from tpu_dist_torch.train import LMTrainConfig, LMTrainer, adamw, schedule


def make_trainer(lm: torch.nn.Module, *, steps: int, batch: int, bf16: bool,
                 device) -> LMTrainer:
    """The demo's optimizer and compute type around ``lm``."""
    opt = adamw(schedule.cosine(3e-3, steps, warmup_steps=steps // 10))
    cfg = LMTrainConfig(global_batch=batch, compute_dtype="bfloat16" if bf16 else None,
                        log=lambda line: None)
    return LMTrainer(lm, cfg, optimizer=opt, device=device)


def run(trainer: LMTrainer, batch_at: Callable[[int], np.ndarray], steps: int, *,
        log: Callable[[str], None] = print) -> tuple[list[float], float]:
    """``steps`` training steps on the global batches ``batch_at(i)``, this
    rank taking its rows; returns every step's loss (averaged over ranks)
    and the seconds the steps took."""
    local = trainer.config.global_batch // trainer.world
    rows = slice(trainer.rank * local, (trainer.rank + 1) * local)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        loss = trainer.train_step(to_device(batch_at(i)[rows], trainer.device))
        losses.append(loss)
        if i % max(steps // 6, 1) == 0 or i == steps - 1:
            log(f"  step {i:4d}  loss {loss.item():.4f}")
    values = torch.stack(losses).tolist()  # waits for the device
    return values, time.perf_counter() - t0


def main(argv: list[str] | None = None) -> dict:
    """Train; returns the losses, tokens/s and, with a corpus, the held-out
    loss and perplexity."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=60, help="training steps")
    parser.add_argument("--seq", type=int, default=64, help="sequence length")
    parser.add_argument("--batch", type=int, default=64, help="global batch size")
    parser.add_argument("--bf16", type=int, default=0, help="1 = bfloat16 compute")
    parser.add_argument("--corpus", default="",
                        help="UTF-8 text file to train on byte-level "
                             "(default: synthetic Markov corpus)")
    parser.add_argument("--tp", default="", help="tensor parallelism (not ported)")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.tp:
        raise SystemExit(
            f"--tp {args.tp!r}: tensor parallelism is not ported yet (ROADMAP queue 1, "
            "item 10); run without --tp for the data-parallel path"
        )

    device = resolve_device(args.device)
    rank, world = comm.init_process_group(device)
    try:
        vocab = data.TEXT_VOCAB if args.corpus else 64
        lm = models.TransformerLM(vocab=vocab, dim=64, depth=2, heads=4, max_seq=args.seq,
                                  generator=torch.Generator().manual_seed(1234))
        trainer = make_trainer(lm, steps=args.steps, batch=args.batch, bf16=bool(args.bf16),
                               device=device)
        val_windows = None
        if args.corpus:
            train_part, val_part = data.load_text(args.corpus, seq_len=args.seq,
                                                  val_fraction=0.1)
            windows = np.stack([train_part[i] for i in range(len(train_part))])
            val_windows = np.stack([val_part[i] for i in range(len(val_part))])
            rng = np.random.default_rng(1234)  # the same stream on every rank
            source = f"{args.corpus} ({len(train_part)} train windows)"

            def batch_at(i):
                return windows[rng.integers(0, len(windows), size=args.batch)]
        else:
            fixed = models.synthetic_tokens(args.batch, args.seq, 64).numpy()
            source = "synthetic Markov corpus"

            def batch_at(i):
                return fixed

        log = print if rank == 0 else (lambda line: None)
        log(f"TransformerLM on {world} ranks [{device}]{' bf16' if args.bf16 else ''}: "
            f"{args.steps} steps on {source}")
        losses, seconds = run(trainer, batch_at, args.steps, log=log)
        tok_s = args.steps * args.batch * args.seq / seconds
        log(f"done: {tok_s:,.0f} tokens/s (expect decreasing loss — "
            f"{'real text' if args.corpus else 'a learnable Markov chain'})")
        out = {"losses": losses, "tokens_per_sec": tok_s, "seconds": seconds}
        if val_windows is not None:
            vloss, ppl = models.lm_perplexity(trainer.lm, val_windows,
                                              batch=min(64, len(val_windows)))
            log(f"held-out: loss {vloss:.4f}, perplexity {ppl:.1f} (uniform would be {vocab})")
            out.update(val_loss=vloss, val_perplexity=ppl)
        return out
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
