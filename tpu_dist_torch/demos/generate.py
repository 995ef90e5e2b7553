"""Autoregressive generation demo: the port's counterpart of
demos/generate.py.

    python -m tpu_dist_torch.demos.generate
    python -m tpu_dist_torch.demos.generate --temperature 0.8
    python -m tpu_dist_torch.demos.generate --beams 4 --device cpu

Trains a tiny TransformerLM (vocab 64, dim 64, depth 2, heads 4, max_seq
128) on the seeded Markov corpus by full-batch SGD (lr 0.3), then continues
8 two-token prompts with the KV-cache decode (`TransformerLM.generate`: one
prefill, then single-token steps; or `generate_beam`).  The corpus follows a
permutation table, so greedy continuations of a trained model follow it:
the demo prints their accuracy against the chain (expect >= 0.9) and the
decode's tokens/s.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tpu_dist_torch import models
from tpu_dist_torch.device import resolve_device


def train_tiny_lm(max_seq: int, steps: int, batch: int, device, log=print):
    """The tiny LM of both serving demos, trained on one fixed batch of
    16-token Markov windows; returns ``(lm, tokens, last loss)``."""
    lm = models.TransformerLM(vocab=64, dim=64, depth=2, heads=4, max_seq=max_seq,
                              generator=torch.Generator().manual_seed(1234)).to(device)
    tokens = models.synthetic_tokens(batch, 16, 64, seed=0).to(device)
    for i in range(steps):
        loss = models.lm_loss(lm(tokens), tokens)
        grads = torch.autograd.grad(loss, list(lm.parameters()))
        with torch.no_grad():
            for p, g in zip(lm.parameters(), grads):
                p -= 0.3 * g
        if i % max(steps // 5, 1) == 0 or i == steps - 1:
            log(f"  train step {i:4d}  loss {loss.item():.4f}")
    return lm, tokens, loss.item()


def chain(start: np.ndarray, steps: int) -> np.ndarray:
    """``steps`` tokens continuing each ``start`` through the Markov table."""
    table = models.markov_table(64, seed=0)
    out = np.empty((len(start), steps), np.int64)
    cur = np.asarray(start)
    for t in range(steps):
        cur = table[cur]
        out[:, t] = cur
    return out


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=150, help="training steps")
    parser.add_argument("--gen", type=int, default=32, help="tokens to generate per stream")
    parser.add_argument("--batch", type=int, default=64, help="training batch (streams)")
    parser.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    parser.add_argument("--beams", type=int, default=0, help="k = beam search of width k")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    lm, tokens, _ = train_tiny_lm(128, args.steps, args.batch, device)
    prompt = tokens[:8, :2]
    if args.beams:
        def run():
            return lm.generate_beam(prompt, args.gen, beams=args.beams)
    else:
        def run():
            return lm.generate(prompt, args.gen, temperature=args.temperature, seed=0)
    run()  # first use of each kernel outside the timed pass
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = run().cpu().numpy()  # the copy waits for the device
    dt = time.perf_counter() - t0
    acc = float((out == chain(prompt[:, -1].cpu().numpy(), args.gen)).mean())
    print(f"generated {out.shape[0]}x{out.shape[1]} tokens in {dt * 1e3:.1f} ms "
          f"({out.size / dt:,.0f} tok/s) [{device}]")
    print(f"chain accuracy vs the Markov table: {acc:.2f} (expect >= 0.9)")
    return {"tokens": out, "accuracy": acc, "seconds": dt}


if __name__ == "__main__":
    main()
