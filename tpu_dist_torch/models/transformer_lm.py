"""Decoder-only transformer LM, as `tpu_dist.models.transformer_lm`.

Token embedding, learned or rotary positions, pre-norm causal blocks
(`EncoderBlock`), a final layer norm and the weight-tied head
``h @ table.T``.  Parameter names follow the JAX tree with dots:
``embed.table``, ``blocks.3.attn.qkv.w``, ``ln.scale``, ``pos``.  With
``TPU_DIST_FLASH=1`` every block's attention runs the flash kernels.

Also here: the next-token loss `lm_loss`, the seeded Markov-chain corpus
`synthetic_tokens` (the same numpy stream as the JAX package, bit for bit)
and `lm_perplexity`.  Cached decoding (``generate``) and the tensor-,
sequence-, pipeline- and MoE-parallel forwards are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_dist_torch import nn
from tpu_dist_torch.models.vit import EncoderBlock


class TransformerLM(torch.nn.Module):
    def __init__(
        self,
        *,
        vocab: int = 256,
        dim: int = 128,
        depth: int = 4,
        heads: int = 4,
        max_seq: int = 1024,
        kv_heads: int | None = None,
        pos_embedding: str = "learned",
        remat: bool = False,
        moe_experts: int = 0,
        sliding_window: int | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if pos_embedding not in ("learned", "rope"):
            raise ValueError(
                f"pos_embedding must be 'learned' or 'rope', got {pos_embedding!r}"
            )
        if moe_experts:
            raise NotImplementedError(
                "moe_experts > 0 is not ported yet (ROADMAP queue 1, item 10: the "
                "parallel strategies, with parallel/moe.py)"
            )
        self.vocab = vocab
        self.dim = dim
        self.heads = heads
        self.kv_heads = heads if kv_heads is None else kv_heads
        self.max_seq = max_seq
        self.pos_embedding = pos_embedding
        self.sliding_window = sliding_window
        # Recompute each block's forward during backward: activation memory
        # O(B*S*d) instead of O(depth*B*S*d), for one more forward.
        self.remat = remat
        self.embed = nn.Embedding(vocab, dim, generator=generator)
        self.blocks = torch.nn.ModuleList(
            EncoderBlock(
                dim, heads, causal=True, kv_heads=kv_heads,
                use_rope=pos_embedding == "rope", sliding_window=sliding_window,
                generator=generator,
            )
            for _ in range(depth)
        )
        self.ln = nn.LayerNorm(dim)
        if pos_embedding == "learned":
            self.pos = torch.nn.Parameter(
                torch.randn(1, max_seq, dim, generator=generator) * 0.02
            )

    def _trunk(self, tokens: torch.Tensor) -> torch.Tensor:
        h = self.embed(tokens)
        if self.pos_embedding == "learned":
            h = h + self.pos[:, : tokens.shape[1]]
        # rope: positions enter inside attention (q/k rotation), not here
        return h

    def forward(
        self, tokens: torch.Tensor, attn_mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        """(batch, seq) int tokens -> (batch, seq, vocab) logits.
        ``attn_mask``: a key-padding mask (b, s), True = real token, or a
        full (..., s, s) mask, combined with the causal mask in every
        block."""
        h = self._trunk(tokens)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(blk, h, attn_mask, use_reentrant=False)
            else:
                h = blk(h, attn_mask)
        h = self.ln(h)
        return h @ self.embed.table.T


def lm_loss(
    logits: torch.Tensor, tokens: torch.Tensor, *, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Next-token cross-entropy: predict tokens[:, 1:] from positions
    [:, :-1], with a float32 log-softmax.  ``mask``: (b, s) boolean of real
    tokens; a position counts when its target is real, and the mean is
    over counted positions."""
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    picked = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    if mask is None:
        return -picked.mean()
    w = mask[:, 1:].float()
    return -(picked * w).sum() / w.sum().clamp(min=1.0)


def markov_table(vocab: int = 256, *, seed: int = 0) -> np.ndarray:
    """The transition table behind `synthetic_tokens`:
    ``next_token = table[token]``."""
    return np.random.default_rng(seed).permutation(vocab)


def synthetic_tokens(n: int, seq: int, vocab: int = 256, *, seed: int = 0) -> torch.Tensor:
    """(n, seq) int32 token streams of a seeded Markov chain whose every
    next-token distribution is a delta (see `markov_table`); the same
    numbers as the JAX package's."""
    rng = np.random.default_rng(seed)
    table = rng.permutation(vocab)
    starts = rng.integers(0, vocab, size=n)
    out = np.empty((n, seq), np.int32)
    out[:, 0] = starts
    for t in range(1, seq):
        out[:, t] = table[out[:, t - 1]]
    return torch.from_numpy(out)


@torch.no_grad()
def lm_perplexity(lm: TransformerLM, tokens, *, batch: int = 64) -> tuple[float, float]:
    """Token-weighted mean next-token loss and perplexity over (N, S)
    tokens, on the device of ``lm``'s parameters.  Returns
    ``(mean_loss, exp(mean_loss))``."""
    tokens = torch.as_tensor(np.asarray(tokens))
    n, s = tokens.shape
    if n == 0:
        raise ValueError("empty token array")
    device = next(lm.parameters()).device
    total, weight = 0.0, 0
    for i in range(0, n, batch):
        chunk = tokens[i : i + batch].to(device)
        loss = lm_loss(lm(chunk), chunk).item()
        w = chunk.shape[0] * (s - 1)
        total += loss * w
        weight += w
    mean = total / weight
    return mean, math.exp(mean)
