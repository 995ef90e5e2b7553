"""The transformer block of `tpu_dist.models.vit`: ``MLP`` and the pre-norm
``EncoderBlock`` that the TransformerLM stacks.  (``ViT`` itself is not
ported yet.)"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_dist_torch import nn


class MLP(torch.nn.Module):
    """fc1 -> tanh gelu -> fc2."""

    def __init__(self, dim: int, hidden: int, *, generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = nn.Dense(dim, hidden, generator=generator)
        self.fc2 = nn.Dense(hidden, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class EncoderBlock(torch.nn.Module):
    """Pre-norm transformer block: x + MHA(LN(x)); x + MLP(LN(x))."""

    def __init__(
        self,
        dim: int,
        heads: int,
        mlp_ratio: int = 4,
        *,
        causal: bool = False,
        kv_heads: int | None = None,
        use_rope: bool = False,
        sliding_window: int | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim)
        self.attn = nn.MultiHeadAttention(
            dim, heads, causal=causal, kv_heads=kv_heads, use_rope=use_rope,
            sliding_window=sliding_window, generator=generator,
        )
        self.ln2 = nn.LayerNorm(dim)
        self.mlp = MLP(dim, dim * mlp_ratio, generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask=mask)
        return x + self.mlp(self.ln2(x))
