"""`tpu_dist.models.vit` (BASELINE config 5: ViT-Ti/16 on ImageNet-1k):
``MLP``, the pre-norm ``EncoderBlock`` (which the TransformerLM stacks
too) and ``ViT``.

Parameter names follow the JAX tree (``embed.w``, ``cls``, ``pos``,
``blocks.<i>.attn.qkv.w``, ``ln.scale``, ``head.w``), so `interop` carries
them without a layer count.  Attention is `nn.dot_product_attention`,
non-causal and unmasked: under ``TPU_DIST_FLASH=1`` a token count of at
least 128 that divides by ``min(256, S)`` takes the flash kernels (ViT-Ti/16
at 224 has 197 tokens); fewer tokens take the dense path, as in JAX."""

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


class ViT(torch.nn.Module):
    """Vision transformer on (N, H, W, C) images: a ``patch`` x ``patch``
    stride-``patch`` convolution embeds the patches, a learned CLS token
    (zeros at init) is prepended and learned positions (normal * 0.02)
    added, ``depth`` encoder blocks and a final layer norm follow, and the
    ``Dense`` head reads the CLS token."""

    def __init__(
        self,
        *,
        image_size: int = 224,
        patch: int = 16,
        dim: int = 192,
        depth: int = 12,
        heads: int = 3,
        num_classes: int = 1000,
        channels: int = 3,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image size {image_size} not divisible by patch {patch}")
        self.dim = dim
        self.num_tokens = (image_size // patch) ** 2 + 1  # + CLS
        self.embed = nn.Conv2D(channels, dim, patch, stride=patch, generator=generator)
        self.cls = torch.nn.Parameter(torch.zeros(1, 1, dim))
        self.pos = torch.nn.Parameter(
            torch.randn(1, self.num_tokens, dim, generator=generator) * 0.02)
        self.blocks = torch.nn.ModuleList(
            EncoderBlock(dim, heads, generator=generator) for _ in range(depth))
        self.ln = nn.LayerNorm(dim)
        self.head = nn.Dense(dim, num_classes, generator=generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits (N, num_classes).  ``generator`` is taken for the
        trainer's call convention; no layer draws random bits."""
        b = x.shape[0]
        h = self.embed(x).reshape(b, -1, self.dim)  # (b, H/p * W/p, dim)
        h = torch.cat([self.cls.expand(b, 1, self.dim), h], dim=1) + self.pos
        for block in self.blocks:
            h = block(h)
        return self.head(self.ln(h)[:, 0])


def vit_tiny(image_size: int = 224, patch: int = 16, num_classes: int = 1000, *,
             generator: torch.Generator | None = None) -> ViT:
    """ViT-Ti/16: dim 192, depth 12, heads 3, MLP ratio 4."""
    return ViT(image_size=image_size, patch=patch, num_classes=num_classes,
               generator=generator)
