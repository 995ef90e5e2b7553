"""`tpu_dist.models.vit` (BASELINE config 5: ViT-Ti/16 on ImageNet-1k):
``MLP``, the top-2 mixture of experts ``MoE``, the pre-norm
``EncoderBlock`` (which the TransformerLM stacks too) and ``ViT``.

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
from tpu_dist_torch.parallel.moe import top_k


class MLP(torch.nn.Module):
    """fc1 -> tanh gelu -> fc2."""

    def __init__(self, dim: int, hidden: int, *, generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = nn.Dense(dim, hidden, generator=generator)
        self.fc2 = nn.Dense(hidden, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class MoE(torch.nn.Module):
    """A top-2 mixture of ``experts`` bias-free MLPs, the feed-forward half
    of a `TransformerLM(moe_experts=)` block: the router ``gate (d, E)``
    (normal * 0.02) and the expert-stacked ``up (E, d, hidden)`` (normal /
    sqrt(d)) and ``down (E, hidden, d)`` (normal / sqrt(hidden)), the JAX
    package's tree and init distributions.

    Calling it is the dense evaluation (the JAX package's
    ``TransformerLM._moe_dense``):
    every expert computes every token and the router's top two, their
    probabilities renormalized to sum to 1, are combined; no capacity
    bound.  The expert-parallel form is `parallel.moe_mlp_top2`."""

    def __init__(self, dim: int, experts: int, hidden: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.gate = torch.nn.Parameter(torch.randn(dim, experts, generator=generator) * 0.02)
        self.up = torch.nn.Parameter(
            torch.randn(experts, dim, hidden, generator=generator) / dim**0.5)
        self.down = torch.nn.Parameter(
            torch.randn(experts, hidden, dim, generator=generator) / hidden**0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(-1, x.shape[-1])
        probs = torch.softmax(x2 @ self.gate, dim=-1)  # (T, E)
        top2_p, top2_e = top_k(probs, 2)
        gates = top2_p / top2_p.sum(-1, keepdim=True).clamp(min=1e-9)
        hidden = F.gelu(torch.einsum("td,edh->eth", x2, self.up), approximate="tanh")
        y_all = torch.einsum("eth,ehd->etd", hidden, self.down)  # (E, T, d)
        t = torch.arange(x2.shape[0], device=x.device)
        y = (gates[:, 0, None] * y_all[top2_e[:, 0], t]
             + gates[:, 1, None] * y_all[top2_e[:, 1], t])
        return y.reshape(x.shape)


class EncoderBlock(torch.nn.Module):
    """Pre-norm transformer block: x + MHA(LN(x)); x + MLP(LN(x)), or with
    ``moe_experts`` x + MoE(LN(x)) (then the block has ``moe`` and no
    ``mlp``)."""

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
        moe_experts: int = 0,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.moe_experts = moe_experts
        self.ln1 = nn.LayerNorm(dim)
        self.attn = nn.MultiHeadAttention(
            dim, heads, causal=causal, kv_heads=kv_heads, use_rope=use_rope,
            sliding_window=sliding_window, generator=generator,
        )
        self.ln2 = nn.LayerNorm(dim)
        if moe_experts:
            self.moe = MoE(dim, moe_experts, dim * mlp_ratio, generator=generator)
        else:
            self.mlp = MLP(dim, dim * mlp_ratio, generator=generator)

    def mlp_or_moe(self, x: torch.Tensor) -> torch.Tensor:
        """The feed-forward half (JAX's ``TransformerLM._mlp_or_moe``): the
        MLP, or the dense evaluation of the MoE."""
        return self.moe(x) if self.moe_experts else self.mlp(x)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask=mask)
        return x + self.mlp_or_moe(self.ln2(x))


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
