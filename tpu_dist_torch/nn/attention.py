"""Attention: the functional core and the multi-head module.

The counterpart of `tpu_dist.nn.attention`, on the same layout
``(..., heads, seq, head_dim)``.  Under ``TPU_DIST_FLASH=1``, read at call
time, `dot_product_attention` hands eligible calls to the flash kernels
(`tpu_dist_torch.ops.flash_attention`) by the JAX package's own rule, so
the same inputs take the same path in both packages.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from tpu_dist_torch.nn.layers import Dense
from tpu_dist_torch.ops.flash_attention import NEG_INF, flash_attention


def use_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask) -> bool:
    """The routing rule of tpu_dist/nn/attention.py:58-66: the flag is on,
    self-attention shapes, S >= 128 and divisible by its block, no mask."""
    if os.environ.get("TPU_DIST_FLASH", "0") != "1":
        return False
    S = q.shape[-2]
    return q.shape == k.shape == v.shape and S >= 128 and S % min(256, S) == 0 and mask is None


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: torch.Tensor | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Softmax attention over ``(..., heads, seq, head_dim)``.

    ``mask``: boolean, broadcastable to ``(..., heads, sq, sk)``, True =
    attend; ANDed with the causal mask.  ``causal`` with sq != sk aligns the
    queries with the last sq keys (bottom-right).  ``window=w`` keeps keys
    ``k > q - w`` over absolute positions.  A row with no visible key gives
    zeros, not NaN."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if use_flash(q, k, v, mask):
        bq = bk = min(256, q.shape[-2])
        return flash_attention(q, k, v, causal=causal, bq=bq, bk=bk, window=window)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("...hqd,...hkd->...hqk", q * scale, k)
    sq, sk = logits.shape[-2], logits.shape[-1]
    visible = None
    if causal:
        visible = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
    if window is not None:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        band = torch.arange(sk, device=q.device)[None, :] > q_pos - window
        visible = band if visible is None else (visible & band)
    if mask is not None:
        m = torch.broadcast_to(mask, logits.shape)
        visible = m if visible is None else (visible & m)
    if visible is not None:
        # -1e30, not -inf: an empty row softmaxes to a uniform row, which
        # is zeroed below instead of turning into NaN
        logits = torch.where(visible, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    if visible is not None:
        weights = torch.where(visible.any(-1, keepdim=True), weights, 0.0)
    return torch.einsum("...hqk,...hkd->...hqd", weights, v)


def rope(x: torch.Tensor, positions: torch.Tensor, *, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over ``(..., seq, head_dim)``: the two
    halves ``x[..., :d/2]`` and ``x[..., d/2:]`` rotate by ``position *
    base**(-i / (d/2))``, computed in float32 and cast back."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope requires an even head_dim, got {d}")
    half = d // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions.to(torch.float32)[:, None] * freqs  # (s, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Multi-head attention over (batch, seq, dim), as
    `tpu_dist.nn.MultiHeadAttention`: a fused ``qkv`` projection, or, with
    ``kv_heads < heads`` (grouped-query attention), ``q`` and ``kv``
    projections whose kv heads are repeated over their query-head group
    before attention; then ``out``.  Optional rope and sliding window."""

    def __init__(
        self,
        dim: int,
        heads: int,
        *,
        causal: bool = False,
        kv_heads: int | None = None,
        use_rope: bool = False,
        sliding_window: int | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.dim = dim
        self.heads = heads
        self.head_dim = dim // heads
        self.causal = causal
        self.use_rope = use_rope
        if use_rope and self.head_dim % 2:
            raise ValueError(f"rope requires an even head_dim, got {self.head_dim}")
        self.kv_heads = heads if kv_heads is None else kv_heads
        if self.kv_heads < 1 or heads % self.kv_heads:
            raise ValueError(f"heads {heads} not divisible by kv_heads {self.kv_heads}")
        if sliding_window is not None and sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
        self.sliding_window = sliding_window
        self.group = heads // self.kv_heads
        if self.group == 1:
            self.qkv = Dense(dim, 3 * dim, generator=generator)
        else:
            self.q = Dense(dim, dim, generator=generator)
            self.kv = Dense(dim, 2 * self.kv_heads * self.head_dim, generator=generator)
        self.out = Dense(dim, dim, generator=generator)

    def _project(self, x):
        """-> q (b, heads, s, hd), k and v (b, kv_heads, s, hd)."""
        b, s, _ = x.shape
        if self.group == 1:
            qkv = self.qkv(x).reshape(b, s, 3, self.heads, self.head_dim)
            return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))
        q = self.q(x).reshape(b, s, self.heads, self.head_dim).transpose(1, 2)
        kv = self.kv(x).reshape(b, s, 2, self.kv_heads, self.head_dim)
        k, v = (kv[:, :, i].transpose(1, 2) for i in range(2))
        return q, k, v

    def _expand_kv(self, t):
        """Repeat each kv head over its query-head group (``jnp.repeat`` on
        the head axis: head h of the result is kv head h // group)."""
        if self.group == 1:
            return t
        return torch.repeat_interleave(t, self.group, dim=1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """``mask``: a key-padding mask (b, s), True = real token, or a
        full (..., sq, sk) attention mask."""
        b, s, _ = x.shape
        q, k, v = self._project(x)
        if self.use_rope:
            pos = torch.arange(s, device=x.device)
            q, k = rope(q, pos), rope(k, pos)
        if mask is not None and mask.dim() == 2:
            mask = mask[:, None, None, :]  # keys masked, all queries
        o = dot_product_attention(
            q, self._expand_kv(k), self._expand_kv(v),
            causal=self.causal, mask=mask, window=self.sliding_window,
        )
        return self.out(o.transpose(1, 2).reshape(b, s, self.dim))


def sliding_window_mask(seq: int, window: int, device=None) -> torch.Tensor:
    """Boolean (seq, seq) mask, True where |i - j| < window."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    i = torch.arange(seq, device=device)[:, None]
    j = torch.arange(seq, device=device)[None, :]
    return (i - j).abs() < window


def segment_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """Block-diagonal mask for packed sequences: ``segment_ids`` (b, s) ->
    (b, 1, s, s) boolean, True within one segment."""
    return segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
