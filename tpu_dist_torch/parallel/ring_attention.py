"""Sequence-parallel multi-head attention: the module of
`tpu_dist.parallel.ring_attention`.

`RingMultiHeadAttention` is `nn.MultiHeadAttention` (the same parameters:
the fused ``qkv`` projection and ``out``) run on this rank's shard of the
sequence, so one state dict runs sharded or not.  The projections are
token-local; only the attention core talks to the other ranks of the
sequence group.  rope rotates q and k by their GLOBAL positions, so the
rotation survives any resharding.

Cores: ``"ulysses"`` (`parallel.ulysses.ulysses_attention`).  ``"ring"``,
the blockwise ring over `comm.sendrecv` with its flash-block form, is not
ported yet (ROADMAP queue 1, item 10, entry 1a: ring attention).
"""

from __future__ import annotations

import torch

from tpu_dist_torch.comm.collectives import Group, rank
from tpu_dist_torch.nn.attention import MultiHeadAttention, rope
from tpu_dist_torch.parallel.ulysses import ulysses_attention


def check_core(core: str, use_flash: bool, sliding_window: int | None) -> None:
    """The JAX module's refusals, then the core the port lacks."""
    if core not in ("ring", "ulysses"):
        raise ValueError(f"core must be 'ring' or 'ulysses', got {core!r}")
    if sliding_window is not None and use_flash and core != "ulysses":
        raise ValueError(
            "sliding_window is not supported with use_flash yet — the per-block flash "
            "kernels have no cross-shard band offset; use the dense blockwise ring or "
            "ulysses cores"
        )
    if core == "ring":
        raise NotImplementedError(
            "core='ring': not ported yet (ROADMAP queue 1, item 10, entry 1a: ring "
            "attention); use core='ulysses'"
        )


def sharded_attention(attn: MultiHeadAttention, x: torch.Tensor,
                      group: Group | None) -> torch.Tensor:
    """``attn``'s forward on this rank's shard ``x`` ``(b, s_local, dim)``
    of a sequence split over ``group`` in member order: the fused-QKV
    projection, rope at the global positions ``rank * s_local + arange(
    s_local)``, the ulysses core (the only one `check_core` lets through,
    which every caller runs first), the output projection."""
    if attn.group != 1:
        raise ValueError("sequence-parallel attention needs the fused-QKV layout "
                         "(kv_heads == heads)")
    b, s_local, _ = x.shape
    q, k, v = attn._project(x)
    if attn.use_rope:
        pos = rank(group) * s_local + torch.arange(s_local, device=x.device)
        q, k = rope(q, pos), rope(k, pos)
    o = ulysses_attention(q, k, v, group, causal=attn.causal, window=attn.sliding_window)
    return attn.out(o.transpose(1, 2).reshape(b, s_local, attn.dim))


class RingMultiHeadAttention(MultiHeadAttention):
    """`nn.MultiHeadAttention` over sequence shards: inputs ``(b, s_local,
    dim)`` are this rank's shard of a sequence split over ``group``, and
    the output is its shard of the dense module's output.  ``core`` and
    ``use_flash`` (the ring core's flash blocks) only take part in the JAX
    module's refusals: ``"ulysses"`` is the one core ported, and its local
    attention routes by ``TPU_DIST_FLASH``, as every attention call does."""

    def __init__(self, dim: int, heads: int, *, group: Group | None = None,
                 causal: bool = False, use_rope: bool = False, use_flash: bool = False,
                 core: str = "ring", sliding_window: int | None = None,
                 generator: torch.Generator | None = None):
        check_core(core, use_flash, sliding_window)
        super().__init__(dim, heads, causal=causal, use_rope=use_rope,
                         sliding_window=sliding_window, generator=generator)
        self.sharding = group

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if mask is not None:
            raise ValueError("sequence-parallel attention takes no mask")
        return sharded_attention(self, x, self.sharding)
