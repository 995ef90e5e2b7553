"""Ring attention: the port of `tpu_dist.parallel.ring_attention`.

Each rank of a sequence group holds a shard of the sequence, rank-major:
member ``r`` holds the global positions ``r * s_local + arange(s_local)``.
`ring_attention` attends the local queries to the local K/V block first,
then rotates K and V one step around the group's ring (`comm.sendrecv`
along `comm.ring_perm`) and attends to what arrived, n - 1 times, keeping
a streaming softmax (running max, denominator and numerator, in float32)
so that no rank holds the full (S, S) scores or the full K/V.  Its
gradient is autograd's through `sendrecv`, whose backward sends each
cotangent back along the inverse permutation, so every rank runs the
backward's collectives.

`ring_attention_flash` computes each block with the flash forward
(`ops.flash_attention_lse`: on the card the hand-written kernels, on the
CPU their plain version) and joins the blocks by their log-sum-exp; its
backward recomputes through `ring_attention`, as the JAX package's does.

`RingMultiHeadAttention` is `nn.MultiHeadAttention` (the same parameters:
the fused ``qkv`` projection and ``out``) run on this rank's shard, with
the ring core (``use_flash`` for its flash blocks) or the Ulysses one
(`parallel.ulysses.ulysses_attention`).  rope rotates q and k by their
GLOBAL positions, so the rotation survives the rotation of K and any
resharding.
"""

from __future__ import annotations

import torch

from tpu_dist_torch.comm.collectives import Group, rank, ring_perm, sendrecv, world_size
from tpu_dist_torch.nn.attention import MultiHeadAttention, rope
from tpu_dist_torch.ops.flash_attention import NEG_INF, flash_attention_lse
from tpu_dist_torch.parallel.ulysses import ulysses_attention


def _empty_state(q: torch.Tensor):
    """The streaming softmax's start: running max NEG_INF, denominator and
    numerator 0, all float32."""
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    return m, l, torch.zeros(q.shape, dtype=torch.float32, device=q.device)


def _block_update(m, l, acc, logits, v_blk, mask):
    """One streaming-softmax step: ``m`` (..., sq) the running row max,
    ``l`` (..., sq) the running denominator, ``acc`` (..., sq, d) the
    running numerator, ``logits`` (..., sq, sk) float32, ``mask``
    broadcastable to them (True = attend)."""
    logits = torch.where(mask, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(-1))
    # NEG_INF is finite, so a fully masked row gives exp(0), which the
    # re-mask zeroes: no inf - inf
    correction = torch.exp(m - m_new)
    p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
    l_new = l * correction + p.sum(-1)
    acc_new = acc * correction[..., None] + p @ v_blk.float()
    return m_new, l_new, acc_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Group | None = None, *, causal: bool = False,
                   window: int | None = None) -> torch.Tensor:
    """Blockwise attention over sequence shards.

    ``q``, ``k``, ``v``: this rank's shards ``(..., s_local, d)`` of a
    sequence split over ``group`` in member order (the world without one).
    ``causal`` masks over global positions; ``window=w`` keeps keys ``k >
    q - w`` over global positions, as `nn.dot_product_attention` does.
    Returns this rank's shard of the output in q's dtype, equal to
    attention over the gathered sequence.  The running max, denominator
    and numerator stay in float32 whatever the input dtype; the products
    take the input values exactly (a bf16 product is exact in float32) and
    sum in float32.  2(n - 1) `sendrecv` calls: no rotation after the last
    block."""
    n, r = world_size(group), rank(group)
    s_local, d = q.shape[-2:]
    qs = (q * d**-0.5).to(q.dtype).float()
    perm = ring_perm(n)
    m, l, acc = _empty_state(q)
    local_pos = torch.arange(s_local, device=q.device)

    def block_step(m, l, acc, k_blk, v_blk, kv_rank):
        logits = qs @ k_blk.float().transpose(-1, -2)
        q_pos = r * s_local + local_pos
        k_pos = kv_rank * s_local + local_pos
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
        else:
            mask = torch.ones((s_local, s_local), dtype=torch.bool, device=q.device)
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        return _block_update(m, l, acc, logits, v_blk, mask)

    m, l, acc = block_step(m, l, acc, k, v, r)
    k_blk, v_blk = k, v
    for t in range(n - 1):
        k_blk = sendrecv(k_blk, perm, group)
        v_blk = sendrecv(v_blk, perm, group)
        # after t + 1 rotations this rank holds the block of member r - t - 1
        m, l, acc = block_step(m, l, acc, k_blk, v_blk, (r - t - 1) % n)
    return (acc / l[..., None]).to(q.dtype)


def _combine(m, l, acc, out_b, lse_b):
    """Join a normalised block by its log-sum-exp."""
    m_new = torch.maximum(m, lse_b)
    c = torch.exp(m - m_new)
    w = torch.exp(lse_b - m_new)
    return m_new, l * c + w, acc * c[..., None] + w[..., None] * out_b.float()


def _ring_flash(q, k, v, group, causal, bq, bk):
    n, r = world_size(group), rank(group)
    perm = ring_perm(n)
    m, l, acc = _empty_state(q)
    # the diagonal block comes first, so its causal form is known here:
    # one flash call a block
    out_b, lse_b = flash_attention_lse(q, k, v, causal=causal, bq=bq, bk=bk)
    m, l, acc = _combine(m, l, acc, out_b, lse_b)
    k_blk, v_blk = k, v
    for t in range(n - 1):
        k_blk = sendrecv(k_blk, perm, group)
        v_blk = sendrecv(v_blk, perm, group)
        out_b, lse_b = flash_attention_lse(q, k_blk, v_blk, causal=False, bq=bq, bk=bk)
        if causal and (r - t - 1) % n > r:
            # a later member's block: computed, as every rank computes in
            # lockstep, and weighted 0
            lse_b = torch.full_like(lse_b, NEG_INF)
        m, l, acc = _combine(m, l, acc, out_b, lse_b)
    # the diagonal block always contributes (causal attends to itself): l > 0
    return (acc / l[..., None]).to(q.dtype)


class _RingFlash(torch.autograd.Function):
    """The JAX package's custom VJP: the forward on flash blocks, the
    backward autograd's through `ring_attention` recomputed on the saved
    inputs (its collectives run on every rank)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, bq, bk):
        ctx.save_for_backward(q, k, v)
        ctx.group, ctx.causal = group, causal
        return _ring_flash(q, k, v, group, causal, bq, bk)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ring_attention(*leaves, ctx.group, causal=ctx.causal)
        return (*torch.autograd.grad(out, leaves, g), None, None, None, None)


def ring_attention_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group: Group | None = None, *, causal: bool = False,
                         bq: int = 256, bk: int = 256) -> torch.Tensor:
    """`ring_attention` with each block computed by the flash forward
    (`ops.flash_attention_lse`; ``bq``/``bk`` its JAX block check): the
    (s_local, s_local) scores of a block never reach memory.  The
    diagonal block runs ``causal``, the others non-causal, and under
    ``causal`` a block of a later member is weighted 0.  Differentiable:
    the backward recomputes through `ring_attention`, so the gradient is
    that ring's."""
    return _RingFlash.apply(q, k, v, group, causal, bq, bk)


def check_core(core: str, use_flash: bool, sliding_window: int | None) -> None:
    """The JAX module's refusals: the core's name, and a window on the ring's
    flash blocks."""
    if core not in ("ring", "ulysses"):
        raise ValueError(f"core must be 'ring' or 'ulysses', got {core!r}")
    if sliding_window is not None and use_flash and core != "ulysses":
        raise ValueError(
            "sliding_window is not supported with use_flash yet — the per-block flash "
            "kernels have no cross-shard band offset; use the dense blockwise ring or "
            "ulysses cores"
        )


def sharded_attention(attn: MultiHeadAttention, x: torch.Tensor, group: Group | None, *,
                      core: str = "ring", use_flash: bool = False) -> torch.Tensor:
    """``attn``'s forward on this rank's shard ``x`` ``(b, s_local, dim)``
    of a sequence split over ``group`` in member order: the fused-QKV
    projection, rope at the global positions ``rank * s_local + arange(
    s_local)``, the attention core (``"ulysses"``, or ``"ring"``: with
    ``use_flash`` its flash blocks), the output projection.  The caller has
    run `check_core`."""
    if attn.group != 1:
        raise ValueError("sequence-parallel attention needs the fused-QKV layout "
                         "(kv_heads == heads)")
    b, s_local, _ = x.shape
    q, k, v = attn._project(x)
    if attn.use_rope:
        pos = rank(group) * s_local + torch.arange(s_local, device=x.device)
        q, k = rope(q, pos), rope(k, pos)
    if core == "ulysses":
        o = ulysses_attention(q, k, v, group, causal=attn.causal, window=attn.sliding_window)
    elif use_flash:
        o = ring_attention_flash(q, k, v, group, causal=attn.causal)
    else:
        o = ring_attention(q, k, v, group, causal=attn.causal, window=attn.sliding_window)
    return attn.out(o.transpose(1, 2).reshape(b, s_local, attn.dim))


class RingMultiHeadAttention(MultiHeadAttention):
    """`nn.MultiHeadAttention` over sequence shards: inputs ``(b, s_local,
    dim)`` are this rank's shard of a sequence split over ``group``, and
    the output is its shard of the dense module's output, on the same
    state dict.  ``core``: ``"ring"`` (``use_flash``: its flash blocks) or
    ``"ulysses"``, whose local attention routes by ``TPU_DIST_FLASH``, as
    every attention call does."""

    def __init__(self, dim: int, heads: int, *, group: Group | None = None,
                 causal: bool = False, use_rope: bool = False, use_flash: bool = False,
                 core: str = "ring", sliding_window: int | None = None,
                 generator: torch.Generator | None = None):
        check_core(core, use_flash, sliding_window)
        super().__init__(dim, heads, causal=causal, use_rope=use_rope,
                         sliding_window=sliding_window, generator=generator)
        self.sharding, self.core, self.use_flash = group, core, use_flash

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if mask is not None:
            raise ValueError("sequence-parallel attention takes no mask")
        return sharded_attention(self, x, self.sharding, core=self.core,
                                 use_flash=self.use_flash)
