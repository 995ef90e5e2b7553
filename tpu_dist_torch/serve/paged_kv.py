"""Paged KV cache: fixed-size blocks in a preallocated pool.

The counterpart of `tpu_dist.serve.paged_kv`.  KV memory is a pool of
blocks of ``block_size`` token positions; each request owns the blocks its
tokens fill, mapped by its block table (logical block -> physical block id),
handed out by the host-side `BlockAllocator` at admission and returned at
eviction.

`paged_apply_cached` is `TransformerLM.apply_cached` against the pool, with
two differences:

- write: a token's k/v rows go in place into
  ``pool[table[pos // block_size], :, pos % block_size]``; masked tokens
  (pads, inactive slots) write to a reserved scratch block;
- read: the tables gather the pool back into the contiguous
  ``(slots, kv_heads, L, head_dim)`` view, after which the attention is the
  dense cached attention with per-slot positions.

Plain torch operations: no kernel of the port runs on this path, as no
Pallas kernel runs on the JAX package's.
"""

from __future__ import annotations

import torch

from tpu_dist_torch.ops.flash_attention import NEG_INF


class BlockAllocator:
    """Host-side free list over the physical KV blocks.

    Deterministic (a LIFO free list that hands out ascending ids from a
    fresh pool), so a seeded arrival trace gives the same block tables run
    to run.  A double free or a foreign id raises."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))  # pop() gives 0, 1, 2, ...
        self._allocated: set[int] = set()
        self.high_water = 0

    @property
    def used(self) -> int:
        return len(self._allocated)

    @property
    def available(self) -> int:
        return len(self._free)

    def utilization(self) -> float:
        return self.used / self.num_blocks

    def alloc(self, n: int) -> list[int] | None:
        """``n`` block ids, or None when the pool cannot grant them all (no
        partial grants)."""
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._allocated.update(blocks)
        self.high_water = max(self.high_water, self.used)
        return blocks

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"freeing unallocated block {b}")
            self._allocated.remove(b)
            self._free.append(b)


def init_paged_cache(lm, num_blocks: int, block_size: int, dtype=None,
                     device=None) -> list[dict[str, torch.Tensor]]:
    """The pool: per transformer block a ``{"k", "v"}`` pair of
    ``(num_blocks + 1, kv_heads, block_size, head_dim)`` zeros (float32, on
    the CPU, unless given).  Block ``num_blocks`` is the scratch block:
    masked writes land there, and no real block table reads it."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    shape = (num_blocks + 1, lm.kv_heads, block_size, lm.dim // lm.heads)
    kw = dict(dtype=dtype or torch.float32, device=device)
    return [{"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)} for _ in lm.blocks]


def _rope_slots(x: torch.Tensor, positions: torch.Tensor, *, base: float = 10000.0):
    """`nn.rope` with per-slot positions: ``x`` ``(slots, heads, s,
    head_dim)``, ``positions`` ``(slots, s)``; elementwise the same as the
    shared-positions rope for equal positions."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions[:, None, :, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _paged_attention(attn, x, k_pool, v_pool, block_tables, positions, write_mask,
                     block_size: int):
    """One block's incremental attention against the pool: ``x`` ``(S, s,
    dim)``, ``positions`` and ``write_mask`` ``(S, s)``.  Writes the pools
    in place; returns ``y``."""
    S, s, _ = x.shape
    q, k, v = attn._project(x)
    if attn.use_rope:
        q, k = _rope_slots(q, positions), _rope_slots(k, positions)
    scratch = k_pool.shape[0] - 1
    blk = torch.gather(block_tables, 1, positions // block_size)
    blk = torch.where(write_mask, blk, scratch).reshape(-1)
    off = (positions % block_size).reshape(-1)
    for pool, new in ((k_pool, k), (v_pool, v)):
        rows = new.to(pool.dtype).transpose(1, 2).reshape(S * s, attn.kv_heads, attn.head_dim)
        pool[blk, :, off] = rows
    # the tables gather the pool back into the dense cache's layout; from
    # here on the math is MultiHeadAttention.apply_cached's
    L = block_tables.shape[1] * block_size

    def full(pool):
        view = pool[block_tables].transpose(1, 2)  # (S, kv_heads, blocks, bs, hd)
        return attn._expand_kv(view.reshape(S, attn.kv_heads, L, attn.head_dim)).to(q.dtype)

    logits = torch.einsum("bhqd,bhkd->bhqk", q * attn.head_dim**-0.5, full(k_pool))
    pos_k = torch.arange(L, device=x.device)[None, None, :]
    qpos = positions[:, :, None]
    visible = pos_k <= qpos  # (S, s, L)
    if attn.sliding_window is not None:
        visible = visible & (pos_k > qpos - attn.sliding_window)
    weights = torch.softmax(torch.where(visible[:, None], logits, NEG_INF), dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", weights, full(v_pool))
    return attn.out(o.transpose(1, 2).reshape(S, s, attn.dim))


def paged_apply_cached(lm, tokens, cache, block_tables, positions, write_mask,
                       block_size: int):
    """`TransformerLM.apply_cached` against the paged pool.

    ``tokens`` ``(S, s)``: new tokens of S slots (s = 1 for decode, the chunk
    for prefill); ``positions`` ``(S, s)`` their global positions;
    ``block_tables`` ``(S, max_blocks)`` physical block ids; ``write_mask``
    ``(S, s)`` True where the token is real (False rows write scratch, and
    their logits are garbage the caller ignores).  Writes the pool in place;
    returns ``(logits (S, s, vocab), cache)``."""
    L = block_tables.shape[1] * block_size
    positions = positions.clamp(0, min(lm.max_seq, L) - 1)
    h = lm.embed(tokens)
    if lm.pos_embedding == "learned":
        h = h + lm.pos[0][positions]
    for blk, c in zip(lm.blocks, cache):
        h = h + _paged_attention(blk.attn, blk.ln1(h), c["k"], c["v"], block_tables,
                                 positions, write_mask, block_size)
        h = h + blk.mlp_or_moe(blk.ln2(h))
    return lm.ln(h) @ lm.embed.table.T, cache
