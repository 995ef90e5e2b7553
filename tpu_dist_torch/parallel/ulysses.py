"""Ulysses-style sequence parallelism: the port of `tpu_dist.parallel.ulysses`.

Each rank of a sequence group holds a shard of the sequence.  An
all-to-all turns the sequence-sharded q, k and v into head-sharded ones,
every rank runs ordinary full-sequence attention over its share of the
heads, and a second all-to-all restores the sequence sharding: two
exchanges each way, and the attention itself unchanged.  So under
``TPU_DIST_FLASH=1`` the local attention runs the flash kernels by the
rule every attention call follows (`nn.dot_product_attention`).
"""

from __future__ import annotations

import torch

from tpu_dist_torch.comm.collectives import Group, all_to_all, world_size
from tpu_dist_torch.nn.attention import dot_product_attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group: Group | None = None, *, causal: bool = False,
                      window: int | None = None) -> torch.Tensor:
    """Attention over sequence shards by head resharding.

    ``q``, ``k``, ``v``: this rank's shards ``(batch, heads, s_local,
    head_dim)``, the sequence split over ``group`` in member order (the
    world without one); ``heads`` must divide by the group's size.  Returns
    this rank's shard of the output, equal to full attention over the
    gathered sequence."""
    n = world_size(group)
    h = q.shape[1]
    if h % n:
        raise ValueError(
            f"heads {h} not divisible by sequence-parallel world {n} — "
            f"use ring_attention for head counts below the world size"
        )

    def reshard(t):  # (b, h, s_local, d) -> (b, h/n, S, d)
        return all_to_all(t, split_axis=1, concat_axis=2, group=group)

    # every head shard holds the whole sequence, so the causal mask and the
    # window band apply as in the dense path
    o = dot_product_attention(reshard(q), reshard(k), reshard(v), causal=causal, window=window)
    return all_to_all(o, split_axis=2, concat_axis=1, group=group)  # back to (b, h, s_local, d)
