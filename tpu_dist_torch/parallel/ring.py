"""Ring collectives over point-to-point messages: the tutorial's hand-rolled
all-reduce, done right.

The port of `tpu_dist.parallel.ring`, on `comm.shift` (``batch_isend_irecv``
between neighbours) in place of ``lax.ppermute``; every rank of the group
calls each function:

- `ring_all_reduce`: the naive ring, ``n - 1`` hops of the whole buffer to
  the right neighbour, each arrival added to the sum, so rank r holds
  ``x_r + x_{r-1} + ... + x_{r-n+1}`` summed in that order in ``x``'s dtype.
- `ring_reduce_scatter` and `ring_all_gather`, and their composition
  `ring_all_reduce_chunked`, the bandwidth-optimal ring: ``2 (n - 1)`` hops
  of ``size / n`` each.
"""

from __future__ import annotations

import torch

from tpu_dist_torch.comm.collectives import rank, shift, world_size


def pad_to_multiple(flat: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad a 1-D tensor so its length divides ``n``."""
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Naive ring all-reduce: each step forwards the buffer received last
    (at first the local tensor) to the right and adds what arrives from the
    left.  After ``n - 1`` steps every rank has added every contribution
    once."""
    n = world_size(group)
    acc, buf = x.clone(), x
    for _ in range(n - 1):
        buf = shift(buf, 1, group)
        acc = acc + buf
    return acc


def ring_reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Ring reduce-scatter: rank r ends with the fully reduced chunk
    ``(r + 1) % n`` of the flattened, zero-padded input, shape
    ``(ceil(size / n),)``.  At step t rank r sends chunk ``(r - t) % n`` and
    adds the arrival into chunk ``(r - t - 1) % n``."""
    n, r = world_size(group), rank(group)
    chunks = pad_to_multiple(x.reshape(-1), n).reshape(n, -1).clone()
    for t in range(n - 1):
        buf = shift(chunks[(r - t) % n], 1, group)
        recv = (r - t - 1) % n
        chunks[recv] = chunks[recv] + buf
    return chunks[(r + 1) % n]


def ring_all_gather(chunk: torch.Tensor, group=None, *, owner_offset: int = 0) -> torch.Tensor:
    """Ring all-gather: rank r starts owning chunk ``(r + owner_offset) %
    n``; after ``n - 1`` hops every rank holds every chunk, ordered by
    owner index.  Returns shape ``(n,) + chunk.shape``."""
    n, r = world_size(group), rank(group)
    out = chunk.new_zeros((n,) + tuple(chunk.shape))
    out[(r + owner_offset) % n] = chunk
    buf = chunk
    for t in range(n - 1):
        buf = shift(buf, 1, group)
        # it came from rank r - 1 - t, the owner of this chunk
        out[(r - 1 - t + owner_offset) % n] = buf
    return out


def ring_all_reduce_chunked(x: torch.Tensor, group=None) -> torch.Tensor:
    """Bandwidth-optimal ring all-reduce: reduce-scatter, then all-gather."""
    if world_size(group) == 1:
        return x.clone()
    own = ring_reduce_scatter(x, group)  # rank r owns chunk (r + 1) % n
    gathered = ring_all_gather(own, group, owner_offset=1)
    return gathered.reshape(-1)[: x.numel()].reshape(x.shape)
