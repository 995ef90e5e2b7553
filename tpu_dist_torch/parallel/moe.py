"""Expert parallelism: a mixture-of-experts MLP with one expert per rank,
tokens dispatched with all_to_all.  The port of `tpu_dist.parallel.moe`.

Top-1 routing (Switch Transformer), capacity-bounded:

1. every rank routes its own tokens: ``argmax(x @ gate_w)`` picks an
   expert, the softmax gives the combine weight;
2. tokens are packed into an ``(n_experts, capacity, d)`` dispatch buffer
   (slot = running count within the expert; tokens past the capacity are
   dropped, and the stats say how many);
3. one ``all_to_all`` sends row e of every rank to rank e, the expert's
   owner, which runs its expert MLP on every token that arrives;
4. a second ``all_to_all`` sends the results back, and each token takes
   its output scaled by its gate (a dropped token takes zeros, so the layer
   is used residually).

`moe_mlp_top2` routes every token to its two best experts (GShard) over
the same transport and reports the balance loss; `moe_mlp_expert_choice`
lets every expert pick its tokens over the whole batch.  The world is the
process group's (`comm.world_size`, `comm.rank`): the expert axis is the
world, one expert per rank.  Both collectives carry gradients, so a loss
through these layers trains every expert and the router.

Everything is static-shaped.  The dispatch buffer is written without
accumulation, each kept token into a slot of its own, so the result is
deterministic on the card; the combine gathers from the same unique
indices.  Ties between router probabilities go to the lower expert index,
as ``lax.top_k`` puts them (`top_k`).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from tpu_dist_torch.comm.collectives import all_gather, all_to_all, rank, world_size


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU, which ``jax.nn.gelu`` computes."""
    return F.gelu(x, approximate="tanh")


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis and their indices, largest
    first and equal entries by lower index first, as ``lax.top_k`` (a stable
    descending sort: ``torch.topk`` promises no order among ties)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


def capacity_for(tokens_per_rank: int, n_experts: int, factor: float = 1.25) -> int:
    """Per-expert, per-source-rank slot count."""
    return max(1, math.ceil(tokens_per_rank / n_experts * factor))


def _dispatch_process_combine(xv, assign, gate, w_up, w_down, cap, activation):
    """The shared MoE transport: pack ``(R, d)`` virtual tokens into the
    ``(n, cap, d)`` dispatch buffer (slots by running count, overflow
    dropped), send it with one all_to_all each way, run this rank's expert
    MLP, and return each virtual token's gated output (zeros when dropped),
    the kept mask and the per-expert load."""
    n = world_size()
    R, d = xv.shape
    onehot = F.one_hot(assign, n)  # (R, n) int64
    pos = torch.cumsum(onehot, dim=0) * onehot - 1
    pos_in_expert = pos.max(dim=1).values  # (R,)
    kept = pos_in_expert < cap
    load = onehot.sum(dim=0)

    # Row e * cap + slot of the flat buffer holds a kept token; dropped
    # token i writes row n * cap + i, past the buffer, so every row is
    # written at most once and no write accumulates.
    scratch = n * cap + torch.arange(R, device=xv.device)
    row = torch.where(kept, assign * cap + pos_in_expert, scratch)
    flat = xv.new_zeros((n * cap + R, d)).index_put((row,), xv)
    dispatch = flat[: n * cap].reshape(n, cap, d)

    arriving = all_to_all(dispatch, split_axis=0, concat_axis=0)
    hidden = activation(arriving.reshape(n * cap, d) @ w_up)
    processed = (hidden @ w_down).reshape(n, cap, d)
    returned = all_to_all(processed, split_axis=0, concat_axis=0)

    # the same rows back: a dropped token reads a row of zeros
    padded = torch.cat([returned.reshape(n * cap, d), returned.new_zeros((R, d))])
    yv = padded[row] * gate[:, None]
    return yv, kept, load


def moe_mlp(
    x: torch.Tensor,
    gate_w: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    capacity_factor: float = 1.25,
    activation=_gelu,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Top-1 MoE MLP over the world.

    Args:
      x: this rank's tokens ``(T, d)``.
      gate_w: the router ``(d, n_experts)``, the same on every rank.
      w_up, w_down: THIS rank's expert, ``(d, hidden)`` and ``(hidden, d)``
        (row ``rank`` of the expert-stacked weights).

    Returns ``(y, stats)``: ``y (T, d)``, the gated expert outputs (zeros
    for dropped tokens), and the routing stats ``dropped_fraction`` and
    ``local_load`` (tokens of this rank routed to each expert)."""
    n = world_size()
    T, _ = x.shape
    cap = capacity_for(T, n, capacity_factor)
    scores = x @ gate_w  # (T, n)
    probs = torch.softmax(scores, dim=-1)
    assign = scores.argmax(dim=-1)  # the first of equal maxima, as jnp.argmax
    gate = probs.gather(1, assign[:, None])[:, 0]
    y, kept, load = _dispatch_process_combine(x, assign, gate, w_up, w_down, cap, activation)
    return y, {"dropped_fraction": (~kept).float().mean(), "local_load": load}


def moe_mlp_top2(
    x: torch.Tensor,
    gate_w: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    capacity_factor: float = 2.0,
    activation=_gelu,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Top-2 MoE MLP (GShard) over the world.

    Each token goes to its two most probable experts, the combine weights
    renormalized over the pair (``g1 + g2 = 1``).  The two placements are
    packed as ``2T`` virtual tokens, every first choice before every second,
    so first choices win the capacity, through the transport of `moe_mlp`.
    The default ``capacity_factor`` is doubled to hold the second copies.

    ``stats`` also holds ``balance_loss``, the load-balancing auxiliary
    ``n * sum_e f_e * P_e`` (``f_e``: the fraction of tokens whose FIRST
    choice is e, which carries no gradient; ``P_e``: the mean router
    probability), 1.0 at perfect balance."""
    n = world_size()
    T, _ = x.shape
    cap = capacity_for(T, n, capacity_factor)
    probs = torch.softmax(x @ gate_w, dim=-1)
    top2_p, top2_e = top_k(probs, 2)  # (T, 2)
    gates = top2_p / top2_p.sum(-1, keepdim=True).clamp(min=1e-9)

    assign = torch.cat([top2_e[:, 0], top2_e[:, 1]])  # (2T,)
    gate = torch.cat([gates[:, 0], gates[:, 1]])
    yv, kept, load = _dispatch_process_combine(
        torch.cat([x, x]), assign, gate, w_up, w_down, cap, activation)
    y = yv[:T] + yv[T:]

    f = F.one_hot(top2_e[:, 0], n).float().mean(dim=0)
    balance = n * torch.sum(f * probs.mean(dim=0))
    stats = {"dropped_fraction": (~kept).float().mean(), "local_load": load,
             "balance_loss": balance}
    return y, stats


def moe_mlp_expert_choice(
    x: torch.Tensor,
    gate_w: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    capacity_factor: float = 2.0,
    activation=_gelu,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Expert-choice MoE MLP (Zhou et al. 2022): the EXPERTS pick their
    tokens.  Each expert takes its top ``C = T * capacity_factor`` tokens
    over the global batch by router probability (clamped to the ``n * T``
    tokens there are), so every expert is balanced by construction; a
    token no expert picked contributes zero.

    The competition conditions every token's routing on the whole batch,
    future positions included: this layer is for encoders, and
    `TransformerLM(moe_experts=)` routes top-2 instead.

    Wire: an all_gather of the (T, n) probabilities, the same global top-C
    on every rank; one all_to_all sends each rank's slots of every expert's
    pick to the expert (non-owned slots are zero, summed on arrival); the
    expert runs on its (C, d) pick; one all_gather returns every expert's
    outputs and each rank combines its own tokens by the router's gate.

    Stats: ``local_pick_count``, the picks of this rank's tokens, and
    ``mean_experts_per_token`` over this rank's tokens."""
    n, r = world_size(), rank()
    T, d = x.shape
    cap = max(1, min(int(T * capacity_factor), n * T))

    probs = torch.softmax(x @ gate_w, dim=-1)  # (T, n)
    probs_g = all_gather(probs, axis=0, tiled=True)  # (n * T, n), the same everywhere
    top_w, top_idx = top_k(probs_g.T, cap)  # (n, cap): expert e's picks

    # this rank owns global tokens [r * T, (r + 1) * T)
    mine = top_idx // T == r
    local_tok = (top_idx - r * T).clamp(0, T - 1)
    dispatch = torch.where(mine[:, :, None], x[local_tok], 0.0)  # (n, cap, d)
    arriving = all_to_all(dispatch, split_axis=0, concat_axis=0)
    picked = arriving.reshape(n, cap, d).sum(dim=0)  # each slot filled by one rank

    out_local = activation(picked @ w_up) @ w_down  # (cap, d)
    out_all = all_gather(out_local, axis=0)  # (n, cap, d), rows as top_idx

    flat_idx = top_idx.reshape(-1)
    in_mine = (flat_idx >= r * T) & (flat_idx < (r + 1) * T)
    local_ids = (flat_idx - r * T).clamp(0, T - 1)
    weighted = top_w.reshape(-1, 1) * out_all.reshape(n * cap, d)
    y = x.new_zeros((T, d)).index_add(0, local_ids, torch.where(in_mine[:, None], weighted, 0.0))
    cover = x.new_zeros((T,), dtype=torch.float32).index_add(0, local_ids, in_mine.float())
    return y, {"local_pick_count": mine.sum(), "mean_experts_per_token": cover.mean()}


def stack_expert_params(experts: list[Any]) -> Any:
    """Stack per-expert parameter trees (dicts, lists, tuples of tensors or
    arrays) on a new leading axis, leaf by leaf."""
    first = experts[0]
    if isinstance(first, dict):
        return {k: stack_expert_params([e[k] for e in experts]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_expert_params([e[i] for e in experts])
                           for i in range(len(first)))
    return torch.stack([torch.as_tensor(e) for e in experts])
