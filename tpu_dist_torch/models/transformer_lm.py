"""Decoder-only transformer LM, as `tpu_dist.models.transformer_lm`.

Token embedding, learned or rotary positions, pre-norm causal blocks
(`EncoderBlock`), a final layer norm and the weight-tied head
``h @ table.T``.  Parameter names follow the JAX tree with dots:
``embed.table``, ``blocks.3.attn.qkv.w``, ``ln.scale``, ``pos``.  With
``TPU_DIST_FLASH=1`` every block's attention runs the flash kernels.

Also here: the next-token loss `lm_loss`, the seeded Markov-chain corpus
`synthetic_tokens` (the same numpy stream as the JAX package, bit for bit)
and `lm_perplexity`.

Inference: `init_cache` and `apply_cached` (the new tokens' keys and values
written in place into a static-shape cache), `generate` (one multi-token
prefill, then a Python loop of single-token steps; greedy, or a draw
``argmax(masked logits + Gumbel noise)`` whose noise comes from an explicit
``torch.Generator``) and `generate_beam`.

Mixture of experts: ``moe_experts=E`` (0, or at least 2) swaps every
block's MLP for a top-2 MoE (`models.vit.MoE`: ``moe.gate``, ``moe.up``,
``moe.down``).  The forward, cached decode and the paged pool evaluate it
densely (every expert on every token, no capacity bound); `apply_moe_ep`
and `loss_moe_ep` run it expert-parallel, one expert per rank, tokens
dispatched by all_to_all (`parallel.moe_mlp_top2`), which
``LMTrainer(moe=True)`` trains.

Sequence parallelism: `apply_seq_parallel` runs the blocks on this rank's
shard of the sequence with the attention core sharded over a group (the
K/V ring, `parallel.ring_attention`, with ``flash=True`` its flash blocks;
or ``attention="ulysses"``, `parallel.ulysses_attention`), and
`lm_loss_seq_parallel` is the next-token loss across the shards'
boundaries; ``LMTrainer(sequence_parallel="ring"|"ulysses")`` trains them.
`generate_seq_parallel` decodes after a sequence-sharded prompt whose K/V
stay sharded (context-parallel decode).  The tensor- and pipeline-parallel
forms are not ported yet (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_dist_torch import nn
from tpu_dist_torch.comm.collectives import (
    Group,
    ReduceOp,
    all_reduce,
    rank,
    sendrecv,
    world_size,
)
from tpu_dist_torch.models.vit import EncoderBlock
from tpu_dist_torch.parallel.moe import moe_mlp_top2


class TransformerLM(torch.nn.Module):
    def __init__(
        self,
        *,
        vocab: int = 256,
        dim: int = 128,
        depth: int = 4,
        heads: int = 4,
        max_seq: int = 1024,
        kv_heads: int | None = None,
        pos_embedding: str = "learned",
        remat: bool = False,
        moe_experts: int = 0,
        moe_capacity_factor: float = 2.0,
        moe_balance_weight: float = 0.01,
        sliding_window: int | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if pos_embedding not in ("learned", "rope"):
            raise ValueError(
                f"pos_embedding must be 'learned' or 'rope', got {pos_embedding!r}"
            )
        if moe_experts < 0 or moe_experts == 1:
            raise ValueError(
                f"moe_experts must be 0 (dense MLP) or >= 2 (top-2 routing), got "
                f"{moe_experts}"
            )
        self.moe_experts = moe_experts
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_balance_weight = moe_balance_weight
        self.vocab = vocab
        self.dim = dim
        self.heads = heads
        self.kv_heads = heads if kv_heads is None else kv_heads
        self.max_seq = max_seq
        self.pos_embedding = pos_embedding
        self.sliding_window = sliding_window
        # Recompute each block's forward during backward: activation memory
        # O(B*S*d) instead of O(depth*B*S*d), for one more forward.
        self.remat = remat
        self.embed = nn.Embedding(vocab, dim, generator=generator)
        self.blocks = torch.nn.ModuleList(
            EncoderBlock(
                dim, heads, causal=True, kv_heads=kv_heads,
                use_rope=pos_embedding == "rope", sliding_window=sliding_window,
                moe_experts=moe_experts, generator=generator,
            )
            for _ in range(depth)
        )
        self.ln = nn.LayerNorm(dim)
        if pos_embedding == "learned":
            self.pos = torch.nn.Parameter(
                torch.randn(1, max_seq, dim, generator=generator) * 0.02
            )

    def _trunk(self, tokens: torch.Tensor, pos_offset=0) -> torch.Tensor:
        h = self.embed(tokens)
        if self.pos_embedding == "learned":
            # lax.dynamic_slice's clamp: the window always lies inside the table
            s = tokens.shape[1]
            if isinstance(pos_offset, int):
                start = max(0, min(pos_offset, self.max_seq - s))
                h = h + self.pos[:, start : start + s]
            else:  # a 0-d tensor: no host value in a decode step
                start = pos_offset.clamp(0, self.max_seq - s)
                h = h + self.pos[0, start + torch.arange(s, device=h.device)]
        # rope: positions enter inside attention (q/k rotation), not here
        return h

    def forward(
        self, tokens: torch.Tensor, attn_mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        """(batch, seq) int tokens -> (batch, seq, vocab) logits.
        ``attn_mask``: a key-padding mask (b, s), True = real token, or a
        full (..., s, s) mask, combined with the causal mask in every
        block."""
        h = self._trunk(tokens)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(blk, h, attn_mask, use_reentrant=False)
            else:
                h = blk(h, attn_mask)
        h = self.ln(h)
        return h @ self.embed.table.T

    def apply_moe_ep(self, tokens_local: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Expert-parallel forward: each rank holds its share of the batch
        (attention is per sample, so the split is exact) and owns one
        expert per block, row ``rank`` of the replicated ``up`` and
        ``down``; every MoE layer dispatches its tokens to their routed
        experts with one all_to_all each way (`parallel.moe_mlp_top2`).
        Requires ``moe_experts == world size``.  With the parameters
        replicated, the gradient is the uniform mean over ranks: a shared
        parameter's gradient is each rank's own, an expert's is nonzero on
        its owner alone, and the mean divides both by the world.

        Returns ``(logits_local, balance)``, the mean GShard balance loss
        over blocks, whose gradient reaches the routers."""
        n = world_size()
        if self.moe_experts != n:
            raise ValueError(
                f"moe_experts {self.moe_experts} != expert-axis size {n} (one expert "
                "per rank)"
            )
        r = rank()
        b, s = tokens_local.shape
        h = self._trunk(tokens_local)
        balances = []
        for blk in self.blocks:
            h = h + blk.attn(blk.ln1(h))
            moe = blk.moe
            y, stats = moe_mlp_top2(blk.ln2(h).reshape(b * s, self.dim), moe.gate, moe.up[r],
                                    moe.down[r], capacity_factor=self.moe_capacity_factor)
            h = h + y.reshape(b, s, self.dim)
            balances.append(stats["balance_loss"])
        return self.ln(h) @ self.embed.table.T, torch.stack(balances).mean()

    def loss_moe_ep(self, tokens_local: torch.Tensor) -> torch.Tensor:
        """Expert-parallel training loss: the local next-token loss plus
        ``moe_balance_weight`` times the mean balance loss.  Its mean over
        ranks is the global batch's loss."""
        logits, balance = self.apply_moe_ep(tokens_local)
        return lm_loss(logits.float(), tokens_local) + self.moe_balance_weight * balance

    def apply_seq_parallel(self, tokens_local: torch.Tensor, group: Group | None = None, *,
                           flash: bool = False, attention: str = "ring") -> torch.Tensor:
        """Sequence-parallel forward: ``tokens_local`` ``(b, s_local)`` is
        this rank's shard of the sequence, split over ``group`` in member
        order (the world without one); returns its ``(b, s_local, vocab)``
        logits, those of the dense `forward` on the gathered sequence at
        this shard's positions.  The same parameters as `forward`; only
        attention talks to the other ranks: ``attention="ring"`` rotates
        K/V blocks around the group (``flash=True``: each block on the
        flash forward, `parallel.ring_attention_flash`), ``"ulysses"``
        reshards heads by all_to_all, its local attention routed to the
        flash kernels by ``TPU_DIST_FLASH``."""
        from tpu_dist_torch.parallel.ring_attention import check_core, sharded_attention

        if self.kv_heads != self.heads:
            raise ValueError(
                "apply_seq_parallel requires kv_heads == heads (the ring attention core uses "
                "the fused-QKV layout)"
            )
        check_core(attention, flash, self.sliding_window)
        n = world_size(group)
        s_local = tokens_local.shape[1]
        if n * s_local > self.max_seq:
            raise ValueError(
                f"global sequence {n} ranks x {s_local} tokens = {n * s_local} exceeds "
                f"max_seq {self.max_seq} — the positional table would silently clamp"
            )
        h = self._trunk(tokens_local, pos_offset=rank(group) * s_local)
        for blk in self.blocks:
            h = h + sharded_attention(blk.attn, blk.ln1(h), group, core=attention,
                                      use_flash=flash)
            h = h + blk.mlp_or_moe(blk.ln2(h))
        return self.ln(h) @ self.embed.table.T

    # ---- context-parallel decode (a sequence-sharded prompt cache) -------

    def _project_qkv(self, attn, x: torch.Tensor, positions: torch.Tensor):
        """The fused-QKV projection of ``x`` (b, s, dim) and rope at the
        GLOBAL ``positions``: q, k, v each (b, heads, s, head_dim)."""
        q, k, v = attn._project(x)
        if self.pos_embedding == "rope":
            q, k = nn.rope(q, positions), nn.rope(k, positions)
        return q, k, v

    @torch.no_grad()
    def generate_seq_parallel(
        self,
        prompt_local,
        steps: int,
        group: Group | None = None,
        *,
        generator: torch.Generator | None = None,
        seed: int | None = None,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
    ) -> torch.Tensor:
        """Decode ``steps`` tokens after a sequence-sharded prompt:
        ``prompt_local`` ``(b, s_local)`` is this rank's shard, split over
        ``group`` in member order.  Context-parallel serving: a prompt too
        long for one card's KV cache keeps its K/V sharded, 1/n a rank, for
        the whole decode.

        Prefill: `apply_seq_parallel`'s blocks on the ring core, keeping
        each block's local K/V; the last global position's logits reach
        every rank by one all_reduce.  Decode: each new token is computed
        on every rank; each rank scores it against its prompt shard, and
        the shards' partials merge exactly by their log-sum-exp (an
        all_reduce MAX of the lse, then SUM of the weighted numerators and
        of the weights) with a replicated cache of the generated tokens.
        Sampling is `generate`'s, with the noise from ``generator`` (or one
        on the model's device seeded with ``seed``, 0 by default), so every
        rank seeded alike draws the same token.  Returns ``(b, steps)``
        tokens in the prompt's integer dtype on every rank."""
        from tpu_dist_torch.parallel.ring_attention import NEG_INF, ring_attention
        from tpu_dist_torch.serve import sampling

        if self.sliding_window is not None:
            raise ValueError(
                "generate_seq_parallel does not support sliding_window yet — context-parallel "
                "decode computes the full causal mask; use dense generate() or "
                "generate_tensor_parallel()"
            )
        if self.kv_heads != self.heads:
            raise ValueError("generate_seq_parallel requires kv_heads == heads (fused-QKV layout)")
        n, r = world_size(group), rank(group)
        device = self.embed.table.device
        prompt_local = torch.as_tensor(prompt_local, device=device)
        b, s_l = prompt_local.shape
        S = n * s_l  # the global prompt's length
        if S + steps > self.max_seq:
            raise ValueError(f"prompt {S} + steps {steps} exceeds max_seq {self.max_seq}")
        sample = _make_sampler(temperature, top_k, top_p)
        noisy = temperature != 0.0
        if noisy and generator is None:
            generator = torch.Generator(device).manual_seed(0 if seed is None else seed)

        # prefill: the ring, keeping each block's local K/V
        h = self._trunk(prompt_local, pos_offset=r * s_l)
        pos_local = r * s_l + torch.arange(s_l, device=device)
        prompt_cache = []
        for blk in self.blocks:
            q, k, v = self._project_qkv(blk.attn, blk.ln1(h), pos_local)
            o = ring_attention(q, k, v, group, causal=True)
            h = h + blk.attn.out(o.transpose(1, 2).reshape(b, s_l, self.dim))
            h = h + blk.mlp_or_moe(blk.ln2(h))
            prompt_cache.append((k.float(), v.float()))
        last = self.ln(h)[:, -1] @ self.embed.table.T
        # the last global position lives on the last member
        last = all_reduce(last if r == n - 1 else torch.zeros_like(last), group=group)

        # decode: a replicated cache of the generated tokens
        hd = self.dim // self.heads
        dt = self.embed.table.dtype
        dec_cache = [torch.zeros((2, b, self.heads, steps, hd), dtype=dt, device=device)
                     for _ in self.blocks]
        slots = torch.arange(steps, device=device)
        out = torch.empty((b, steps), dtype=prompt_local.dtype, device=device)
        for t in range(steps):
            noise = sampling.gumbel(last.shape, last.dtype, generator) if noisy else None
            tok = sample(last, noise).to(prompt_local.dtype)
            out[:, t] = tok
            if t + 1 == steps:
                break  # the next token's logits would go unused
            hh = self._trunk(tok[:, None], pos_offset=S + t)
            pos = torch.tensor([S + t], device=device)
            for blk, (pk, pv), dc in zip(self.blocks, prompt_cache, dec_cache):
                q, k_new, v_new = self._project_qkv(blk.attn, blk.ln1(hh), pos)
                dc[0, :, :, t] = k_new[:, :, 0]
                dc[1, :, :, t] = v_new[:, :, 0]
                qs = (q * hd**-0.5).float()
                # this rank's prompt shard
                lg_p = qs @ pk.transpose(-1, -2)
                m_p = lg_p.amax(-1)
                p_p = torch.exp(lg_p - m_p[..., None])
                l_p = p_p.sum(-1)
                out_p = (p_p @ pv) / l_p[..., None]
                lse_p = m_p + torch.log(l_p)
                # the generated window, positions <= t
                lg_d = qs @ dc[0].float().transpose(-1, -2)
                valid = slots <= t
                lg_d = torch.where(valid, lg_d, NEG_INF)
                m_d = lg_d.amax(-1)
                p_d = torch.where(valid, torch.exp(lg_d - m_d[..., None]), 0.0)
                l_d = p_d.sum(-1)
                out_d = (p_d @ dc[1].float()) / l_d.clamp(min=1e-30)[..., None]
                lse_d = m_d + torch.log(l_d.clamp(min=1e-30))
                # exact merge: the prompt partials summed over the group (the
                # numerator and the weight in one call), the window's (the
                # same on every rank) added once
                m_star = torch.maximum(all_reduce(lse_p.clone(), ReduceOp.MAX, group=group),
                                       lse_d)
                w_p = torch.exp(lse_p - m_star)[..., None]
                w_d = torch.exp(lse_d - m_star)[..., None]
                summed = all_reduce(torch.cat([w_p * out_p, w_p], dim=-1), group=group)
                num = summed[..., :-1] + w_d * out_d
                den = summed[..., -1:] + w_d
                o = (num / den).to(hh.dtype)
                hh = hh + blk.attn.out(o.transpose(1, 2).reshape(b, 1, self.dim))
                hh = hh + blk.mlp_or_moe(blk.ln2(hh))
            last = self.ln(hh)[:, 0] @ self.embed.table.T
        return out

    # ---- autoregressive inference (KV cache) ----------------------------

    def init_cache(self, batch: int, cache_len: int | None = None, dtype=None,
                   device=None) -> list[dict[str, torch.Tensor]]:
        """Static-shape KV cache: one ``{"k", "v"}`` pair per block, each
        ``(batch, kv_heads, cache_len, head_dim)`` zeros, in the embedding
        table's dtype and on its device unless given."""
        table = self.embed.table
        shape = (batch, self.kv_heads, cache_len or self.max_seq, self.dim // self.heads)
        kw = dict(dtype=dtype or table.dtype, device=device or table.device)
        return [{"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
                for _ in self.blocks]

    def apply_cached(self, tokens: torch.Tensor, cache: list, index):
        """Forward ``tokens`` ``(b, s)``, new tokens at global positions
        ``index .. index + s - 1`` (an int or a 0-d integer tensor), against
        and into ``cache`` (written in place).  Returns ``(logits (b, s,
        vocab), cache)``."""
        h = self._trunk(tokens, pos_offset=index)
        for blk, c in zip(self.blocks, cache):
            o, c["k"], c["v"] = blk.attn.apply_cached(blk.ln1(h), c["k"], c["v"], index)
            h = h + o
            h = h + blk.mlp_or_moe(blk.ln2(h))
        return self.ln(h) @ self.embed.table.T, cache

    def _check_room(self, s_p: int, steps: int, cache_len: int | None) -> int:
        L = cache_len or self.max_seq
        if s_p + steps > L:
            raise ValueError(f"prompt {s_p} + steps {steps} exceeds cache length {L}")
        return L

    @torch.no_grad()
    def generate(
        self,
        prompt,
        steps: int,
        *,
        generator: torch.Generator | None = None,
        seed: int | None = None,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        cache_len: int | None = None,
        stop_token: int | None = None,
        sampler=None,
    ) -> torch.Tensor:
        """Sample ``steps`` tokens after ``prompt`` ``(b, s_prompt)``: one
        multi-token prefill, then one single-token step at a time against
        the static cache, every step the same tensors, so that on the card
        the step runs as one CUDA graph (`device.Replay`), as the JAX
        package's decode is one compiled program.  Returns ``(b, steps)``
        tokens in the prompt's integer dtype, on the model's device.

        ``temperature=0`` is greedy argmax.  Otherwise each step draws
        Gumbel noise ``(b, vocab)`` in the logits' dtype from ``generator``
        (or a generator on the model's device seeded with ``seed``, 0 by
        default), shared by every stream of the batch, and takes
        ``argmax(masked logits / temperature + noise)``, ``top_k`` and
        ``top_p`` masking the tail as `serve.sampling.sample_logits` does.
        ``stop_token``: a stream that emits it keeps emitting it.
        ``sampler``: ``(logits, noise) -> tokens`` in place of the sampling
        arguments (on the card it runs inside the graph: it must not
        synchronise); noise is then drawn every step."""
        from tpu_dist_torch.device import Replay
        from tpu_dist_torch.serve import sampling

        device = self.embed.table.device
        prompt = torch.as_tensor(prompt, device=device)
        b, s_p = prompt.shape
        L = self._check_room(s_p, steps, cache_len)
        sample = sampler or _make_sampler(temperature, top_k, top_p)
        noisy = sampler is not None or temperature != 0.0
        if noisy and generator is None:
            generator = torch.Generator(device).manual_seed(0 if seed is None else seed)
        cache = self.init_cache(b, L)
        logits, cache = self.apply_cached(prompt, cache, 0)
        # the step's state: every step reads and writes these same tensors
        last = logits[:, -1].clone()
        noise = torch.zeros_like(last) if noisy else None
        out = torch.empty((b, steps), dtype=prompt.dtype, device=device)
        done = torch.zeros(b, dtype=torch.bool, device=device)
        index = torch.tensor(s_p, device=device)  # the position the step feeds

        def step():
            tok = sample(last, noise).to(prompt.dtype)
            if stop_token is not None:
                tok = torch.where(done, stop_token, tok)
                done.logical_or_(tok == stop_token)
            out.index_copy_(1, (index - s_p).reshape(1), tok[:, None])
            # the last step's forward is wasted, as the JAX package's scan's
            logits, _ = self.apply_cached(tok[:, None], cache, index)
            last.copy_(logits[:, 0])
            index.add_(1)

        run = Replay(step, device)
        for _ in range(steps):
            if noisy:
                noise.copy_(sampling.gumbel(last.shape, last.dtype, generator))
            run()
        return out

    @torch.no_grad()
    def generate_beam(self, prompt, steps: int, *, beams: int = 4,
                      cache_len: int | None = None, return_all: bool = False):
        """Beam search: keep the ``beams`` continuations of highest total
        log-probability at every step (ties to the lower index, as
        ``lax.top_k``).  One prefill, the cache repeated ``beams``-fold, then
        each step re-gathers the cache and the token history under the
        surviving beams.  Returns the best beam's tokens ``(b, steps)``, or
        with ``return_all`` ``(tokens (b, beams, steps), scores (b, beams))``
        best first.  ``beams=1`` is greedy `generate`."""
        if beams < 1:
            raise ValueError(f"beams must be >= 1, got {beams}")
        device = self.embed.table.device
        prompt = torch.as_tensor(prompt, device=device)
        b, s_p = prompt.shape
        L = self._check_room(s_p, steps, cache_len)
        k = beams
        logits, cache = self.apply_cached(prompt, self.init_cache(b, L), 0)
        cache = [{n: t.repeat_interleave(k, 0) for n, t in c.items()} for c in cache]
        last = logits[:, -1].repeat_interleave(k, 0)  # (b*k, V): rows b0 x k, b1 x k, ...
        V = last.shape[-1]
        # beam 0 live, the others at -1e30: step 0 picks k distinct tokens
        scores = torch.full((b, k), -1e30, device=device)
        scores[:, 0] = 0.0
        toks = torch.zeros((b, k, steps), dtype=prompt.dtype, device=device)
        base = torch.arange(b, device=device)[:, None] * k
        for t in range(steps):
            logp = torch.log_softmax(last.float(), dim=-1).reshape(b, k, V)
            total = (scores[:, :, None] + logp).reshape(b, k * V)
            order = torch.sort(total, dim=-1, descending=True, stable=True)
            scores, top_idx = order.values[:, :k], order.indices[:, :k]
            beam_idx = top_idx // V  # (b, k) surviving parent beams
            tok = (top_idx % V).to(prompt.dtype)
            toks = torch.take_along_dim(toks, beam_idx[:, :, None], dim=1)
            toks[:, :, t] = tok
            if t + 1 < steps:
                flat = (base + beam_idx).reshape(-1)
                cache = [{n: x[flat] for n, x in c.items()} for c in cache]
                logits, cache = self.apply_cached(tok.reshape(b * k, 1), cache, s_p + t)
                last = logits[:, 0]
        order = torch.argsort(-scores, dim=1, stable=True)
        toks = torch.take_along_dim(toks, order[:, :, None], dim=1)
        scores = torch.take_along_dim(scores, order, dim=1)
        return (toks, scores) if return_all else toks[:, 0]


def _make_sampler(temperature: float, top_k: int | None, top_p: float | None):
    """`generate`'s draw for fixed sampling arguments: ``(logits, noise) ->
    tokens``, greedy at ``temperature=0``."""
    from tpu_dist_torch.serve import sampling

    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    k = 0 if top_k is None else top_k
    p = 1.0 if top_p is None else top_p
    return lambda logits, noise: sampling.sample_logits(logits, noise, temperature, k, p)


def lm_loss(
    logits: torch.Tensor, tokens: torch.Tensor, *, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Next-token cross-entropy: predict tokens[:, 1:] from positions
    [:, :-1], with a float32 log-softmax.  ``mask``: (b, s) boolean of real
    tokens; a position counts when its target is real, and the mean is
    over counted positions."""
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    picked = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    if mask is None:
        return -picked.mean()
    w = mask[:, 1:].float()
    return -(picked * w).sum() / w.sum().clamp(min=1.0)


def lm_loss_seq_parallel(logits_local: torch.Tensor, tokens_local: torch.Tensor,
                         group: Group | None = None) -> torch.Tensor:
    """Next-token loss over sequence shards, across their boundaries: the
    target of a shard's last position is the right neighbour's first token,
    which every shard sends left (one `comm.sendrecv` of ``(b, 1)`` tokens);
    the last global position has none and is left out.  Normalised so that
    the mean over the group's ranks is the dense `lm_loss` on the gathered
    sequence, with a float32 log-softmax."""
    n, r = world_size(group), rank(group)
    b, s_local, _ = logits_local.shape
    from_right = sendrecv(tokens_local[:, :1].contiguous(),
                          [(i, (i - 1) % n) for i in range(n)], group)
    targets = torch.cat([tokens_local[:, 1:], from_right], dim=1)
    logp = F.log_softmax(logits_local.float(), dim=-1)
    picked = logp.gather(-1, targets[..., None].long())[..., 0]
    if r == n - 1:  # the last global position has no target
        picked = picked[:, :-1]
    total_positions = n * s_local - 1
    return -picked.sum() / (b * total_positions / n)


def markov_table(vocab: int = 256, *, seed: int = 0) -> np.ndarray:
    """The transition table behind `synthetic_tokens`:
    ``next_token = table[token]``."""
    return np.random.default_rng(seed).permutation(vocab)


def synthetic_tokens(n: int, seq: int, vocab: int = 256, *, seed: int = 0) -> torch.Tensor:
    """(n, seq) int32 token streams of a seeded Markov chain whose every
    next-token distribution is a delta (see `markov_table`); the same
    numbers as the JAX package's."""
    rng = np.random.default_rng(seed)
    table = rng.permutation(vocab)
    starts = rng.integers(0, vocab, size=n)
    out = np.empty((n, seq), np.int32)
    out[:, 0] = starts
    for t in range(1, seq):
        out[:, t] = table[out[:, t - 1]]
    return torch.from_numpy(out)


@torch.no_grad()
def lm_perplexity(lm: TransformerLM, tokens, *, batch: int = 64) -> tuple[float, float]:
    """Token-weighted mean next-token loss and perplexity over (N, S)
    tokens, on the device of ``lm``'s parameters.  Returns
    ``(mean_loss, exp(mean_loss))``."""
    tokens = torch.as_tensor(np.asarray(tokens))
    n, s = tokens.shape
    if n == 0:
        raise ValueError("empty token array")
    device = next(lm.parameters()).device
    total, weight = 0.0, 0
    for i in range(0, n, batch):
        chunk = tokens[i : i + batch].to(device)
        loss = lm_loss(lm(chunk), chunk).item()
        w = chunk.shape[0] * (s - 1)
        total += loss * w
        weight += w
    mean = total / weight
    return mean, math.exp(mean)
