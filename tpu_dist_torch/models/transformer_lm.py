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
``torch.Generator``) and `generate_beam`.  The tensor-, sequence-, pipeline-
and MoE-parallel forms are not ported yet (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_dist_torch import nn
from tpu_dist_torch.models.vit import EncoderBlock


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
        sliding_window: int | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if pos_embedding not in ("learned", "rope"):
            raise ValueError(
                f"pos_embedding must be 'learned' or 'rope', got {pos_embedding!r}"
            )
        if moe_experts:
            raise NotImplementedError(
                "moe_experts > 0 is not ported yet (ROADMAP queue 1, item 10: the "
                "parallel strategies, with parallel/moe.py)"
            )
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
                generator=generator,
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
            h = h + blk.mlp(blk.ln2(h))
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
