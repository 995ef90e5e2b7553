"""Sampling with runtime parameters, per call and per slot.

The counterpart of `tpu_dist.serve.sampling`.  A draw is
``argmax(masked logits + noise)``: ``jax.random.categorical``'s own formula
(``argmax(logits + gumbel(key))``), with the Gumbel noise an argument
instead of a key, so the same noise gives the same tokens in both packages.

- `sample_logits`: scalar parameters, one noise row per batch row (the
  whole batch shares one step's draw in `TransformerLM.generate`).
- `sample_slots`: per-slot ``(S,)`` temperature, top_k and top_p, the
  continuous-batching engine's sampler.
- `slot_noise`: the engine's noise, a pure function of each request's
  ``(seed, token index)`` and the vocabulary index, made by an integer hash
  in one pass for all slots: it depends neither on the slot nor on its
  neighbours.
- `gumbel`: noise from an explicit ``torch.Generator``.
- `generate_runtime`: `TransformerLM.generate` with the parameters as
  runtime values.

Disabled encodings: ``top_k <= 0`` and ``top_p >= 1.0`` mask nothing;
``temperature == 0`` is greedy argmax.
"""

from __future__ import annotations

import torch

_NEG = -1e30
_M32 = 0xFFFFFFFF


def _number(x) -> bool:
    return isinstance(x, (int, float))


def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` on the host, as ``jnp.asarray(x, dtype)``
    rounds it: a scalar parameter never becomes a tensor copied to the card
    (which a CUDA graph could not hold)."""
    return torch.tensor(x, dtype=dtype).item()


def _mask_top_k(scaled: torch.Tensor, top_k) -> torch.Tensor:
    """Keep each row's ``top_k`` highest logits (``top_k <= 0`` = off; an
    int, or a tensor of one a row).  Ties at the threshold survive (``<
    kth`` is masked, ``== kth`` is not)."""
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    if _number(top_k):
        if top_k <= 0:
            return scaled
        kth = sorted_desc[..., min(top_k, V) - 1 :][..., :1]
        return torch.where(scaled < kth, _NEG, scaled)
    top_k = top_k.broadcast_to(scaled.shape[:-1])
    kth = torch.gather(sorted_desc, -1, (top_k - 1).clamp(0, V - 1)[..., None].long())
    enabled = (top_k > 0)[..., None]
    return torch.where(enabled & (scaled < kth), _NEG, scaled)


def _mask_top_p(scaled: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus truncation at ``top_p`` (``>= 1.0`` = off; a float, or a
    tensor of one a row): drop the tail past cumulative probability
    ``top_p``; the most probable token always survives (its exclusive
    cumulative sum is 0)."""
    if _number(top_p):
        top_p = _rounded(top_p, scaled.dtype)
        if top_p >= 1.0:
            return scaled
    else:
        top_p = top_p.to(scaled.dtype).broadcast_to(scaled.shape[:-1])[..., None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs  # exclusive
    cutoff_idx = (cum < top_p).sum(-1, keepdim=True) - 1
    cutoff = torch.gather(sorted_desc, -1, cutoff_idx.clamp(0, scaled.shape[-1] - 1))
    masked = scaled < cutoff
    if not _number(top_p):
        masked &= top_p < 1.0
    return torch.where(masked, _NEG, scaled)


def _masked(logits: torch.Tensor, temperature, top_k, top_p) -> torch.Tensor:
    if _number(temperature):
        scaled = logits / (_rounded(temperature, logits.dtype) or 1.0)
    else:  # per-slot (S,) against (S, V) logits
        t = temperature.to(logits.dtype)
        scaled = logits / torch.where(t == 0, torch.ones_like(t), t)[..., None]
    return _mask_top_p(_mask_top_k(scaled, top_k), top_p)


def sample_logits(logits: torch.Tensor, noise: torch.Tensor | None, temperature,
                  top_k, top_p) -> torch.Tensor:
    """Tokens ``(b,)`` from ``(b, vocab)`` logits at scalar parameters
    (numbers, or 0-d tensors): ``argmax(logits)`` at ``temperature == 0``
    (``noise`` may then be None), else ``argmax(_masked(logits) + noise)``."""
    if _number(temperature):
        if temperature == 0:
            return logits.argmax(-1)
        return (_masked(logits, temperature, top_k, top_p) + noise).argmax(-1)
    sampled = (_masked(logits, temperature, top_k, top_p) + noise).argmax(-1)
    return torch.where(temperature == 0, logits.argmax(-1), sampled)


def sample_slots(logits: torch.Tensor, noise: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-slot draw for the serving batch: ``logits`` and ``noise``
    ``(S, vocab)``, parameters ``(S,)`` tensors.  A slot at temperature 0
    takes the argmax."""
    sampled = (_masked(logits, temperature, top_k, top_p) + noise).argmax(-1)
    return torch.where(temperature == 0, logits.argmax(-1), sampled)


def gumbel(shape, dtype: torch.dtype, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log u)``, ``u`` uniform in
    ``[tiny, 1)`` drawn in float32 from ``generator`` on its device, then
    cast to ``dtype``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(dtype)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser on int64 lanes holding values in
    ``[0, 2**32)``: shifts stay logical and each product stays below
    ``2**63``, so every step is exact on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def slot_noise(seeds: torch.Tensor, counters: torch.Tensor, vocab: int,
               device=None) -> torch.Tensor:
    """Gumbel noise ``(S, vocab)`` float32 for slots whose requests have
    ``seeds`` and token indices ``counters`` (``(S,)`` integers; a seed
    counts by its low 32 bits).  Entry ``[i, v]`` depends only on
    ``(seeds[i], counters[i], v)``: a request's stream is the same in any
    slot, beside any neighbours."""
    seeds = torch.as_tensor(seeds, device=device).long() & _M32
    counters = torch.as_tensor(counters, device=device).long() & _M32
    key = _mix32(_mix32(seeds ^ 0x6A09E667) ^ counters)[:, None]
    v = torch.arange(vocab, device=key.device, dtype=torch.int64)[None, :]
    bits = _mix32(_mix32(key ^ v) ^ 0x3C6EF372)
    u = ((bits >> 8).float() + 0.5) * 2.0**-24  # 24 bits, strictly inside (0, 1)
    return -torch.log(-torch.log(u))


def generate_runtime(lm, prompt, steps: int, *, generator: torch.Generator | None = None,
                     seed: int | None = None, temperature=0.0, top_k=0, top_p=1.0,
                     cache_len: int | None = None, stop_token: int | None = None):
    """`TransformerLM.generate` with runtime sampling parameters, entered
    through its ``sampler`` hook (``top_k=0``/``top_p=1.0`` disable the
    truncations, ``temperature=0`` is greedy).  For equal settings it gives
    `generate`'s tokens."""
    top_k = 0 if top_k is None else top_k
    top_p = 1.0 if top_p is None else top_p

    def sampler(logits, noise):
        return sample_logits(logits, noise, temperature, top_k, top_p)

    return lm.generate(prompt, steps, generator=generator, seed=seed, cache_len=cache_len,
                       stop_token=stop_token, sampler=sampler)
