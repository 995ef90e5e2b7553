"""Cached decode, generate and beam search of the port against the JAX package.

The same parameters (through `interop`) and the same inputs go through
`tpu_dist` and `tpu_dist_torch` on the CPU:

- `MultiHeadAttention.apply_cached` (MHA, GQA, rope, sliding window): the
  output and the written caches within 1e-5;
- `TransformerLM.apply_cached`: prefill and teacher-forced decode logits
  within 1e-5 of the JAX package's and of the port's own dense forward;
- greedy `generate` token for token; sampled `generate` token for token with
  the JAX package's own Gumbel noise fed in (``jax.random.gumbel`` of each
  ``split(key, steps)`` key), with and without top_k/top_p; ``top_k=1`` is
  greedy; the ``stop_token`` freeze; the overflow ``ValueError``;
- `generate_beam` tokens and scores (within 1e-5), ``beams=1`` greedy;
- the sampling masks exactly, ties planted at the thresholds;
- KV caches carried between the packages (`interop.cache_from_jax`);
- ``python -m tpu_dist_torch.demos.generate --device cpu``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import models as jax_models
from tpu_dist import nn as jax_nn
from tpu_dist import serve as jax_serve
from tpu_dist.serve import sampling as jax_sampling
from tpu_dist_torch import interop, models, nn, serve
from tpu_dist_torch.serve import sampling

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
LM = dict(vocab=64, dim=64, depth=2, heads=4, max_seq=48)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module's tiny tensors: on a busy host the
    thread pool's wake-ups cost a hundred times the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(**kw):
    """A JAX TransformerLM and the port's, holding the same parameters (the
    port's seeded init, carried over by `interop`)."""
    tlm = models.TransformerLM(**{**LM, **kw}, generator=torch.Generator().manual_seed(7))
    params = jax.tree.map(jnp.asarray, interop.params_to_jax(tlm.state_dict()))
    return jax_models.TransformerLM(**{**LM, **kw}), params, tlm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _prompts(n, s, seed):
    return np.asarray(jax_models.synthetic_tokens(n, s, 64, seed=seed))


@pytest.mark.parametrize("kw", [{}, {"kv_heads": 2}, {"use_rope": True},
                                {"sliding_window": 3, "use_rope": True, "kv_heads": 1}],
                         ids=["mha", "gqa", "rope", "window_mqa_rope"])
def test_mha_apply_cached_matches_jax(kw):
    jm = jax_nn.MultiHeadAttention(32, 4, causal=True, **kw)
    tm = nn.MultiHeadAttention(32, 4, causal=True, **kw,
                               generator=torch.Generator().manual_seed(3))
    params = jax.tree.map(jnp.asarray, interop.params_to_jax(tm.state_dict()))
    apply_cached = jax.jit(jm.apply_cached)
    rng = np.random.default_rng(0)
    kvh = tm.kv_heads
    k0 = rng.standard_normal((2, kvh, 12, 8), np.float32)
    v0 = rng.standard_normal((2, kvh, 12, 8), np.float32)
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    for index, s in ((0, 5), (5, 1), (6, 3)):  # prefill, then decode steps
        x = rng.standard_normal((2, s, 32), np.float32)
        jy, jk, jv = apply_cached(params, jnp.asarray(x), jk, jv, index)
        with torch.no_grad():
            ty, tk2, tv2 = tm.apply_cached(torch.from_numpy(x), tk, tv, index)
        assert tk2 is tk and tv2 is tv  # written in place
        torch.testing.assert_close(ty, torch.from_numpy(np.asarray(jy)), **TOL)
        torch.testing.assert_close(tk, torch.from_numpy(np.asarray(jk)), **TOL)
        torch.testing.assert_close(tv, torch.from_numpy(np.asarray(jv)), **TOL)
    with pytest.raises(ValueError, match="apply_cached requires causal=True"):
        nn.MultiHeadAttention(32, 4).apply_cached(torch.zeros(1, 1, 32), tk, tv, 0)


@pytest.mark.parametrize("kw", [{}, {"pos_embedding": "rope", "kv_heads": 2,
                                     "sliding_window": 5}], ids=["learned", "rope_gqa_window"])
def test_prefill_and_decode_logits_match_jax_and_dense(kw):
    jlm, params, tlm = _pair(**kw)
    seq = _prompts(2, 10, seed=1)
    apply_cached = jax.jit(jlm.apply_cached)
    jcache = jlm.init_cache(2, 16)
    jlogits, jcache = apply_cached(params, seq[:, :6], jcache, 0)
    got = [jlogits]
    for t in range(6, 10):
        step, jcache = apply_cached(params, seq[:, t : t + 1], jcache, t)
        got.append(step)
    want = torch.from_numpy(np.concatenate([np.asarray(g) for g in got], axis=1))
    tseq = torch.from_numpy(seq).long()
    with torch.no_grad():
        cache = tlm.init_cache(2, 16)
        logits = [tlm.apply_cached(tseq[:, :6], cache, 0)[0]]
        for t in range(6, 10):
            logits.append(tlm.apply_cached(tseq[:, t : t + 1], cache, t)[0])
        dense = tlm(tseq)
    port = torch.cat(logits, dim=1)
    torch.testing.assert_close(port, want, **TOL)
    torch.testing.assert_close(port, dense, **TOL)
    # the caches too: the JAX package's, carried over, continue the port's decode
    moved = interop.cache_from_jax(jax.device_get(jcache))
    for a, b in zip(moved, cache):
        torch.testing.assert_close(a["k"], b["k"], **TOL)
        torch.testing.assert_close(a["v"], b["v"], **TOL)
    back = interop.cache_to_jax(cache)
    nxt = jnp.asarray(_prompts(2, 1, seed=9))
    jnext, _ = apply_cached(params, nxt, [{k: jnp.asarray(v) for k, v in c.items()}
                                          for c in back], 10)
    with torch.no_grad():
        tnext, _ = tlm.apply_cached(torch.from_numpy(np.asarray(nxt)).long(), moved, 10)
    torch.testing.assert_close(tnext, torch.from_numpy(np.asarray(jnext)), **TOL)


def test_greedy_generate_matches_jax_with_stop_top_k_and_overflow(pair):
    jlm, params, tlm = pair
    prompts = _prompts(4, 6, seed=3)
    want = np.asarray(jlm.generate(params, prompts, 10, cache_len=32))
    got = tlm.generate(torch.from_numpy(prompts), 10, cache_len=32)
    assert got.dtype == torch.int32  # the prompt's integer dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # top_k=1 at any temperature is greedy
    np.testing.assert_array_equal(
        tlm.generate(torch.from_numpy(prompts), 10, cache_len=32, temperature=0.9, top_k=1,
                     seed=5).numpy(), want)
    # stop_token: the stream freezes on it, in both packages
    stop = int(want[0, 3])
    jstop = np.asarray(jlm.generate(params, prompts, 10, cache_len=32, stop_token=stop))
    tstop = tlm.generate(torch.from_numpy(prompts), 10, cache_len=32, stop_token=stop).numpy()
    np.testing.assert_array_equal(tstop, jstop)
    first = int(np.nonzero(tstop[0] == stop)[0][0])
    assert (tstop[0, first:] == stop).all() and first <= 3
    with pytest.raises(ValueError, match="exceeds cache length"):
        tlm.generate(torch.zeros(1, 40, dtype=torch.long), 20)
    with pytest.raises(ValueError, match="exceeds cache length"):
        serve.generate_runtime(tlm, torch.zeros(1, 40, dtype=torch.long), 20)
    with pytest.raises(ValueError, match="top_k must be >= 1"):
        tlm.generate(torch.zeros(1, 4, dtype=torch.long), 2, temperature=1.0, top_k=0)


def _jax_noise(key, steps, shape):
    """The Gumbel noise of the JAX `generate`'s draws: one ``(b, V)`` array
    a step, from ``split(key, steps)``."""
    return [torch.from_numpy(np.asarray(jax.random.gumbel(k, shape, jnp.float32)))
            for k in jax.random.split(key, steps)]


@pytest.mark.parametrize(
    "kw",
    [dict(temperature=0.8, top_k=None, top_p=None),
     dict(temperature=0.8, top_k=8, top_p=None),
     dict(temperature=1.0, top_k=None, top_p=0.9),
     dict(temperature=0.7, top_k=16, top_p=0.8)],
    ids=["plain", "top_k", "top_p", "both"])
def test_sampled_generate_matches_jax_with_its_noise(pair, monkeypatch, kw):
    jlm, params, tlm = pair
    prompts = _prompts(2, 5, seed=3)
    key = jax.random.key(11)
    want = np.asarray(jlm.generate(params, prompts, 10, key=key, **kw))
    # the draw moved the tokens off greedy decode (the port's, JAX's own above)
    assert not np.array_equal(want, tlm.generate(torch.from_numpy(prompts), 10).numpy())
    # generate's own draw, its noise replaced by the JAX package's
    noise = iter(_jax_noise(key, 10, (2, 64)))
    monkeypatch.setattr(sampling, "gumbel", lambda shape, dtype, gen: next(noise).to(dtype))
    got = tlm.generate(torch.from_numpy(prompts), 10, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    # runtime parameters through the sampler hook, the same noise again
    noise = iter(_jax_noise(key, 10, (2, 64)))
    got = serve.generate_runtime(tlm, torch.from_numpy(prompts), 10, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_draws_from_its_generator(pair):
    _, _, tlm = pair
    prompts = torch.from_numpy(_prompts(2, 5, seed=3))
    a = tlm.generate(prompts, 12, temperature=1.0, seed=4)
    b = tlm.generate(prompts, 12, temperature=1.0,
                     generator=torch.Generator().manual_seed(4))
    c = tlm.generate(prompts, 12, temperature=1.0, seed=5)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_generate_beam_matches_jax(pair):
    jlm, params, tlm = pair
    prompts = _prompts(2, 5, seed=4)
    jt, js = jlm.generate_beam(params, prompts, 8, beams=3, cache_len=32, return_all=True)
    tt, ts = tlm.generate_beam(torch.from_numpy(prompts), 8, beams=3, cache_len=32,
                               return_all=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    torch.testing.assert_close(ts, torch.from_numpy(np.asarray(js)), **TOL)
    assert (ts[:, :-1] >= ts[:, 1:]).all()
    np.testing.assert_array_equal(
        tlm.generate_beam(torch.from_numpy(prompts), 8, beams=3, cache_len=32).numpy(),
        np.asarray(jt)[:, 0])
    np.testing.assert_array_equal(
        tlm.generate_beam(torch.from_numpy(prompts), 8, beams=1).numpy(),
        tlm.generate(torch.from_numpy(prompts), 8).numpy())
    with pytest.raises(ValueError, match="beams must be >= 1"):
        tlm.generate_beam(torch.from_numpy(prompts), 8, beams=0)


def _tied_logits():
    """Seeded logits with ties planted at the top-k thresholds and among the
    largest values."""
    logits = np.random.default_rng(0).standard_normal((6, 64)).astype(np.float32) * 3
    srt = -np.sort(-logits, axis=1)
    logits[0, :3] = srt[0, 4]  # ties with the 5th largest
    logits[1, 10:14] = srt[1, 0]  # four-way tie at the top
    logits[2, :] = 1.0  # all equal
    return logits


@pytest.mark.parametrize("scalar", [False, True], ids=["per_row", "scalar"])
def test_masks_match_jax_exactly(scalar):
    logits = _tied_logits()
    if scalar:
        top_k, top_p = [5, 1, 64, 0], [0.5, 0.9, 1.0, 0.3]
    else:
        top_k = [np.array([5, 1, 64, 0, 3, 2], np.int32)]
        top_p = [np.array([0.5, 0.9, 1.0, 0.3, 0.95, 0.01], np.float32)]
    # a number takes the scalar path, an array a row each
    port = (lambda a: a) if scalar else torch.from_numpy
    for k in top_k:
        want = np.asarray(jax_sampling._mask_top_k(jnp.asarray(logits), jnp.asarray(k)))
        got = sampling._mask_top_k(torch.from_numpy(logits), port(k))
        np.testing.assert_array_equal(got.numpy(), want)
    for p in top_p:
        want = np.asarray(jax_sampling._mask_top_p(jnp.asarray(logits), jnp.asarray(p)))
        got = sampling._mask_top_p(torch.from_numpy(logits), port(p))
        np.testing.assert_array_equal(got.numpy(), want)


def test_sample_slots_and_logits_match_jax_draws():
    logits = _tied_logits()
    S, V = logits.shape
    keys = jax_serve.slot_keys(jnp.arange(S, dtype=jnp.int32) * 7 - 3,
                               jnp.arange(S, dtype=jnp.int32))
    temp = np.array([0.0, 0.5, 1.0, 0.8, 2.0, 0.9], np.float32)
    top_k = np.array([0, 4, 0, 8, 1, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.9, 0.7, 1.0, 0.5], np.float32)
    want = np.asarray(jax_serve.sample_slots(jnp.asarray(logits), keys, jnp.asarray(temp),
                                             jnp.asarray(top_k), jnp.asarray(top_p)))
    noise = torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, (V,), jnp.float32))
                                       for k in keys]))
    got = serve.sample_slots(torch.from_numpy(logits), noise, torch.from_numpy(temp),
                             torch.from_numpy(top_k), torch.from_numpy(top_p))
    np.testing.assert_array_equal(got.numpy(), want)
    key = jax.random.key(2)
    want = np.asarray(jax_serve.sample_logits(jnp.asarray(logits), key, 0.8, 8, 0.9))
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, (S, V), jnp.float32)))
    got = serve.sample_logits(torch.from_numpy(logits), noise, 0.8, 8, 0.9)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(serve.sample_logits(torch.from_numpy(logits), None, 0.0, 8, 0.9),
                                  logits.argmax(-1))


def test_generate_demo_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.demos.generate", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"),  # beside busy test workers
    )
    assert out.returncode == 0, out.stderr[-2000:]
    acc = float(out.stdout.split("chain accuracy vs the Markov table: ")[1].split()[0])
    assert acc >= 0.9, out.stdout
