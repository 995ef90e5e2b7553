"""The port's paged KV pool, continuous-batching engine and LMServer against
the JAX package.

On the CPU, with the same parameters (through `interop`):

- `BlockAllocator`: the same ids, counts and errors as the JAX one's;
- `paged_apply_cached`: logits and pool within 1e-5 of the JAX package's
  for the same tables, positions and write mask;
- greedy decode through the engine equals dense `generate` at block sizes
  4, 8 and 16, with chunked prefill, staggered admission and the GQA, rope
  and sliding-window variants;
- on one seeded trace (greedy and sampled requests, a stop token, a cancel,
  a fake clock) the engine's ``audit``, results (tokens, finish reasons,
  latency fields) and registry values equal the JAX engine's, the sampling
  noise being the JAX engine's own (``gumbel(fold_in(key(seed), counter))``,
  put in place of `slot_noise`), after ``warmup()`` on both;
- a sampled stream does not depend on its slot or its neighbours;
- `save_params` from either package loads in the other's `LMServer`;
- ``python -m tpu_dist_torch.demos.serve_demo --device cpu``.
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

from tpu_dist import export as jax_export
from tpu_dist import models as jax_models
from tpu_dist import serve as jax_serve
from tpu_dist.observe.registry import REGISTRY as JAX_REGISTRY
from tpu_dist_torch import export, interop, models, serve
from tpu_dist_torch.observe.registry import REGISTRY
from tpu_dist_torch.serve import engine as engine_mod

REPO = Path(__file__).resolve().parents[1]
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
    """A JAX TransformerLM and the port's with the same parameters (the
    port's seeded init, carried over by `interop`)."""
    tlm = models.TransformerLM(**{**LM, **kw}, generator=torch.Generator().manual_seed(7))
    params = jax.tree.map(jnp.asarray, interop.params_to_jax(tlm.state_dict()))
    return jax_models.TransformerLM(**{**LM, **kw}), params, tlm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _cfg(package, **kw):
    base = dict(max_batch=4, block_size=8, num_blocks=64, max_seq=32, prefill_chunk=8)
    return package.ServeConfig(**{**base, **kw})


def _prompts(n, s, seed):
    return np.asarray(jax_models.synthetic_tokens(n, s, 64, seed=seed))


def _allocator_trace(package):
    """The same calls on a package's allocator: what each returned or raised."""
    out = []
    with pytest.raises(ValueError, match="num_blocks must be >= 1") as e:
        package.BlockAllocator(0)
    out.append(str(e.value))
    a = package.BlockAllocator(6)
    first = a.alloc(3)
    out += [first, a.alloc(2), a.alloc(2), a.used, a.available]
    a.free(first[:2])
    out += [a.alloc(1), a.alloc(3), a.high_water, a.utilization()]
    for bad in (first[:1] + first[:1], [99]):
        with pytest.raises(ValueError, match="unallocated") as e:
            a.free(bad)
        out.append(str(e.value))
    with pytest.raises(ValueError, match="n >= 1") as e:
        a.alloc(0)
    return out + [str(e.value), a.used, a.available]


def test_block_allocator_matches_jax():
    assert _allocator_trace(serve) == _allocator_trace(jax_serve)


def test_paged_apply_cached_matches_jax(pair):
    jlm, params, tlm = pair
    bs, nb = 4, 10
    jpool = jax_serve.init_paged_cache(jlm, nb, bs)
    tpool = serve.init_paged_cache(tlm, nb, bs)
    tables = np.array([[3, 7, 1, nb], [0, 2, nb, nb], [nb, nb, nb, nb]], np.int32)
    # a prefill chunk of 5 (slot 1 with 3 real tokens, slot 2 inactive), then a decode step
    calls = [(_prompts(3, 5, seed=2), np.tile(np.arange(5), (3, 1)),
              np.array([[1] * 5, [1, 1, 1, 0, 0], [0] * 5], bool)),
             (_prompts(3, 1, seed=3), np.array([[5], [3], [0]]), np.array([[1], [1], [0]], bool))]
    paged = jax.jit(jax_serve.paged_apply_cached, static_argnums=(0, 7))
    for tokens, positions, mask in calls:
        jl, jpool = paged(jlm, params, tokens, jpool, tables, positions.astype(np.int32), mask, bs)
        with torch.no_grad():
            tl, _ = serve.paged_apply_cached(
                tlm, torch.from_numpy(tokens).long(), tpool, torch.from_numpy(tables).long(),
                torch.from_numpy(positions), torch.from_numpy(mask), bs)
        real = torch.from_numpy(mask)
        torch.testing.assert_close(tl[real], torch.from_numpy(np.asarray(jl))[real],
                                   rtol=1e-5, atol=1e-5)
        # every block but scratch, whose writes collide; the JAX pool carried
        # over by interop
        for j, t in zip(interop.cache_from_jax(jax.device_get(jpool)), tpool):
            for side in ("k", "v"):
                torch.testing.assert_close(t[side][:nb], j[side][:nb], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_greedy(pair):
    """Four prompts and the JAX package's greedy `generate` of them."""
    jlm, params, _ = pair
    prompts = _prompts(4, 6, seed=3)
    return prompts, np.asarray(jlm.generate(params, prompts, 10, cache_len=32))


@pytest.mark.parametrize("block_size", [4, 8, 16])
def test_paged_greedy_equals_dense(pair, jax_greedy, block_size):
    _, _, tlm = pair
    prompts, want = jax_greedy
    dense = tlm.generate(torch.from_numpy(prompts), 10, cache_len=32).numpy()
    np.testing.assert_array_equal(dense, want)
    eng = serve.ServeEngine(tlm, _cfg(serve, block_size=block_size), device="cpu")
    rids = [eng.submit(p, 10) for p in prompts]
    res = eng.run_until_drained()
    np.testing.assert_array_equal(np.stack([res[r].tokens for r in rids]), want)
    assert eng.allocator.used == 0


@pytest.mark.parametrize("chunk", [3, 5, 16])
def test_chunked_prefill_equals_dense(pair, chunk):
    _, _, tlm = pair
    prompts = _prompts(3, 11, seed=5)
    dense = tlm.generate(torch.from_numpy(prompts), 8, cache_len=32).numpy()
    eng = serve.ServeEngine(tlm, _cfg(serve, prefill_chunk=chunk), device="cpu")
    rids = [eng.submit(p, 8) for p in prompts]
    res = eng.run_until_drained()
    np.testing.assert_array_equal(np.stack([res[r].tokens for r in rids]), dense)


@pytest.mark.parametrize("kw", [{"kv_heads": 2}, {"pos_embedding": "rope"},
                                {"sliding_window": 8}, {}], ids=["gqa", "rope", "window",
                                                                 "staggered"])
def test_variants_and_staggered_admission_equal_dense(kw):
    tlm = _pair(**kw)[2]
    n = 6 if not kw else 2  # six requests through two slots: admitted mid-flight
    prompts = _prompts(n, 6, seed=11)
    dense = tlm.generate(torch.from_numpy(prompts), 8, cache_len=32).numpy()
    eng = serve.ServeEngine(tlm, _cfg(serve, max_batch=2), device="cpu")
    rids = [eng.submit(p, 8) for p in prompts]
    res = eng.run_until_drained()
    np.testing.assert_array_equal(np.stack([res[r].tokens for r in rids]), dense)


def _jax_slot_noise(seeds, counters, vocab, device=None):
    """The JAX engine's per-slot noise, ``gumbel(fold_in(key(seed), counter),
    (vocab,))``, in place of the port's `slot_noise`."""
    rows = []
    for s, c in zip(seeds.tolist(), counters.tolist()):
        s32 = s & 0xFFFFFFFF
        key = jax.random.fold_in(jax.random.key(s32 - (1 << 32) if s32 >= 1 << 31 else s32), c)
        rows.append(np.asarray(jax.random.gumbel(key, (vocab,), jnp.float32)))
    return torch.from_numpy(np.stack(rows))


METRICS = ("tpu_dist_serve_batch_occupancy", "tpu_dist_serve_queue_depth",
           "tpu_dist_serve_kv_blocks_used", "tpu_dist_serve_kv_block_utilization",
           "tpu_dist_serve_weights_bytes", "tpu_dist_serve_kv_pool_bytes")


def _trace(package, make_engine):
    """A seeded trace through a package's engine under a fake clock: greedy
    and sampled requests, a stop token, a cancel at step 3, after warmup.
    Returns the audit, the results, the registry's gauges and the
    histograms' added counts and sums."""
    registry = REGISTRY if package is serve else JAX_REGISTRY
    hists = [registry.histogram(f"tpu_dist_serve_{n}_seconds") for n in ("ttft", "tpot")]
    before = [(h.count(), h._values.get((), [0.0])[-1]) for h in hists]
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    eng = make_engine(clock)
    eng.warmup()
    rng = np.random.default_rng(0)
    rids = []
    for i in range(7):
        prompt = _prompts(1, int(rng.integers(2, 9)), seed=i)[0]
        sp = package.SamplingParams(temperature=0.0 if i % 2 else 0.8,
                                    top_k=8 if i % 3 else None,
                                    top_p=0.9 if i == 4 else None, seed=i - 3)
        rids.append(eng.submit(prompt, int(rng.integers(2, 12)), sampling=sp,
                               stop_token=17 if i == 5 else None))
    for _ in range(3):
        eng.step()
    assert eng.cancel(rids[0])
    res = eng.run_until_drained()
    results = [(r.tokens.tolist(), r.finish_reason, r.ttft, r.tpot_mean, r.token_times,
                r.prompt_len, r.finish_time) for r in (res[i] for i in rids)]
    gauges = [registry.gauge(name).value() for name in METRICS]
    added = [(h.count() - c, h._values.get((), [0.0])[-1] - s)
             for h, (c, s) in zip(hists, before)]
    return eng.audit, results, gauges, added, eng.allocator.high_water


def test_engine_trace_matches_jax(pair, monkeypatch):
    jlm, params, tlm = pair
    monkeypatch.setattr(engine_mod, "slot_noise", _jax_slot_noise)
    jax_run = _trace(jax_serve, lambda clock: jax_serve.ServeEngine(
        jlm, params, _cfg(jax_serve, max_batch=2, prefill_batch=2), now=clock))
    port_run = _trace(serve, lambda clock: serve.ServeEngine(
        tlm, _cfg(serve, max_batch=2, prefill_batch=2), device="cpu", now=clock))
    audit, results = port_run[0], port_run[1]
    assert audit == jax_run[0]
    assert results == jax_run[1]
    assert port_run[2:] == jax_run[2:]
    assert results[0][1] == "cancelled" and 0 < len(results[0][0])
    assert {r[1] for r in results} >= {"cancelled", "length"}
    # sampled requests drew from the noise: they differ from greedy decode
    sampled = [r for i, r in enumerate(results) if i % 2 == 0 and i]
    assert any(len(set(r[0])) > 1 for r in sampled)


def test_sampled_stream_is_scheduling_independent(pair):
    _, _, tlm = pair
    prompts = _prompts(3, 6, seed=8)
    sp = serve.SamplingParams(temperature=0.9, top_k=8, seed=2**40 + 5)
    eng1 = serve.ServeEngine(tlm, _cfg(serve), device="cpu")
    r1 = eng1.submit(prompts[1], 10, sampling=sp)
    eng1.submit(prompts[0], 10)
    eng2 = serve.ServeEngine(tlm, _cfg(serve), device="cpu")
    eng2.submit(prompts[2], 3)
    eng2.submit(prompts[0], 7, sampling=serve.SamplingParams(temperature=1.0, seed=3))
    r2 = eng2.submit(prompts[1], 10, sampling=sp)
    a, b = eng1.run_until_drained()[r1].tokens, eng2.run_until_drained()[r2].tokens
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, tlm.generate(torch.from_numpy(prompts[1:2]), 10)[0].numpy())


def test_slot_noise_is_a_function_of_seed_and_counter():
    seeds = torch.tensor([5, -1, 2**31 + 7, 5])
    counters = torch.tensor([0, 3, 9, 1])
    noise = serve.slot_noise(seeds, counters, 4096)
    assert noise.shape == (4, 4096) and noise.dtype == torch.float32
    assert torch.isfinite(noise).all()
    # a row depends on its own (seed, counter) only, wherever it sits
    again = serve.slot_noise(seeds.flip(0), counters.flip(0), 4096).flip(0)
    assert torch.equal(noise, again)
    assert torch.equal(serve.slot_noise(torch.tensor([-1]), torch.tensor([3]), 4096)[0],
                       noise[1])
    assert torch.equal(serve.slot_noise(torch.tensor([2**32 - 1]), torch.tensor([3]), 4096)[0],
                       noise[1])  # a seed counts by its low 32 bits
    assert not torch.equal(noise[0], noise[3])
    # standard Gumbel: mean 0.5772, variance pi^2 / 6
    assert abs(noise.mean().item() - 0.5772) < 0.03
    assert abs(noise.var().item() - 1.6449) < 0.1


def test_engine_refusals(pair):
    _, _, tlm = pair
    eng = serve.ServeEngine(tlm, _cfg(serve, max_batch=4, num_blocks=2), device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(np.zeros(30, np.int32), 10)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros(0, np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.zeros(4, np.int32), 0)
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit(np.zeros(10, np.int32), 20)
    assert not eng.pending and not eng.cancel(999)
    with pytest.raises(ValueError, match="exceeds model max_seq"):
        serve.ServeEngine(tlm, _cfg(serve, max_seq=64), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        eng.analysis_programs()
    # head of line: the second request waits for the first's blocks
    p = _prompts(2, 6, seed=0)
    r0, r1 = eng.submit(p[0], 10), eng.submit(p[1], 10)
    eng.step()
    assert [a[1] for a in eng.audit if a[0] == "admit"] == [r0] and len(eng.queue) == 1
    res = eng.run_until_drained()
    assert [a[1] for a in eng.audit if a[0] == "admit"] == [r0, r1]
    assert res[r1].emitted == 10 and eng.allocator.used == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_params_loads_in_the_other_packages_server(pair, tmp_path, writer):
    jlm, params, tlm = pair
    path = tmp_path / "weights.npz"
    prompt = _prompts(1, 5, seed=1)
    dense = tlm.generate(torch.from_numpy(prompt), 8, cache_len=32)[0].numpy()
    if writer == "jax":
        jax_export.save_params(params, path)
        with torch.device("meta"):
            like = models.TransformerLM(**LM)
        srv = serve.LMServer.from_artifact(like, path, _cfg(serve), device="cpu")
        for name, p in tlm.named_parameters():
            assert torch.equal(dict(srv.lm.named_parameters())[name], p), name
    else:
        export.save_params(tlm, path)
        srv = jax_serve.LMServer.from_artifact(jlm, path, _cfg(jax_serve))
    rid = srv.submit(prompt[0], 8)
    res = srv.run_until_drained()
    np.testing.assert_array_equal(res[rid].tokens, dense)
    assert srv.result(rid) is res[rid] and not srv.pending


def test_serve_demo_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.demos.serve_demo", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"),  # beside busy test workers
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "OK:" in out.stdout and "used=0" in out.stdout
