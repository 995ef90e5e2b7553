"""The port's telemetry against the JAX package's.

- `observe.events`: the same schemas field for field; records judged alike
  by both packages' `validate_record`; the events of a serving run pass
  both packages' `validate_dir`, and the JAX ``tools/tpu_top.py`` renders
  their serve line;
- `observe.registry`: the same exposition text for the same calls; the
  ``/metrics`` endpoint on ``TPU_DIST_METRICS_PORT`` (localhost);
- `observe.flightrec` and `observe.memory`: the ring and its dump; the CPU
  reading (``rss``, no limit); `is_resource_exhausted` as the JAX
  package's, and ``torch.OutOfMemoryError``; an OOM on a serving step
  leaves a flight dump and an ``oom`` event; an over-budget grant the same
  ``warning`` event as the JAX engine's.
"""

import json
import os
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import models as jax_models
from tpu_dist import serve as jax_serve
from tpu_dist.observe import events as jax_events
from tpu_dist.observe import memory as jax_memory
from tpu_dist.observe import registry as jax_registry
from tpu_dist_torch import interop, models, serve
from tpu_dist_torch.observe import events, flightrec, memory, registry

REPO = Path(__file__).resolve().parents[1]
LM = dict(vocab=64, dim=64, depth=2, heads=4, max_seq=48)
CFG = dict(max_batch=2, block_size=8, num_blocks=64, max_seq=32, prefill_chunk=8,
           decode_event_every=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module's tiny tensors: on a busy host the
    thread pool's wake-ups cost a hundred times the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm():
    return models.TransformerLM(**LM, generator=torch.Generator().manual_seed(7))


def _serve(lm, out_dir, **cfg) -> serve.ServeEngine:
    logger = events.for_dir(str(out_dir))
    eng = serve.ServeEngine(lm, serve.ServeConfig(**{**CFG, **cfg}), device="cpu",
                            events=logger)
    prompts = models.synthetic_tokens(3, 5, 64, seed=4).numpy()
    for p in prompts:
        eng.submit(p, 6)
    eng.run_until_drained()
    logger.close()
    return eng


def test_schemas_and_record_checks_match_jax():
    assert events.SCHEMA == jax_events.SCHEMA
    assert events.ENVELOPE == jax_events.ENVELOPE
    records = [{"event": "request_finish", "time": 1.0, "rank": 0, "run_id": "r"},
               {"event": "prefill", "request_id": 1, "chunk": 0, "tokens": 3, "done": True},
               {"event": "decode_step", "time": 0, "rank": 0, "run_id": "r", "step": 1},
               {"event": "unknown", "time": 0, "rank": 0, "run_id": "r"}, ["not", "a", "dict"]]
    for rec in records:
        assert events.validate_record(rec) == jax_events.validate_record(rec)


def test_serve_events_pass_both_validators_and_tpu_top(lm, tmp_path, monkeypatch):
    out = tmp_path / "serve_events"
    eng = _serve(lm, out)
    for validate in (events.validate_dir, jax_events.validate_dir):
        n, errors = validate(str(out))
        assert n > 0 and not errors, errors[:5]
    recs = events.read_events(str(out))
    kinds = {r["event"] for r in recs}
    assert {"request_admit", "prefill", "decode_step", "request_finish"} <= kinds
    fin = [r for r in recs if r["event"] == "request_finish"]
    assert len(fin) == 3 and all(f["emitted"] == 6 and f["finish_reason"] == "length"
                                 for f in fin)
    assert registry.REGISTRY.gauge("tpu_dist_serve_kv_blocks_used").value() == 0
    assert registry.REGISTRY.histogram("tpu_dist_serve_ttft_seconds").count() >= 3
    assert eng.allocator.used == 0
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    import tpu_top

    frame = tpu_top.render(tpu_top.collect(str(out)))
    for word in ("serve", "occupancy", "queue", "kv-blocks"):
        assert word in frame, frame


def test_loggers_from_env_and_for_dir(tmp_path, monkeypatch):
    monkeypatch.delenv(events.ENV_DIR, raising=False)
    assert events.from_env() is events.NULL and events.NULL.emit("x") is None
    monkeypatch.setenv(events.ENV_DIR, str(tmp_path))
    monkeypatch.setenv(events.ENV_RANK, "2")
    logger = events.from_env()
    assert logger is events.for_dir(str(tmp_path)) and logger.rank == 2
    rec = logger.emit("bench", metric="m", value=float("nan"))
    logger.manifest(world=1)
    logger.close()
    assert rec["value"] == "nan"
    assert Path(logger.path).name == "events_rank2.jsonl"
    lines = [json.loads(line) for line in Path(logger.path).read_text().splitlines()]
    assert lines[0]["value"] == "nan" and lines[1]["platform"]["backend"] == "cpu"
    assert events.validate_dir(str(tmp_path)) == (2, [])


def _exercise(reg):
    reg.counter("req_total", "requests").inc(2, route="a")
    reg.counter("req_total").inc(route='b"\n')
    reg.gauge("depth", "queue depth").set(3)
    reg.gauge("depth").inc(-1)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    for bad in (lambda: reg.counter("bad name"), lambda: reg.gauge("req_total"),
                lambda: reg.counter("c").inc(-1)):
        with pytest.raises(ValueError):
            bad()
    return reg.render()


def test_registry_renders_as_jax(monkeypatch):
    assert _exercise(registry.MetricsRegistry()) == _exercise(jax_registry.MetricsRegistry())
    monkeypatch.setenv(registry.ENV_PORT, "0")
    monkeypatch.setattr(registry, "_server", None)
    reg = registry.MetricsRegistry()
    reg.gauge("tpu_dist_serve_queue_depth").set(5)
    srv = registry.maybe_serve_from_env(reg)
    try:
        assert registry.maybe_serve_from_env(reg) is srv
        body = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=10).read()
        assert b"tpu_dist_serve_queue_depth 5.0" in body
    finally:
        srv.close()


def test_flight_recorder_ring_and_dump(tmp_path, monkeypatch):
    monkeypatch.setattr(flightrec, "_recorder", None)
    monkeypatch.setenv(flightrec.ENV_CAPACITY, "3")
    rec = flightrec.get()
    assert flightrec.get() is rec and rec.capacity == 3
    for i in range(5):
        rec.record("step", step=i)
    assert len(rec) == 3 and rec.total == 5 and rec.snapshot()[0]["step"] == 2
    monkeypatch.delenv(events.ENV_DIR, raising=False)
    monkeypatch.delenv(flightrec.ENV_DIR, raising=False)
    assert flightrec.crash_dump("x") is None  # nowhere to dump
    path = flightrec.crash_dump("manual", dirpath=str(tmp_path))
    doc = json.loads(Path(path).read_text())
    assert doc["reason"] == "manual" and [r["step"] for r in doc["records"]] == [2, 3, 4]
    monkeypatch.setattr(flightrec, "_recorder", None)
    monkeypatch.setenv(flightrec.ENV_CAPACITY, "off")
    assert flightrec.get() is flightrec.NULL and flightrec.NULL.dump() is None


def test_memory_on_the_cpu_and_oom_markers():
    snap = memory.memory_snapshot("cpu")
    assert snap["source"] == "rss" and snap["bytes_limit"] is None and snap["bytes_in_use"] > 0
    sampler = memory.WatermarkSampler("cpu", flight=flightrec.FlightRecorder(8))
    sampler.sample("prefill")
    sampler.sample("decode")
    assert set(sampler.phases) == {"prefill", "decode"}
    assert sampler.last["source"] == "rss" and sampler.last_phase == "decode"
    for exc in (MemoryError(), RuntimeError("RESOURCE_EXHAUSTED: x"), ValueError("BLOOM"),
                RuntimeError("CUDA out of memory. Tried to allocate"), KeyError("OOM here")):
        assert memory.is_resource_exhausted(exc) == jax_memory.is_resource_exhausted(exc)
    assert memory.is_resource_exhausted(torch.OutOfMemoryError("no room"))
    assert not memory.is_resource_exhausted(ValueError("BLOOM"))


def test_an_oom_on_a_serving_step_is_recorded(lm, tmp_path, monkeypatch):
    out = tmp_path / "oom"
    logger = events.for_dir(str(out))
    monkeypatch.setattr(flightrec, "_recorder", flightrec.FlightRecorder(16))
    monkeypatch.setenv(events.ENV_DIR, str(out))
    eng = serve.ServeEngine(lm, serve.ServeConfig(**CFG), device="cpu", events=logger)

    def boom(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(eng, "_prefill_round", boom)
    eng.submit(np.arange(4), 3)
    with pytest.raises(torch.OutOfMemoryError):
        eng.step()
    logger.close()
    oom = [r for r in events.read_events(str(out)) if r["event"] == "oom"]
    assert len(oom) == 1 and oom[0]["phase"] == "prefill"
    assert oom[0]["top_class"] == ("kv_pool" if eng.kv_pool_bytes > eng.weights_bytes
                                   else "weights")
    dump = json.loads((out / "flightrec_rank0.json").read_text())
    assert dump["reason"] == "oom" and dump["records"][-1]["what"] == "oom"
    assert events.validate_dir(str(out))[1] == []


def test_grant_over_budget_warns_as_the_jax_engine(lm, tmp_path):
    params = jax.tree.map(jnp.asarray, interop.params_to_jax(lm.state_dict()))
    jlm = jax_models.TransformerLM(**LM)
    prompt = np.asarray(jax_models.synthetic_tokens(1, 5, 64, seed=1))[0]
    budget = 100_000
    warned = []
    for package, make in (
        (jax_events, lambda logger: jax_serve.ServeEngine(
            jlm, params, jax_serve.ServeConfig(**CFG, bytes_limit=budget), events=logger)),
        (events, lambda logger: serve.ServeEngine(
            lm, serve.ServeConfig(**CFG, bytes_limit=budget), device="cpu", events=logger)),
    ):
        out = tmp_path / package.__name__
        logger = package.for_dir(str(out))
        eng = make(logger)
        assert eng.memory_breakdown()["activation_headroom_bytes"] == (
            budget - eng.weights_bytes - eng.kv_pool_bytes)
        eng.submit(prompt, 20)
        eng.run_until_drained()
        logger.close()
        recs = package.read_events(str(out))
        warned.append([{k: v for k, v in r.items() if k not in package.ENVELOPE}
                       for r in recs if r["event"] == "warning"])
    assert warned[0] == warned[1] and warned[0][0]["reason"] == "kv_grant_over_limit"


def test_the_port_reads_its_own_platform():
    info = events.platform_provenance()
    assert info["backend"] == ("gpu" if torch.cuda.is_available() else "cpu")
    assert info["torch_version"] == torch.__version__ and info["pid"] == os.getpid()
    assert "jax_version" not in info


def test_warmup_is_silent_and_leaves_no_trace(lm, tmp_path, monkeypatch):
    """``warmup()`` runs every path of the engine and emits nothing: no event
    on disk, no TTFT/TPOT sample; no result, audit, step, queued request or
    granted block is left."""
    out = tmp_path / "warmup_events"
    monkeypatch.setenv(events.ENV_DIR, str(out))
    hists = [registry.REGISTRY.histogram(f"tpu_dist_serve_{n}_seconds") for n in ("ttft", "tpot")]
    before = [h.count() for h in hists]
    eng = serve.ServeEngine(lm, serve.ServeConfig(**CFG), device="cpu")
    eng.warmup()
    eng.events.close()
    assert [h.count() for h in hists] == before
    assert not eng.results and not eng.audit and not eng.pending
    assert (eng.step_count, eng.steps_with_decode, eng.steps_with_prefill) == (0, 0, 0)
    assert eng.allocator.used == 0 and eng.allocator.available == CFG["num_blocks"]
    assert not (events.event_files(str(out)) and events.read_events(str(out)))
