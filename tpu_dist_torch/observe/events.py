"""Per-rank structured JSONL event log: the port's own copy of
`tpu_dist.observe.events`, the same schemas field for field.

One line per event, one file per rank, under the directory named by
``TPU_DIST_TELEMETRY`` (unset = telemetry off, every emit is a no-op).
Rank 0 writes ``events.jsonl``; rank r > 0 writes ``events_rank<r>.jsonl``;
a supervisor writes ``events_<role>.jsonl``.  The first record of a run is
a ``manifest`` carrying config, mesh and platform provenance; the serving
engine writes the request-lifecycle records (``request_admit``,
``prefill``, ``decode_step``, ``request_finish``), which the JAX package's
validators and ``tools/tpu_top.py`` read as they read its own.

Stdlib-only apart from `platform_provenance`, which reads torch and the
card lazily.

Env knobs:

    TPU_DIST_TELEMETRY        event output directory
    TPU_DIST_TELEMETRY_RANK   this process's rank (falls back to RANK, then 0)
    TPU_DIST_TELEMETRY_EVERY  emit every Nth step record (default 1)
    TPU_DIST_RUN_ID           shared run id (set by the first logger and
                              inherited by spawned children)
"""

from __future__ import annotations

import json
import math
import os
import socket
import threading
import time
import uuid

ENV_DIR = "TPU_DIST_TELEMETRY"
ENV_RANK = "TPU_DIST_TELEMETRY_RANK"
ENV_EVERY = "TPU_DIST_TELEMETRY_EVERY"
ENV_RUN_ID = "TPU_DIST_RUN_ID"

# Envelope keys present on EVERY record.
ENVELOPE = ("event", "time", "rank", "run_id")

# Per-event required payload keys (the documented schema —
# docs/observability.md).  Values may be null where a backend doesn't
# track them (e.g. mfu/hbm on CPU-sim, bad_steps with the guard off);
# the KEYS must be present so consumers never need hasattr-style probing.
STEP_REQUIRED = (
    "step",
    "epoch",
    "loss",
    "step_time",
    "samples_per_sec_per_chip",
    "mfu",
    "bad_steps",
    "loss_scale",
    "hbm",
    # pipeline-parallel runs: measured schedule-table idle fraction
    # (null when the step is not pipeline-scheduled)
    "bubble_fraction",
)
SCHEMA: dict[str, tuple[str, ...]] = {
    "manifest": ("world", "platform", "mesh", "config"),
    "step": STEP_REQUIRED,
    # "mesh" = partition provenance: {"axes": {name: size}, "rules":
    # <active partition rule-set name or null>} — WHAT sharded the run
    "epoch": (
        "epoch", "mean_loss", "seconds", "goodput", "bubble_fraction",
        "mesh",
    ),
    "checkpoint": ("path", "epoch", "seconds"),
    "retry": ("what", "attempt", "max_attempts", "error"),
    "chaos": ("clause",),
    "stall": ("what", "timeout_s", "ranks_behind"),
    "preempt": ("signal", "epoch", "step"),
    "warning": ("reason",),
    "print": ("text",),
    "spmd_result": ("spmd_rank", "summary"),
    "bench": ("metric", "value"),
    "heartbeat": ("step",),
    "compile_cache": ("outcome",),  # "hit" | "miss" (comm.init cache)
    # compressed gradient sync (comm.compress): per-epoch wire accounting
    "compress": ("wire", "bytes_on_wire", "bytes_saved", "compression_error"),
    # serving request lifecycle (tpu_dist.serve.ServeEngine):
    # admission -> chunked prefill -> sampled decode_step (engine-health
    # snapshot, emitted every decode_event_every steps) -> finish
    "request_admit": (
        "request_id", "prompt_tokens", "max_new_tokens", "queue_depth",
    ),
    "prefill": ("request_id", "chunk", "tokens", "done"),
    "decode_step": (
        "step", "occupancy", "queue_depth", "kv_blocks_used",
        "kv_block_utilization",
    ),
    "request_finish": (
        "request_id", "emitted", "finish_reason", "ttft", "tpot_mean",
    ),
    # static analyzer summary (python -m tpu_dist.analysis / make
    # analyze): programs analyzed, findings per lint rule, golden-plan
    # gate status ("ok" | "stale" | "missing" | "blessed" | null)
    "analysis": ("programs", "findings", "golden"),
    # flight-recorder dumps gathered (observe.flightrec): the comm.launch
    # supervisor on gang failure/relaunch ("gang_failure"), or any local
    # dump trigger that records one; `dir` is where the per-rank
    # flightrec_rank<r>.json files landed, `ranks` which ranks dumped
    "flight_dump": ("reason", "ranks", "dir"),
    # plan-vs-measured cost attribution (observe.attribution / make
    # attribute): measured step time bucketed into compute vs each
    # (kind, axes, dtype) collective class, with plan payload bytes and
    # achieved wire GB/s per class
    "attribution": ("program", "step_time", "compute_seconds", "classes"),
    # live memory accounting (observe.memory.WatermarkSampler): the
    # latest snapshot (source "hbm" on tracked backends, "rss" on the
    # CPU-sim host fallback) plus per-phase watermark-delta buckets
    "memory": (
        "source", "bytes_in_use", "peak_bytes_in_use", "bytes_limit",
        "phases",
    ),
    # elastic resume (train.reshard.redistribute): one record per
    # redistribution — source/target partition provenance, bytes this
    # rank streamed off disk, the transient staging peak the memory
    # bound was asserted on (observe.memory.TransientMeter), wall time,
    # and "ok" | "failed"
    "reshard": (
        "source", "target", "bytes_moved", "peak_bytes", "seconds",
        "status",
    ),
    # OOM forensics (observe.memory.record_oom): RESOURCE_EXHAUSTED on
    # a step path — the failing phase, the headroom at failure, and the
    # largest resident class; the full report rides the flight dump
    "oom": ("phase", "headroom_bytes", "top_class"),
    # static memory-plan gate (python -m tpu_dist.analysis.memory /
    # make memcheck): programs checked + golden gate status
    "memcheck": ("programs", "golden"),
    # auto-sharding advisor (python -m tpu_dist.analysis.advise / make
    # advise): ranked candidate configurations — "best" is the
    # top-ranked {spec, compress, predicted_step_s, ...} summary (null
    # when nothing survived pruning), "ranking" the full ordered list
    "advice": ("model", "chips", "best", "ranking"),
    # cost-model calibration gate (make costcheck): predicted-vs-
    # measured step time per program with attribution rows; status
    # "ok" | "violation" | "skew" (rows from a different jax, gate
    # waived) | "no-rows"
    "costcheck": ("programs", "tolerance", "status"),
}


def _json_default(obj):
    """Last-resort serializer: telemetry must never crash the run over an
    exotic leaf (dtype objects, device arrays, callables).  Non-finite
    numerics (e.g. a numpy NaN scalar) come out as their string names so
    the emitted line stays RFC-8259 parseable under allow_nan=False."""
    try:
        f = float(obj)
    except (TypeError, ValueError):
        return repr(obj)
    return f if math.isfinite(f) else str(f)


def _sanitize_nonfinite(obj):
    """Replace non-finite floats with their string names ('nan', 'inf',
    '-inf'): bare NaN/Infinity tokens are valid only to Python's lenient
    parser, and the log must stay RFC-8259 parseable for jq/scrapers."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else str(obj)
    if isinstance(obj, dict):
        return {k: _sanitize_nonfinite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize_nonfinite(v) for v in obj]
    return obj


def _run_id_for(dirpath: str) -> str:
    """One run id per telemetry dir.  The first dir seen in a process
    adopts an inherited ``TPU_DIST_RUN_ID`` (set by the launching
    parent); later, different dirs get fresh ids (a second fit in the
    same process is a new run, not the stale first one).  The current
    id is always (re)published to the environment so children spawned
    during THIS run inherit it."""
    rid = _run_ids.get(dirpath)
    if rid is None:
        inherited = os.environ.get(ENV_RUN_ID)
        rid = inherited if (inherited and not _run_ids) else uuid.uuid4().hex[:12]
        _run_ids[dirpath] = rid
    os.environ[ENV_RUN_ID] = rid
    return rid


class EventLogger:
    """Append-only JSONL writer for one rank.  Thread-safe; every emit
    is flushed so a killed process loses at most the in-flight line."""

    enabled = True

    def __init__(self, dirpath: str, rank: int = 0, *, role: str | None = None):
        self.dir = str(dirpath)
        self.rank = int(rank)
        os.makedirs(self.dir, exist_ok=True)
        self.run_id = _run_id_for(self.dir)
        if role is not None:
            name = f"events_{role}.jsonl"
        elif self.rank == 0:
            name = "events.jsonl"
        else:
            name = f"events_rank{self.rank}.jsonl"
        self.path = os.path.join(self.dir, name)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")

    def emit(self, event: str, **fields) -> dict | None:
        rec = {
            "event": event,
            "time": time.time(),
            "rank": self.rank,
            "run_id": self.run_id,
            **fields,
        }
        try:
            line = json.dumps(rec, default=_json_default, allow_nan=False)
        except ValueError:  # a non-finite float somewhere in the payload
            rec = _sanitize_nonfinite(rec)
            try:
                line = json.dumps(rec, default=_json_default, allow_nan=False)
            except ValueError:  # never crash the run over a payload
                rec = {k: rec[k] for k in ENVELOPE if k in rec}
                rec["error"] = "unserializable payload"
                line = json.dumps(rec, allow_nan=False)
        with self._lock:
            if self._fh.closed:
                return None
            self._fh.write(line + "\n")
            self._fh.flush()
        return rec

    def manifest(self, *, world: int, config=None, mesh=None,
                 platform=None, **extra) -> dict | None:
        """The run-open record: everything needed to interpret the step
        stream (and to reproduce the run)."""
        return self.emit(
            "manifest",
            world=world,
            config=config_summary(config) if config is not None else {},
            mesh=mesh_summary(mesh) if mesh is not None else {},
            platform=platform if platform is not None else platform_provenance(),
            **extra,
        )

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


class NullLogger:
    """Telemetry-off stand-in: same surface, every call a no-op."""

    enabled = False
    path = None
    rank = 0
    run_id = None

    def emit(self, event: str, **fields):
        return None

    def manifest(self, **kw):
        return None

    def close(self) -> None:
        pass


NULL = NullLogger()
_cache: dict[tuple[str, int | str], EventLogger] = {}
_cache_lock = threading.Lock()
_run_ids: dict[str, str] = {}


def env_rank(rank: int | None = None) -> int:
    """This process's telemetry rank: explicit > TPU_DIST_TELEMETRY_RANK >
    RANK > 0."""
    if rank is not None:
        return int(rank)
    for var in (ENV_RANK, "RANK"):
        raw = os.environ.get(var)
        if raw is not None:
            try:
                return int(raw)
            except ValueError:
                pass
    return 0


def from_env(rank: int | None = None, *, role: str | None = None):
    """The process's logger for the ``TPU_DIST_TELEMETRY`` directory, or
    the NULL logger when the env var is unset.  Cached per (dir, rank) so
    every subsystem appends to one file."""
    dirpath = os.environ.get(ENV_DIR)
    if not dirpath:
        return NULL
    return for_dir(dirpath, rank=rank, role=role)


def for_dir(dirpath: str, rank: int | None = None, *,
            role: str | None = None) -> EventLogger:
    """A (cached) logger for an explicit directory, independent of the
    environment."""
    r = env_rank(rank)
    key = (str(dirpath), role if role is not None else r)
    with _cache_lock:
        logger = _cache.get(key)
        if logger is None or logger._fh.closed:
            logger = EventLogger(dirpath, r, role=role)
            _cache[key] = logger
        return logger


def step_every() -> int:
    """Step-record sampling stride (``TPU_DIST_TELEMETRY_EVERY``)."""
    try:
        return max(1, int(os.environ.get(ENV_EVERY, "1")))
    except ValueError:
        return 1


# ---------------------------------------------------------------- summaries


def platform_provenance() -> dict:
    """Where this run executed: the record that tells a card's number from
    a CPU run's long after stderr is gone."""
    info: dict = {"hostname": socket.gethostname(), "pid": os.getpid()}
    try:
        import torch

        cuda = torch.cuda.is_available()
        info.update(
            backend="gpu" if cuda else "cpu",
            device_kind=torch.cuda.get_device_name(0) if cuda else "cpu",
            device_count=torch.cuda.device_count() if cuda else 1,
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
        )
    except Exception as e:  # torch absent, or the card did not answer
        info["backend"] = None
        info["error"] = f"{type(e).__name__}: {e}"
    return info


def mesh_summary(mesh) -> dict:
    """JSON-able summary of a device mesh (duck-typed: ``axis_names``,
    ``shape``, ``devices``)."""
    try:
        return {
            "axis_names": list(mesh.axis_names),
            "shape": {str(k): int(v) for k, v in dict(mesh.shape).items()},
            "devices": int(mesh.devices.size),
        }
    except Exception:
        return {"repr": repr(mesh)}


def config_summary(config) -> dict:
    """Config dataclass/dict → JSON-able dict (callables like ``log``
    dropped; exotic values fall back to repr via the emit serializer)."""
    if config is None:
        return {}
    items = config if isinstance(config, dict) else vars(config)
    return {k: v for k, v in items.items() if not callable(v)}


# --------------------------------------------------------------- validation


def validate_record(rec: dict) -> list[str]:
    """Schema errors for one parsed record (empty list = valid).  Unknown
    event types are fine (the schema is open); known types must carry
    their required keys plus the envelope."""
    errors = []
    if not isinstance(rec, dict):
        return [f"record is not an object: {rec!r}"]
    for key in ENVELOPE:
        if key not in rec:
            errors.append(f"missing envelope key {key!r}")
    required = SCHEMA.get(rec.get("event", ""))
    if required:
        for key in required:
            if key not in rec:
                errors.append(
                    f"{rec.get('event')} record missing key {key!r}"
                )
    return errors


def validate_file(path: str) -> tuple[int, list[str]]:
    """Parse + schema-check one JSONL file.  Returns (record count,
    errors); errors are prefixed with the 1-based line number."""
    count, errors = 0, []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: invalid JSON ({e})")
                continue
            count += 1
            errors.extend(f"line {lineno}: {e}" for e in validate_record(rec))
    return count, errors


def event_files(dirpath: str) -> list[str]:
    """All event files of a telemetry dir (rank 0 first)."""
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        return []
    return [
        os.path.join(dirpath, n)
        for n in names
        if n.startswith("events") and n.endswith(".jsonl")
    ]


def validate_dir(dirpath: str) -> tuple[int, list[str]]:
    """Validate every event file under ``dirpath``."""
    total, errors = 0, []
    files = event_files(dirpath)
    if not files:
        return 0, [f"no events*.jsonl files under {dirpath}"]
    for path in files:
        n, errs = validate_file(path)
        total += n
        errors.extend(f"{os.path.basename(path)}: {e}" for e in errs)
    return total, errors


def read_events(dirpath: str) -> list[dict]:
    """Every parseable record from every event file, oldest first."""
    records = []
    for path in event_files(dirpath):
        try:
            with open(path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        except OSError:
            continue
    records.sort(key=lambda r: r.get("time", 0.0))
    return records
