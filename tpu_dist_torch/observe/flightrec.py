"""The flight recorder: an always-on per-rank ring of recent records.

The part of `tpu_dist.observe.flightrec` the serving engine uses: a
fixed-size `collections.deque` of (wall time, kind, fields) records, one
append per call and no I/O on the hot path, dumped to
``flightrec_rank<r>.json`` when something went wrong (`crash_dump`, which
`observe.memory.record_oom` calls).  The crash hooks (signals, the
exception hook), the supervisor's gathering and the merge CLI are not
ported yet (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from tpu_dist_torch.observe import events as _events

ENV_CAPACITY = "TPU_DIST_FLIGHTREC"  # ring size; "0"/"off" disables
ENV_DIR = "TPU_DIST_FLIGHTREC_DIR"  # dump dir when telemetry is off
DEFAULT_CAPACITY = 512


def dump_path_for(dirpath: str, rank: int) -> str:
    return os.path.join(dirpath, f"flightrec_rank{rank}.json")


class FlightRecorder:
    """Fixed-size in-memory ring of (wall time, kind, fields) records."""

    enabled = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._buf: collections.deque = collections.deque(maxlen=self.capacity)
        self.total = 0  # lifetime records (ring overwrites don't decrement)

    def record(self, kind: str, **fields) -> None:
        self.total += 1
        self._buf.append((time.time(), kind, fields))

    def __len__(self) -> int:
        return len(self._buf)

    def snapshot(self) -> list[dict]:
        return [{"t": t, "kind": kind, **fields} for t, kind, fields in list(self._buf)]

    def resolve_dir(self, dirpath: str | None = None) -> str | None:
        """Where a dump would land: explicit > ``TPU_DIST_TELEMETRY`` >
        ``TPU_DIST_FLIGHTREC_DIR`` > nowhere (None)."""
        return dirpath or os.environ.get(_events.ENV_DIR) or os.environ.get(ENV_DIR) or None

    def dump(self, reason: str = "manual", *, dirpath: str | None = None) -> str | None:
        """Write the ring to ``flightrec_rank<r>.json`` (atomic rename).
        Returns the path, or None when no dump directory is resolvable.
        Never raises: the dump runs on crash paths."""
        try:
            dirpath = self.resolve_dir(dirpath)
            if dirpath is None:
                return None
            rank = _events.env_rank()
            os.makedirs(dirpath, exist_ok=True)
            path = dump_path_for(dirpath, rank)
            try:
                world = int(os.environ.get("WORLD_SIZE", ""))
            except ValueError:
                world = None
            doc = {
                "rank": rank,
                "world": world,
                "pid": os.getpid(),
                "run_id": os.environ.get(_events.ENV_RUN_ID),
                "reason": reason,
                "dumped_at": time.time(),
                "capacity": self.capacity,
                "total_records": self.total,
                "records": self.snapshot(),
            }
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, default=_events._json_default)
            os.replace(tmp, path)
            return path
        except Exception:
            return None


class NullFlightRecorder:
    """``TPU_DIST_FLIGHTREC=off`` stand-in: same surface, zero cost."""

    enabled = False
    capacity = 0
    total = 0

    def record(self, kind: str, **fields) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def snapshot(self) -> list:
        return []

    def resolve_dir(self, dirpath=None):
        return None

    def dump(self, reason: str = "manual", *, dirpath=None):
        return None


NULL = NullFlightRecorder()
_recorder = None
_lock = threading.Lock()


def _capacity_from_env() -> int:
    raw = (os.environ.get(ENV_CAPACITY) or "").strip().lower()
    if raw in ("0", "off", "false"):
        return 0
    try:
        return max(int(raw), 1)
    except ValueError:
        return DEFAULT_CAPACITY


def get():
    """The process's flight recorder, created on first use (the ring is on
    unless ``TPU_DIST_FLIGHTREC`` disables it)."""
    global _recorder
    rec = _recorder
    if rec is None:
        with _lock:
            if _recorder is None:
                cap = _capacity_from_env()
                _recorder = FlightRecorder(cap) if cap else NULL
            rec = _recorder
    return rec


def crash_dump(reason: str, *, dirpath: str | None = None) -> str | None:
    """Dump the ring; the entry point every dump trigger calls."""
    return get().dump(reason, dirpath=dirpath)
