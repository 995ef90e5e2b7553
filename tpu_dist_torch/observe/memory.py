"""Live memory accounting and OOM forensics, for the serving engine.

The part of `tpu_dist.observe.memory` the engine calls:

- `memory_snapshot()`: one ``{source, bytes_in_use, peak_bytes_in_use,
  bytes_limit}`` reading.  On a CUDA device the source is ``"hbm"``:
  ``torch.cuda.memory_stats`` (the caching allocator's allocated bytes, now
  and at peak) and ``torch.cuda.mem_get_info`` (the card's total as the
  limit).  On the CPU it is host RSS, labelled ``source: "rss"`` with no
  ``bytes_limit``, as the JAX package reports on CPU-sim.
- `WatermarkSampler`: per-phase watermark accounting (``prefill``,
  ``decode``, ...), the ``tpu_dist_hbm_*`` gauges, a ``memory`` record in
  the flight ring whenever the watermark moves.
- OOM forensics: `is_resource_exhausted` (``torch.OutOfMemoryError`` or an
  OOM marker in the message) and `record_oom` (the plan-against-live
  report, a flight dump and an ``oom`` event).

`TransientMeter` and the rest of the module are not ported yet (ROADMAP
queue 1, item 11).
"""

from __future__ import annotations

import os
import re as _re
import time

import torch

from tpu_dist_torch.observe import events as _events
from tpu_dist_torch.observe import flightrec as _flightrec

# The phase vocabulary the sampler buckets watermark deltas into — the
# union of the trainer span phases, the serve engine's step halves, and
# the elastic-resume redistribution (`train.reshard`).
PHASES = (
    "data", "dispatch", "readback", "checkpoint", "prefill", "decode",
    "reshard",
)

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def host_rss_bytes() -> int | None:
    """Current resident-set size of this process (bytes).  Linux
    ``/proc/self/statm`` first (live number), `getrusage` peak as the
    fallback so the function still answers off-Linux."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        pass
    return host_peak_rss_bytes()


def host_peak_rss_bytes() -> int | None:
    """Peak RSS of this process (bytes) — ``ru_maxrss`` is kilobytes on
    Linux, bytes on macOS."""
    try:
        import resource
        import sys

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(peak) if sys.platform == "darwin" else int(peak) * 1024
    except Exception:
        return None


def memory_snapshot(device=None) -> dict:
    """One live memory reading: ``{source, bytes_in_use, peak_bytes_in_use,
    bytes_limit}``.  ``source`` is ``"hbm"`` for a CUDA ``device`` (None
    means the current card once CUDA is initialised: a reading never
    initialises it), ``"rss"`` for the host fallback, whose ``bytes_limit``
    is None.  Keys are always present."""
    if device is None and torch.cuda.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None and torch.device(device).type == "cuda":
        stats = torch.cuda.memory_stats(device)
        return {
            "source": "hbm",
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(device)[1],
        }
    return {
        "source": "rss",
        "bytes_in_use": host_rss_bytes(),
        "peak_bytes_in_use": host_peak_rss_bytes(),
        "bytes_limit": None,
    }


def publish_gauges(snapshot: dict, registry=None) -> None:
    """Set the ``tpu_dist_hbm_{in_use,peak,limit}_bytes`` gauges from
    one snapshot (labeled with its source, so an RSS fallback never
    masquerades as a chip reading in a scrape)."""
    from tpu_dist_torch.observe import registry as reg_mod

    reg = registry if registry is not None else reg_mod.REGISTRY
    src = snapshot.get("source", "?")
    for key, name, help_ in (
        ("bytes_in_use", "tpu_dist_hbm_in_use_bytes",
         "live device-memory (or host-RSS fallback) bytes in use"),
        ("peak_bytes_in_use", "tpu_dist_hbm_peak_bytes",
         "peak device-memory (or host-RSS fallback) bytes"),
        ("bytes_limit", "tpu_dist_hbm_limit_bytes",
         "device-memory capacity (absent on the RSS fallback)"),
    ):
        value = snapshot.get(key)
        if value is not None:
            reg.gauge(name, help_).set(value, source=src)


class WatermarkSampler:
    """Phase-bucketed peak-memory accounting for one rank.

    Each `sample(phase)` takes a snapshot and attributes the watermark
    delta (``peak_bytes_in_use`` growth since the previous sample) to
    ``phase``; per-phase buckets accumulate ``{samples, delta_bytes,
    peak_bytes}``.  The watermark only ever rises, so the sum of the
    per-phase deltas is the run's total peak growth and the phase with
    the largest delta is where the footprint was built.  Every rise
    also lands one ``memory`` record in the flight ring — the per-rank
    memory trajectory a post-mortem merge renders."""

    def __init__(self, device=None, *, flight=None, registry=None):
        self.device = device
        self.flight = flight if flight is not None else _flightrec.get()
        self.registry = registry
        self.phases: dict[str, dict] = {}
        self.last: dict | None = None
        self._last_peak: int | None = None
        self.last_phase: str | None = None

    def snapshot(self) -> dict:
        """The most recent sample (a fresh unbucketed reading when
        never sampled — probing must not invent a phase delta)."""
        if self.last is None:
            return memory_snapshot(self.device)
        return dict(self.last)

    def sample(self, phase: str) -> dict:
        snap = memory_snapshot(self.device)
        peak = snap.get("peak_bytes_in_use")
        bucket = self.phases.setdefault(
            phase, {"samples": 0, "delta_bytes": 0, "peak_bytes": None}
        )
        bucket["samples"] += 1
        if peak is not None:
            delta = peak - self._last_peak if self._last_peak is not None else 0
            if delta > 0:
                bucket["delta_bytes"] += int(delta)
                # ring record only when the watermark MOVED: a steady-
                # state step adds nothing, so the ring keeps its step
                # history instead of drowning in flat memory lines
                self.flight.record(
                    "memory", phase=phase, peak_bytes=int(peak),
                    delta_bytes=int(delta), source=snap.get("source"),
                )
            bucket["peak_bytes"] = int(peak)
            self._last_peak = int(peak)
        self.last = snap
        self.last_phase = phase
        publish_gauges(snap, self.registry)
        return snap


# ------------------------------------------------------------ OOM forensics


# Substrings that mark an allocation failure on the step path (torch's
# "CUDA out of memory", XLA's RESOURCE_EXHAUSTED).
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "resource exhausted", "out of memory",
               "Out of memory")
# bare "OOM" only as a whole word — a substring match would flag
# unrelated text like "BLOOM" and pollute the forensics with spurious
# flight dumps
_OOM_WORD = _re.compile(r"\bOOM\b")


def is_resource_exhausted(exc: BaseException) -> bool:
    """True when ``exc`` is an allocation failure worth a memory
    post-mortem: ``torch.OutOfMemoryError``, a `MemoryError`, or any
    exception whose message (or type name) carries an OOM marker."""
    if isinstance(exc, (torch.OutOfMemoryError, MemoryError)):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return (any(marker in text for marker in OOM_MARKERS)
            or bool(_OOM_WORD.search(text)))


def oom_report(*, phase: str | None, snapshot: dict | None = None,
               resident: list | None = None, plan: dict | None = None,
               error: str | None = None) -> dict:
    """The plan-vs-live OOM story: which PHASE was executing, how much
    HEADROOM the device had (``bytes_limit - bytes_in_use``; None on
    the RSS fallback, which has no budget), the top RESIDENT classes
    (params / opt / ef_residual / kv_pool / weights / batch — whatever
    the caller can attribute), and the static plan's numbers when one
    is on hand, so "live exceeded plan" is readable from the dump."""
    snap = snapshot or memory_snapshot()
    limit = snap.get("bytes_limit")
    in_use = snap.get("bytes_in_use")
    headroom = (
        int(limit) - int(in_use)
        if limit is not None and in_use is not None else None
    )
    rows = sorted(
        (dict(r) for r in (resident or []) if r.get("bytes") is not None),
        key=lambda r: -int(r["bytes"]),
    )
    return {
        "phase": phase,
        "source": snap.get("source"),
        "bytes_in_use": in_use,
        "peak_bytes_in_use": snap.get("peak_bytes_in_use"),
        "bytes_limit": limit,
        "headroom_bytes": headroom,
        "resident": rows,
        "top_class": rows[0]["class"] if rows else None,
        "plan": plan,
        "error": error,
    }


def record_oom(exc: BaseException, *, phase: str | None = None,
               sampler: WatermarkSampler | None = None,
               resident: list | None = None, plan: dict | None = None,
               events_logger=None, dirpath: str | None = None) -> dict:
    """The one OOM entry point every step path calls: build the
    plan-vs-live report, append it to the flight ring as a ``mark``
    (``what: "oom"``), dump the ring via `flightrec.crash_dump("oom")`
    — the supervisor gathers it like any flight dump — and emit an
    ``oom`` telemetry event.  Never raises (it runs on a crash path);
    returns the report."""
    try:
        snap = None
        if sampler is not None:
            # a FRESH reading at failure time — the sampler's last
            # sample predates the failing allocation, so its in-use
            # number would overstate the headroom.  Exception: a
            # tracked (hbm) snapshot the live probe cannot reproduce
            # stays authoritative — that is the documented fake-
            # bytes_limit test hook on backends with no tracked HBM.
            snap = memory_snapshot(sampler.device)
            last = sampler.last
            if (last is not None and last.get("source") == "hbm"
                    and snap.get("source") != "hbm"):
                snap = dict(last)
        if phase is None and sampler is not None:
            phase = sampler.last_phase
        report = oom_report(
            phase=phase, snapshot=snap, resident=resident, plan=plan,
            error=f"{type(exc).__name__}: {str(exc)[:500]}",
        )
    except Exception:
        report = {"phase": phase, "error": repr(exc), "headroom_bytes": None,
                  "top_class": None}
    try:
        _flightrec.get().record("mark", what="oom", t_mark=time.time(),
                                **report)
    except Exception:
        pass
    try:
        _flightrec.crash_dump("oom", dirpath=dirpath)
    except Exception:
        pass
    try:
        log = events_logger if events_logger is not None else _events.from_env()
        log.emit(
            "oom",
            phase=report.get("phase"),
            headroom_bytes=report.get("headroom_bytes"),
            top_class=report.get("top_class"),
            source=report.get("source"),
            bytes_in_use=report.get("bytes_in_use"),
            bytes_limit=report.get("bytes_limit"),
            resident=report.get("resident"),
            error=report.get("error"),
        )
    except Exception:
        pass
    return report
