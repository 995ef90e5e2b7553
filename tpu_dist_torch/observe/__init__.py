"""`tpu_dist_torch.observe` — the telemetry the serving engine writes.

The port's own copies of the JAX package's `observe` modules, as far as the
engine uses them:

- `events`    — the per-rank JSONL event log (``TPU_DIST_TELEMETRY``), its
                schemas and validators, field for field the JAX package's;
- `registry`  — counters, gauges, histograms and the Prometheus endpoint
                (``TPU_DIST_METRICS_PORT``);
- `flightrec` — the per-rank ring of recent records and its dump;
- `memory`    — live memory readings (the card's allocator, host RSS on
                the CPU), watermarks and OOM forensics.

Spans, heartbeats, attribution and the rest of `flightrec` and `memory` are
ROADMAP queue 1, item 11.
"""

from tpu_dist_torch.observe import events, flightrec, memory, registry

__all__ = ["events", "flightrec", "memory", "registry"]
