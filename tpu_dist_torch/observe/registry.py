"""Metrics registry: counters, gauges, histograms and a Prometheus scrape.

The port's own copy of `tpu_dist.observe.registry`, with the same metric
names (``tpu_dist_serve_*`` from the serving engine).  In-process,
label-aware, stdlib-only.  `MetricsRegistry.render` emits the Prometheus
text exposition format (version 0.0.4); `serve` exposes it on ``/metrics``
from a daemon thread, and `maybe_serve_from_env` turns it on when
``TPU_DIST_METRICS_PORT`` is set (port 0 = ephemeral).  The engine
publishes into the module-level ``REGISTRY`` so one scrape shows the whole
process.
"""

from __future__ import annotations

import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

ENV_PORT = "TPU_DIST_METRICS_PORT"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# step-time-shaped default buckets (seconds), 1ms..10s
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0,
)


def _escape_label_value(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _check_name(name: str, what: str = "metric") -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid {what} name {name!r}")
    return name


def _labels_key(labels: dict) -> tuple:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _labels_str(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing count (increments must be >= 0)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_labels_key(labels), 0.0)

    def render(self) -> list[str]:
        lines = []
        with self._lock:
            for key, v in sorted(self._values.items()):
                lines.append(f"{self.name}{_labels_str(key)} {v}")
        # No fabricated 0.0 sample before the first observation: a scrape
        # must not show a measured-looking zero (Prometheus convention:
        # omit a series until it has a value).
        return lines


class Gauge:
    """A value that goes up and down (loss, loss scale, queue depth)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_labels_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_labels_key(labels), 0.0)

    def render(self) -> list[str]:
        lines = []
        with self._lock:
            for key, v in sorted(self._values.items()):
                lines.append(f"{self.name}{_labels_str(key)} {v}")
        # No fabricated 0.0 sample before the first observation: a scrape
        # must not show a measured-looking zero (Prometheus convention:
        # omit a series until it has a value).
        return lines


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each ``le``
    bucket counts observations <= its bound, plus ``+Inf``/sum/count)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = _check_name(name)
        self.help = help
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        # label-key -> [bucket counts..., +Inf count, sum]
        self._values: dict[tuple, list[float]] = {}

    def observe(self, value: float, **labels) -> None:
        key = _labels_key(labels)
        with self._lock:
            row = self._values.setdefault(
                key, [0.0] * (len(self.buckets) + 2)
            )
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    row[i] += 1
            row[-2] += 1  # +Inf
            row[-1] += value  # sum

    def count(self, **labels) -> float:
        row = self._values.get(_labels_key(labels))
        return row[-2] if row else 0.0

    def render(self) -> list[str]:
        lines = []
        with self._lock:
            for key, row in sorted(self._values.items()):
                for i, bound in enumerate(self.buckets):
                    labels = tuple(sorted(key + (("le", str(bound)),)))
                    lines.append(
                        f"{self.name}_bucket{_labels_str(labels)} {row[i]}"
                    )
                inf = key + (("le", "+Inf"),)
                lines.append(
                    f"{self.name}_bucket{_labels_str(tuple(sorted(inf)))} {row[-2]}"
                )
                lines.append(f"{self.name}_sum{_labels_str(key)} {row[-1]}")
                lines.append(f"{self.name}_count{_labels_str(key)} {row[-2]}")
        return lines


class MetricsRegistry:
    """Named metrics + the text exposition.  ``counter``/``gauge``/
    ``histogram`` are get-or-create (idempotent across call sites);
    re-registering a name as a different kind raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}"
                    )
                return existing
            metric = cls(name, help, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def render(self) -> str:
        out = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, metric in metrics:
            if metric.help:
                out.append(f"# HELP {name} {metric.help}")
            out.append(f"# TYPE {name} {metric.kind}")
            out.extend(metric.render())
        return "\n".join(out) + "\n"

    def serve(self, port: int = 0, addr: str = "127.0.0.1") -> "MetricsServer":
        return MetricsServer(self, port=port, addr=addr)


class MetricsServer:
    """``/metrics`` on a daemon thread.  ``.port`` is the bound port
    (useful with port 0); ``.close()`` shuts it down."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 addr: str = "127.0.0.1"):
        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = reg.render().encode("utf-8")
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stdout
                pass

        self._httpd = ThreadingHTTPServer((addr, port), Handler)
        self.addr = addr
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="tpu-dist-metrics",
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


# The process-wide registry (what the serving engine publishes into) and
# its lazily-started server.
REGISTRY = MetricsRegistry()
_server: MetricsServer | None = None
_server_lock = threading.Lock()


def maybe_serve_from_env(registry: MetricsRegistry = REGISTRY):
    """Start (once) the ``/metrics`` endpoint on ``TPU_DIST_METRICS_PORT``
    if set; returns the server or None.  Bind failures are downgraded to
    a warning — metrics export must never kill a training run."""
    raw = os.environ.get(ENV_PORT)
    if raw is None:
        return None
    global _server
    with _server_lock:
        if _server is not None:
            return _server
        try:
            _server = registry.serve(port=int(raw))
        except (OSError, ValueError) as e:
            import warnings

            warnings.warn(
                f"could not serve metrics on {ENV_PORT}={raw!r}: {e}",
                RuntimeWarning,
                stacklevel=2,
            )
            return None
        return _server
