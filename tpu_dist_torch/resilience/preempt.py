"""Preemption: SIGTERM or SIGINT becomes a checkpoint at the next step
boundary (the port of `tpu_dist.resilience.preempt`).

`PreemptionGuard` turns the signal into a flag the training loops poll
after every step: `Trainer.fit` and `LMTrainer.fit` then write one
synchronous checkpoint of the current epoch and return, so a resume
through `checkpoint.latest_intact` finds consistent state.  A second
SIGINT raises `KeyboardInterrupt` at once.  The flag is per process: a
scheduler's drain signals every process of a job.
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Context manager that installs cooperative SIGTERM/SIGINT handlers
    and restores the previous ones on exit.  Off the main thread (where
    ``signal.signal`` is refused) it is an inert flag."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous: dict[int, object] = {}
        self._requested = False
        self._signum: int | None = None

    @property
    def requested(self) -> bool:
        """True once a shutdown signal arrived: checkpoint and stop."""
        return self._requested

    @property
    def signal_name(self) -> str | None:
        return signal.Signals(self._signum).name if self._signum else None

    def _handle(self, signum, frame):
        if self._requested and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self._requested = True
        self._signum = signum

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handle)
            except (ValueError, OSError):
                pass
        return self

    def __exit__(self, *exc_info):
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._previous.clear()
        return False
