"""Retry, timeout and backoff for the bootstrap: bounded, jittered, logged.

The port's copy of `tpu_dist.resilience.retry` (which imports no jax; the
port keeps its own copy all the same, since it imports nothing of
`tpu_dist`).  Transient rendezvous failures are absorbed by bounded
exponential backoff with jitter, and only a persistent failure surfaces, as
a typed error (`RendezvousTimeout`, `WorkerFailed`) instead of a hang.

`retry_call` takes ``sleep``, ``clock``, ``rng`` and ``log``, so that its
schedule is testable with a fake clock.  The JAX package's chaos gate and
its structured retry events are not ported yet: they come with the
resilience and observability slice.

Environment (read by `RetryPolicy.from_env`, used by `comm.init_process_group`):

    TPU_DIST_RDZV_RETRIES      max attempts (default 5)
    TPU_DIST_RDZV_BASE_DELAY   first backoff in seconds (default 0.25)
    TPU_DIST_RDZV_MAX_DELAY    backoff cap in seconds (default 8.0)
    TPU_DIST_STARTUP_DEADLINE  overall deadline in seconds (default none)
"""

from __future__ import annotations

import logging
import os
import random
import time
from dataclasses import dataclass
from typing import Any, Callable

logger = logging.getLogger("tpu_dist_torch.resilience")


class RendezvousTimeout(RuntimeError):
    """The rendezvous or the process-group init did not succeed within the
    retry budget or the startup deadline."""


class WorkerFailed(RuntimeError):
    """A launched worker died (or failed) and the launcher's restart budget
    is spent."""


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: attempt ``i`` sleeps ``min(base_delay *
    multiplier**i, max_delay)``, scaled by a uniform jitter factor in ``[1 -
    jitter, 1 + jitter]`` (every worker of a gang retries on the same
    schedule otherwise).  ``deadline`` bounds the whole operation in
    seconds, whatever the attempt count."""

    max_attempts: int = 5
    base_delay: float = 0.25
    max_delay: float = 8.0
    multiplier: float = 2.0
    jitter: float = 0.25
    deadline: float | None = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        d = min(self.base_delay * self.multiplier**attempt, self.max_delay)
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * rng.uniform(-1.0, 1.0)
        return d

    @staticmethod
    def from_env() -> "RetryPolicy":
        def _get(name, cast, default):
            raw = os.environ.get(name)
            if raw is None:
                return default
            try:
                return cast(raw)
            except ValueError:
                raise ValueError(f"{name}={raw!r} is not a valid {cast.__name__}")

        return RetryPolicy(
            max_attempts=_get("TPU_DIST_RDZV_RETRIES", int, 5),
            base_delay=_get("TPU_DIST_RDZV_BASE_DELAY", float, 0.25),
            max_delay=_get("TPU_DIST_RDZV_MAX_DELAY", float, 8.0),
            deadline=_get("TPU_DIST_STARTUP_DEADLINE", float, None),
        )


def retry_call(
    fn: Callable[[int], Any],
    *,
    policy: RetryPolicy | None = None,
    retry_on: tuple[type[BaseException], ...] = (Exception,),
    describe: str = "operation",
    error_type: type[Exception] | None = None,
    log: Callable[[str], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: random.Random | None = None,
) -> Any:
    """Call ``fn(attempt)`` under ``policy``, backing off between failed
    attempts; ``fn`` receives the 0-based attempt index.

    Gives up when the attempts are spent or the policy's deadline has
    passed, then raises ``error_type`` (chained to the last failure) when
    given, else re-raises the last failure.  Each backoff logs one line
    ("attempt i/n failed ...; backing off d s"), which tells a retrying
    bootstrap from a hang."""
    policy = policy or RetryPolicy()
    log = log or logger.warning
    rng = rng or random.Random()
    start = clock()
    last: BaseException | None = None
    attempt = 0
    for attempt in range(policy.max_attempts):
        try:
            return fn(attempt)
        except retry_on as e:
            last = e
            elapsed = clock() - start
            out_of_time = policy.deadline is not None and elapsed >= policy.deadline
            if attempt + 1 >= policy.max_attempts or out_of_time:
                break
            d = policy.delay(attempt, rng)
            if policy.deadline is not None:
                d = min(d, max(policy.deadline - elapsed, 0.0))
            log(f"{describe}: attempt {attempt + 1}/{policy.max_attempts} "
                f"failed ({type(e).__name__}: {e}); backing off {d:.2f}s")
            sleep(d)
    if last is None:  # max_attempts >= 1, so only a caught failure ends the loop
        raise RuntimeError(f"{describe}: no attempt was made")
    if error_type is not None:
        raise error_type(
            f"{describe} failed after {attempt + 1} attempt(s) in "
            f"{clock() - start:.1f}s: {type(last).__name__}: {last}"
        ) from last
    raise last
