"""Step guards: non-finite detection with skip-and-count, and the dynamic
loss scale (the port of `tpu_dist.resilience.guards`, replicated form).

`nan_guard` wraps an `Optimizer` (`train.optim`).  Each update reduces the
gradients to one all-finite flag on the device, runs the inner update out
of place and keeps its result only where the flag holds
(compute-then-select), so a bad step leaves the parameters and the inner
state bit for bit as they were, is counted in ``bad_steps``, and training
goes on.  Nothing is read back to the host: ``bad_steps`` is read at the
epoch's end.

The loss scale: on every bad step ``scale *= backoff``; after
``growth_interval`` good steps in a row ``scale *= growth``; clamped to
``[min_scale, max_scale]``.  The trainers read it with ``current_scale``,
multiply the loss by it before the backward and divide it back out of the
gradients and the loss.

State: ``{"inner": <inner state>, "step", "bad_steps", "good_streak",
"scale"}``, every scalar a 0-d tensor on the parameters' device (int32,
and float32 for ``scale``), the JAX package's layout, so checkpoints carry
it unchanged.  Apply `nan_guard` outermost (over `clip_by_global_norm`).

The chaos injection (``TPU_DIST_CHAOS=nan_step=K``) waits for resilience
(ROADMAP queue 1, item 11), and the sharded form (``shard_update``) for the
parallel strategies (item 10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable

import torch


@dataclass(frozen=True)
class GuardedOptimizer:
    """An optimizer of `train.optim`'s form (``init``, ``update``) whose
    state carries the guard's scalars; ``current_scale(state)`` is the live
    loss scale (a 0-d tensor)."""

    init: Callable[[dict], dict]
    update: Callable[..., None]
    current_scale: Callable[[dict], torch.Tensor]


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """One 0-d bool tensor: every element of every floating tensor is
    finite."""
    checks = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    if not checks:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(checks).all()


def poison_if_nonfinite(grads: Iterable[torch.Tensor], loss: torch.Tensor) -> None:
    """NaN every floating gradient, in place, when ``loss`` is not finite:
    applied before the reduce, so one rank's bad loss makes every rank
    skip the step even where its gradients stayed finite."""
    bad = ~torch.isfinite(loss).reshape(())
    for g in grads:
        if g.is_floating_point():
            g.masked_fill_(bad, float("nan"))


def nan_guard(
    optimizer,
    *,
    init_scale: float = 1.0,
    backoff: float = 0.5,
    growth: float = 2.0,
    growth_interval: int = 200,
    min_scale: float = 1.0,
    max_scale: float = 2.0**16,
) -> GuardedOptimizer:
    """Wrap ``optimizer`` with non-finite skip-and-count and a dynamic loss
    scale (see the module docstring)."""
    if not 0.0 < backoff < 1.0:
        raise ValueError(f"backoff must be in (0, 1), got {backoff}")
    if growth < 1.0:
        raise ValueError(f"growth must be >= 1, got {growth}")
    if growth_interval < 1:
        raise ValueError(f"growth_interval must be >= 1, got {growth_interval}")
    if not min_scale <= init_scale <= max_scale:
        raise ValueError(
            f"need min_scale <= init_scale <= max_scale, got "
            f"{min_scale} / {init_scale} / {max_scale}"
        )

    def init(params: dict) -> dict:
        device = next(iter(params.values())).device if params else None

        def scalar(value, dtype=torch.int32):
            return torch.full((), value, dtype=dtype, device=device)

        return {
            "inner": optimizer.init(params),
            "step": scalar(0),
            "bad_steps": scalar(0),
            "good_streak": scalar(0),
            "scale": scalar(init_scale, torch.float32),
        }

    @torch.no_grad()
    def update(params: dict, grads: dict, state: dict, ok: torch.Tensor | None = None) -> None:
        finite = all_finite(grads.values()).to(state["step"].device)
        if ok is not None:
            finite = finite & ok
        optimizer.update(params, grads, state["inner"], finite)
        good_streak = torch.where(finite, state["good_streak"] + 1, 0)
        grow = finite & (good_streak >= growth_interval)
        good_streak = torch.where(grow, 0, good_streak)
        scale = state["scale"]
        scale = torch.where(finite, torch.where(grow, scale * growth, scale), scale * backoff)
        state["step"] = state["step"] + 1
        state["bad_steps"] = state["bad_steps"] + (~finite).int()
        state["good_streak"] = good_streak.to(torch.int32)
        state["scale"] = scale.clamp(min_scale, max_scale)

    return GuardedOptimizer(init, update, lambda state: state["scale"])


def _guard_state(tree: Any) -> dict | None:
    """The guard's scalar dict inside an optimizer state, or None; found by
    its ``bad_steps`` key."""
    if isinstance(tree, dict):
        if "bad_steps" in tree and "scale" in tree:
            return tree
        for v in tree.values():
            found = _guard_state(v)
            if found is not None:
                return found
    return None


def bad_steps(opt_state: Any) -> int | None:
    """Cumulative skipped steps in a guarded state (None when unguarded);
    one host read."""
    g = _guard_state(opt_state)
    return None if g is None else int(g["bad_steps"])


def loss_scale(opt_state: Any) -> float | None:
    """The live loss scale of a guarded state (None when unguarded)."""
    g = _guard_state(opt_state)
    return None if g is None else float(g["scale"])
