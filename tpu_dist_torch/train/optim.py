"""Optimizers.

`sgd`: torch's own SGD with momentum semantics ``buf = m * buf + g;
p -= lr * buf`` (no dampening, no Nesterov, no weight decay), the rule
`tpu_dist.train.sgd` reproduces.  The momentum buffer is
``optimizer.state[p]["momentum_buffer"]``.  `sgd_rule` gives such an
optimizer the `Optimizer` form, with its buffers as the state
``{"buf": ...}`` of the JAX package's layout.

`adamw`, `clip_by_global_norm`, `global_norm`, `decay_mask_default`: the
JAX package's optimizer library for the LM, written out by hand (torch's
AdamW applies its decay in another order).  An `Optimizer` here has the
JAX package's two functions, ``init(params) -> state`` and ``update(params,
grads, state)``, over dicts of tensors keyed by parameter name; unlike the
JAX update, which returns new trees, this one updates ``params`` and
``state`` in place, so a step holds no second copy of the model.  Given
``ok`` (a 0-d bool tensor on the device), ``update`` computes each new
tensor out of place and keeps it only where ``ok`` holds, as the JAX
package's `nan_guard` selects whole states (compute-then-select): the
step is skipped on the device, without a host read.  Every scalar of a
state (AdamW's ``step``) is a 0-d tensor on the parameters' device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch

Tree = dict[str, torch.Tensor]


def sgd(params: Iterable[torch.nn.Parameter], lr: float, momentum: float = 0.0):
    return torch.optim.SGD(
        params, lr=lr, momentum=momentum, dampening=0.0, nesterov=False,
        weight_decay=0.0,
    )


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], dict]
    # update(params, grads, state, ok=None), in place
    update: Callable[..., None]


def _keep(ok: torch.Tensor | None, target: torch.Tensor, new: torch.Tensor) -> None:
    """``target = new``, or where ``ok`` holds when it is given."""
    target.copy_(new if ok is None else torch.where(ok, new, target))


def sgd_rule(optimizer: torch.optim.SGD) -> Optimizer:
    """The `Optimizer` form of an optimizer built by `sgd`.  ``init`` gives
    every parameter a momentum buffer of zeros, as the JAX package's
    ``sgd`` starts (torch would clone the first gradient: the same
    numbers), and returns ``{"buf": {name: buffer}}`` (``{}`` without
    momentum): the tensors torch's own step updates.  ``update`` without
    ``ok`` is torch's step on the parameters' ``.grad``; with ``ok`` it is
    the same rule out of place, selected, by the same operations as
    torch's step, so that with ``ok`` true it gives torch's bits."""
    group = optimizer.param_groups[0]

    def init(params: Tree) -> dict:
        if not group["momentum"]:
            return {}
        bufs = {}
        for name, p in params.items():
            state = optimizer.state[p]
            if state.get("momentum_buffer") is None:
                state["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            bufs[name] = state["momentum_buffer"]
        return {"buf": bufs}

    @torch.no_grad()
    def update(params: Tree, grads: Tree, state: dict, ok: torch.Tensor | None = None) -> None:
        if ok is None:
            optimizer.step()
            return
        lr, momentum = group["lr"], group["momentum"]
        for name, p in params.items():
            direction = grads[name]
            if momentum:
                buf = state["buf"][name]
                direction = buf.mul(momentum).add_(direction)
                _keep(ok, buf, direction)
            _keep(ok, p, p.add(direction, alpha=-lr))

    return Optimizer(init, update)


def adamw(
    lr,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    decay_mask: Callable[[str, torch.Tensor], bool] | None = None,
) -> Optimizer:
    """AdamW as tpu_dist/train/optim.py:94-151.  ``lr`` is a float or a
    schedule ``f(step) -> lr`` read at the step count *before* this update
    (a 0-d int32 tensor on the device: `schedule` computes on it there);
    bias correction in float32; ``p -= lr * (m_hat / (sqrt(v_hat) + eps) +
    wd * p)``, the decay only where ``decay_mask(name, p)`` holds
    (everywhere when None)."""
    lr_fn = lr if callable(lr) else (lambda _step: lr)

    def init(params: Tree) -> dict:
        device = next(iter(params.values())).device if params else None
        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    @torch.no_grad()
    def update(params: Tree, grads: Tree, state: dict, ok: torch.Tensor | None = None) -> None:
        step = state["step"]
        cur_lr = lr_fn(step)
        new_step = step + 1
        t = new_step.float()
        bc1 = 1 - torch.full((), b1, dtype=torch.float32, device=t.device) ** t
        bc2 = 1 - torch.full((), b2, dtype=torch.float32, device=t.device) ** t
        for name, p in params.items():
            g, m, v = grads[name], state["m"][name], state["v"][name]
            if ok is None:
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(g.square() * (1 - b2))
            else:
                m_new = m * b1 + g * (1 - b1)
                v_new = v * b2 + g.square() * (1 - b2)
                _keep(ok, m, m_new)
                _keep(ok, v, v_new)
                m, v = m_new, v_new
            direction = (m / bc1) / ((v / bc2).sqrt() + eps)
            decay_on = decay_mask is None or decay_mask(name, p)
            if decay_on and weight_decay:
                direction.add_(p * weight_decay)
            if ok is None:
                p.sub_(direction * cur_lr)
            else:
                _keep(ok, p, p - direction * cur_lr)
        state["step"] = new_step if ok is None else torch.where(ok, new_step, step)

    return Optimizer(init, update)


def decay_mask_default(path: str, leaf: torch.Tensor) -> bool:
    """Decay matrices; skip biases, norm scales and any 1-D parameter."""
    lowered = path.lower()
    if "bias" in lowered or "scale" in lowered or "b" in lowered.split("."):
        return False
    return leaf.dim() >= 2


def global_norm(tree: Tree) -> torch.Tensor:
    """L2 norm over every tensor of the tree, accumulated in float32."""
    if not tree:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(t.float().square().sum() for t in tree.values()))


def clip_by_global_norm(optimizer: Optimizer, max_norm: float) -> Optimizer:
    """Scale every gradient by ``max_norm / norm`` when the global norm
    exceeds ``max_norm``, then run ``optimizer``."""
    if max_norm <= 0:
        raise ValueError(f"max_norm must be > 0, got {max_norm}")

    def update(params: Tree, grads: Tree, state: dict, ok: torch.Tensor | None = None) -> None:
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        clipped = {k: (g * scale).to(g.dtype) for k, g in grads.items()}
        optimizer.update(params, clipped, state, ok)

    return Optimizer(optimizer.init, update)
