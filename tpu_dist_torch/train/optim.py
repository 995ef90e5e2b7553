"""Optimizers.

`sgd`: torch's own SGD with momentum semantics ``buf = m * buf + g;
p -= lr * buf`` (no dampening, no Nesterov, no weight decay), the rule
`tpu_dist.train.sgd` reproduces.  The momentum buffer is
``optimizer.state[p]["momentum_buffer"]``.

`adamw`, `clip_by_global_norm`, `global_norm`, `decay_mask_default`: the
JAX package's optimizer library for the LM, written out by hand (torch's
AdamW applies its decay in another order).  An `Optimizer` here has the
JAX package's two functions, ``init(params) -> state`` and ``update(params,
grads, state)``, over dicts of tensors keyed by parameter name; unlike the
JAX update, which returns new trees, this one updates ``params`` and
``state`` in place, so a step holds no second copy of the model.
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
    update: Callable[[Tree, Tree, dict], None]  # in place


def adamw(
    lr,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    decay_mask: Callable[[str, torch.Tensor], bool] | None = None,
) -> Optimizer:
    """AdamW as tpu_dist/train/optim.py:94-151.  ``lr`` is a float or a
    schedule ``f(step)`` read at the step count *before* this update; bias
    correction in float32; ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd *
    p)``, the decay only where ``decay_mask(name, p)`` holds (everywhere
    when None)."""
    lr_fn = lr if callable(lr) else (lambda _step: lr)

    def init(params: Tree) -> dict:
        return {
            "step": 0,
            "m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    @torch.no_grad()
    def update(params: Tree, grads: Tree, state: dict) -> None:
        cur_lr = float(lr_fn(state["step"]))
        state["step"] += 1
        step = torch.tensor(state["step"], dtype=torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** step)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** step)
        for name, p in params.items():
            g, m, v = grads[name], state["m"][name], state["v"][name]
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square() * (1 - b2))
            direction = (m / bc1) / ((v / bc2).sqrt() + eps)
            decay_on = decay_mask is None or decay_mask(name, p)
            if decay_on and weight_decay:
                direction.add_(p * weight_decay)
            p.sub_(direction * cur_lr)

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

    def update(params: Tree, grads: Tree, state: dict) -> None:
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        clipped = {k: (g * scale).to(g.dtype) for k, g in grads.items()}
        optimizer.update(params, clipped, state)

    return Optimizer(optimizer.init, update)
