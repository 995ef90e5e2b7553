"""LMTrainer: data-parallel training of the TransformerLM over token windows.

The port of `tpu_dist.train.LMTrainer` on its data-parallel path: per step
the dense next-token loss on the global batch (each rank its slice), the
gradients averaged over ranks with one all-reduce that also carries the
loss, and AdamW.  Per epoch the JAX package's order
(``default_rng(seed + epoch).permutation``), ``n // global_batch`` steps,
the mean loss, tokens/s and, given ``val_windows``, the validation
perplexity.

``compute_dtype`` (``"float32"``, ``"bfloat16"`` or ``"float16"``) runs the
forward and backward on a copy of the float32 master parameters in that
type, cast where the JAX package casts (every floating leaf, before the
forward), and the gradients land on the masters; the loss is a float32
log-softmax of the logits.

Not ported yet (ROADMAP queue 1, item 8): fsdp, zero1, tensor, sequence,
pipeline and MoE modes, compressed gradients, partition rules, the NaN
guard and loss scaling, in-flight steps, ``accum_steps != 1``,
checkpoints and ``restore``, ``generate``, telemetry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.models.transformer_lm import lm_loss, lm_perplexity
from tpu_dist_torch.parallel.data_parallel import average_gradients, broadcast_parameters
from tpu_dist_torch.train.optim import Optimizer, adamw, clip_by_global_norm

# the floating dtypes `jnp.dtype(compute_dtype)` names in the JAX trainer
_COMPUTE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclass
class LMTrainConfig:
    epochs: int = 3
    global_batch: int = 64
    lr: float = 3e-3
    seed: int = 1234
    accum_steps: int = 1
    compute_dtype: str | None = None  # e.g. "bfloat16"
    grad_clip: float | None = None  # global-norm clipping
    log: Callable[[str], None] = print


@dataclass
class LMEpochStats:
    epoch: int
    mean_loss: float
    seconds: float
    tokens_per_sec: float
    val_loss: float | None = None
    val_perplexity: float | None = None


class LMTrainer:
    """Data-parallel LM training over ``(N, S)`` token windows.

    The model arrives initialized; the trainer moves it to ``device``, in a
    process group overwrites every rank's parameters and buffers with rank
    0's (the replicas start equal however each rank built the model), and
    keeps its float32 parameters as the masters the optimizer updates in
    place."""

    def __init__(
        self,
        lm: torch.nn.Module,
        config: LMTrainConfig | None = None,
        *,
        optimizer: Optimizer | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.config = config or LMTrainConfig()
        if self.config.accum_steps != 1:
            raise ValueError(
                f"accum_steps={self.config.accum_steps} is not ported yet (ROADMAP "
                "queue 1, item 8); use accum_steps=1"
            )
        compute = self.config.compute_dtype
        if compute is not None and compute not in _COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)} or None, "
                f"got {compute!r}"
            )
        self.compute_dtype = None if compute is None else _COMPUTE_DTYPES[compute]
        self.distributed = dist.is_initialized()
        if self.distributed:
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.world = 0, 1
        self.lm = lm.to(self.device)
        if self.distributed:
            broadcast_parameters(self.lm)
        self.params = dict(self.lm.named_parameters())
        self.optimizer = optimizer or adamw(self.config.lr)
        if self.config.grad_clip is not None:
            self.optimizer = clip_by_global_norm(self.optimizer, self.config.grad_clip)
        self.opt_state = self.optimizer.init(
            {k: p.detach() for k, p in self.params.items()}
        )

    def loss_and_grads(self, tokens: torch.Tensor) -> torch.Tensor:
        """Forward and backward on this rank's (b, s) tokens: leaves the
        gradients in each master's ``.grad`` and returns the loss (0-d,
        detached)."""
        for p in self.params.values():
            p.grad = None
        if self.compute_dtype is None:
            logits = self.lm(tokens)
        else:
            cast = {
                k: p.to(self.compute_dtype) if p.is_floating_point() else p
                for k, p in self.params.items()
            }
            logits = functional_call(self.lm, cast, (tokens,))
        loss = lm_loss(logits.float(), tokens)
        loss.backward()
        return loss.detach()

    def train_step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One AdamW step; returns the loss averaged over ranks, a 0-d
        tensor on the device (not synchronized)."""
        loss = self.loss_and_grads(tokens).reshape(1)
        grads = {k: p.grad for k, p in self.params.items()}
        if self.distributed:
            average_gradients(list(grads.values()) + [loss])
        self.optimizer.update(self.params, grads, self.opt_state)
        return loss.reshape(())

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def fit(
        self, windows, *, epochs: int | None = None, val_windows=None
    ) -> list[LMEpochStats]:
        """``windows``: (N, S) int tokens (e.g. `models.synthetic_tokens`)."""
        cfg = self.config
        windows = np.asarray(windows)
        n, s = windows.shape
        gb = cfg.global_batch
        if n < gb:
            raise ValueError(
                f"{n} windows < global batch {gb} — shrink the batch or use more data"
            )
        if gb % self.world:
            raise ValueError(f"global batch {gb} does not split over {self.world} ranks")
        local = gb // self.world
        steps_per_epoch = n // gb
        history = []
        for epoch in range(epochs if epochs is not None else cfg.epochs):
            order = np.random.default_rng(cfg.seed + epoch).permutation(n)
            t0 = time.perf_counter()
            total = torch.zeros((), dtype=torch.float64, device=self.device)
            for b in range(steps_per_epoch):
                batch = windows[order[b * gb : (b + 1) * gb]]
                mine = batch[self.rank * local : (self.rank + 1) * local]
                total += self.train_step(self._to_device(mine))
            mean = total.item() / steps_per_epoch  # waits for the device
            dt = time.perf_counter() - t0
            tps = steps_per_epoch * gb * s / dt
            vloss = vppl = None
            if val_windows is not None:
                vloss, vppl = lm_perplexity(
                    self.lm, val_windows, batch=min(64, len(val_windows))
                )
            cfg.log(
                f"epoch {epoch}: loss {mean:.4f}  [{tps:,.0f} tok/s]"
                + (f"  val loss {vloss:.4f} ppl {vppl:.1f}" if vppl else "")
            )
            history.append(LMEpochStats(epoch, mean, dt, tps, vloss, vppl))
        return history
