"""The training loop: ``run(rank, size)`` of the reference, one process per
rank over ``torch.distributed``.

Per batch: forward, the loss (``nll_loss`` by default, ``cross_entropy``
for the image models), backward (over ``accum_steps`` microbatches, the
loss scaled under the guard's ``loss_scale``), `average_gradients` (by
default one flat all-reduce; with ``grad_reduce="ring"`` one ring call per
tensor; either way the loss rides along, so every rank reports the
global batch's mean loss, as the JAX Trainer does, and the model's
floating buffers, its batch-norm statistics, are averaged over ranks as
the JAX step pmeans its model state), SGD step (under ``nan_guard``
computed out of place and kept only when every gradient is finite).  Per epoch: the mean loss and
samples/s, read from the device once, the held-out accuracy given
``eval_dataset``, ``bad_steps`` under the guard, and given
``checkpoint_dir`` an asynchronous ``ckpt_<epoch>.npz``.  Without a
process group the Trainer runs a world of one and issues no collective.

The model's state is its buffers: batch norm updates them in place in
training (once a step under ``remat``: the recompute leaves them alone),
each microbatch in turn, and evaluation reads them.  Checkpoints hold
``{"params", "model_state", "opt_state"}`` in the JAX package's layout
(`interop`: convolution weights and their momentum buffers HWIO), so
either package's `Trainer.restore` reads the other's.
The profiler trace (``trace_dir``), telemetry and in-flight steps wait for
resilience and observability (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint as remat_call

from tpu_dist_torch import interop
from tpu_dist_torch.comm.collectives import all_reduce
from tpu_dist_torch.data.loader import DistributedLoader
from tpu_dist_torch.device import resolve_device, to_device
from tpu_dist_torch.nn.layers import frozen_statistics
from tpu_dist_torch.nn.losses import nll_loss
from tpu_dist_torch.parallel.data_parallel import (
    accumulate_gradients,
    average_gradients,
    broadcast_parameters,
    check_backend,
)
from tpu_dist_torch.resilience.guards import bad_steps, nan_guard, poison_if_nonfinite
from tpu_dist_torch.resilience.preempt import PreemptionGuard
from tpu_dist_torch.train import checkpoint
from tpu_dist_torch.train.optim import sgd, sgd_rule

# the floating dtypes `jnp.dtype(compute_dtype)` names in the JAX trainers
COMPUTE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def compute_dtype_of(name: str | None) -> torch.dtype | None:
    if name is not None and name not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)} or None, got {name!r}"
        )
    return None if name is None else COMPUTE_DTYPES[name]


def guarded(optimizer, config):
    """``optimizer`` under `nan_guard` as the JAX trainers wrap it: with
    ``loss_scale`` the dynamic scale starts there; without it the guard
    only skips and counts (its scale pinned to 1.0)."""
    if config.loss_scale is not None and not config.nan_guard:
        raise ValueError("loss_scale requires nan_guard=True")
    if not config.nan_guard:
        return optimizer
    if config.loss_scale is None:
        return nan_guard(optimizer, max_scale=1.0)
    return nan_guard(optimizer, init_scale=config.loss_scale)


@dataclass
class TrainConfig:
    """The reference's hyperparameters (batch 128, lr 0.01, momentum 0.5,
    10 epochs, seed 1234 — train_dist.py:85,105,110,113)."""

    epochs: int = 10
    global_batch: int = 128
    lr: float = 0.01
    momentum: float = 0.5
    seed: int = 1234
    log: Callable[[str], None] = print
    # Gradient reduction (`parallel.average_gradients`): "psum", one flat
    # all-reduce (the default), or "ring", the hand-rolled ring per tensor
    # (the ring kernel on the card); both exact.
    grad_reduce: str = "psum"
    # Forward and backward on a copy of the float32 masters in this type
    # ("bfloat16", "float16"); the loss in float32; buffers stay float32.
    compute_dtype: str | None = None
    # Recompute the forward during the backward (torch.utils.checkpoint).
    remat: bool = False
    # Microbatches per step: each rank's batch split along axis 0, one
    # backward each, the mean gradient over the global batch unchanged.
    accum_steps: int = 1
    # Skip-and-count of non-finite steps (EpochStats.bad_steps); loss_scale
    # arms the dynamic loss scale.
    nan_guard: bool = False
    loss_scale: float | None = None


@dataclass
class EpochStats:
    epoch: int
    mean_loss: float
    seconds: float
    samples_per_sec: float
    eval_accuracy: float | None = None
    # cumulative non-finite steps skipped by the guard (None: guard off)
    bad_steps: int | None = None


class Trainer:
    """Data-parallel SGD for a classifier: a `tpu_dist_torch.nn.Sequential`
    (the ConvNet, ResNet-18) or a module with the same call, ``model(x,
    generator)`` (the ViT).

    The model arrives initialized; the Trainer moves it to ``device`` and,
    in a process group, overwrites every rank's parameters and buffers
    with rank 0's, so the replicas start equal however each rank built its
    model.  ``loss(scores, labels)`` is the training loss.  ``seed``
    drives the data order and, per rank and epoch, the dropout generator.
    ``optimizer`` is torch's SGD; ``rule`` its `Optimizer` form (under
    ``nan_guard``, guarded) and ``opt_state`` the state in the JAX layout's
    structure, its tensors torch's buffers."""

    def __init__(
        self,
        model: torch.nn.Module,
        config: TrainConfig | None = None,
        *,
        device: str | torch.device | None = None,
        loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = nll_loss,
    ):
        self.device = resolve_device(device)
        self.loss = loss
        self.config = config or TrainConfig()
        check_backend(self.config.grad_reduce)
        self.compute_dtype = compute_dtype_of(self.config.compute_dtype)
        self.distributed = dist.is_initialized()
        if self.distributed:
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.world = 0, 1
        self.model = model.to(self.device)
        if self.distributed:
            broadcast_parameters(self.model)
        self.named_params = dict(self.model.named_parameters())
        self.params = list(self.named_params.values())
        # the model's state (batch-norm statistics): averaged over ranks every step
        self.float_buffers = [b for b in self.model.buffers() if b.is_floating_point()]
        self.optimizer = sgd(self.params, self.config.lr, self.config.momentum)
        self.rule = guarded(sgd_rule(self.optimizer), self.config)
        self.opt_state = self.rule.init(self.named_params)
        self.generator = torch.Generator(self.device).manual_seed(
            self.config.seed + 1 + 1000 * self.rank
        )

    def _scores(self, x: torch.Tensor) -> torch.Tensor:
        """The training forward, float32 scores; in ``compute_dtype`` on a
        cast of the masters (gradients land on the masters)."""
        if self.compute_dtype is None:
            return self.model(x, self.generator)
        cast = {
            k: p.to(self.compute_dtype) if p.is_floating_point() else p
            for k, p in self.named_params.items()
        }
        return functional_call(
            self.model, cast, (x.to(self.compute_dtype), self.generator)
        ).float()

    def _loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if not self.config.remat:
            return self.loss(self._scores(x), y)
        # The recompute draws the same dropout bits: it starts the
        # generator where the forward started it, and leaves it where the
        # forward left it.  It leaves the batch-norm statistics alone: the
        # forward has updated them, as jax.checkpoint returns the new state
        # once.
        start = self.generator.get_state()

        def forward(x):
            self.generator.set_state(start)
            return self._scores(x)

        scores = remat_call(
            forward, x, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), frozen_statistics(self.model)),
        )
        return self.loss(scores, y)

    def train_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One SGD step on this rank's batch; returns the loss averaged over
        ranks, as a 0-d tensor on the device (not synchronized)."""
        cfg = self.config
        self.model.train()
        scale = self.rule.current_scale(self.opt_state) if cfg.loss_scale is not None else None
        loss = accumulate_gradients(
            self._loss, self.params, (x, y), accum_steps=cfg.accum_steps, scale=scale
        ).reshape(1)
        grads = [p.grad for p in self.params]
        if cfg.nan_guard:
            poison_if_nonfinite(grads, loss)
        if self.distributed:
            average_gradients(grads + [loss], backend=cfg.grad_reduce,
                              state=self.float_buffers)
        self.rule.update(self.named_params, dict(zip(self.named_params, grads)), self.opt_state)
        return loss.reshape(())

    # ---------------------------------------------------------------- state

    def _ckpt_tree(self) -> dict:
        """The checkpointed state in the JAX Trainer's layout, as views of
        the live tensors: `save` copies them, `restore` writes into them."""
        n = interop.num_layers(self.model)
        return {
            "params": jax_layout(self.named_params, self.named_params, n),
            "model_state": interop.jax_views(dict(self.model.named_buffers()), n),
            "opt_state": jax_layout(self.opt_state, self.named_params, n),
        }

    def save(self, path, *, epoch: int = 0, async_writer=None) -> None:
        """Checkpoint the training state (rank 0 writes); with
        ``async_writer`` (a `checkpoint.AsyncCheckpointer`) the file is
        written while training goes on."""
        writer = async_writer or checkpoint
        writer.save(path, self._ckpt_tree(), step=epoch)

    def restore(self, path) -> int:
        """Load state written by `save` (or by the JAX Trainer) into this
        trainer's tensors; returns the stored epoch (the resume point)."""
        live = self._ckpt_tree()
        loaded, epoch = checkpoint.restore(path, live)
        restore_leaves(live, loaded)
        return epoch

    # ------------------------------------------------------------------ fit

    def fit(
        self,
        dataset,
        *,
        epochs: int | None = None,
        start_epoch: int = 0,
        checkpoint_dir: str | None = None,
        eval_dataset=None,
    ) -> list[EpochStats]:
        """Train epochs ``start_epoch`` .. ``epochs`` (the config's by
        default).  ``checkpoint_dir``: ``ckpt_<epoch>.npz`` after each epoch
        (step ``epoch + 1``), written asynchronously; on SIGTERM or SIGINT
        the loop stops at the next step boundary and writes
        ``ckpt_preempt.npz`` (step ``epoch``: the interrupted epoch is
        redone).  ``eval_dataset``: held-out accuracy after each epoch."""
        cfg = self.config
        loader = DistributedLoader(
            dataset, self.world, cfg.global_batch, rank=self.rank, seed=cfg.seed
        )
        if loader.steps_per_epoch == 0:
            raise ValueError(
                f"dataset of {len(dataset)} samples gives each of the "
                f"{self.world} shards fewer than the local batch "
                f"({loader.local_batch}) — zero steps per epoch"
            )
        history = []
        with checkpoint.AsyncCheckpointer() as writer, PreemptionGuard() as preempt:
            for epoch in range(start_epoch, epochs if epochs is not None else cfg.epochs):
                # dropout bits a function of (seed, rank, epoch): a resumed
                # run draws what an uninterrupted one draws
                self.generator.manual_seed(
                    int(np.random.SeedSequence([cfg.seed + 1, self.rank, epoch])
                        .generate_state(1)[0])
                )
                t0 = time.perf_counter()
                total = torch.zeros((), dtype=torch.float64, device=self.device)
                for xb, yb in loader.epoch(epoch):
                    total += self.train_step(to_device(xb, self.device), to_device(yb, self.device))
                    if preempt.requested:
                        break
                if preempt.requested:
                    if checkpoint_dir is not None:
                        writer.wait()
                        self.save(f"{checkpoint_dir}/ckpt_preempt.npz", epoch=epoch)
                    cfg.log(
                        f"preemption ({preempt.signal_name}) at epoch {epoch}: "
                        + ("checkpoint written, stopping" if checkpoint_dir is not None
                           else "no checkpoint_dir, stopping")
                    )
                    break
                mean_loss = total.item() / loader.steps_per_epoch  # waits for the device
                dt = time.perf_counter() - t0
                sps = loader.steps_per_epoch * cfg.global_batch / dt
                acc = self.evaluate(eval_dataset) if eval_dataset is not None else None
                bad = bad_steps(self.opt_state)  # None without the guard
                cfg.log(
                    f"Rank {self.rank} of {self.world}, epoch {epoch}: "
                    f"{mean_loss:.4f}  [{sps:,.0f} samples/s]"
                    + (f"  eval acc {acc:.4f}" if acc is not None else "")
                    + (f"  bad_steps {bad}" if bad else "")
                )
                history.append(EpochStats(epoch, mean_loss, dt, sps, acc, bad))
                if checkpoint_dir is not None:
                    self.save(f"{checkpoint_dir}/ckpt_{epoch}.npz", epoch=epoch + 1,
                              async_writer=writer)
        return history

    @torch.no_grad()
    def evaluate(self, dataset, *, batch_size: int = 1024) -> float:
        """Top-1 accuracy with dropout off and the running batch-norm
        statistics, in float32 (``compute_dtype`` aside, as the JAX
        Trainer evaluates).  Every sample is scored: the
        trailing partial batch is zero-padded to the batch shape and the
        padding left out of the count.  Ranks take batches in turn and sum
        their counts."""
        n = len(dataset)
        if n == 0:
            raise ValueError("cannot evaluate an empty dataset")
        batch_size = min(batch_size, n)
        self.model.eval()
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for i, start in enumerate(range(0, n, batch_size)):
            if i % self.world != self.rank:
                continue
            xs = dataset.images[start : start + batch_size]
            ys = dataset.labels[start : start + batch_size]
            if len(xs) < batch_size:
                pad = np.zeros((batch_size - len(xs),) + xs.shape[1:], xs.dtype)
                xs = np.concatenate([xs, pad])
            scores = self.model(to_device(xs, self.device))
            pred = scores[: len(ys)].argmax(-1)
            correct += (pred == to_device(ys, self.device)).sum()
        if self.distributed:
            all_reduce(correct)
        return correct.item() / n


def jax_layout(node, params: dict, num_layers: int | None = None):
    """A trainer's state in the JAX package's layout, as views of its
    tensors: every dict keyed by the parameter names becomes
    `interop.jax_views`'s tree (a ``Sequential``'s tuple of layers with
    ``num_layers``), every other dict keeps its keys."""
    if isinstance(node, dict) and node.keys() == params.keys():
        return interop.jax_views(node, num_layers)
    if isinstance(node, dict):
        return {k: jax_layout(v, params, num_layers) for k, v in node.items()}
    return interop.jax_view(node)


@torch.no_grad()
def restore_leaves(live, loaded) -> None:
    """Copy each array of ``loaded`` (a restored tree) into the view at the
    same path of ``live`` (`_ckpt_tree`: both in the JAX layout); shapes
    must match."""
    pairs = zip(checkpoint.flatten_with_paths(live), checkpoint.flatten_with_paths(loaded),
                strict=True)
    for (path, view), (_, array) in pairs:
        if array.shape != tuple(view.shape):
            raise ValueError(f"checkpoint leaf {path}: shape {array.shape} vs {tuple(view.shape)}")
        view.copy_(torch.from_numpy(array))
