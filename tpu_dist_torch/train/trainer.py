"""The training loop: ``run(rank, size)`` of the reference, one process per
rank over ``torch.distributed``.

Per batch: forward, ``nll_loss``, backward, `average_gradients` (by default
one flat all-reduce; with ``grad_reduce="ring"`` one ring call per tensor;
either way the loss rides along, so every rank reports the global batch's
mean loss, as the JAX Trainer does), SGD step.  Per epoch: the mean
loss and samples/s, read from the device once.  Without a process group the
Trainer runs a world of one and issues no collective.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from tpu_dist_torch.comm.collectives import all_reduce
from tpu_dist_torch.data.loader import DistributedLoader
from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.nn.losses import nll_loss
from tpu_dist_torch.parallel.data_parallel import (
    average_gradients,
    broadcast_parameters,
    check_backend,
)
from tpu_dist_torch.train.optim import sgd


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


@dataclass
class EpochStats:
    epoch: int
    mean_loss: float
    seconds: float
    samples_per_sec: float


class Trainer:
    """Data-parallel SGD for a `tpu_dist_torch.nn.Sequential` classifier.

    The model arrives initialized; the Trainer moves it to ``device`` and,
    in a process group, overwrites every rank's parameters and buffers
    with rank 0's, so the replicas start equal however each rank built its
    model.  ``seed`` drives the data order and, offset per rank, the
    dropout generator."""

    def __init__(
        self,
        model: torch.nn.Module,
        config: TrainConfig | None = None,
        *,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.config = config or TrainConfig()
        check_backend(self.config.grad_reduce)
        self.distributed = dist.is_initialized()
        if self.distributed:
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.world = 0, 1
        self.model = model.to(self.device)
        if self.distributed:
            broadcast_parameters(self.model)
        self.params = list(self.model.parameters())
        self.optimizer = sgd(self.params, self.config.lr, self.config.momentum)
        self.generator = torch.Generator(self.device).manual_seed(
            self.config.seed + 1 + 1000 * self.rank
        )

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host batch to the device.  On the card the copy goes through
        pinned memory without blocking, so the host queues the next step
        while the card still runs this one."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def train_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One SGD step on this rank's batch; returns the loss averaged over
        ranks, as a 0-d tensor on the device (not synchronized)."""
        self.model.train()
        self.optimizer.zero_grad()
        loss = nll_loss(self.model(x, self.generator), y)
        loss.backward()
        loss = loss.detach().reshape(1)
        if self.distributed:
            average_gradients([p.grad for p in self.params] + [loss],
                              backend=self.config.grad_reduce)
        self.optimizer.step()
        return loss.reshape(())

    def fit(self, dataset) -> list[EpochStats]:
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
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            total = torch.zeros((), dtype=torch.float64, device=self.device)
            for xb, yb in loader.epoch(epoch):
                total += self.train_step(self._to_device(xb), self._to_device(yb))
            mean_loss = total.item() / loader.steps_per_epoch  # waits for the device
            dt = time.perf_counter() - t0
            sps = loader.steps_per_epoch * cfg.global_batch / dt
            cfg.log(
                f"Rank {self.rank} of {self.world}, epoch {epoch}: "
                f"{mean_loss:.4f}  [{sps:,.0f} samples/s]"
            )
            history.append(EpochStats(epoch, mean_loss, dt, sps))
        return history

    @torch.no_grad()
    def evaluate(self, dataset, *, batch_size: int = 1024) -> float:
        """Top-1 accuracy with dropout off.  Every sample is scored: the
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
            scores = self.model(self._to_device(xs))
            pred = scores[: len(ys)].argmax(-1)
            correct += (pred == self._to_device(ys)).sum()
        if self.distributed:
            all_reduce(correct)
        return correct.item() / n
