"""Batch loading: the ``DataLoader(partition, bsz, shuffle=True)`` analog.

The same batches as `tpu_dist.data.loader`, bit for bit.  Batches have a
fixed size and the trailing partial batch is dropped; each epoch's order is
``default_rng(seed + epoch).permutation``.  Under ``torch.distributed``
every process loads only its own rank's batches, so `DistributedLoader`
takes the rank: rank ``r`` reads partition ``r`` of the seed-1234 split with
shuffle seed ``seed + 1000 * r``, and its batches are the rows
``[r * local_batch, (r + 1) * local_batch)`` of the JAX loader's rank-major
global batches.  `HostLoader` moves batch assembly and the copy to the
device onto a background thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from tpu_dist_torch.data.mnist import Dataset
from tpu_dist_torch.data.partition import DataPartitioner, Partition, equal_shards
from tpu_dist_torch.device import to_device


class Loader:
    """Single-shard loader over a `Partition` of a `Dataset`: seeded
    per-epoch shuffle, fixed batch size, trailing partial batch dropped."""

    def __init__(self, partition: Partition, batch_size: int, *, seed: int = 1234):
        self.partition = partition
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self) -> int:
        return len(self.partition) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        n = len(self.partition)
        order = np.random.default_rng(self.seed + epoch).permutation(n)
        global_idx = np.asarray(self.partition.indices)[order]
        data = self.partition.data
        for b in range(len(self)):
            idx = global_idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield data.images[idx], data.labels[idx]


class DistributedLoader:
    """One rank's loader over the deterministic equal-shard partition.

    Every rank takes ``steps_per_epoch`` steps, the fewest any rank's shard
    allows, so the ranks' collectives stay matched."""

    def __init__(
        self,
        dataset: Dataset,
        world_size: int,
        global_batch: int = 128,
        *,
        rank: int,
        seed: int = 1234,
    ):
        if global_batch % world_size:
            raise ValueError(
                f"global batch {global_batch} not divisible by world size "
                f"{world_size}"
            )
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world of {world_size}")
        self.world_size = world_size
        self.rank = rank
        self.local_batch = global_batch // world_size
        partitioner = DataPartitioner(dataset, equal_shards(world_size), seed=seed)
        self.steps_per_epoch = min(
            len(p) // self.local_batch for p in partitioner.partitions
        )
        self.loader = Loader(
            partitioner.use(rank), self.local_batch, seed=seed + 1000 * rank
        )

    def __len__(self) -> int:
        return self.steps_per_epoch

    def epoch(self, epoch: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        batches = self.loader.epoch(epoch)
        for _ in range(self.steps_per_epoch):
            yield next(batches)


class _WorkerFailure:
    """Queue marker carrying the worker thread's exception."""

    def __init__(self, error: BaseException):
        self.error = error


_END = object()  # queue marker: the wrapped iterator is exhausted


class HostLoader:
    """Batch assembly and the host-to-device copy on a daemon thread,
    feeding a bounded queue (tpu_dist/data/loader.py:161-278).

    The worker pulls each item (a numpy array, or a tuple of them) from
    ``iterator``, pins it and issues its copy to ``device`` on a copy stream
    of its own, staying up to ``depth`` items ahead; the consumer's stream
    waits for that copy before it uses the tensors, so the copy overlaps the
    steps queued before it.  On the CPU the items become tensors that share
    the arrays' memory.  One worker and a FIFO queue keep the items' order
    and content; a worker exception is re-raised in the consumer, and
    `close` (or leaving the ``with``) always stops and joins the thread."""

    def __init__(self, iterator: Iterator, device: torch.device | str, *, depth: int = 2):
        if depth < 1:
            raise ValueError(f"HostLoader depth must be >= 1, got {depth}")
        self.device = torch.device(device)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None

        def place(a: np.ndarray):
            return to_device(a, self.device, stream=stream)

        def work():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for item in iterator:
                    placed = tuple(map(place, item)) if isinstance(item, tuple) else place(item)
                    ready = None
                    if cuda:
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    if not self._put((placed, ready)):
                        return  # closed mid-epoch: drop the batch and exit
                self._put(_END)
            except BaseException as e:  # noqa: BLE001 — must reach the consumer
                self._put(_WorkerFailure(e))

        self._thread = threading.Thread(target=work, name="host-loader", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """A bounded put that gives up once `close` raised the stop flag."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> "HostLoader":
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        while True:
            try:
                item = self._queue.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._queue.empty():
                    self._done = True
                    raise StopIteration from None
        if item is _END:
            self._done = True
            raise StopIteration
        if isinstance(item, _WorkerFailure):
            self._done = True
            raise item.error
        placed, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for t in placed if isinstance(placed, tuple) else (placed,):
                t.record_stream(current)  # the copy stream's memory is used here
        return placed

    def close(self) -> None:
        """Stop the worker (idempotent): raise the stop flag, drain the
        queue so a blocked put wakes, and join."""
        self._stop.set()
        self._done = True
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "HostLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
