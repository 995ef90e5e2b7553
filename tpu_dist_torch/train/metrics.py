"""Throughput metrics (the port's copy of `tpu_dist.train.metrics`'s)."""

from __future__ import annotations


def allreduce_gbps(nbytes: int, seconds: float, world: int) -> float:
    """Achieved all-reduce bus bandwidth in GB/s: each rank moves
    ``2 (n - 1) / n`` of the payload (the reduce-scatter plus all-gather
    lower bound), as NCCL's tests count it."""
    moved = 2 * (world - 1) / world * nbytes
    return moved / seconds / 1e9
