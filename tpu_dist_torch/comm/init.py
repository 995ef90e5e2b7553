"""Process-group bootstrap: ``dist.init_process_group`` from the tutorial's
four environment variables, and the port's teardown.

``MASTER_ADDR`` (default ``localhost``), ``MASTER_PORT``, ``WORLD_SIZE``
(default 1) and ``RANK`` (default 0), as ``torchrun`` sets them.  A world
of one with no ``MASTER_PORT`` takes a free local port; a larger world
needs the port named.  A rank on the card drives
``cuda:(LOCAL_RANK % device_count)``.

The backend follows `choose_backend`: NCCL for a CUDA world, Gloo on the
CPU, and Gloo as a control group for a CUDA world only where this host is
known to run more ranks than it has cards (NCCL refuses two ranks on one
device).  In that group the ring kernel moves the data through peer-mapped
memory; the group carries only control (handle exchange, shape checks).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

_TEARDOWN: list[Callable[[], None]] = []


@dataclass(frozen=True)
class BackendChoice:
    backend: str  # "nccl" or "gloo"
    control_only: bool  # Gloo carrying control for ranks that share cards
    reason: str


def choose_backend(
    device_type: str, world: int, local_world: int | None, cards: int
) -> BackendChoice:
    """The process-group backend for ``world`` ranks on ``device_type``.

    ``local_world`` is how many ranks run on this host when that is known
    (``LOCAL_WORLD_SIZE``, or `comm.spmd`, which starts every rank here),
    else None; ``cards`` is this host's CUDA device count.  Only a known
    local world larger than the card count takes Gloo for a CUDA world: a
    multi-host launch with one card per rank keeps NCCL, and if NCCL then
    cannot run, it fails loudly."""
    if device_type != "cuda":
        return BackendChoice("gloo", False, f"world {world} on the CPU")
    if local_world is not None and local_world > cards:
        return BackendChoice(
            "gloo", True,
            f"{local_world} ranks on this host share {cards} card(s), which NCCL "
            "refuses; the group carries control, the kernels move the data",
        )
    where = (f"{local_world} rank(s) on this host, {cards} card(s)" if local_world is not None
             else "ranks per host unknown: one card per rank assumed")
    return BackendChoice("nccl", False, f"world {world} on the card ({where})")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(
    device: torch.device, *, local_world: int | None = None
) -> tuple[int, int]:
    """Join the process group for ``device`` (``cuda`` without an index
    means ``cuda:(LOCAL_RANK % device_count)``, LOCAL_RANK defaulting to the
    rank); returns ``(rank, world)``.

    ``local_world``: the number of ranks on this host, when the caller
    knows it (`comm.spmd` does); otherwise ``LOCAL_WORLD_SIZE`` if set."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT")
    if port is None:
        if world != 1:
            raise ValueError(f"MASTER_PORT must be set for a world of {world}")
        port = str(_free_port())
    if local_world is None and "LOCAL_WORLD_SIZE" in os.environ:
        local_world = int(os.environ["LOCAL_WORLD_SIZE"])
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    choice = choose_backend(device.type, world, local_world, cards)
    if device.type == "cuda":
        if device.index is None:
            local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
            device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    if rank == 0:
        print(f"[comm] world {world}, backend {choice.backend} ({choice.reason})", flush=True)
    dist.init_process_group(
        choice.backend, init_method=f"tcp://{addr}:{port}", world_size=world, rank=rank
    )
    return rank, world


def on_teardown(fn: Callable[[], None]) -> None:
    """Run ``fn`` in `destroy_process_group`, before the group goes (the
    ring kernel frees its peer-mapped workspaces there)."""
    if fn not in _TEARDOWN:
        _TEARDOWN.append(fn)


def destroy_process_group() -> None:
    """The port's teardown: every registered hook, then
    ``dist.destroy_process_group``, which runs also when a hook raises (the
    hook's error is raised after it)."""
    try:
        while _TEARDOWN:
            _TEARDOWN.pop()()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
