"""Process-group bootstrap: ``dist.init_process_group`` from the tutorial's
environment contract, and the port's teardown.

The port of `tpu_dist.comm.init`.  ``MASTER_ADDR`` (default ``localhost``),
``MASTER_PORT``, ``WORLD_SIZE`` (default 1) and ``RANK``, as ``torchrun``
and `tpu_dist_torch.run` set them (tuto.md:421-428).  The rendezvous is a
torch store, made here and handed to ``dist.init_process_group``:

- ``TPU_DIST_INIT_METHOD=file:///path``: a ``FileStore`` on that path
  (tuto.md:430-437), single-host only: a ``MASTER_ADDR`` that names another
  machine is refused.
- Otherwise a ``TCPStore`` at ``MASTER_ADDR:MASTER_PORT``.  Rank 0 hosts
  it, unless ``TORCHELASTIC_USE_AGENT_STORE=True`` says that the launcher
  already does (`comm.spmd`, `comm.launch` and `tpu_dist_torch.run` hold
  the store in the parent, so no port is chosen and released before it is
  bound); then every rank is a client, as under torch's own launcher.
- A world of one with neither names no port at all: an in-process store.

With ``RANK`` unset, ranks are handed out first come, first served through
the store's counter (the MPI-style rank-less init of allreduce.py:54), in a
launcher's store or a ``file://`` one.  Joining the TCP store is retried
under `RetryPolicy.from_env` and raises `RendezvousTimeout` when the
retries are spent.  A rank on the card drives
``cuda:(LOCAL_RANK % device_count)``.

The backend follows `choose_backend`: NCCL for a CUDA world, Gloo on the
CPU, and Gloo as a control group for a CUDA world only where this host is
known to run more ranks than it has cards (NCCL refuses two ranks on one
device).  In that group the ring kernel moves the data through peer-mapped
memory; the group carries only control (handle exchange, shape checks).
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.constants import default_pg_timeout

# the JAX package's names: a process is a rank here, one card each at most
from tpu_dist_torch.comm.collectives import rank as process_rank  # noqa: F401
from tpu_dist_torch.comm.collectives import world_size as process_count  # noqa: F401
from tpu_dist_torch.resilience.retry import RendezvousTimeout, RetryPolicy, retry_call

_TEARDOWN: list[Callable[[], None]] = []
AGENT_STORE = "TORCHELASTIC_USE_AGENT_STORE"  # torch's name: the launcher hosts the store
ATTEMPT = "TORCHELASTIC_RESTART_COUNT"  # torch's name: the launch attempt's index
STORE_CONNECT_S = 30.0  # one rendezvous attempt's wait for the store's host
_RANK_KEY = "tpu_dist_torch/next_rank"


@dataclass(frozen=True)
class InitConfig:
    """The bootstrap configuration the environment gives (tuto.md:421-428):
    ``MASTER_ADDR:MASTER_PORT`` when both are set, ``WORLD_SIZE`` and
    ``RANK`` when set."""

    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None

    @staticmethod
    def from_env() -> "InitConfig":
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        world = os.environ.get("WORLD_SIZE")
        rank_ = os.environ.get("RANK")
        return InitConfig(
            coordinator_address=f"{addr}:{port}" if addr and port else None,
            num_processes=int(world) if world is not None else None,
            process_id=int(rank_) if rank_ is not None else None,
        )


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


def _addr_is_remote(addr: str) -> bool:
    """True only when ``addr`` definitely names another machine: not
    loopback, not this hostname, and not resolving to any of this host's
    addresses.  Unresolvable addresses count as local (a guard must not
    refuse what may be this host)."""
    if addr in ("127.0.0.1", "localhost", "::1") or addr == socket.gethostname():
        return False
    try:
        target = {ai[4][0] for ai in socket.getaddrinfo(addr, None)}
    except OSError:
        return False
    if any(ip.startswith("127.") or ip == "::1" for ip in target):
        return False
    try:
        local = {ai[4][0] for ai in socket.getaddrinfo(socket.gethostname(), None)}
    except OSError:
        local = set()
    if target & local:
        return False
    # gethostname() may map to loopback only (a 127.0.1.1 line in
    # /etc/hosts) while MASTER_ADDR carries the interface's address: the
    # source address of a route to the target is the target itself iff it
    # is one of ours (a UDP connect picks the route and sends nothing).
    for ip in target:
        fam = socket.AF_INET6 if ":" in ip else socket.AF_INET
        try:
            s = socket.socket(fam, socket.SOCK_DGRAM)
            try:
                s.connect((ip, 9))
                if s.getsockname()[0] == ip:
                    return False
            finally:
                s.close()
        except OSError:
            continue
    return True


def host_store(addr: str = "localhost", port: int = 0) -> dist.TCPStore:
    """A TCP store hosted by this process (a launcher), by default on a port
    that the system picks as it binds it, so no other process can take the
    port first.  Its ranks join with `launcher_env`'s variables, as
    clients."""
    return dist.TCPStore(addr, port, is_master=True, wait_for_workers=False)


def launcher_env(store: dist.TCPStore, addr: str, world: int, attempt: int = 0
                 ) -> dict[str, str]:
    """The variables that make each of ``world`` ranks on this host a client
    of ``store``; ``attempt`` is the launch's attempt index, under torch's
    name for it (which torch's own ``env://`` init reads with an agent's
    store)."""
    return {"MASTER_ADDR": addr, "MASTER_PORT": str(store.port), "WORLD_SIZE": str(world),
            "LOCAL_WORLD_SIZE": str(world), AGENT_STORE: str(True),
            ATTEMPT: str(attempt)}


def _rendezvous(world: int) -> tuple[dist.Store, int]:
    """The store every rank of the world joins, and this process's rank."""
    cfg = InitConfig.from_env()
    method = os.environ.get("TPU_DIST_INIT_METHOD", "")
    rank = cfg.process_id
    if rank is not None and not 0 <= rank < world:
        raise ValueError(f"RANK={rank} out of range for WORLD_SIZE={world}")
    if method.startswith("file://"):
        master = os.environ.get("MASTER_ADDR")
        if master and _addr_is_remote(master):
            raise ValueError(
                f"TPU_DIST_INIT_METHOD=file:// is single-host only, but "
                f"MASTER_ADDR={master!r} resolves off this host — use the TCP "
                "init path (tuto.md:421-428 contract) instead")
        store = dist.FileStore(method[len("file://"):], world)
    elif method:
        raise ValueError(f"TPU_DIST_INIT_METHOD={method!r}: only file:///path is supported")
    elif "MASTER_PORT" not in os.environ:
        if world != 1:
            raise ValueError(f"MASTER_PORT (or TPU_DIST_INIT_METHOD=file:///path) must be "
                             f"set for a world of {world}")
        store = dist.HashStore()
    else:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = int(os.environ["MASTER_PORT"])
        hosted = os.environ.get(AGENT_STORE) == str(True)
        if rank is None and not hosted:
            raise ValueError(
                "rank-less init (RANK unset) needs a launcher that hosts the store "
                f"({AGENT_STORE}=True: python -m tpu_dist_torch.run --rankless, "
                "comm.launch(assign_ranks=False)) or TPU_DIST_INIT_METHOD=file:///path")
        wait = datetime.timedelta(seconds=STORE_CONNECT_S)
        # a client of the launcher's store, or of rank 0's, which rank 0 hosts
        store = retry_call(
            lambda _attempt: dist.TCPStore(addr, port, world, is_master=not hosted and rank == 0,
                                           timeout=wait, wait_for_workers=False),
            policy=RetryPolicy.from_env(),
            retry_on=(RuntimeError, OSError),
            describe=f"rendezvous at {addr}:{port}",
            error_type=RendezvousTimeout,
        )
    if rank is None:  # first come, first served
        rank = store.add(_RANK_KEY, 1) - 1
        if rank >= world:
            raise RuntimeError(f"rank-less init: process {rank + 1} joined a world of {world}")
    return store, rank


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
    store, rank = _rendezvous(world)
    store.set_timeout(default_pg_timeout)  # the group's own waits
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
    dist.init_process_group(choice.backend, store=store, world_size=world, rank=rank)
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
