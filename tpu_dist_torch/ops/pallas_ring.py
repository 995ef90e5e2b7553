"""Ring all-reduce as a hand-written CUDA kernel across processes.

The port of `tpu_dist.ops.pallas_ring` (the Pallas TPU kernel
``_ring_kernel``, which issues its own inter-chip DMAs).  Every rank of a
process group calls `ring_all_reduce_pallas(x)`; on a CUDA tensor the
kernel of ``csrc/ring.cu`` makes the ``n - 1`` hops itself, storing into
its neighbours' peer-mapped workspaces and adding each arrival, so rank r
gets ``x_r + x_{r-1} + ... + x_{r-n+1}`` summed in that order in ``x``'s
dtype.  No hop goes through NCCL, Gloo or another library collective: the
process group carries only control (the workspace handles, a check that
every rank passed the same shape and dtype).  Beside it:

- `ring_all_reduce_reference`, the plain version: every rank's output from
  the stacked inputs of all ranks, the same sums in the same order.
- On a CPU tensor `ring_all_reduce_pallas` runs the naive ring of
  `tpu_dist_torch.parallel.ring` over the group, which sums in that order.
- `synchronize()`: waits for the current stream and raises if a kernel
  timed out waiting for a neighbour.

A call is asynchronous like any CUDA op: it enqueues the kernel and returns
its output.  Calls on one group follow each other on one stream (the
kernel's flags count the steps of every earlier call, so a call is not
captured in a CUDA graph for replay).  Every wait in the kernel is bounded
(`TIMEOUT_S` seconds); a kernel that gives up writes an error word that the
next call on the same workspace, or `synchronize()`, reads and raises, and
the workspace is then broken for good.

Workspaces: one per (device, group), grown collectively when a call is
larger than any before it, freed by `destroy()` after a final barrier
(`comm.destroy_process_group` runs it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch
import torch.distributed as dist

from tpu_dist_torch.comm import init as _init
from tpu_dist_torch.ops import _build
from tpu_dist_torch.parallel.ring import ring_all_reduce

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int32: 3}
_SLOT_ALIGN = 256
TIMEOUT_S = 10.0  # the bound on every wait in the kernel
_ERRORS = {
    1: "timed out waiting for the right neighbour to free its receive slot",
    2: "timed out waiting for the left neighbour's data to arrive",
}


def ring_all_reduce_reference(xs: torch.Tensor) -> torch.Tensor:
    """Every rank's output from the stacked inputs ``xs`` of shape ``(n,
    ...)``: rank r sums ``x_r, x_{r-1}, ..., x_{r-n+1}`` in that order, in
    ``xs``'s dtype."""
    n = xs.shape[0]
    out = torch.empty_like(xs)
    for r in range(n):
        acc = xs[r].clone()
        for t in range(1, n):
            acc = acc + xs[(r - t) % n]
        out[r] = acc
    return out


def slot_stride(capacity: int) -> int:
    """Bytes between the two slots of a workspace of ``capacity`` bytes."""
    return -(-max(capacity, 1) // _SLOT_ALIGN) * _SLOT_ALIGN


class Workspace:
    """The kernel's workspace for one (device, group): its capacity in
    bytes (the largest payload so far), the steps made on it (the kernel's
    flags count across calls) and whether a kernel gave up on it.

    The memory itself comes from three hooks: ``_create(capacity)`` makes
    every rank's and maps the neighbours' (a collective) and returns the
    (mine, right, left) pointers, ``_release()`` frees it after a final
    barrier, ``_error()`` reads the error word.  `_CudaWorkspace` fills
    them; the host-side logic here runs without a card."""

    def __init__(self, world: int):
        self.world = world
        self.capacity = 0
        self.pointers: tuple | None = None
        self.steps = 0
        self.grows = 0
        self.broken: str | None = None

    def _create(self, capacity: int) -> tuple:
        raise NotImplementedError

    def _release(self) -> None:
        raise NotImplementedError

    def _error(self) -> int:
        return 0

    def check(self) -> None:
        """Raise if a kernel gave up on this workspace, now or before."""
        if self.broken is None:
            code = self._error()
            if code:
                self.broken = _ERRORS.get(code, f"error code {code}")
        if self.broken is not None:
            raise RuntimeError(f"ring_all_reduce_pallas: a kernel {self.broken}; the "
                               "workspace is broken")

    def reserve(self, nbytes: int) -> bool:
        """Make room for a payload of ``nbytes``; True when it grew.  Every
        rank makes the same calls, so every rank grows together."""
        if nbytes <= self.capacity:
            return False
        self.free()
        self.pointers = self._create(nbytes)
        self.capacity = nbytes
        self.grows += 1
        return True

    def free(self) -> None:
        if self.pointers is not None:
            self._release()
            self.pointers = None
            self.capacity = 0
            self.steps = 0

    def close(self) -> None:
        self.free()


_WORKSPACES: dict[tuple, Workspace] = {}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("ring").path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ring_all_reduce.argtypes = [p, p, p, p, p, ll, i, i, ctypes.c_ulonglong, ll, ll, p, p]
    lib.ring_workspace_alloc.argtypes = [ll, ctypes.POINTER(p), p]
    lib.ring_workspace_open.argtypes = [p, ctypes.POINTER(p)]
    lib.ring_workspace_close.argtypes = [p]
    lib.ring_workspace_free.argtypes = [p]
    lib.ring_error_word_alloc.argtypes = [ctypes.POINTER(p), ctypes.POINTER(p)]
    lib.ring_error_word_free.argtypes = [p]
    lib.ring_handle_bytes.argtypes = []
    for fn in (lib.ring_all_reduce, lib.ring_workspace_alloc, lib.ring_workspace_open,
               lib.ring_workspace_close, lib.ring_workspace_free, lib.ring_error_word_alloc,
               lib.ring_error_word_free, lib.ring_handle_bytes):
        fn.restype = i
    lib.ring_error_string.argtypes = [i]
    lib.ring_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_check(code: int, what: str) -> None:
    if code != 0:
        reason = _library().ring_error_string(code).decode()
        raise RuntimeError(f"ring_all_reduce_pallas: {what} failed: CUDA error {code} ({reason})")


class _CudaWorkspace(Workspace):
    """Memory cudaMalloc'd by ``csrc/ring.cu`` on ``device`` and shared
    with the ring neighbours by CUDA IPC, exchanged over a Gloo control
    group; the error word lives in host-mapped memory."""

    def __init__(self, device: torch.device, group):
        super().__init__(dist.get_world_size(group))
        self.device = device
        self.lib = _library()
        if dist.get_backend(group) == "gloo":
            self.control = group
        else:
            ranks = dist.get_process_group_ranks(group if group is not None else dist.group.WORLD)
            self.control = dist.new_group(ranks, backend="gloo", use_local_synchronization=True)
        me = dist.get_rank(group)
        self.right, self.left = (me + 1) % self.world, (me - 1) % self.world
        self._mine: int | None = None
        self._peers: dict[int, int] = {}
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(device):
            _cuda_check(self.lib.ring_error_word_alloc(ctypes.byref(host), ctypes.byref(dev)),
                        "error word allocation")
        self._error_host, self.error_address = host, dev.value

    def _create(self, capacity: int) -> tuple:
        mine, handle = ctypes.c_void_p(), ctypes.create_string_buffer(self.lib.ring_handle_bytes())
        with torch.cuda.device(self.device):
            _cuda_check(self.lib.ring_workspace_alloc(slot_stride(capacity), ctypes.byref(mine),
                                                      handle), "workspace allocation")
        self._mine = mine.value
        handles = [None] * self.world
        dist.all_gather_object(handles, handle.raw, group=self.control)
        with torch.cuda.device(self.device):
            for r in {self.right, self.left}:
                ptr = ctypes.c_void_p()
                _cuda_check(self.lib.ring_workspace_open(handles[r], ctypes.byref(ptr)),
                            f"mapping rank {r}'s workspace")
                self._peers[r] = ptr.value
        return self._mine, self._peers[self.right], self._peers[self.left]

    def _release(self) -> None:
        # No kernel of any rank may still write into memory about to go.
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.control)
        with torch.cuda.device(self.device):
            for ptr in self._peers.values():
                _cuda_check(self.lib.ring_workspace_close(ptr), "unmapping a neighbour")
            _cuda_check(self.lib.ring_workspace_free(self._mine), "freeing the workspace")
        self._mine, self._peers = None, {}

    def _error(self) -> int:
        return ctypes.c_int.from_address(self._error_host.value).value

    def close(self) -> None:
        super().close()
        self.lib.ring_error_word_free(self._error_host)


def workspace(device: torch.device, group=None,
              factory: Callable[[torch.device, object], Workspace] = _CudaWorkspace
              ) -> Workspace:
    """The one workspace of (device, group), made at first use; shape and
    dtype play no part in the key."""
    key = (device, group if group is not None else dist.group.WORLD)
    if key not in _WORKSPACES:
        _WORKSPACES[key] = factory(device, group)
        _init.on_teardown(destroy)
    return _WORKSPACES[key]


def destroy() -> None:
    """Free every workspace after a final barrier with its group.  Every
    rank calls it (`comm.destroy_process_group` does)."""
    while _WORKSPACES:
        _WORKSPACES.popitem()[1].close()


def synchronize() -> None:
    """Wait for the current stream, then raise if a ring kernel gave up
    waiting for a neighbour."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()
    for ws in list(_WORKSPACES.values()):
        ws.check()


def _check_same_call(control, x: torch.Tensor) -> None:
    """Every rank passed the same shape and dtype (over the control
    group)."""
    mine = torch.tensor([x.numel(), _DTYPE_CODES[x.dtype], hash(tuple(x.shape)) % 2**62])
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size(control))]
    dist.all_gather(every, mine, group=control)
    if any(not torch.equal(e, mine) for e in every):
        raise ValueError("ring_all_reduce_pallas: the ranks passed different shapes or "
                         f"dtypes (numel, dtype code per rank: "
                         f"{[tuple(e[:2].tolist()) for e in every]})")


def ring_all_reduce_pallas(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ring all-reduce of ``x`` over ``group`` (every rank calls it
    with the same shape and dtype: float32, bfloat16, float16 or int32).
    `TIMEOUT_S` bounds each wait of the kernel for a neighbour; it must
    exceed how far the ranks' streams may drift apart before the call.

    A CUDA tensor launches the kernel on the current stream and returns
    without waiting; anything the kernel cannot take raises.  A CPU tensor
    takes the plain naive ring over the group.  Counts each launch in
    ``ring_all_reduce_pallas.launches``."""
    if x.device.type == "cpu":
        return ring_all_reduce(x, group)
    if not x.is_cuda:
        raise ValueError(f"ring_all_reduce_pallas runs on cuda or cpu tensors, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ring_all_reduce_pallas takes float32, bfloat16, float16 or int32, "
                        f"got {x.dtype}")
    if not dist.is_initialized():
        raise RuntimeError("ring_all_reduce_pallas on a CUDA tensor needs a process group "
                           "(comm.spmd or comm.init_process_group): the kernel exchanges "
                           "its workspace handles over it")
    ws = workspace(x.device, group)
    ws.check()
    _check_same_call(ws.control, x)
    flat = x.detach().reshape(-1)
    if flat.data_ptr() % 16:
        flat = flat.clone()  # the kernel moves 16 bytes a thread
    out = torch.empty_like(flat)
    if flat.numel() == 0:
        return out.view(x.shape)
    n = ws.world
    nbytes = flat.numel() * flat.element_size()
    if n > 1:
        ws.reserve(nbytes)
    mine, right, left = ws.pointers if n > 1 else (None, None, None)
    lib = _library()
    with torch.cuda.device(x.device):
        code = lib.ring_all_reduce(
            flat.data_ptr(), out.data_ptr(), mine, right, left, flat.numel(),
            _DTYPE_CODES[x.dtype], n, ws.steps, slot_stride(ws.capacity),
            int(TIMEOUT_S * 1e9), ws.error_address,
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda_check(code, "kernel launch")
    ws.steps += n - 1
    ring_all_reduce_pallas.launches += 1
    return out.view(x.shape)


ring_all_reduce_pallas.launches = 0
