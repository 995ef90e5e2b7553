"""Ring all-reduce as a hand-written CUDA kernel across processes.

The port of `tpu_dist.ops.pallas_ring` (the Pallas TPU kernel
``_ring_kernel``, which issues its own inter-chip DMAs).  Every rank of a
process group calls `ring_all_reduce_pallas(x)`; on a CUDA tensor one
launch of the kernel of ``csrc/ring.cu`` runs the bandwidth-optimal ring,
a reduce-scatter then an all-gather of ``ceil(numel / n)``-element chunks,
storing into its neighbours' peer-mapped workspaces.  It sums in the order
of `tpu_dist_torch.parallel.ring_all_reduce_chunked`, the order the JAX
package's `ring_all_reduce_pallas` takes off the TPU: chunk c is ``x_c +
x_{c+1} + ... + x_{c+n-1}`` (ranks mod n) in ``x``'s dtype, and every rank
gets the same bits.  No hop goes through NCCL, Gloo or another library
collective, and a call that fits the workspace makes no host collective
either: the process group carries only the workspace's growth.  Beside it:

- `ring_all_reduce_reference`, the plain version: every rank's output from
  the stacked inputs of all ranks, the same sums in the same order.
- On a CPU tensor `ring_all_reduce_pallas` runs
  `tpu_dist_torch.parallel.ring_all_reduce_chunked` over the group.
- `cut`, `chunk_bounds`, `slice_elements` and `region_bytes`: the kernel's
  partition, in Python, for the tests.
- `synchronize()`: waits for the current stream and raises if a kernel
  gave up.

A call is asynchronous like any CUDA op: it enqueues the kernel and returns
its output.  Calls on one group follow each other on one stream (the
kernel's flags count the sends of every earlier call, so a call is not
captured in a CUDA graph for replay).  Every wait in the kernel is bounded
(`TIMEOUT_S` seconds).  A kernel gives up when a wait runs out, or when its
left neighbour's call carries another numel, dtype or shape (each call's
first send carries that stamp); it writes an error word that the next call
on the same workspace, or `synchronize()`, reads and raises, and the
workspace is then broken for good.

Workspaces: one per (device, group), grown when a call is larger than any
before it.  Growth is the one host collective, over Gloo control groups:
the ranks first exchange their call's stamp over a group whose waits end
after `CONTROL_TIMEOUT_S` (a rank that passed another size raises there,
and a rank that does not come makes the others raise), then their IPC
handles over a group with Gloo's default timeout.  `destroy()` frees every
workspace after a final barrier over that group (`comm.destroy_process_group`
runs it).
"""

from __future__ import annotations

import ctypes
import datetime
import functools
from typing import Callable

import torch
import torch.distributed as dist

from tpu_dist_torch.comm import init as _init
from tpu_dist_torch.comm.collectives import Group
from tpu_dist_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int32: 3}
BLOCKS = 128  # the kernel's grid, the same for every call (at most 128)
TIMEOUT_S = 10.0  # the bound on every wait in the kernel
CONTROL_TIMEOUT_S = 120.0  # the bound on a growth's stamp exchange
_MISMATCH = "found that the ranks passed different shapes or dtypes"
_ERRORS = {
    1: "timed out waiting for the right neighbour to free its receive slot",
    2: "timed out waiting for the left neighbour's data to arrive",
    3: _MISMATCH,
}


def chunk_bounds(numel: int, n: int, c: int) -> tuple[int, int]:
    """Elements ``[lo, hi)`` of chunk ``c`` of ``n`` (``ceil(numel / n)``
    each; the last short or empty), as `ring_reduce_scatter` cuts them."""
    m = -(-numel // n)
    return min(c * m, numel), min((c + 1) * m, numel)


def slice_elements(numel: int, n: int, item: int, blocks: int) -> int:
    """Elements of each block's slice of a chunk: a multiple of 16 bytes."""
    v = 16 // item
    per = -(-(-(-numel // n)) // blocks)
    return -(-per // v) * v


def cut(numel: int, n: int, item: int, c: int, blocks: int) -> list[tuple[int, int, int, int]]:
    """The kernel's cut of chunk ``c``: for each block's slice ``(lo, a, e,
    hi)``, scalar lanes on ``[lo, a)`` and ``[e, hi)``, 16-byte vectors on
    ``[a, e)``.  A slice sits in its slot region from element ``lo - lo %
    V`` (V = 16 / item), so ``a`` and ``e`` are 16-byte aligned on both
    sides."""
    v = 16 // item
    c_lo, c_hi = chunk_bounds(numel, n, c)
    ps = slice_elements(numel, n, item, blocks)
    slices = []
    for b in range(blocks):
        lo, hi = min(c_lo + b * ps, c_hi), min(c_lo + (b + 1) * ps, c_hi)
        a = min(lo if lo % v == 0 else lo - lo % v + v, hi)
        e = max(hi - hi % v, a)
        slices.append((lo, a, e, hi))
    return slices


def region_bytes(capacity: int, n: int, blocks: int) -> int:
    """Bytes of one block's region in a slot, for every call of at most
    ``capacity`` bytes in any dtype: a slice and up to 16 bytes of its
    misaligned head."""
    return -(-(-(-capacity // (n * blocks))) // 16) * 16 + 32


def ring_all_reduce_reference(xs: torch.Tensor) -> torch.Tensor:
    """Every rank's output from the stacked inputs ``xs`` of shape ``(n,
    ...)``: chunk c (`chunk_bounds`) summed ``x_c + x_{c+1} + ... +
    x_{c+n-1}`` in that order, in ``xs``'s dtype; every row the same."""
    n = xs.shape[0]
    flat = xs.reshape(n, -1)
    numel = flat.shape[1]
    out = torch.empty_like(flat[0])
    for c in range(n):
        lo, hi = chunk_bounds(numel, n, c)
        acc = flat[c, lo:hi]
        for t in range(1, n):
            acc = flat[(c + t) % n, lo:hi] + acc
        out[lo:hi] = acc
    return out.reshape(xs.shape[1:]).expand(xs.shape).clone()


def _call_stamp(x: torch.Tensor, step0: int) -> tuple[int, int, int, int]:
    """What a call carries to its neighbour: numel, dtype code, a hash of
    the shape, and the call's first send."""
    return (x.numel(), _DTYPE_CODES[x.dtype], hash(tuple(x.shape)) % 2**62, step0)


class Workspace:
    """The kernel's workspace for one (device, group): its capacity in
    bytes (the largest payload so far), its grid (`BLOCKS` when it was
    made), the sends made on it (the kernel's flags count across calls),
    its control-group collectives and whether a kernel gave up on it.

    ``_agree(stamp)`` returns every rank's stamp, after this rank's device
    has finished its kernels (a collective over ``bounded``).  The memory
    comes from hooks: ``_create(capacity)`` makes every rank's memory and
    maps the neighbours' (a collective) and returns the (mine, right, left)
    pointers, ``_barrier()`` waits for every rank's kernels (a collective),
    ``_release()`` unmaps and frees, ``_error()`` reads the error word and
    ``_free_error_word()`` frees it.  `_CudaWorkspace` fills them; the
    logic here runs without a card."""

    control = bounded = None  # the Gloo groups, made by `join`

    def __init__(self, world: int, rank: int = 0):
        self.world, self.rank = world, rank
        self.blocks = BLOCKS
        self.capacity = 0
        self.pointers: tuple | None = None
        self.steps = 0
        self.grows = 0
        self.collectives = 0
        self.broken: str | None = None

    def join(self, group=None) -> None:
        """Make the Gloo control groups of ``group``'s ranks (a collective):
        ``control``, with Gloo's default timeout, for the handle exchange
        and the teardown barrier, and ``bounded``, whose waits end after
        `CONTROL_TIMEOUT_S`, for a growth's stamp exchange alone."""
        self.control = control_group(group)
        self.bounded = control_group(group, CONTROL_TIMEOUT_S)

    def _agree(self, stamp) -> list:
        every = [None] * self.world
        dist.all_gather_object(every, stamp, group=self.bounded)
        return every

    def _create(self, capacity: int) -> tuple:
        raise NotImplementedError

    def _barrier(self) -> None:
        raise NotImplementedError

    def _release(self) -> None:
        raise NotImplementedError

    def _error(self) -> int:
        return 0

    def _free_error_word(self) -> None:
        pass

    @property
    def sends(self) -> int:
        """Sends per call: reduce-scatter and all-gather, n - 1 each."""
        return 2 * (self.world - 1)

    @property
    def region_bytes(self) -> int:
        return region_bytes(self.capacity, self.world, self.blocks)

    def slot_bytes(self, capacity: int) -> int:
        """Bytes of one slot (the kernel keeps three) for payloads up to
        ``capacity`` bytes: ``ceil(capacity / n)`` and the slices'
        padding."""
        return self.blocks * region_bytes(capacity, self.world, self.blocks)

    def _is_broken(self) -> bool:
        if self.broken is None:
            code = self._error()
            if code:
                self.broken = f"a kernel {_ERRORS.get(code, f'gave error code {code}')}"
        return self.broken is not None

    def check(self) -> None:
        """Raise if a kernel gave up on this workspace, now or before."""
        if self._is_broken():
            raise RuntimeError(f"ring_all_reduce_pallas: {self.broken}; the workspace is broken")

    def _collective(self, fn, *args):
        """One collective over the control group, counted; if it fails (a
        rank did not come in time) the workspace is broken."""
        self.collectives += 1
        try:
            return fn(*args)
        except Exception as e:
            self.broken = f"a control-group exchange failed ({type(e).__name__}: {e})"
            raise RuntimeError(f"ring_all_reduce_pallas: {self.broken}; did the ranks pass "
                               "different sizes?") from e

    def reserve(self, nbytes: int, stamp=None) -> bool:
        """Make room for a payload of ``nbytes``; True when it grew.  A call
        that fits makes no collective.  Growth first exchanges ``stamp``
        with every rank and raises on every rank if they differ."""
        if nbytes <= self.capacity:
            return False
        stamps = self._collective(self._agree, stamp)
        if any(s != stamp for s in stamps):
            self.broken = f"the growth exchange {_MISMATCH}"
            raise ValueError(f"ring_all_reduce_pallas: the ranks passed different shapes or "
                             f"dtypes (numel, dtype code per rank: "
                             f"{[tuple(s[:2]) if s else s for s in stamps]})")
        if self.pointers is not None:  # every rank's kernels are done (_agree)
            self._release()
            self.pointers = None
        self.capacity = 0
        self.pointers = self._collective(self._create, nbytes)
        self.capacity = nbytes
        self.steps = 0
        self.grows += 1
        return True

    def prepare(self, x: torch.Tensor) -> tuple:
        """The host's part of a call on ``x``, before its launch: raise if
        the workspace is broken, grow it if ``x`` does not fit (the only
        collective), and return the call's stamp."""
        self.check()
        if self.world > 1:
            self.reserve(x.numel() * x.element_size(), _call_stamp(x, self.steps))
        return _call_stamp(x, self.steps)

    def launched(self) -> None:
        """Count a launched call's sends."""
        self.steps += self.sends

    def free(self) -> None:
        """Free the memory after a barrier with every rank.  The memory of
        a broken workspace, or of one whose barrier failed, is left for the
        process's end, since a neighbour's kernel may still store into it;
        a failed barrier raises, after the workspace is emptied."""
        if self.pointers is None:
            return
        try:
            if not self._is_broken():
                self._collective(self._barrier)
                self._release()
        finally:
            self.pointers = None
            self.capacity = 0
            self.steps = 0

    def close(self) -> None:
        """`free`, then free the error word (also when `free` raises)."""
        try:
            self.free()
        finally:
            self._free_error_word()


_WORKSPACES: dict[tuple, Workspace] = {}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("ring").path))
    p, i, ll, ull = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
    lib.ring_all_reduce.argtypes = [p, p, p, p, p, ll, i, i, i, ull, i, ll, p, ll, p, p, p]
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


def control_group(group=None, timeout: float | None = None):
    """A Gloo group of ``group``'s ranks whose every wait ends after
    ``timeout`` seconds, or Gloo's default (a collective over ``group``'s
    ranks)."""
    ranks = dist.get_process_group_ranks(group if group is not None else dist.group.WORLD)
    wait = None if timeout is None else datetime.timedelta(seconds=timeout)
    return dist.new_group(ranks, backend="gloo", timeout=wait, use_local_synchronization=True)


class _CudaWorkspace(Workspace):
    """Memory cudaMalloc'd by ``csrc/ring.cu`` on ``device`` and shared
    with the ring neighbours by CUDA IPC, exchanged over the control
    groups; the error word lives in host-mapped memory."""

    def __init__(self, device: torch.device, group):
        super().__init__(dist.get_world_size(group), dist.get_rank(group))
        self.device = device
        self.lib = _library()
        self.join(group)
        self.right, self.left = (self.rank + 1) % self.world, (self.rank - 1) % self.world
        self._mine: int | None = None
        self._peers: dict[int, int] = {}
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(device):
            _cuda_check(self.lib.ring_error_word_alloc(ctypes.byref(host), ctypes.byref(dev)),
                        "error word allocation")
        self._error_host, self.error_address = host, dev.value

    def _agree(self, stamp) -> list:
        torch.cuda.synchronize(self.device)
        return super()._agree(stamp)

    def _create(self, capacity: int) -> tuple:
        mine, handle = ctypes.c_void_p(), ctypes.create_string_buffer(self.lib.ring_handle_bytes())
        nbytes = self.slot_bytes(capacity)
        nbytes += -nbytes % 256
        with torch.cuda.device(self.device):
            _cuda_check(self.lib.ring_workspace_alloc(nbytes, ctypes.byref(mine), handle),
                        "workspace allocation")
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

    def _barrier(self) -> None:
        # No kernel of any rank may still store into memory about to go.
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.control)

    def _release(self) -> None:
        with torch.cuda.device(self.device):
            for ptr in self._peers.values():
                _cuda_check(self.lib.ring_workspace_close(ptr), "unmapping a neighbour")
            _cuda_check(self.lib.ring_workspace_free(self._mine), "freeing the workspace")
        self._mine, self._peers = None, {}

    def _error(self) -> int:
        return ctypes.c_int.from_address(self._error_host.value).value

    def _free_error_word(self) -> None:
        self.lib.ring_error_word_free(self._error_host)

    def close(self) -> None:
        torch.cuda.synchronize(self.device)  # this rank's kernels write the error word
        super().close()


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
    rank calls it (`comm.destroy_process_group` does).  A workspace that
    fails to close does not keep the others open; the first failure is
    raised once every one was tried."""
    failures = []
    while _WORKSPACES:
        try:
            _WORKSPACES.popitem()[1].close()
        except Exception as e:
            failures.append(e)
    if failures:
        raise failures[0]


def synchronize() -> None:
    """Wait for the current stream, then raise if a ring kernel gave up."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()
    for ws in list(_WORKSPACES.values()):
        ws.check()


def ring_all_reduce_pallas(x: torch.Tensor, group: Group | None = None) -> torch.Tensor:
    """The ring all-reduce of ``x`` over ``group`` (a `comm.Group`, or the
    world; every rank of it calls it
    with the same shape and dtype: float32, bfloat16, float16 or int32).
    `TIMEOUT_S` bounds each wait of the kernel for a neighbour; it must
    exceed how far the ranks' streams may drift apart before the call.

    A CUDA tensor launches the kernel on the current stream and returns
    without waiting; anything the kernel cannot take raises.  A CPU tensor
    takes the chunked ring over the group.  Counts each launch in
    ``ring_all_reduce_pallas.launches``."""
    if x.device.type == "cpu":
        # imported here: `parallel` imports `nn`, which imports `ops`
        from tpu_dist_torch.parallel.ring import ring_all_reduce_chunked

        return ring_all_reduce_chunked(x, group)
    return _launch(x, group, None)


def ring_all_reduce_traced(x: torch.Tensor, phases: torch.Tensor,
                           group: Group | None = None) -> torch.Tensor:
    """`ring_all_reduce_pallas` of a CUDA tensor through the kernel's
    traced instantiation: ``phases``, a contiguous int64 tensor of 3 x
    `BLOCKS` on ``x``'s card, receives each block's nanoseconds spent
    waiting for arrivals, waiting for a free slot and moving data
    (`ops.checks.trace_ring_calls` reads it)."""
    if not (phases.device == x.device and phases.dtype == torch.int64
            and phases.is_contiguous() and phases.numel() >= 3 * BLOCKS):
        raise ValueError(f"phases must be a contiguous int64 tensor of {3 * BLOCKS} "
                         f"elements on {x.device}")
    return _launch(x, group, phases)


def _launch(x: torch.Tensor, group: Group | None, phases: torch.Tensor | None) -> torch.Tensor:
    """One launch of the kernel on ``x``, counted."""
    if not x.is_cuda:
        raise ValueError(f"ring_all_reduce_pallas runs on cuda or cpu tensors, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ring_all_reduce_pallas takes float32, bfloat16, float16 or int32, "
                        f"got {x.dtype}")
    if not dist.is_initialized():
        raise RuntimeError("ring_all_reduce_pallas on a CUDA tensor needs a process group "
                           "(comm.spmd or comm.init_process_group): the kernel exchanges "
                           "its workspace handles over it")
    ws = workspace(x.device, None if group is None else group.pg)
    stamp = ws.prepare(x)
    flat = x.detach().reshape(-1)
    if flat.data_ptr() % 16:
        flat = flat.clone()  # the kernel moves 16 bytes a thread
    out = torch.empty_like(flat)
    if flat.numel() == 0:
        return out.view(x.shape)
    mine, right, left = ws.pointers if ws.world > 1 else (None, None, None)
    with torch.cuda.device(x.device):
        code = _library().ring_all_reduce(
            flat.data_ptr(), out.data_ptr(), mine, right, left, flat.numel(),
            _DTYPE_CODES[x.dtype], ws.world, ws.rank, ws.steps, ws.blocks, ws.region_bytes,
            (ctypes.c_ulonglong * 4)(*stamp), int(TIMEOUT_S * 1e9), ws.error_address,
            None if phases is None else phases.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda_check(code, "kernel launch")
    ws.launched()
    ring_all_reduce_pallas.launches += 1
    return out.view(x.shape)


ring_all_reduce_pallas.launches = 0
