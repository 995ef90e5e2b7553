"""Blockwise (flash) attention: forward, dK/dV and dQ as CUDA kernels.

The port of `tpu_dist.ops.flash_attention` (the Pallas kernels
``_flash_kernel``, ``_dkv_kernel`` and ``_dq_kernel``).  Two sources, each
built at first use by `_build.build` and called through ``ctypes``:

- ``csrc/flash_attention_sm90.cu``: the forward, dK/dV and dQ on Hopper's
  tensor cores (``wgmma`` fed by TMA), for bfloat16 and float16 at head
  dims 64 and 128;
- ``csrc/flash_attention.cu``: SIMT kernels for every dtype and head dim
  up to 256, which take float32 (whose products must stay float32, not the
  tensor cores' TF32) and the other head dims.  `simt_tiling` picks the
  tiles of its forward and dK/dV for each head dim.

`flash_route` picks one by dtype and head dim.  Beside the kernels:

- `flash_fwd_reference`, `flash_dkv_reference`, `flash_dq_reference`: the
  plain PyTorch versions, the same formulas on dense (S, S) blocks.  Tensors
  on the CPU take them; on the card they are what the kernels are held
  against.
- `flash_fwd_sm90`, `flash_fwd_simt`, `flash_dkv_sm90`, `flash_dkv_simt`,
  `flash_dq_sm90`, `flash_dq_simt`: the kernels' wrappers, for CUDA tensors
  only, each with its launch count (``flash_fwd_sm90.launches``, ...);
  `flash_fwd`, `flash_dkv` and `flash_dq` hand a call to the wrapper
  `flash_route` names.  A failed build or launch raises: nothing falls
  back to another kernel.
- `flash_attention` and `flash_attention_lse` on the JAX layout
  ``(..., heads, S, d)``, with the JAX package's checks; the first is
  differentiable, its backward the two backward kernels, as the JAX custom
  VJP runs them.
- `key_tile_range`, `query_tile_range` and `sm90_tile_order`: the
  tile-skipping arithmetic the kernels use (and the TPU kernels used), and
  the order the sm90 blocks take their tiles, in Python for the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpu_dist_torch.ops import _build

NEG_INF = -1e30
TILE = 64  # the SIMT dQ kernel's query and key tile up to d = 128 (the TPU kernels' bq, bk: 256)
MAX_HEAD_DIM = 256
SIMT_WIDTHS = (16, 32, 64, 128, 256)  # the SIMT kernels' head-dim templates
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_GRID_Y = 65535  # the kernels' grid is (bh, S / tile)
# The tensor-core kernels: their dtypes and head dims, their forward query
# and key tile, dK/dV key tile and dQ query tile, their dK/dV query tile
# and their dQ key tile.
SM90_DTYPES = (torch.bfloat16, torch.float16)
SM90_HEAD_DIMS = (64, 128)
SM90_TILE = 128
SM90_DKV_QUERY_TILE = 64
SM90_DQ_KEY_TILE = 64
# Plain versions form (chunk, S, S) float32 blocks; this many elements each.
_REFERENCE_BLOCK = 1 << 27


# ---------------------------------------------------------------- tile ranges


def tile_rows(d: int) -> int:
    """The SIMT dQ kernel's query and key tile for head dim ``d``: 64 rows,
    and 32 at d > 128, where four 64-row float32 tiles would not fit in a
    block's shared memory."""
    return TILE if d <= 128 else TILE // 2


def head_width(d: int) -> int:
    """The SIMT kernels' template width for head dim ``d``: the head dim is
    padded with zeros up to it."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"the flash kernels take head dims 1..{MAX_HEAD_DIM}, got {d}")
    return next(w for w in SIMT_WIDTHS if d <= w)


class SimtTiling(NamedTuple):
    """The tiles of the SIMT forward or dK/dV at one template width: a
    block owns ``rows`` rows (query rows in the forward, keys in dK/dV) and
    scans ``cols``-row tiles of the other side (keys, queries) through
    ``stages`` shared-memory buffers."""

    rows: int
    cols: int
    stages: int


# (rows, cols, stages) by template width: the one tiling
# csrc/flash_attention.cu builds at each (`run<T, D>`, which refuses any
# other).  The forward takes 128 query rows at widths 32 and 64, so that
# each K and V tile it reads serves twice the rows; the rows fall as the
# width grows, so that a thread's accumulators stay in registers.
_SIMT_TILES = {
    "fwd": {16: (64, 64, 1), 32: (128, 64, 1), 64: (128, 64, 1), 128: (64, 32, 1),
            256: (32, 16, 1)},
    "dkv": {16: (64, 32, 1), 32: (64, 32, 1), 64: (64, 32, 1), 128: (32, 64, 2),
            256: (16, 32, 2)},
}


def simt_tiling(kernel: str, d: int) -> SimtTiling:
    """The tiling of the SIMT forward (``kernel="fwd"``) or dK/dV
    (``"dkv"``) for head dim ``d``, in every dtype; the wrapper passes it to
    the C entry point."""
    if kernel not in _SIMT_TILES:
        raise ValueError(f"kernel is 'fwd' or 'dkv', got {kernel!r}")
    return SimtTiling(*_SIMT_TILES[kernel][head_width(d)])


def key_tile_range(
    i: int, S: int, bq: int, bk: int, *, causal: bool, window: int | None
) -> tuple[int, int]:
    """Key tiles ``[lo, hi)`` that query tile ``i`` has to scan: past the
    diagonal nothing is visible under ``causal``, and before the band
    ``k > q - window`` nothing is (tpu_dist/ops/flash_attention.py:80-92)."""
    n = -(-S // bk)
    hi = min(n, ((i + 1) * bq + bk - 1) // bk) if causal else n
    lo = max(0, (i * bq - window + 1) // bk) if window is not None else 0
    return lo, hi


def query_tile_range(
    j: int, S: int, bq: int, bk: int, *, causal: bool, window: int | None
) -> tuple[int, int]:
    """Query tiles ``[lo, hi)`` that can see key tile ``j``
    (tpu_dist/ops/flash_attention.py:216-225)."""
    n = -(-S // bq)
    lo = (j * bk) // bq if causal else 0
    hi = min(n, ((j + 1) * bk - 1 + window - 1) // bq + 1) if window is not None else n
    return lo, hi


def flash_route(dtype: torch.dtype, d: int) -> str:
    """``"sm90"``: the tensor-core kernels (forward, dK/dV and dQ) take
    bfloat16 and float16 at head dims 64 and 128.  ``"simt"`` for everything
    else: float32 keeps float32 products, and other head dims keep their own
    tiles."""
    return "sm90" if dtype in SM90_DTYPES and d in SM90_HEAD_DIMS else "simt"


def sm90_tile_order(n: int, *, causal: bool, kernel: str) -> list[int]:
    """The tile each sm90 block takes, in launch order (``blockIdx.y`` = 0,
    1, ...; every batch-head at one ``blockIdx.y`` launches together).
    ``kernel="fwd"`` and ``kernel="dq"``: query tiles, and under a causal
    mask the last ones, which scan the most key tiles, first.
    ``kernel="dkv"``: key tiles in order; under a causal mask the first scan
    the most query tiles."""
    if kernel not in ("fwd", "dkv", "dq"):
        raise ValueError(f"kernel is 'fwd', 'dkv' or 'dq', got {kernel!r}")
    return list(range(n - 1, -1, -1)) if causal and kernel != "dkv" else list(range(n))


# ------------------------------------------------------------ plain versions


def visible_mask(
    S: int, *, causal: bool, window: int | None, device=None
) -> torch.Tensor | None:
    """(S, S) boolean, True where query row q may attend key column k:
    ``k <= q`` under causal, ``k > q - window`` under a window; None when
    everything is visible."""
    if not causal and window is None:
        return None
    pos = torch.arange(S, device=device)
    q_pos, k_pos = pos[:, None], pos[None, :]
    mask = q_pos >= k_pos if causal else torch.ones(S, S, dtype=torch.bool, device=device)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def _chunks(bh: int, S: int):
    step = max(1, _REFERENCE_BLOCK // (S * S))
    return [slice(b, min(b + step, bh)) for b in range(0, bh, step)]


def _logits(q, k, mask, scale):
    logits = (q.float() * scale) @ k.float().transpose(-1, -2)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    return logits


def flash_fwd_reference(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, *,
    causal: bool = False, window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward on dense blocks: float32 masked softmax of
    ``(q * scale) k^T``.  Returns ``out`` (bh, S, d) in q's dtype and ``lse``
    (bh, S) float32, as the kernel does."""
    bh, S, d = q3.shape
    scale = d**-0.5
    mask = visible_mask(S, causal=causal, window=window, device=q3.device)
    out = torch.empty_like(q3)
    lse = torch.empty((bh, S), dtype=torch.float32, device=q3.device)
    for c in _chunks(bh, S):
        logits = _logits(q3[c], k3[c], mask, scale)
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m)
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        l = p.sum(-1, keepdim=True)
        out[c] = ((p @ v3[c].float()) / l).to(q3.dtype)
        lse[c] = (m + torch.log(l))[..., 0]
    return out, lse


def _probs_and_dscores(q, k, v, go, lse, delta, mask, scale):
    """P = exp(logits - lse) and dS = P * (dO V^T - D) on a chunk, as the
    backward kernels form them tile by tile."""
    p = torch.exp(_logits(q, k, mask, scale) - lse[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = go.float() @ v.float().transpose(-1, -2)
    return p, p * (dp - delta[..., None])


def flash_dkv_reference(q3, k3, v3, go, lse, delta, *, causal=False, window=None):
    """dK = dS^T Q scale and dV = P^T dO on dense blocks, in k's and v's
    dtype (the `_dkv_kernel` formulas)."""
    bh, S, d = q3.shape
    scale = d**-0.5
    mask = visible_mask(S, causal=causal, window=window, device=q3.device)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    for c in _chunks(bh, S):
        p, ds = _probs_and_dscores(q3[c], k3[c], v3[c], go[c], lse[c], delta[c], mask, scale)
        dv[c] = (p.transpose(-1, -2) @ go[c].float()).to(v3.dtype)
        dk[c] = ((ds.transpose(-1, -2) @ q3[c].float()) * scale).to(k3.dtype)
    return dk, dv


def flash_dq_reference(q3, k3, v3, go, lse, delta, *, causal=False, window=None):
    """dQ = dS K scale on dense blocks, in q's dtype (the `_dq_kernel`
    formula)."""
    bh, S, d = q3.shape
    scale = d**-0.5
    mask = visible_mask(S, causal=causal, window=window, device=q3.device)
    dq = torch.empty_like(q3)
    for c in _chunks(bh, S):
        _, ds = _probs_and_dscores(q3[c], k3[c], v3[c], go[c], lse[c], delta[c], mask, scale)
        dq[c] = ((ds @ k3[c].float()) * scale).to(q3.dtype)
    return dq


# ------------------------------------------------------------------- kernels


_SIGNATURES = {  # pointers, then tiling ints after the shared tail, of each entry point
    "flash_attention": {"flash_fwd": (5, 3), "flash_dkv": (8, 3), "flash_dq": (7, 0)},
    "flash_attention_sm90": {"flash_fwd_sm90": (5, 0), "flash_dkv_sm90": (8, 0),
                             "flash_dq_sm90": (7, 0)},
}
_ERROR_STRINGS = {"flash_attention": "flash_error_string",
                  "flash_attention_sm90": "flash_sm90_error_string"}


@functools.cache
def _library(source: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(source).path))
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i, i, i, ctypes.c_float, i, i, i]  # bh S d scale dtype causal window
    for name, (pointers, tiling) in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = [p] * pointers + tail + [i] * tiling + [p]  # ..., stream
        fn.restype = ctypes.c_int
    errors = getattr(lib, _ERROR_STRINGS[source])
    errors.argtypes = [i]
    errors.restype = ctypes.c_char_p
    return lib


def _check_operands(name, blocks, rows, tile):
    """``blocks``: (bh, S, d) tensors of one float dtype; ``rows``: (bh, S)
    float32 tensors.  All contiguous CUDA tensors on one device.  ``tile``:
    the kernel's rows per block along S (its grid is (bh, S / tile))."""
    first = blocks[0]
    if not all(t.is_cuda and t.device == first.device for t in blocks + rows):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if first.dtype not in _DTYPE_CODES or any(t.dtype != first.dtype for t in blocks):
        raise TypeError(f"{name} takes float32, bfloat16 or float16 q/k/v of one "
                        f"dtype, got {[t.dtype for t in blocks]}")
    if any(t.dtype != torch.float32 for t in rows):
        raise TypeError(f"{name} takes float32 lse and delta, got {[t.dtype for t in rows]}")
    if first.dim() != 3 or any(t.shape != first.shape for t in blocks):
        raise ValueError(f"{name} needs equal (bh, S, d) shapes, got "
                         f"{[tuple(t.shape) for t in blocks]}")
    bh, S, d = first.shape
    if any(tuple(t.shape) != (bh, S) for t in rows):
        raise ValueError(f"{name} needs lse and delta of shape {(bh, S)}")
    if not all(t.is_contiguous() for t in blocks + rows):
        raise ValueError(f"{name} takes contiguous tensors")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{name} takes head dims 1..{MAX_HEAD_DIM}, got {d}")
    if bh > 2**31 - 1 or -(-S // tile) > _MAX_GRID_Y:
        raise ValueError(f"{name} shape {(bh, S, d)} exceeds the kernel's grid "
                         f"(bh < 2^31, S <= {_MAX_GRID_Y * tile})")
    return bh, S, d


def _check_sm90(name, blocks, rows):
    """`_check_operands`, then what TMA needs: the sm90 domain and 16-byte
    aligned q/k/v."""
    shape = _check_operands(name, blocks, rows, SM90_TILE)
    dtype, d = blocks[0].dtype, shape[2]
    if flash_route(dtype, d) != "sm90":
        raise ValueError(f"{name} takes bfloat16 or float16 at head dims {SM90_HEAD_DIMS}, "
                         f"got {dtype} at d = {d}")
    if any(t.data_ptr() % 16 for t in blocks):
        raise ValueError(f"{name} needs 16-byte aligned q/k/v (TMA)")
    return shape


def _launch(source, fn, pointers, shape, dtype, causal, window, device, tiling=()):
    bh, S, d = shape
    lib = _library(source)
    with torch.cuda.device(device):
        code = getattr(lib, fn)(
            *pointers, bh, S, d, d**-0.5, _DTYPE_CODES[dtype], int(causal),
            0 if window is None else window, *tiling,
            torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        reason = getattr(lib, _ERROR_STRINGS[source])(code).decode()
        raise RuntimeError(f"{fn} launch failed: error {code} ({reason})")


def flash_fwd_simt(q3, k3, v3, *, causal=False, window=None):
    """Launch the SIMT forward kernel on the current stream, on the tiles
    `simt_tiling` picks; returns ``out`` (bh, S, d) in q's dtype and ``lse``
    (bh, S) float32.  Raises on anything it does not take.  Counts each
    launch in ``flash_fwd_simt.launches``."""
    tiles = simt_tiling("fwd", q3.shape[-1])
    shape = _check_operands("flash_fwd_simt", [q3, k3, v3], [], tiles.rows)
    out = torch.empty_like(q3)
    lse = torch.empty(shape[:2], dtype=torch.float32, device=q3.device)
    _launch("flash_attention", "flash_fwd",
            [t.data_ptr() for t in (q3, k3, v3, out, lse)],
            shape, q3.dtype, causal, window, q3.device, tiles)
    flash_fwd_simt.launches += 1
    return out, lse


def flash_fwd_sm90(q3, k3, v3, *, causal=False, window=None):
    """Launch the tensor-core forward kernel; the contract of
    `flash_fwd_simt` on bfloat16 and float16 at head dims 64 and 128.
    Counts each launch in ``flash_fwd_sm90.launches``."""
    shape = _check_sm90("flash_fwd_sm90", [q3, k3, v3], [])
    out = torch.empty_like(q3)
    lse = torch.empty(shape[:2], dtype=torch.float32, device=q3.device)
    _launch("flash_attention_sm90", "flash_fwd_sm90",
            [t.data_ptr() for t in (q3, k3, v3, out, lse)],
            shape, q3.dtype, causal, window, q3.device)
    flash_fwd_sm90.launches += 1
    return out, lse


def flash_dkv_simt(q3, k3, v3, go, lse, delta, *, causal=False, window=None):
    """Launch the SIMT dK/dV kernel on the tiles `simt_tiling` picks;
    returns ``(dk, dv)`` in k's dtype.  Counts each launch in
    ``flash_dkv_simt.launches``."""
    tiles = simt_tiling("dkv", q3.shape[-1])
    shape = _check_operands("flash_dkv_simt", [q3, k3, v3, go], [lse, delta], tiles.rows)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    _launch("flash_attention", "flash_dkv",
            [t.data_ptr() for t in (q3, k3, v3, go, lse, delta, dk, dv)],
            shape, q3.dtype, causal, window, q3.device, tiles)
    flash_dkv_simt.launches += 1
    return dk, dv


def flash_dkv_sm90(q3, k3, v3, go, lse, delta, *, causal=False, window=None):
    """Launch the tensor-core dK/dV kernel; the contract of
    `flash_dkv_simt` on its domain.  Counts each launch in
    ``flash_dkv_sm90.launches``."""
    shape = _check_sm90("flash_dkv_sm90", [q3, k3, v3, go], [lse, delta])
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    _launch("flash_attention_sm90", "flash_dkv_sm90",
            [t.data_ptr() for t in (q3, k3, v3, go, lse, delta, dk, dv)],
            shape, q3.dtype, causal, window, q3.device)
    flash_dkv_sm90.launches += 1
    return dk, dv


def flash_dq_simt(q3, k3, v3, go, lse, delta, *, causal=False, window=None):
    """Launch the SIMT dQ kernel; returns ``dq`` in q's dtype.  Counts
    each launch in ``flash_dq_simt.launches``."""
    shape = _check_operands("flash_dq_simt", [q3, k3, v3, go], [lse, delta],
                            tile_rows(q3.shape[-1]))
    dq = torch.empty_like(q3)
    _launch("flash_attention", "flash_dq",
            [t.data_ptr() for t in (q3, k3, v3, go, lse, delta, dq)],
            shape, q3.dtype, causal, window, q3.device)
    flash_dq_simt.launches += 1
    return dq


def flash_dq_sm90(q3, k3, v3, go, lse, delta, *, causal=False, window=None):
    """Launch the tensor-core dQ kernel; the contract of `flash_dq_simt` on
    its domain.  Counts each launch in ``flash_dq_sm90.launches``."""
    shape = _check_sm90("flash_dq_sm90", [q3, k3, v3, go], [lse, delta])
    dq = torch.empty_like(q3)
    _launch("flash_attention_sm90", "flash_dq_sm90",
            [t.data_ptr() for t in (q3, k3, v3, go, lse, delta, dq)],
            shape, q3.dtype, causal, window, q3.device)
    flash_dq_sm90.launches += 1
    return dq


# every wrapper that launches a kernel, each with its own count
KERNELS = (flash_fwd_sm90, flash_fwd_simt, flash_dkv_sm90, flash_dkv_simt, flash_dq_sm90,
           flash_dq_simt)
for _kernel in KERNELS:
    _kernel.launches = 0


def flash_fwd(q3, k3, v3, *, causal=False, window=None):
    """The forward kernel `flash_route` names for q's dtype and head dim."""
    sm90 = flash_route(q3.dtype, q3.shape[-1]) == "sm90"
    return (flash_fwd_sm90 if sm90 else flash_fwd_simt)(q3, k3, v3, causal=causal, window=window)


def flash_dkv(q3, k3, v3, go, lse, delta, *, causal=False, window=None):
    """The dK/dV kernel `flash_route` names for q's dtype and head dim."""
    sm90 = flash_route(q3.dtype, q3.shape[-1]) == "sm90"
    return (flash_dkv_sm90 if sm90 else flash_dkv_simt)(q3, k3, v3, go, lse, delta,
                                                        causal=causal, window=window)


def flash_dq(q3, k3, v3, go, lse, delta, *, causal=False, window=None):
    """The dQ kernel `flash_route` names for q's dtype and head dim."""
    sm90 = flash_route(q3.dtype, q3.shape[-1]) == "sm90"
    return (flash_dq_sm90 if sm90 else flash_dq_simt)(q3, k3, v3, go, lse, delta,
                                                      causal=causal, window=window)


def _on(t: torch.Tensor, kernel, reference):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if t.is_cuda:
        return kernel
    if t.device.type == "cpu":
        return reference
    raise ValueError(f"flash attention runs on cuda or cpu tensors, not {t.device}")


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q3, k3, v3, causal, window):
        out, lse = _on(q3, flash_fwd, flash_fwd_reference)(
            q3, k3, v3, causal=causal, window=window
        )
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q3, k3, v3, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        # tpu_dist/ops/flash_attention.py::_flash_bwd: D from the unrounded
        # cotangent, the kernels take it in q's dtype.
        q3, k3, v3, out, lse = ctx.saved_tensors
        delta = (g.float() * out.float()).sum(-1)
        go = g.to(q3.dtype).contiguous()
        kw = dict(causal=ctx.causal, window=ctx.window)
        dk, dv = _on(q3, flash_dkv, flash_dkv_reference)(q3, k3, v3, go, lse, delta, **kw)
        dq = _on(q3, flash_dq, flash_dq_reference)(q3, k3, v3, go, lse, delta, **kw)
        return dq, dk, dv, None, None


def _validate(q, k, v, bq, bk, window, *, window_first):
    """The JAX package's checks, in its order (flash_attention.py:154-162,
    358-372), so the same calls are accepted and refused."""

    def check_window():
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")

    if window_first:
        check_window()
    S = q.shape[-2]
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    bq, bk = min(bq, S), min(bk, S)
    if S % bq or S % bk:
        raise ValueError(f"seq {S} not divisible by blocks ({bq}, {bk})")
    if not window_first:
        check_window()


def _flat(t: torch.Tensor) -> torch.Tensor:
    S, d = t.shape[-2:]
    return t.reshape(-1, S, d).contiguous()


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False, bq: int = 256, bk: int = 256, window: int | None = None,
) -> torch.Tensor:
    """Attention over ``(..., heads, S, d)`` without materializing (S, S).

    ``bq``/``bk`` are the JAX kernel's blocks: S must divide by them after
    they clamp to S, as there; the CUDA kernels use their own tiles (128
    rows on the tensor-core route, 64 or 32 on the SIMT one) and take any S.  ``window=w`` adds the band ``k > q - w``.
    Differentiable: the backward runs the dK/dV and dQ kernels."""
    _validate(q, k, v, bq, bk, window, window_first=False)
    out = _Flash.apply(_flat(q), _flat(k), _flat(v), causal, window)
    return out.reshape(q.shape)


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False, bq: int = 256, bk: int = 256, window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention` that also returns the per-row log-sum-exp
    ``(..., S)``.  Forward only, as in the JAX package."""
    _validate(q, k, v, bq, bk, window, window_first=True)
    q3, k3, v3 = _flat(q), _flat(k), _flat(v)
    out, lse = _on(q3, flash_fwd, flash_fwd_reference)(
        q3, k3, v3, causal=causal, window=window
    )
    return out.reshape(q.shape), lse.reshape(q.shape[:-1])
