"""Blockwise (flash) attention: forward, dK/dV and dQ in three CUDA kernels.

The port of `tpu_dist.ops.flash_attention` (the Pallas kernels
``_flash_kernel``, ``_dkv_kernel`` and ``_dq_kernel``).  The kernels are
``csrc/flash_attention.cu``, built at first use by `_build.build` and called
through ``ctypes``.  Beside them:

- `flash_fwd_reference`, `flash_dkv_reference`, `flash_dq_reference`: the
  plain PyTorch versions, the same formulas on dense (S, S) blocks.  Tensors
  on the CPU take them; on the card they are what the kernels are held
  against.
- `flash_fwd`, `flash_dkv`, `flash_dq`: the kernels' wrappers, for CUDA
  tensors only, each with its launch count (``flash_fwd.launches``, ...).
- `flash_attention` and `flash_attention_lse` on the JAX layout
  ``(..., heads, S, d)``, with the JAX package's checks; the first is
  differentiable, its backward the two backward kernels, as the JAX custom
  VJP runs them.
- `key_tile_range` and `query_tile_range`: the tile-skipping arithmetic the
  kernels use (and the TPU kernels used), in Python for the tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_dist_torch.ops import _build

NEG_INF = -1e30
TILE = 64  # the kernels' query and key tile up to d = 128 (the TPU kernels' bq, bk: 256)
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_GRID_Y = 65535  # the kernels' grid is (bh, S / tile)
# Plain versions form (chunk, S, S) float32 blocks; this many elements each.
_REFERENCE_BLOCK = 1 << 27


# ---------------------------------------------------------------- tile ranges


def tile_rows(d: int) -> int:
    """The kernels' query and key tile for head dim ``d``: 64 rows, and 32
    at d > 128, where four 64-row float32 tiles would not fit in a block's
    shared memory."""
    return TILE if d <= 128 else TILE // 2


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("flash_attention").path))
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i, i, i, ctypes.c_float, i, i, i, p]  # bh S d scale dtype causal window stream
    lib.flash_fwd.argtypes = [p] * 5 + tail
    lib.flash_dkv.argtypes = [p] * 8 + tail
    lib.flash_dq.argtypes = [p] * 7 + tail
    for fn in (lib.flash_fwd, lib.flash_dkv, lib.flash_dq):
        fn.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [i]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(name, blocks, rows):
    """``blocks``: (bh, S, d) tensors of one float dtype; ``rows``: (bh, S)
    float32 tensors.  All contiguous CUDA tensors on one device."""
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
    if bh > 2**31 - 1 or -(-S // tile_rows(d)) > _MAX_GRID_Y:
        raise ValueError(f"{name} shape {(bh, S, d)} exceeds the kernel's grid "
                         f"(bh < 2^31, S <= {_MAX_GRID_Y * tile_rows(d)})")
    return bh, S, d


def _launch(name, fn, pointers, shape, dtype, causal, window, device):
    bh, S, d = shape
    lib = _library()
    with torch.cuda.device(device):
        code = getattr(lib, fn)(
            *pointers, bh, S, d, d**-0.5, _DTYPE_CODES[dtype], int(causal),
            0 if window is None else window, torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        reason = lib.flash_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({reason})")


def flash_fwd(q3, k3, v3, *, causal=False, window=None):
    """Launch the forward kernel on the current stream; returns ``out``
    (bh, S, d) in q's dtype and ``lse`` (bh, S) float32.  Raises on anything
    it does not take.  Counts each launch in ``flash_fwd.launches``."""
    shape = _check_operands("flash_fwd", [q3, k3, v3], [])
    out = torch.empty_like(q3)
    lse = torch.empty(shape[:2], dtype=torch.float32, device=q3.device)
    _launch("flash_fwd", "flash_fwd",
            [t.data_ptr() for t in (q3, k3, v3, out, lse)],
            shape, q3.dtype, causal, window, q3.device)
    flash_fwd.launches += 1
    return out, lse


def flash_dkv(q3, k3, v3, go, lse, delta, *, causal=False, window=None):
    """Launch the dK/dV kernel; returns ``(dk, dv)`` in k's dtype.  Counts
    each launch in ``flash_dkv.launches``."""
    shape = _check_operands("flash_dkv", [q3, k3, v3, go], [lse, delta])
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    _launch("flash_dkv", "flash_dkv",
            [t.data_ptr() for t in (q3, k3, v3, go, lse, delta, dk, dv)],
            shape, q3.dtype, causal, window, q3.device)
    flash_dkv.launches += 1
    return dk, dv


def flash_dq(q3, k3, v3, go, lse, delta, *, causal=False, window=None):
    """Launch the dQ kernel; returns ``dq`` in q's dtype.  Counts each
    launch in ``flash_dq.launches``."""
    shape = _check_operands("flash_dq", [q3, k3, v3, go], [lse, delta])
    dq = torch.empty_like(q3)
    _launch("flash_dq", "flash_dq",
            [t.data_ptr() for t in (q3, k3, v3, go, lse, delta, dq)],
            shape, q3.dtype, causal, window, q3.device)
    flash_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_dkv.launches = 0
flash_dq.launches = 0


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
    they clamp to S, as there; the CUDA kernels use their own 64- or 32-row tiles
    and take any S.  ``window=w`` adds the band ``k > q - w``.
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
