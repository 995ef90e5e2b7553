"""Fused dense kernel: ``epilogue(x @ w + b)`` in one CUDA launch.

The port of `tpu_dist.ops.matmul` (the Pallas kernel ``_matmul_kernel``).
The kernel is ``csrc/matmul.cu``, built at first use by `_build.build` and
called through ``ctypes``.  Beside it:

- `matmul_reference`, the plain PyTorch version: ``x @ w + b`` in float32,
  the epilogue, then a cast to the input type.  Tensors on the CPU take it;
  on the card it is what the kernel is held against.
- `fused_dense`, the kernel's wrapper, for CUDA tensors only, with its
  launch count ``fused_dense.launches``.
- `dense_tiling`, the one place that picks the kernel's route and tiles
  from the shape and the card's SM count; `DenseTiling.tiles` and
  `DenseTiling.k_slices` are the output tiles and K slices the kernel walks.
- `matmul`, the differentiable op ``nn.Dense`` calls, whose backward mirrors
  the JAX custom VJP: plain matrix products, with the pre-activation
  recomputed by the kernel for the fused epilogues.
- `use_pallas_dense`, the same ``TPU_DIST_PALLAS_DENSE`` flag.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tpu_dist_torch.ops import _build

_EPILOGUES = {
    "none": lambda y: y,
    "relu": F.relu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),  # jax.nn.gelu's form
}
_EPILOGUE_CODES = {"none": 0, "relu": 1, "gelu": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT32_MAX = 2**31 - 1
_ROUTE_CODES = {"small": 0, "large": 1}
LARGE_TILE = (64, 64, 16)  # the large route's bm, bn and K step
SMALL_TILES = ((8, 8), (16, 16))
SMALL_MAX_WARPS = 8
SMALL_MAX_SMEM = 48 * 1024  # bytes: the static limit, no attribute call per launch


@dataclass(frozen=True)
class DenseTiling:
    """How the kernel covers ``(m, k) @ (k, n)``: ``route`` "large" (64 x 64
    tiles, K steps of ``k_chunk`` = 16) or "small" (``bm`` x ``bn`` tiles,
    ``k_split`` warps sharing each K chunk of up to ``k_chunk`` columns)."""

    route: str
    bm: int
    bn: int
    k_split: int
    k_chunk: int

    def tiles(self, m: int, n: int) -> list[tuple[slice, slice]]:
        """The (rows, columns) each block owns, clipped to the output."""
        return [(slice(r, min(r + self.bm, m)), slice(c, min(c + self.bn, n)))
                for r in range(0, m, self.bm) for c in range(0, n, self.bn)]

    def k_slices(self, k: int) -> list[range]:
        """The K columns one output element sums, as the small kernel's
        warps take them: for each chunk, warp w's slice ``[w ks, (w + 1)
        ks)``, ``ks = ceil(chunk / k_split)``; the large route's K steps."""
        out = []
        for c0 in range(0, k, self.k_chunk):
            kc = min(self.k_chunk, k - c0)
            ks = -(-kc // self.k_split)
            out += [range(c0 + w * ks, c0 + min(kc, (w + 1) * ks))
                    for w in range(self.k_split)]
        return out


def small_smem_bytes(bm: int, bn: int, k_split: int, k_chunk: int) -> int:
    """Shared memory of a small-route block (``small_floats`` in the
    source): the x tile at an odd row pitch and the w tile, or the warps'
    partial sums, which reuse that space."""
    return 4 * max(bm * (k_chunk | 1) + k_chunk * bn, k_split * bm * bn)


@functools.cache
def dense_tiling(m: int, n: int, k: int, sms: int) -> DenseTiling:
    """The kernel's route and tiles for an (m, k) @ (k, n) product on a card
    with ``sms`` SMs.  An output that gives every SM a 64 x 64 tile takes
    the large route.  A smaller one takes 8 x 8 tiles while they fit four to
    an SM, else 16 x 16, so the few output elements still spread over the
    card, and splits K over up to 8 warps; K is cut into as few equal
    chunks as the static shared memory allows (one for the MNIST layers)."""
    bm, bn, bk = LARGE_TILE
    if -(-m // bm) * -(-n // bn) >= sms:
        return DenseTiling("large", bm, bn, 1, bk)
    small, medium = SMALL_TILES
    bm, bn = small if -(-m // small[0]) * -(-n // small[1]) <= 4 * sms else medium
    k_split = max(1, min(SMALL_MAX_WARPS, k))
    deepest = (SMALL_MAX_SMEM // 4 - bm) // (bm + bn)  # whose tiles fit; the sums always do
    chunks = max(1, -(-k // deepest))
    k_chunk = max(1, -(-k // chunks))
    return DenseTiling("small", bm, bn, k_split, k_chunk)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def matmul_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, epilogue: str = "none"
) -> torch.Tensor:
    """The plain version: float32 product and bias, epilogue, cast back."""
    y = x.float() @ w.float()
    if b is not None:
        y = y + b.float()
    return _EPILOGUES[epilogue](y).to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("matmul").path))
    lib.fused_dense.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    lib.fused_dense.restype = ctypes.c_int
    lib.fused_dense_error_string.argtypes = [ctypes.c_int]
    lib.fused_dense_error_string.restype = ctypes.c_char_p
    return lib


def fused_dense(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, epilogue: str = "none"
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream, on the route and tiles
    `dense_tiling` picks; raises on anything it does not take.  Counts each
    launch in ``fused_dense.launches``."""
    if epilogue not in _EPILOGUE_CODES:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {list(_EPILOGUES)}")
    operands = [x, w] + ([b] if b is not None else [])
    if not all(t.is_cuda and t.device == x.device for t in operands):
        raise ValueError("fused_dense takes CUDA tensors on one device")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in operands):
        raise TypeError(
            f"fused_dense takes float32, bfloat16 or float16 operands of one dtype, got "
            f"{[t.dtype for t in operands]}"
        )
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_dense needs x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if b is not None and tuple(b.shape) != (n,):
        raise ValueError(f"bias must have shape ({n},), got {tuple(b.shape)}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("fused_dense takes contiguous tensors")
    if max(m, k, n) > _INT32_MAX:  # each is a C int; offsets are 64-bit
        raise ValueError(f"fused_dense shape {(m, k, n)} has a dimension past 2^31 - 1")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _library()
    t = dense_tiling(m, n, k, _sm_count(x.device.index))
    with torch.cuda.device(x.device):
        code = lib.fused_dense(
            x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None else None,
            out.data_ptr(), m, n, k, _DTYPE_CODES[x.dtype], _EPILOGUE_CODES[epilogue],
            _ROUTE_CODES[t.route], t.bm, t.bn, t.k_split, t.k_chunk,
            torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        reason = lib.fused_dense_error_string(code).decode()
        raise RuntimeError(f"fused_dense launch failed: CUDA error {code} ({reason})")
    fused_dense.launches += 1
    return out


fused_dense.launches = 0


def _forward(x, w, b, epilogue):
    if x.is_cuda:
        return fused_dense(x, w, b, epilogue)
    if x.device.type == "cpu":
        return matmul_reference(x, w, b, epilogue)
    raise ValueError(f"matmul runs on cuda or cpu tensors, not {x.device}")


class _FusedDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, epilogue):
        ctx.epilogue = epilogue
        ctx.save_for_backward(x, w, b)
        return _forward(x, w, b, epilogue)

    @staticmethod
    def backward(ctx, g):
        # tpu_dist/ops/matmul.py::_matmul_bwd: the products are plain
        # matmuls; a fused epilogue's pre-activation is recomputed (cheaper
        # than keeping an (M, N) residual).
        x, w, b = ctx.saved_tensors
        if ctx.epilogue == "none":
            d_pre = g
        else:
            pre = _forward(x, w, b, "none").detach().requires_grad_()
            with torch.enable_grad():
                (d_pre,) = torch.autograd.grad(_EPILOGUES[ctx.epilogue](pre), pre, g)
        dx = (d_pre @ w.T).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = (x.T @ d_pre).to(w.dtype) if ctx.needs_input_grad[1] else None
        db = None
        if b is not None and ctx.needs_input_grad[2]:
            db = d_pre.sum(0).to(b.dtype)
        return dx, dw, db, None


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    epilogue: str = "none",
) -> torch.Tensor:
    """``epilogue(x @ w + b)`` in one kernel.  x: (M, K), w: (K, N),
    b: (N,) or None.  Differentiable.  A CUDA tensor runs the kernel; a CPU
    tensor runs `matmul_reference`."""
    if epilogue not in _EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {list(_EPILOGUES)}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"inner dims mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
    if b is not None:
        b = b.contiguous()
    return _FusedDense.apply(x.contiguous(), w.contiguous(), b, epilogue)


def use_pallas_dense() -> bool:
    """Feature flag: route `tpu_dist_torch.nn.Dense` through the kernel (the
    flag of the JAX package, read the same way)."""
    return os.environ.get("TPU_DIST_PALLAS_DENSE", "0") == "1"
