"""The layers the MNIST ConvNet, the TransformerLM, ResNet-18 and the ViT
use, as ``torch.nn.Module``s.

Activations keep the JAX package's layout at every layer boundary: images
NHWC, so ``flatten`` orders features H, W, C exactly as `tpu_dist.nn`
does.  Convolution and pooling run on an NCHW view of the NHWC tensor
(``permute``, no copy: torch treats it as channels-last).  Weights take
torch's layouts where torch consumes them (convolution OIHW) and the
kernel's where the kernel does (Dense ``w`` is (in, out)); `interop`
converts to and from the JAX trees.  `BatchNorm` keeps its running
statistics in buffers, which are the JAX model's ``state``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from tpu_dist_torch.nn.core import Stochastic, fanin_uniform
from tpu_dist_torch.ops.matmul import matmul, use_pallas_dense


class Dense(nn.Module):
    """Affine layer, ``y = x @ w + b`` with ``w`` (in, out)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        use_bias: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.use_bias = use_bias
        self.w = nn.Parameter(fanin_uniform((in_features, features), in_features, generator))
        self.b = (
            nn.Parameter(fanin_uniform((features,), in_features, generator))
            if use_bias
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The condition of tpu_dist/nn/layers.py:50: 2-D input with a bias,
        # under the flag, goes through the fused kernel.
        if self.use_bias and x.dim() == 2 and use_pallas_dense():
            return matmul(x, self.w, self.b)
        y = x @ self.w
        if self.use_bias:
            y = y + self.b
        return y


class Conv2D(nn.Module):
    """2-D convolution, NHWC in and out, OIHW weight ``w`` and bias ``b``
    (``use_bias``).  ``padding``: an int (that many rows and columns on
    every side), ``"VALID"`` (none) or ``"SAME"`` (XLA's: the output is
    ``ceil(size / stride)``, and an odd total pads one more on the high
    side, which ``F.conv2d(padding="same")`` does not take at stride > 1)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel: int,
        *,
        stride: int = 1,
        padding: int | str = "VALID",
        use_bias: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if isinstance(padding, str) and padding.upper() not in ("VALID", "SAME"):
            raise ValueError(f"padding must be an int, 'VALID' or 'SAME', got {padding!r}")
        self.kernel = kernel
        self.stride = stride
        self.padding = padding.upper() if isinstance(padding, str) else padding
        fan_in = in_channels * kernel * kernel
        self.w = nn.Parameter(
            fanin_uniform((features, in_channels, kernel, kernel), fan_in, generator)
        )
        self.b = nn.Parameter(fanin_uniform((features,), fan_in, generator)) if use_bias else None

    def _pads(self, h: int, w: int) -> tuple[int, int, int, int]:
        """(left, right, top, bottom) columns and rows of zeros."""
        if self.padding == "VALID":
            return (0, 0, 0, 0)
        if self.padding != "SAME":
            return (self.padding,) * 4
        pads = []
        for size in (w, h):
            total = max((-(-size // self.stride) - 1) * self.stride + self.kernel - size, 0)
            pads += [total // 2, total - total // 2]
        return tuple(pads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        left, right, top, bottom = self._pads(x.shape[2], x.shape[3])
        if left == right and top == bottom:
            y = F.conv2d(x, self.w, self.b, self.stride, (top, left))
        else:
            y = F.conv2d(F.pad(x, (left, right, top, bottom)), self.w, self.b, self.stride)
        return y.permute(0, 2, 3, 1)


class _Pool2D(nn.Module):
    """VALID pooling over NHWC; the stride defaults to the window."""

    def __init__(self, window: int = 2, stride: int | None = None):
        super().__init__()
        self.window = window
        self.stride = window if stride is None else stride


class MaxPool2D(_Pool2D):
    """Max pooling over NHWC, VALID; the stride defaults to the window."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.max_pool2d(x.permute(0, 3, 1, 2), self.window, self.stride)
        return y.permute(0, 2, 3, 1)


class AvgPool2D(_Pool2D):
    """Mean pooling over NHWC, VALID; the stride defaults to the window."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.avg_pool2d(x.permute(0, 3, 1, 2), self.window, self.stride)
        return y.permute(0, 2, 3, 1)


class GlobalAvgPool(nn.Module):
    """(N, H, W, C) -> (N, C): the mean over the spatial axes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2))


class BatchNorm(nn.Module):
    """Batch normalization over every axis but the last, as
    `tpu_dist.nn.BatchNorm`: parameters ``scale`` and ``bias``, running
    statistics in the float32 buffers ``mean`` and ``var``, eps 1e-5.

    ``momentum`` is the decay of the running average (``running =
    momentum * running + (1 - momentum) * batch``), the reverse of
    ``torch.nn.BatchNorm2d``'s; the running variance takes the biased batch
    variance.  In training the batch's statistics normalize and the
    buffers are updated in place, unless ``update`` is False (see
    `frozen_statistics`); in eval the buffers normalize."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.update = True
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            var, mean = torch.var_mean(x, dim=tuple(range(x.dim() - 1)), correction=0)
            if self.update:
                with torch.no_grad():
                    m = self.momentum
                    # (1 - m) * mean stays in the batch's dtype, then the sum
                    # in float32, as jnp promotes it
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias


@contextlib.contextmanager
def frozen_statistics(module: nn.Module):
    """Within the block, the `BatchNorm` layers of ``module`` normalize as
    before but leave their running statistics alone: the recompute of a
    rematerialized forward updates them no second time."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.update for m in norms]
    for m in norms:
        m.update = False
    try:
        yield
    finally:
        for m, flag in zip(norms, before):
            m.update = flag


class Dropout(Stochastic):
    """Train-only dropout with inverted scaling; draws from the generator
    the caller passes."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def _mask_shape(self, x: torch.Tensor) -> tuple[int, ...]:
        return tuple(x.shape)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError(f"{type(self).__name__} needs a generator in training")
        keep = 1.0 - self.rate
        mask = torch.empty(self._mask_shape(x), device=x.device).bernoulli_(
            keep, generator=generator
        )
        return torch.where(mask.bool(), x / keep, 0.0)


class Dropout2D(Dropout):
    """Drops whole channels: the NHWC mask has shape (N, 1, 1, C)."""

    def _mask_shape(self, x: torch.Tensor) -> tuple[int, ...]:
        return (x.shape[0], 1, 1, x.shape[-1])


class LayerNorm(nn.Module):
    """Layer norm over the last axis with eps 1e-6 and the population
    variance, as `tpu_dist.nn.LayerNorm` (not torch's 1e-5); parameters
    ``scale`` and ``bias``."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias


class Embedding(nn.Module):
    """Lookup table ``table`` (vocab, features), initialised normal * 0.02."""

    def __init__(self, vocab: int, features: int, *, generator: torch.Generator | None = None):
        super().__init__()
        self.vocab = vocab
        self.features = features
        self.table = nn.Parameter(
            torch.randn(vocab, features, generator=generator) * 0.02
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.table[x]


def relu() -> nn.Module:
    return nn.ReLU()


def gelu() -> nn.Module:
    """The tanh form, which ``jax.nn.gelu`` computes by default."""
    return nn.GELU(approximate="tanh")


def log_softmax() -> nn.Module:
    return nn.LogSoftmax(dim=-1)


def flatten() -> nn.Module:
    """(N, H, W, C) -> (N, H*W*C), features in H, W, C order."""
    return nn.Flatten()
