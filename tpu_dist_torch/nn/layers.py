"""The layers the MNIST ConvNet and the TransformerLM use, as
``torch.nn.Module``s.

Activations keep the JAX package's layout at every layer boundary: images
NHWC, so ``flatten`` orders features H, W, C exactly as `tpu_dist.nn`
does.  Convolution and pooling run on an NCHW view of the NHWC tensor
(``permute``, no copy: torch treats it as channels-last).  Weights take
torch's layouts where torch consumes them (convolution OIHW) and the
kernel's where the kernel does (Dense ``w`` is (in, out)); `interop`
converts to and from the JAX trees.
"""

from __future__ import annotations

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
    """2-D convolution, stride 1, no padding; NHWC in and out, OIHW weight."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel: int,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        fan_in = in_channels * kernel * kernel
        self.w = nn.Parameter(
            fanin_uniform((features, in_channels, kernel, kernel), fan_in, generator)
        )
        self.b = nn.Parameter(fanin_uniform((features,), fan_in, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.w, self.b)
        return y.permute(0, 2, 3, 1)


class MaxPool2D(nn.Module):
    """Max pooling over NHWC, window = stride."""

    def __init__(self, window: int = 2):
        super().__init__()
        self.window = window

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.max_pool2d(x.permute(0, 3, 1, 2), self.window)
        return y.permute(0, 2, 3, 1)


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
