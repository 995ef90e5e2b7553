"""`tpu_dist_torch.nn` — layers, losses and metrics of the port."""

from tpu_dist_torch.nn.core import Sequential, Stochastic, fanin_uniform
from tpu_dist_torch.nn.layers import (
    AvgPool2D,
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    Dropout2D,
    Embedding,
    GlobalAvgPool,
    LayerNorm,
    MaxPool2D,
    flatten,
    frozen_statistics,
    gelu,
    log_softmax,
    relu,
)
from tpu_dist_torch.nn.attention import (
    MultiHeadAttention,
    dot_product_attention,
    rope,
    segment_mask,
    sliding_window_mask,
)
from tpu_dist_torch.nn.losses import accuracy, cross_entropy, nll_loss

__all__ = [
    "AvgPool2D",
    "BatchNorm",
    "Conv2D",
    "Dense",
    "Dropout",
    "Dropout2D",
    "Embedding",
    "GlobalAvgPool",
    "LayerNorm",
    "MaxPool2D",
    "MultiHeadAttention",
    "Sequential",
    "Stochastic",
    "accuracy",
    "cross_entropy",
    "dot_product_attention",
    "fanin_uniform",
    "flatten",
    "frozen_statistics",
    "gelu",
    "log_softmax",
    "nll_loss",
    "relu",
    "rope",
    "segment_mask",
    "sliding_window_mask",
]
