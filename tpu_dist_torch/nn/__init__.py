"""`tpu_dist_torch.nn` — layers and losses of the port."""

from tpu_dist_torch.nn.core import Sequential, Stochastic, fanin_uniform
from tpu_dist_torch.nn.layers import (
    Conv2D,
    Dense,
    Dropout,
    Dropout2D,
    Embedding,
    LayerNorm,
    MaxPool2D,
    flatten,
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
from tpu_dist_torch.nn.losses import nll_loss

__all__ = [
    "Conv2D",
    "Dense",
    "Dropout",
    "Dropout2D",
    "Embedding",
    "LayerNorm",
    "MaxPool2D",
    "MultiHeadAttention",
    "Sequential",
    "Stochastic",
    "dot_product_attention",
    "fanin_uniform",
    "flatten",
    "gelu",
    "log_softmax",
    "nll_loss",
    "relu",
    "rope",
    "segment_mask",
    "sliding_window_mask",
]
