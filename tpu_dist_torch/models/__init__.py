"""`tpu_dist_torch.models` — the models the port trains."""

from tpu_dist_torch.models.mnist_net import IN_SHAPE, NUM_CLASSES, mnist_net
from tpu_dist_torch.models.transformer_lm import (
    TransformerLM,
    lm_loss,
    lm_perplexity,
    markov_table,
    synthetic_tokens,
)

__all__ = [
    "IN_SHAPE",
    "NUM_CLASSES",
    "TransformerLM",
    "lm_loss",
    "lm_perplexity",
    "markov_table",
    "mnist_net",
    "synthetic_tokens",
]
