"""`tpu_dist_torch.models` — the models the port trains."""

from tpu_dist_torch.models.mnist_net import IN_SHAPE, NUM_CLASSES, mnist_net
from tpu_dist_torch.models.resnet import BasicBlock, resnet18
from tpu_dist_torch.models.transformer_lm import (
    TransformerLM,
    lm_loss,
    lm_loss_seq_parallel,
    lm_perplexity,
    markov_table,
    synthetic_tokens,
)
from tpu_dist_torch.models.vit import ViT, vit_tiny

__all__ = [
    "BasicBlock",
    "IN_SHAPE",
    "NUM_CLASSES",
    "TransformerLM",
    "ViT",
    "lm_loss",
    "lm_loss_seq_parallel",
    "lm_perplexity",
    "markov_table",
    "mnist_net",
    "resnet18",
    "synthetic_tokens",
    "vit_tiny",
]
