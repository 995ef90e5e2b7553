"""Losses and the accuracy metric: ``nll_loss`` (the MNIST ConvNet's),
``cross_entropy`` (the image models' heads) and ``accuracy``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log likelihood over the batch, given log-probabilities
    and int32 (or int64) class labels."""
    return F.nll_loss(log_probs, targets.long())


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy from raw logits: ``nll_loss`` of their
    ``log_softmax`` over the last axis."""
    return nll_loss(torch.log_softmax(logits, dim=-1), targets)


def accuracy(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The share of rows whose highest score is at the target class, as a
    float32 0-d tensor."""
    return (scores.argmax(-1) == targets).float().mean()
