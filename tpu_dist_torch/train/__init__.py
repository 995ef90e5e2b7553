"""`tpu_dist_torch.train` — optimizers, schedules, FLOP counts and trainers."""

from tpu_dist_torch.train import checkpoint, flops, metrics, schedule
from tpu_dist_torch.train.lm_trainer import LMEpochStats, LMTrainConfig, LMTrainer
from tpu_dist_torch.train.optim import (
    Optimizer,
    adamw,
    clip_by_global_norm,
    decay_mask_default,
    global_norm,
    sgd,
    sgd_rule,
)
from tpu_dist_torch.train.trainer import EpochStats, TrainConfig, Trainer

__all__ = [
    "EpochStats",
    "LMEpochStats",
    "LMTrainConfig",
    "LMTrainer",
    "Optimizer",
    "TrainConfig",
    "Trainer",
    "adamw",
    "checkpoint",
    "clip_by_global_norm",
    "decay_mask_default",
    "flops",
    "global_norm",
    "metrics",
    "schedule",
    "sgd",
    "sgd_rule",
]
