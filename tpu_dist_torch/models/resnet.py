"""ResNet-18, layer for layer as `tpu_dist.models.resnet` (BASELINE
config 4: ResNet-18 on CIFAR-10).

A `tpu_dist_torch.nn.Sequential` at the JAX ``Sequential``'s indices: the
stem at 0-2 (CIFAR: 3x3 conv, batch norm, relu) or 0-3 (``imagenet_stem``:
7x7 stride-2 conv, batch norm, relu, 3x3 stride-2 max pool), then eight
`BasicBlock`s, `GlobalAvgPool` and the ``Dense`` head.  Parameter and
buffer names are ``"<index>.<path>"`` (``"3.bn1.mean"``), so `interop`
carries them to and from the JAX ``(params, state)`` trees.  NHWC
throughout.
"""

from __future__ import annotations

import torch

from tpu_dist_torch import nn

STAGES = (64, 128, 256, 512)


class BasicBlock(torch.nn.Module):
    """Two 3x3 convolutions, each followed by batch norm, and the identity
    shortcut, or a strided 1x1 projection with its own batch norm where the
    stride or the width changes."""

    def __init__(self, in_features: int, features: int, stride: int = 1, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = nn.Conv2D(in_features, features, 3, stride=stride, padding=1,
                               use_bias=False, generator=generator)
        self.bn1 = nn.BatchNorm(features)
        self.conv2 = nn.Conv2D(features, features, 3, padding=1, use_bias=False,
                               generator=generator)
        self.bn2 = nn.BatchNorm(features)
        if stride != 1 or in_features != features:
            self.proj = nn.Conv2D(in_features, features, 1, stride=stride, use_bias=False,
                                  generator=generator)
            self.bn_proj = nn.BatchNorm(features)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        shortcut = x if self.proj is None else self.bn_proj(self.proj(x))
        return torch.relu(h + shortcut)


def resnet18(num_classes: int = 10, *, imagenet_stem: bool = False,
             generator: torch.Generator | None = None) -> nn.Sequential:
    """The [2, 2, 2, 2] basic-block ResNet-18 on (N, H, W, 3) images, with
    torch's fan-in init drawn from ``generator``, float32 on the CPU."""
    if imagenet_stem:
        stem = [nn.Conv2D(3, 64, 7, stride=2, padding=3, use_bias=False, generator=generator),
                nn.BatchNorm(64), nn.relu(), nn.MaxPool2D(3, 2)]
    else:
        stem = [nn.Conv2D(3, 64, 3, padding=1, use_bias=False, generator=generator),
                nn.BatchNorm(64), nn.relu()]
    blocks, width = [], 64
    for stage, features in enumerate(STAGES):
        for i in range(2):
            blocks.append(BasicBlock(width, features, 2 if stage > 0 and i == 0 else 1,
                                     generator=generator))
            width = features
    head = [nn.GlobalAvgPool(), nn.Dense(width, num_classes, generator=generator)]
    return nn.Sequential(*stem, *blocks, *head)
