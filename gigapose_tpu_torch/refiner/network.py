"""Refiner and scorer networks (port of gigapose_tpu/refiner/network.py), NCHW.

A ResNet trunk over the concatenated (observed crop, rendered crop) channels
(7x7/2 conv, BN, ReLU, 3x3/2 max-pool padded with -inf, stages of ResBlocks
with a 1x1 downsample, global mean), with

- RefinerNet: a 9-d pose head (ortho6d dR + vx vy vz) that starts as the
  identity update (zero weight, zero bias, plus the constant
  [1, 0, 0, 0, 1, 0, 0, 0, 1]), and
- CoarseScorerNet: a 1-d logit.

BatchNorm runs in eval mode with eps 1e-5 (flax's default). Module names
follow the flax ones, so `models.convert.refiner_flax_to_torch` maps a
variable tree by its paths.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

POSE_HEAD_BIAS = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class ResBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        if stride != 1 or in_planes != planes:
            self.down = nn.Conv2d(in_planes, planes, 1, stride, 0, bias=False)
            self.down_bn = _bn(planes)
        else:
            self.down = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.down is not None:
            x = self.down_bn(self.down(x))
        return F.relu(x + y)


class RefinerBackbone(nn.Module):
    """ResNet-34-shaped trunk over NCHW inputs -> pooled feature vector."""

    def __init__(self, in_channels: int = 6, width: int = 64,
                 blocks: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.blocks = tuple(blocks)
        self.conv1 = nn.Conv2d(in_channels, width, 7, 2, 3, bias=False)
        self.bn1 = _bn(width)
        planes = width
        for i, n in enumerate(self.blocks):
            out = width * 2 ** i
            for j in range(n):
                setattr(self, f"layer{i + 1}_{j}",
                        ResBlock(planes, out, stride=2 if (i > 0 and j == 0) else 1))
                planes = out
        self.out_dim = planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)  # implicit -inf padding
        for i, n in enumerate(self.blocks):
            for j in range(n):
                x = getattr(self, f"layer{i + 1}_{j}")(x)
        return x.mean(dim=(2, 3))


class RefinerNet(nn.Module):
    """(B, 6, H, W) concat(observed, render) -> (B, 9) pose update."""

    def __init__(self, width: int = 64, blocks: Sequence[int] = (3, 4, 6, 3),
                 in_channels: int = 6):
        super().__init__()
        self.backbone = RefinerBackbone(in_channels, width, blocks)
        self.pose_head = nn.Linear(self.backbone.out_dim, 9)
        self.register_buffer("identity", torch.tensor(POSE_HEAD_BIAS), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pose_head(self.backbone(x)) + self.identity


class CoarseScorerNet(nn.Module):
    """(B, 6, H, W) -> (B,) hypothesis logit."""

    def __init__(self, width: int = 32, blocks: Sequence[int] = (2, 2, 2, 2),
                 in_channels: int = 6):
        super().__init__()
        self.backbone = RefinerBackbone(in_channels, width, blocks)
        self.logit_head = nn.Linear(self.backbone.out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logit_head(self.backbone(x))[..., 0]


def init_like_flax_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in flax's init scheme: convolution and dense
    kernels truncated-normal lecun (std 1 / sqrt(fan_in), cut at 2 std),
    biases 0, BatchNorm scale 1, bias 0, mean 0, var 1; the pose head's
    weight 0 (the identity update, as the JAX RefinerNet starts)."""
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # the cut's variance restored
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
                if name == "pose_head":
                    m.weight.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return net.eval()
