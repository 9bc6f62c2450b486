"""The released MegaPose networks (port of gigapose_tpu/refiner/megapose_net.py), NCHW.

The released checkpoints (refiner-rgb-653307694, coarse-rgb-906902141) use
a pre-activation WideResNet backbone: a 5x5/2 stem convolution with padding
2, BatchNorm, ReLU and a 3x3/2 max-pool padded with -inf, then stages of
BasicBlockV2 ([3, 4, 6, 3] for WideResNet-34, [2, 2, 2, 2] for -18) whose
downsample is a bare 1x1 convolution of relu(bn1(x)). The feature map's
spatial mean feeds a linear head: `pose_fc` (9: ortho6d rotation and
vx, vy, vz) for the refiner, `views_logits_head` (one logit per rendered
view) for the coarse model. `VanillaResNet34` is torchvision's resnet34
with a configurable input width and an fc to n_features.

Module names are those of the reference's torch modules, so a released
state dict loads by name (`backbone.layer2.0.downsample.weight`,
`pose_fc.weight`, ...); the JAX package's converters read exactly these
keys. BatchNorm runs in eval mode with eps 1e-5. Run the nets in f32 with
TF32 off (refiner/refiner.py:no_tf32), as the JAX package runs them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

CONFIG = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, 1, bias=False)


class BasicBlockV2(nn.Module):
    """Pre-activation residual block (He et al. 2016, identity mappings)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.bn1 = _bn(inplanes)
        self.conv1 = _conv3x3(inplanes, planes, stride)
        self.bn2 = _bn(planes)
        self.conv2 = _conv3x3(planes, planes)
        self.downsample = nn.Conv2d(inplanes, planes, 1, stride, bias=False) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = F.relu(self.bn1(x))
        out = self.conv2(F.relu(self.bn2(self.conv1(pre))))
        return out + (self.downsample(pre) if self.downsample is not None else x)


class MegaposeWideResNet(nn.Module):
    """(B, n_inputs, H, W) -> the pooled (B, 512 * width) features, or with
    pool=False the (B, C, h, w) feature map (the reference's WideResNet)."""

    def __init__(self, layers: Sequence[int] = CONFIG[34], width: float = 1.0,
                 n_inputs: int = 9, pool: bool = True):
        super().__init__()
        dims = [int(v * width) for v in (64, 128, 256, 512)]
        self.pool = pool
        self.conv1 = nn.Conv2d(n_inputs, dims[0], 5, 2, 2, bias=False)
        self.bn1 = _bn(dims[0])
        inplanes = dims[0]
        for li, (planes, n_blocks) in enumerate(zip(dims, layers), start=1):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (li > 1 and bi == 0) else 1
                blocks.append(BasicBlockV2(inplanes, planes, stride,
                                           downsample=stride != 1 or inplanes != planes))
                inplanes = planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.n_layers = len(layers)
        self.out_dim = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)  # implicit -inf padding
        for li in range(1, self.n_layers + 1):
            x = getattr(self, f"layer{li}")(x)
        return x.mean(dim=(2, 3)) if self.pool else x


class MegaposePoseHeadNet(nn.Module):
    """Backbone + the 9-d pose head (head="pose", the refiner) or one logit
    per rendered view (head="renderings_logits", the coarse model)."""

    def __init__(self, layers: Sequence[int] = CONFIG[34], width: float = 1.0,
                 head: str = "pose", n_rendered_views: int = 1, n_inputs: int = 9):
        super().__init__()
        self.backbone = MegaposeWideResNet(layers, width, n_inputs)
        self.head = head
        if head == "pose":
            self.pose_fc = nn.Linear(self.backbone.out_dim, 9)
        elif head == "renderings_logits":
            self.views_logits_head = nn.Linear(self.backbone.out_dim, n_rendered_views)
        else:
            raise ValueError(f"head must be pose or renderings_logits, not {head!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head = self.pose_fc if self.head == "pose" else self.views_logits_head
        return head(self.backbone(x))


class TorchvisionBasicBlock(nn.Module):
    """Post-activation BasicBlock (torchvision): conv-bn-relu-conv-bn, plus
    an optional conv-bn downsample, then relu."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv3x3(inplanes, planes, stride)
        self.bn1 = _bn(planes)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = _bn(planes)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                                         _bn(planes)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu((self.downsample(x) if self.downsample is not None else x) + y)


class VanillaResNet34(nn.Module):
    """torchvision's resnet34 with `n_inputs` input channels and an fc to
    n_features: the reference's 'vanilla_resnet34' backbone option."""

    def __init__(self, layers: Sequence[int] = CONFIG[34], n_features: int = 512,
                 n_inputs: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(n_inputs, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        inplanes = 64
        for li, n_blocks in enumerate(layers, start=1):
            planes = 64 * 2 ** (li - 1)
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (li > 1 and bi == 0) else 1
                blocks.append(TorchvisionBasicBlock(inplanes, planes, stride,
                                                    downsample=stride != 1 or inplanes != planes))
                inplanes = planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.n_layers = len(layers)
        self.fc = nn.Linear(inplanes, n_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for li in range(1, self.n_layers + 1):
            x = getattr(self, f"layer{li}")(x)
        return self.fc(x.mean(dim=(2, 3)))
