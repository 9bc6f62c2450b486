"""IST network: in-plane / scale regression from per-correspondence features
(port of gigapose_tpu/models/ist_net.py).

- backbone: bilinear resize of the 224 crop to `input_size` (align_corners),
  conv7x7/s2 + four stages of two BasicBlocks (dims 128/192/256/512, strides
  1/2/2/2) + a 1x1 out-conv -> stride-16 descriptors. NCHW inside; the output
  is flattened to (B, H*W, C), the order of the flax NHWC reshape.
- regressor: per correspondence, concat(query_feat, template_feat) -> two
  3-layer MLPs: scale (1-d) and cos/sin (2-d, tanh + L2 normalize).

BatchNorm normalizes by its running statistics in eval mode (eps 1e-5) and,
in training mode (`module.train()`), as flax's train-mode BatchNorm does:
by the batch's biased variance E[x^2] - E[x]^2 in f32, with the running
statistics moved to it at momentum 0.9 (flax's convention; torch's
nn.BatchNorm2d would store the unbiased variance). Module names
follow the original GigaPose ResNet / Regressor state dicts (conv1, bn1,
layerL.B.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}, layer4_outconv,
{scale,inplane}_predictor.{0,2,4}), which models/convert.py fills.

The optional SpatialTransformer stages are off in the shipped configuration
and not ported yet (ROADMAP A5): num_attn_heads > 0 raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gigapose_tpu_torch.ops.gather import gather_patches


def resize_bilinear_align_corners(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True, in the reference's
    gather-and-lerp form (so both packages round alike)."""
    B, C, H, W = x.shape
    oh, ow = size
    ys = torch.linspace(0.0, H - 1.0, oh, device=x.device)
    xs = torch.linspace(0.0, W - 1.0, ow, device=x.device)
    y0 = torch.floor(ys).to(torch.int64).clamp(0, H - 2)
    x0 = torch.floor(xs).to(torch.int64).clamp(0, W - 2)
    wy = (ys - y0)[None, None, :, None]
    wx = (xs - x0)[None, None, None, :]
    g = lambda yi, xi: x[:, :, yi][:, :, :, xi]
    top = g(y0, x0) * (1 - wx) + g(y0, x0 + 1) * wx
    bot = g(y0 + 1, x0) * (1 - wx) + g(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """layer(x) with input and weights cast to `dtype` (None: as stored)."""
    if dtype is None:
        return layer(x)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), None, layer.stride, layer.padding)


# flax BatchNorm's momentum: running = momentum * running + (1 - momentum) * batch
BN_MOMENTUM = 0.9


def batch_norm(layer: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in f32: on the running statistics in eval mode; in training
    mode on the batch's statistics as flax computes them (mean and E[x^2] -
    mean^2 over N, H, W, floored at 0), moving the running statistics to
    them at BN_MOMENTUM."""
    x = x.to(torch.float32)
    if not layer.training:
        return F.batch_norm(x, layer.running_mean, layer.running_var, layer.weight, layer.bias,
                            False, 0.0, layer.eps)
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        layer.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        layer.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + layer.eps) * layer.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + layer.bias[:, None, None]


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes, eps=1e-5),
            )

    def forward(self, x):
        y = F.relu(batch_norm(self.bn1, conv(self.conv1, x, self.dtype)))
        y = batch_norm(self.bn2, conv(self.conv2, y, self.dtype))
        if self.downsample is not None:
            x = batch_norm(self.downsample[1], conv(self.downsample[0], x, self.dtype))
        return F.relu(x + y)


class ISTBackbone(nn.Module):
    """(B, 3, 224, 224) -> (B, P, C) stride-16 descriptor grid (f32)."""

    def __init__(
        self,
        initial_dim: int = 128,
        block_dims: Sequence[int] = (128, 192, 256, 512),
        descriptor_size: int = 256,
        input_size: int = 256,
        num_attn_heads: int = 0,
        compute_dtype: Optional[str] = None,
    ):
        super().__init__()
        if num_attn_heads > 0:
            raise NotImplementedError(
                "the IST SpatialTransformer stages are not ported yet (ROADMAP A5); "
                "the shipped configuration has num_attn_heads=0"
            )
        self.input_size = input_size
        self.dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.conv1 = nn.Conv2d(3, initial_dim, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(initial_dim, eps=1e-5)
        in_planes = initial_dim
        for i, (dim, stride) in enumerate(zip(block_dims, (1, 2, 2, 2))):
            layer = nn.Sequential(
                BasicBlock(in_planes, dim, stride, self.dtype),
                BasicBlock(dim, dim, 1, self.dtype),
            )
            setattr(self, f"layer{i + 1}", layer)
            in_planes = dim
        self.layer4_outconv = nn.Conv2d(in_planes, descriptor_size, 1, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear_align_corners(images, (self.input_size, self.input_size))
        x = F.relu(batch_norm(self.bn1, conv(self.conv1, x, self.dtype)))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        x = conv(self.layer4_outconv, x, self.dtype)
        return x.flatten(2).transpose(1, 2).to(torch.float32)  # (B, H*W, C)


def _mlp(in_dim: int, hidden: int, out_dim: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Linear(in_dim, hidden * 2), nn.ReLU(),
        nn.Linear(hidden * 2, hidden), nn.ReLU(),
        nn.Linear(hidden, out_dim),
    )


class Regressor(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 256, use_tanh: bool = True,
                 normalize_output: bool = True):
        super().__init__()
        self.use_tanh = use_tanh
        self.normalize_output = normalize_output
        self.scale_predictor = _mlp(in_dim, hidden_dim, 1)
        self.inplane_predictor = _mlp(in_dim, hidden_dim, 2)

    def forward(self, pair_feats: torch.Tensor):
        """(..., 2C) concat(tar, src) -> (scale (...,), cossin (..., 2)), in f32."""
        x = pair_feats.to(torch.float32)
        scale = self.scale_predictor(x)[..., 0]
        cossin = self.inplane_predictor(x)
        if self.use_tanh:
            cossin = torch.tanh(cossin)
        if self.normalize_output:
            norm = torch.linalg.vector_norm(cossin, dim=-1, keepdim=True)
            cossin = cossin / norm.clamp(min=1e-8)
        return scale, cossin


@dataclasses.dataclass
class ISTResult:
    scale: torch.Tensor  # (..., N)
    cossin: torch.Tensor  # (..., N, 2)
    valid: torch.Tensor  # (..., N) bool


class ISTNet(nn.Module):
    def __init__(self, backbone: ISTBackbone, regressor: Regressor):
        super().__init__()
        self.backbone = backbone
        self.regressor = regressor

    def features(self, images: torch.Tensor) -> torch.Tensor:
        return self.backbone(images)

    def forward(self, src_img, tar_img, src_pts, tar_pts) -> ISTResult:
        """End to end: the shared backbone on src, then on tar (two calls, so
        in training mode the running statistics move twice, src first), then
        the per-correspondence regression."""
        return self.regress(self.backbone(src_img), self.backbone(tar_img), src_pts, tar_pts)

    def regress(self, src_feat, tar_feat, src_pts, tar_pts) -> ISTResult:
        """src_feat / tar_feat (B, P, C) feature grids, src_pts / tar_pts
        (B, N, 2) patch coords with (-1, -1) invalid -> per-correspondence
        ISTResult (B, N)."""
        src_g, src_v = gather_patches(src_feat, src_pts)
        tar_g, tar_v = gather_patches(tar_feat, tar_pts)
        scale, cossin = self.regressor(torch.cat([tar_g, src_g], dim=-1))
        return ISTResult(scale=scale, cossin=cossin, valid=src_v & tar_v)


def fill_invalid(result: ISTResult, fill: float = -1000.0):
    """Host-parity view with the original's -1000 sentinel."""
    scale = torch.where(result.valid, result.scale, torch.full_like(result.scale, fill))
    cossin = torch.where(result.valid[..., None], result.cossin,
                         torch.full_like(result.cossin, fill))
    return scale, cossin


def default_ist_net(descriptor_size: int = 256, num_attn_heads: int = 0,
                    compute_dtype: Optional[str] = None) -> ISTNet:
    return ISTNet(
        backbone=ISTBackbone(descriptor_size=descriptor_size,
                             num_attn_heads=num_attn_heads, compute_dtype=compute_dtype),
        regressor=Regressor(2 * descriptor_size, hidden_dim=descriptor_size),
    )
