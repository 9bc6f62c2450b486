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
nn.BatchNorm2d would store the unbiased variance; models/flax_bn.py).
`norm_dtype="bfloat16"` rounds every BatchNorm output to bf16 (the JAX
package's train-time memory knob): the residual stream is then bf16, and a
convolution without compute_dtype takes its bf16 input in f32. Module names
follow the original GigaPose ResNet / Regressor state dicts (conv1, bn1,
layerL.B.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}, layer4_outconv,
{scale,inplane}_predictor.{0,2,4}), which models/convert.py fills.

The optional SpatialTransformer stages (num_attn_heads > 0; off in the
shipped configuration) follow stages 2 and 4 as `attention1` / `attention2`:
GroupNorm (32 groups, else gcd(C, 32); eps 1e-6) -> 1x1 proj_in -> one
transformer block (LayerNorm eps 1e-6 -> self-attention, twice, then a
GEGLU feed-forward with the tanh GELU of jax.nn.gelu; logits in f32) ->
zero-initialized 1x1 proj_out -> residual, in f32. Their module names are
the reference's (norm, proj_in, transformer_blocks.0.{attn1,attn2}.{to_q,
to_k,to_v,to_out.0}, norm1-3, ff.net.0.proj, ff.net.2, proj_out).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gigapose_tpu_torch.models.flax_bn import batch_norm
from gigapose_tpu_torch.ops.gather import gather_patches


def linspace_points(size: int, n: int, device=None) -> torch.Tensor:
    """The n sample points of an align_corners resize over `size` pixels,
    as torch.linspace rounds them (the float IST's)."""
    return torch.linspace(0.0, size - 1.0, n, device=device)


def align_corners_points(size: int, n: int, device=None) -> torch.Tensor:
    """The same points as the JAX package's jnp.linspace(0, size - 1, n)
    gives them in f32: XLA folds its i * (1 / (n - 1)) * (size - 1) into
    i * c with the constant c = f32(f32(1 / (n - 1)) * (size - 1)), and the
    last point is size - 1. torch.linspace rounds most of them otherwise, an
    ulp that an int8 quantizer can turn into a whole step (models/ist_int8
    resizes at these)."""
    if n == 1:
        return torch.zeros(1, device=device)
    c = float(np.float32(np.float32(1.0) / np.float32(n - 1)) * np.float32(size - 1))
    pts = torch.arange(n - 1, dtype=torch.float32, device=device) * c
    return torch.cat([pts, torch.full((1,), float(size - 1), device=device)])


def resize_bilinear_align_corners(x: torch.Tensor, size: Tuple[int, int],
                                  points=linspace_points) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True, in the reference's
    gather-and-lerp form (so both packages round alike), at the sample
    points `points(size, n, device)` gives."""
    B, C, H, W = x.shape
    oh, ow = size
    ys = points(H, oh, x.device)
    xs = points(W, ow, x.device)
    y0 = torch.floor(ys).to(torch.int64).clamp(0, H - 2)
    x0 = torch.floor(xs).to(torch.int64).clamp(0, W - 2)
    wy = (ys - y0)[None, None, :, None]
    wx = (xs - x0)[None, None, None, :]
    g = lambda yi, xi: x[:, :, yi][:, :, :, xi]
    top = g(y0, x0) * (1 - wx) + g(y0, x0 + 1) * wx
    bot = g(y0 + 1, x0) * (1 - wx) + g(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """layer(x) with input and weights cast to `dtype` (None: in f32, a bf16
    input promoted as flax promotes it)."""
    if dtype is None:
        return layer(x.to(torch.float32))
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), None, layer.stride, layer.padding)


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1, dtype=None,
                 norm_dtype=None):
        super().__init__()
        self.dtype, self.norm_dtype = dtype, norm_dtype
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
        nd = self.norm_dtype
        y = F.relu(batch_norm(self.bn1, conv(self.conv1, x, self.dtype), nd))
        y = batch_norm(self.bn2, conv(self.conv2, y, self.dtype), nd)
        if self.downsample is not None:
            x = batch_norm(self.downsample[1], conv(self.downsample[0], x, self.dtype), nd)
        return F.relu(x + y)


class CrossAttention(nn.Module):
    """Multi-head attention; context None is self-attention. Logits and
    softmax in f32."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        # Dropout(0) keeps the reference's Sequential indices (to_out.0, ff.net.2)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        split = lambda t: t.reshape(t.shape[0], -1, self.num_heads, self.head_dim)
        q, k, v = split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx))
        sim = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * self.head_dim ** -0.5
        attn = torch.softmax(sim, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.to_out(o.reshape(o.shape[0], -1, self.num_heads * self.head_dim))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0), nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """norm -> self-attn -> norm -> attn over context (self without one) ->
    norm -> GEGLU feed-forward, each residual."""

    def __init__(self, dim: int, num_heads: int, head_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, num_heads, head_dim)
        self.attn2 = CrossAttention(dim, num_heads, head_dim)
        self.ff = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer blocks -> zero-initialized 1x1
    proj_out -> residual, on an NCHW map; tokens in the flax (H, W) order."""

    def __init__(self, dim: int, num_heads: int, depth: int = 1):
        super().__init__()
        hd = dim // num_heads
        inner = num_heads * hd
        groups = 32 if dim % 32 == 0 else math.gcd(dim, 32)
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = nn.Conv2d(dim, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, num_heads, hd) for _ in range(depth))
        self.proj_out = nn.Conv2d(inner, dim, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.flatten(2).transpose(1, 2)  # (B, H*W, inner)
        for blk in self.transformer_blocks:
            h = blk(h, context)
        h = h.transpose(1, 2).reshape(B, -1, H, W)
        return x + self.proj_out(h)


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
        norm_dtype: Optional[str] = None,
    ):
        super().__init__()
        self.input_size = input_size
        self.num_attn_heads = num_attn_heads
        self.dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.norm_dtype = torch.bfloat16 if norm_dtype == "bfloat16" else None
        self.conv1 = nn.Conv2d(3, initial_dim, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(initial_dim, eps=1e-5)
        in_planes = initial_dim
        for i, (dim, stride) in enumerate(zip(block_dims, (1, 2, 2, 2))):
            layer = nn.Sequential(
                BasicBlock(in_planes, dim, stride, self.dtype, self.norm_dtype),
                BasicBlock(dim, dim, 1, self.dtype, self.norm_dtype),
            )
            setattr(self, f"layer{i + 1}", layer)
            if num_attn_heads > 0 and i in (1, 3):
                setattr(self, f"attention{i // 2 + 1}", SpatialTransformer(dim, num_attn_heads))
            in_planes = dim
        self.layer4_outconv = nn.Conv2d(in_planes, descriptor_size, 1, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear_align_corners(images, (self.input_size, self.input_size))
        x = F.relu(batch_norm(self.bn1, conv(self.conv1, x, self.dtype), self.norm_dtype))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            if self.num_attn_heads > 0 and i in (2, 4):
                x = getattr(self, f"attention{i // 2}")(x.to(torch.float32))
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
