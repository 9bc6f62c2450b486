"""Plain float reference of the two nets GigaPose serves, written from the
published descriptions, with the parameter names of the public state dicts
(facebookresearch/dinov2 for the ViT, the GigaPose ResNet / Regressor for
the IST), so that one set of weights drawn by the benchmark loads into both
this reference and the program under test.

- ViT (DINOv2, arXiv 2304.07193): 14 x 14 patch conv, CLS + position
  embedding, pre-norm blocks (LayerNorm eps 1e-6, multi-head softmax
  attention, erf-GELU MLP), LayerScale on both branches. The AE feature is
  the pre-norm token state of the patches, L2-normalised per patch.
- IST (GigaPose, arXiv 2311.14155): bilinear resize to 256 (align corners),
  conv 7 x 7 / 2, four stages of two BasicBlocks (128 / 192 / 256 / 512,
  strides 1 / 2 / 2 / 2), a 1 x 1 out-conv to the descriptor; BatchNorm on
  its running statistics (eval). The regressor concatenates (query,
  template) patch descriptors into two 3-layer MLPs: scale, and
  tanh-then-normalised (cos, sin).

Everything is float32 (or float64 where the caller casts), no fused kernel,
no cache, no batching trick. `quant` (a callable or None) is applied to the
inputs and weights of every matmul and convolution: the lower-precision
control of `benchmark/reference/quant.py` uses it; None is the reference.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Quant = Optional[Callable[[torch.Tensor, str], torch.Tensor]]


def _q(quant: Quant, t: torch.Tensor, role: str) -> torch.Tensor:
    return t if quant is None else quant(t, role)


def qlinear(layer: nn.Linear, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return F.linear(_q(quant, x, "act"), _q(quant, layer.weight, "weight"), layer.bias)


def qconv(layer: nn.Conv2d, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return F.conv2d(_q(quant, x, "act_nchw"), _q(quant, layer.weight, "weight"), layer.bias,
                    layer.stride, layer.padding)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, hidden)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor, quant: Quant) -> torch.Tensor:
        B, N, C = x.shape
        H = self.attn.heads
        qkv = qlinear(self.attn.qkv, self.norm1(x), quant).reshape(B, N, 3, H, C // H)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # (B, H, N, hd)
        att = torch.softmax((q * (C // H) ** -0.5) @ k.transpose(-1, -2), dim=-1)
        o = (att @ v).transpose(1, 2).reshape(B, N, C)
        x = x + self.ls1.gamma * qlinear(self.attn.proj, o, quant)
        h = F.gelu(qlinear(self.mlp.fc1, self.norm2(x), quant))
        return x + self.ls2.gamma * qlinear(self.mlp.fc2, h, quant)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class ViT(nn.Module):
    """(B, 3, 224, 224) CLIP-normalised crops -> (B, P, C) unit patch features."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int, mlp_hidden: int,
                 patch_size: int, grid: int):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_hidden) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def features(self, images: torch.Tensor, quant: Quant = None) -> torch.Tensor:
        x = self.patch_embed.proj(images).flatten(2).transpose(1, 2)  # (B, P, C)
        B, _, C = x.shape
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(B, 1, C)
        x = torch.cat([cls, x + self.pos_embed[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x, quant)
        f = x[:, 1:]
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(min=1e-12)


def _bn(layer: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, layer.running_mean, layer.running_var, layer.weight, layer.bias,
                        False, 0.0, layer.eps)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=1e-5)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout, eps=1e-5))

    def forward(self, x: torch.Tensor, quant: Quant) -> torch.Tensor:
        y = F.relu(_bn(self.bn1, qconv(self.conv1, x, quant)))
        y = _bn(self.bn2, qconv(self.conv2, y, quant))
        if self.downsample is not None:
            x = _bn(self.downsample[1], qconv(self.downsample[0], x, quant))
        return F.relu(x + y)


def resize_align_corners(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize with align_corners, as gather and lerp at the sample
    points linspace(0, H - 1, size)."""
    B, C, H, W = x.shape
    ys = torch.linspace(0.0, H - 1.0, size, device=x.device, dtype=x.dtype)
    xs = torch.linspace(0.0, W - 1.0, size, device=x.device, dtype=x.dtype)
    y0 = torch.floor(ys).long().clamp(0, H - 2)
    x0 = torch.floor(xs).long().clamp(0, W - 2)
    wy = (ys - y0)[None, None, :, None]
    wx = (xs - x0)[None, None, None, :]
    g = lambda yi, xi: x[:, :, yi][:, :, :, xi]
    top = g(y0, x0) * (1 - wx) + g(y0, x0 + 1) * wx
    bot = g(y0 + 1, x0) * (1 - wx) + g(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


class ISTBackbone(nn.Module):
    def __init__(self, initial_dim: int, block_dims: Sequence[int], descriptor: int,
                 input_size: int):
        super().__init__()
        self.input_size = input_size
        self.conv1 = nn.Conv2d(3, initial_dim, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(initial_dim, eps=1e-5)
        cin = initial_dim
        for i, (dim, stride) in enumerate(zip(block_dims, (1, 2, 2, 2))):
            setattr(self, f"layer{i + 1}",
                    nn.Sequential(BasicBlock(cin, dim, stride), BasicBlock(dim, dim, 1)))
            cin = dim
        self.layer4_outconv = nn.Conv2d(cin, descriptor, 1, bias=False)

    def forward(self, images: torch.Tensor, quant: Quant = None) -> torch.Tensor:
        x = resize_align_corners(images, self.input_size)
        x = F.relu(_bn(self.bn1, qconv(self.conv1, x, quant)))
        for i in range(1, 5):
            for blk in getattr(self, f"layer{i}"):
                x = blk(x, quant)
        x = qconv(self.layer4_outconv, x, quant)
        return x.flatten(2).transpose(1, 2)  # (B, H*W, C)


def _mlp(cin: int, hidden: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(cin, 2 * hidden), nn.ReLU(), nn.Linear(2 * hidden, hidden),
                         nn.ReLU(), nn.Linear(hidden, cout))


class Regressor(nn.Module):
    def __init__(self, descriptor: int):
        super().__init__()
        self.scale_predictor = _mlp(2 * descriptor, descriptor, 1)
        self.inplane_predictor = _mlp(2 * descriptor, descriptor, 2)

    def forward(self, pair: torch.Tensor, quant: Quant = None):
        def run(seq, x):
            x = F.relu(qlinear(seq[0], x, quant))
            x = F.relu(qlinear(seq[2], x, quant))
            return qlinear(seq[4], x, quant)

        scale = run(self.scale_predictor, pair)[..., 0]
        cs = torch.tanh(run(self.inplane_predictor, pair))
        return scale, cs / torch.linalg.vector_norm(cs, dim=-1, keepdim=True).clamp(min=1e-8)


class IST(nn.Module):
    def __init__(self, initial_dim: int, block_dims: Sequence[int], descriptor: int,
                 input_size: int):
        super().__init__()
        self.backbone = ISTBackbone(initial_dim, block_dims, descriptor, input_size)
        self.regressor = Regressor(descriptor)


def build_nets(cfg: dict, device) -> tuple:
    """(ViT, IST) of a configuration file's `model` block, on `device`, in
    float32, eval mode, with the constructor's placeholder values (the
    benchmark draws the real ones: benchmark/weights.py)."""
    m = cfg["model"]
    with torch.device(device):
        vit = ViT(m["embed_dim"], m["depth"], m["num_heads"], m["mlp_hidden"],
                  m["patch_size"], m["crop_size"] // m["patch_size"])
        ist = IST(m["ist_initial_dim"], m["ist_block_dims"], m["ist_descriptor"],
                  m["ist_input_size"])
    return vit.eval(), ist.eval()
