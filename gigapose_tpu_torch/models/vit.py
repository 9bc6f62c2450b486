"""DINOv2-style ViT as an nn.Module (port of gigapose_tpu/models/vit.py).

- patch embed: 14x14 conv, stride 14 (224 -> 16x16 tokens + CLS);
- pre-norm blocks with LayerScale on both branches, LayerNorm eps 1e-6;
- erf GELU MLP (vits/b/l) or SwiGLU (vitg);
- `x_prenorm`: token states after the last block, before the final LayerNorm.

Parameter names follow the facebookresearch/dinov2 state dict (blocks.N.attn.qkv,
patch_embed.proj, ...), so models/convert.py maps the flax tree onto them 1:1.

Mixed precision as in the reference: with compute_dtype "bfloat16" every
matmul (patch embed, qkv, attention, proj, MLP) runs in bf16 with weights
stored f32 and cast at use, while LayerNorm, softmax, LayerScale and the
residual stream stay f32. Attention is the plain softmax(QK^T)V form of the
reference, with the same cast points.

The forward runs under autograd (training): no in-place write touches a
tensor that needs a gradient. `ViTConfig.remat` takes what the JAX package's
takes: False, True (each block checkpointed while gradients are on:
torch.utils.checkpoint, use_reentrant=False, the block's activations
recomputed in the backward pass, with the same gradients) or the name of a
jax.checkpoint_policies entry, mapped onto selective checkpointing
(`REMAT_POLICIES`): nothing_saveable is True; everything_saveable saves
every output; dots_saveable and checkpoint_dots save the matmul outputs (mm,
bmm, addmm) and recompute the rest; dots_with_no_batch_dims_saveable saves
mm and addmm but not the batched bmm. Any other name raises.

`tp` (parallel/tp.TPGroups, the JAX ViTConfig's tp_mesh): Attention, Mlp
and SwiGLU hold this rank's Megatron shard (load parallel/tp.shard_vit_tp's
state dict) and sum their row-split product over the mp group; the
attention stays whole where mp does not divide the heads. Inference only.
None (the default) is the forward above, unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from gigapose_tpu_torch.parallel.tp import heads_split, local_width, row_parallel

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.bmm.default, _aten.addmm.default)
# jax.checkpoint_policies names -> the aten ops whose outputs are saved
# (None: every op's); nothing_saveable saves nothing (a full checkpoint)
REMAT_POLICIES = {
    "nothing_saveable": (),
    "everything_saveable": None,
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": (_aten.mm.default, _aten.addmm.default),
}


def checkpoint_kwargs(remat) -> dict:
    """torch.utils.checkpoint's keyword arguments for a remat setting (True
    or a policy name): a full checkpoint, or a selective one that saves the
    policy's ops."""
    saved = () if remat is True else REMAT_POLICIES[remat]
    if saved == ():
        return {}

    def policy(ctx, op, *args, **kwargs):
        keep = saved is None or op in saved
        return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE

    return {"context_fn": lambda: create_selective_checkpoint_contexts(policy)}


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 14
    mlp_ratio: float = 4.0
    ffn_layer: str = "mlp"  # "mlp" | "swiglu"
    layerscale_init: float = 1e-5
    num_register_tokens: int = 0
    compute_dtype: Optional[str] = None  # None (f32) | "bfloat16"
    # False | True (checkpoint each block in training) | a REMAT_POLICIES name
    remat: Union[bool, str] = False

    def __post_init__(self):
        if not isinstance(self.remat, bool) and self.remat not in REMAT_POLICIES:
            raise ValueError(f"remat={self.remat!r}: false, true or one of the "
                             f"jax.checkpoint_policies names {', '.join(REMAT_POLICIES)}")

    @property
    def matmul_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None


VIT_CONFIGS = {
    "dinov2_vits14": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "dinov2_vitb14": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "dinov2_vitl14": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
    "dinov2_vitg14": ViTConfig(
        embed_dim=1536, depth=40, num_heads=24, mlp_ratio=8 / 3, ffn_layer="swiglu"
    ),
    # small configs for CPU tests (not reference models)
    "vit_tiny_test": ViTConfig(embed_dim=64, depth=2, num_heads=2),
    "vit_deep_test": ViTConfig(embed_dim=256, depth=6, num_heads=4),
    "vit_tiny_swiglu_test": ViTConfig(
        embed_dim=64, depth=2, num_heads=2, mlp_ratio=8 / 3, ffn_layer="swiglu"
    ),
}


def linear(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """layer(x) with input and weights cast to `dtype` (None: as stored)."""
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x):
        return x * self.gamma  # a bf16 x promotes to f32 here, as in flax


def _out(layer: nn.Linear, x, dtype, tp):
    """The product of a layer that tensor parallelism splits by its input
    columns: plain, or parallel/tp.row_parallel's sum over the mp group."""
    return linear(layer, x, dtype) if tp is None else row_parallel(layer, x, dtype, tp)


class Attention(nn.Module):
    """With `tp` (parallel/tp.TPGroups) whose mp divides the heads: this
    rank's heads of q, k and v, and proj's matching input columns."""

    def __init__(self, dim: int, num_heads: int, dtype=None, tp=None):
        super().__init__()
        self.tp = tp if tp is not None and heads_split(num_heads, tp.mp) else None
        mp = 1 if self.tp is None else tp.mp
        self.num_heads, self.local_heads = num_heads, num_heads // mp
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim // mp)
        self.proj = nn.Linear(dim // mp, dim)

    def forward(self, x):
        B, N, C = x.shape
        H = self.local_heads
        hd = C // self.num_heads
        qkv = linear(self.qkv, x, self.dtype).reshape(B, N, 3, H, hd)
        q, k, v = qkv.unbind(dim=2)  # (B, N, H, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q * hd**-0.5, k)
        attn = torch.softmax(attn.to(torch.float32), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, H * hd)
        return _out(self.proj, out, self.dtype, self.tp)


class Mlp(nn.Module):
    """With `tp`: this rank's fc1 rows and fc2 input columns."""

    def __init__(self, dim: int, hidden: int, dtype=None, tp=None):
        super().__init__()
        self.dtype, self.tp = dtype, tp
        h = hidden if tp is None else local_width(hidden, tp.mp, "MLP hidden")
        self.fc1 = nn.Linear(dim, h)
        self.fc2 = nn.Linear(h, dim)

    def forward(self, x):
        # erf GELU (flax nn.gelu(approximate=False)); tanh-GELU belongs only
        # to the int8 kernels of the reference
        return _out(self.fc2, F.gelu(linear(self.fc1, x, self.dtype)), self.dtype, self.tp)


class SwiGLU(nn.Module):
    """DINOv2-giant FFN: SwiGLU with a fused w12 projection. With `tp`: this
    rank's rows of both halves of w12 and w3's matching input columns."""

    def __init__(self, dim: int, hidden: int, dtype=None, tp=None):
        super().__init__()
        self.dtype, self.tp = dtype, tp
        h = hidden if tp is None else local_width(hidden, tp.mp, "SwiGLU hidden")
        self.w12 = nn.Linear(dim, 2 * h)
        self.w3 = nn.Linear(h, dim)

    def forward(self, x):
        x1, x2 = linear(self.w12, x, self.dtype).chunk(2, dim=-1)
        return _out(self.w3, F.silu(x1) * x2, self.dtype, self.tp)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, tp=None):
        super().__init__()
        dt = cfg.matmul_dtype
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=1e-6)
        self.attn = Attention(cfg.embed_dim, cfg.num_heads, dtype=dt, tp=tp)
        self.ls1 = LayerScale(cfg.embed_dim, cfg.layerscale_init)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=1e-6)
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        if cfg.ffn_layer == "swiglu":
            hidden = (int(hidden * 2 / 3) + 7) // 8 * 8  # dinov2's rounding
            self.mlp = SwiGLU(cfg.embed_dim, hidden, dtype=dt, tp=tp)
        else:
            self.mlp = Mlp(cfg.embed_dim, hidden, dtype=dt, tp=tp)
        self.ls2 = LayerScale(cfg.embed_dim, cfg.layerscale_init)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


def add_tokens(x, cls_token, pos_embed, register_tokens, pos_embed_size, gh, gw):
    """(B, gh*gw, C) patch embeddings -> (B, 1 [+ R] + gh*gw, C): position
    embedding (resized when the grid is not pos_embed_size^2), CLS token
    first, then the register tokens if any."""
    B, _, C = x.shape
    pos_cls, pos_patch = pos_embed[:, :1], pos_embed[:, 1:]
    if (gh, gw) != (pos_embed_size, pos_embed_size):
        # antialiased bicubic == jax.image.resize(..., "bicubic")
        s = pos_embed_size
        p = pos_patch.reshape(1, s, s, C).permute(0, 3, 1, 2)
        p = F.interpolate(p, size=(gh, gw), mode="bicubic", align_corners=False,
                          antialias=True)
        pos_patch = p.permute(0, 2, 3, 1).reshape(1, gh * gw, C)
    x = torch.cat([(cls_token + pos_cls).expand(B, 1, C), x + pos_patch], dim=1)
    if register_tokens is not None:
        reg = register_tokens.expand(B, register_tokens.shape[1], C)
        x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
    return x


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)


class ViT(nn.Module):
    """(B, 3, H, W), H and W multiples of patch_size -> dict(x_prenorm, x_norm),
    each (B, 1 + P, C) with tokens [cls, patches]."""

    def __init__(self, cfg: ViTConfig, pos_embed_size: int = 16, tp=None):
        super().__init__()
        self.cfg = cfg
        self.pos_embed_size = pos_embed_size
        C = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_embed_size**2, C))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, C))
        self.blocks = nn.ModuleList(Block(cfg, tp) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(C, eps=1e-6)

    def forward(self, images: torch.Tensor) -> dict:
        c = self.cfg
        B, _, H, W = images.shape
        gh, gw = H // c.patch_size, W // c.patch_size
        conv = self.patch_embed.proj
        dt = c.matmul_dtype
        if dt is None:
            x = conv(images)
        else:
            x = F.conv2d(images.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                         stride=conv.stride)
        x = x.to(torch.float32).flatten(2).transpose(1, 2)  # (B, gh*gw, C)

        reg = self.register_tokens if c.num_register_tokens else None
        x = add_tokens(x, self.cls_token, self.pos_embed, reg, self.pos_embed_size, gh, gw)
        remat = c.remat and torch.is_grad_enabled()
        kw = checkpoint_kwargs(c.remat) if remat else {}
        for blk in self.blocks:
            x = checkpoint(blk, x, use_reentrant=False, **kw) if remat else blk(x)
        x_prenorm = x.to(torch.float32)
        x_norm = self.norm(x_prenorm)
        if c.num_register_tokens:
            keep = lambda t: torch.cat([t[:, :1], t[:, 1 + c.num_register_tokens:]], dim=1)
            return {"x_prenorm": keep(x_prenorm), "x_norm": keep(x_norm)}
        return {"x_prenorm": x_prenorm, "x_norm": x_norm}
