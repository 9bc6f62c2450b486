"""Int8 (W8A8) serving forward of the DINOv2 ViT backbone (port of
gigapose_tpu/models/vit_int8.py).

A functional twin of models/vit.ViT.forward that runs every block through
the int8 kernels of ops/qmm.py: `qmm_attn_block` (LN -> qkv -> attention ->
proj -> residual) and `qmm_mlp` (LN -> fc1 -> tanh-GELU -> fc2 -> residual),
once each per block. The patch embed is an f32 matmul, the final LayerNorm
plain f32. Weights are quantized once from the float module
(`prepare_int8_params`); activations get dynamic per-token scales inside the
kernels. Inference only.

Parameter tree: the JAX package's, key for key (embed_kernel (3*14*14, C),
embed_bias / norm_g / norm_b (1, C), cls, pos, [reg], blocks[i] with n1g,
n1b, qkv_wq/ws/b, proj_wq/ws/b, ls1, n2g, n2b, fc1_wq/ws/b, fc2_wq/ws/b,
ls2). Each `*_wq` is (K, N) int8 as there, stored K-contiguous for the GEMM
(ops/qmm.py); models/convert.int8_params_flax_to_torch carries the JAX tree
across.

Tokens are not padded: the port's kernels mask their own ragged edges (the
GEMM's row and column tiles, the attention's 64-query and 64-key tiles), so
the TPU's B*Np % 128 rule has no counterpart, Np = N and the key bias is 0.
"""

from __future__ import annotations

import torch
from torch import nn

from gigapose_tpu_torch.models.vit import ViTConfig, add_tokens
from gigapose_tpu_torch.ops import qmm as Q


def prepare_int8_params(model: nn.Module) -> dict:
    """Port ViT, or AENet (backbone under .vit) -> int8 serving param tree,
    on the module's device."""
    vit = getattr(model, "vit", model)
    cfg = vit.cfg
    if cfg.ffn_layer != "mlp":
        raise NotImplementedError("int8 serving path supports the GELU-MLP configs "
                                  "(vits/b/l); vitg uses SwiGLU")
    C = cfg.embed_dim

    def f32(t):
        return t.detach().to(torch.float32)

    def row(t):
        return f32(t).reshape(1, -1)

    def dense(lin: nn.Linear):
        wq, ws = Q.quantize_weight(f32(lin.weight).t())  # Linear (N, K) -> (K, N)
        return wq, ws, row(lin.bias)

    with torch.no_grad():
        out = {
            # OIHW -> HWIO -> (14*14*3, C), the JAX patch order (h, w, channel)
            "embed_kernel": f32(vit.patch_embed.proj.weight).permute(2, 3, 1, 0)
            .reshape(-1, C).contiguous(),
            "embed_bias": row(vit.patch_embed.proj.bias),
            "cls": f32(vit.cls_token),
            "pos": f32(vit.pos_embed),
            "norm_g": row(vit.norm.weight),
            "norm_b": row(vit.norm.bias),
            "blocks": [],
        }
        if cfg.num_register_tokens:
            out["reg"] = f32(vit.register_tokens)
        for blk in vit.blocks:
            qkv, proj = dense(blk.attn.qkv), dense(blk.attn.proj)
            fc1, fc2 = dense(blk.mlp.fc1), dense(blk.mlp.fc2)
            out["blocks"].append({
                "n1g": row(blk.norm1.weight), "n1b": row(blk.norm1.bias),
                "qkv_wq": qkv[0], "qkv_ws": qkv[1], "qkv_b": qkv[2],
                "proj_wq": proj[0], "proj_ws": proj[1], "proj_b": proj[2],
                "ls1": row(blk.ls1.gamma),
                "n2g": row(blk.norm2.weight), "n2b": row(blk.norm2.bias),
                "fc1_wq": fc1[0], "fc1_ws": fc1[1], "fc1_b": fc1[2],
                "fc2_wq": fc2[0], "fc2_ws": fc2[1], "fc2_b": fc2[2],
                "ls2": row(blk.ls2.gamma),
            })
    return out


def vit_forward_int8(
    qp: dict,
    images: torch.Tensor,
    cfg: ViTConfig,
    pos_embed_size: int = 16,
) -> dict:
    """(B, 3, H, W) -> {"x_prenorm", "x_norm"}, as models/vit.ViT.forward
    (CLS first, registers dropped). CUDA tensors run the kernels, CPU tensors
    their plain versions."""
    B, _, H, W = images.shape
    ps = cfg.patch_size
    gh, gw = H // ps, W // ps
    C = cfg.embed_dim

    # patch embed as one f32 matmul: a stride == kernel conv is patch extraction
    x = images.to(torch.float32).permute(0, 2, 3, 1)  # NHWC
    x = x.reshape(B, gh, ps, gw, ps, 3).permute(0, 1, 3, 2, 4, 5)
    x = torch.matmul(x.reshape(B, gh * gw, ps * ps * 3), qp["embed_kernel"]) + qp["embed_bias"]
    x = add_tokens(x, qp["cls"], qp["pos"], qp.get("reg"), pos_embed_size, gh, gw)

    N = x.shape[1]
    key_bias = x.new_zeros((1, N))
    x2 = x.reshape(B * N, C).contiguous()
    for b in qp["blocks"]:
        x2 = Q.qmm_attn_block(
            x2, b["qkv_wq"], b["qkv_ws"], b["qkv_b"],
            b["proj_wq"], b["proj_ws"], b["proj_b"],
            b["n1g"], b["n1b"], b["ls1"], key_bias,
            batch=B, num_heads=cfg.num_heads,
        )
        x2 = Q.qmm_mlp(x2, b["fc1_wq"], b["fc1_ws"], b["fc1_b"],
                       b["fc2_wq"], b["fc2_ws"], b["fc2_b"],
                       b["n2g"], b["n2b"], b["ls2"])
    x_prenorm = x2.reshape(B, N, C)
    x_norm = Q._ln(x_prenorm, qp["norm_g"], qp["norm_b"])
    if cfg.num_register_tokens:
        r = cfg.num_register_tokens
        keep = lambda t: torch.cat([t[:, :1], t[:, 1 + r:]], dim=1)
        return {"x_prenorm": keep(x_prenorm), "x_norm": keep(x_norm)}
    return {"x_prenorm": x_prenorm, "x_norm": x_norm}


def ae_forward_int8(qp: dict, images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """The AENet contract on the int8 path: (B, 3, H, W) -> (B, P, C)
    L2-normalized pre-norm patch features."""
    feats = vit_forward_int8(qp, images, cfg)["x_prenorm"][:, 1:, :]
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True).clamp(min=1e-12)


class _Buffers(nn.Module):
    """One flat dict of tensors as buffers (int8 weights keep their layout)."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t)

    def tree(self) -> dict:
        return dict(self.named_buffers(recurse=False))


class AENetInt8(nn.Module):
    """Drop-in for AENet running the int8 serving path, its weights as
    buffers. Built from a float AENet:

        q = AENetInt8.from_ae_net(ae_net)
        feats = q(crops)  # (B, P, C), as ae_net(crops)
    """

    def __init__(self, cfg: ViTConfig, qparams: dict):
        super().__init__()
        self.cfg = cfg
        self.top = _Buffers({k: v for k, v in qparams.items() if k != "blocks"})
        self.blocks = nn.ModuleList(_Buffers(b) for b in qparams["blocks"])

    @classmethod
    def from_ae_net(cls, ae_net: nn.Module) -> "AENetInt8":
        return cls(ae_net.vit.cfg, prepare_int8_params(ae_net))

    @property
    def params(self) -> dict:
        return dict(self.top.tree(), blocks=[b.tree() for b in self.blocks])

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return ae_forward_int8(self.params, images, self.cfg)

