"""AE network: ViT patch features, L2-normalized per patch (port of
gigapose_tpu/models/ae_net.py).

Runs the DINOv2 backbone, keeps the pre-norm tokens without CLS and
L2-normalizes them over channels. Feature layout (B, P, C) patch-major,
P = (H / 14) * (W / 14).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from gigapose_tpu_torch.models.vit import VIT_CONFIGS, ViT


class AENet(nn.Module):
    def __init__(self, model_name: str = "dinov2_vitl14", compute_dtype: Optional[str] = None,
                 remat: Union[bool, str] = False):
        super().__init__()
        self.model_name = model_name
        self.vit = ViT(dataclasses.replace(VIT_CONFIGS[model_name], compute_dtype=compute_dtype,
                                           remat=remat))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) preprocessed crops -> (B, P, C) L2-normalized features."""
        feats = self.vit(images)["x_prenorm"][:, 1:, :]
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True).clamp(min=1e-12)
