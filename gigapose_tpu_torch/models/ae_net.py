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
    """`tp` (parallel/tp.TPGroups, JAX's tp_mesh): the ViT's Megatron shard
    on this rank (models/vit.py), and the batch split over the dp group
    where dp divides it, the whole batch's features gathered back on every
    rank. None: one device, as before."""

    def __init__(self, model_name: str = "dinov2_vitl14", compute_dtype: Optional[str] = None,
                 remat: Union[bool, str] = False, tp=None):
        super().__init__()
        self.model_name = model_name
        self.tp = tp
        self.vit = ViT(dataclasses.replace(VIT_CONFIGS[model_name], compute_dtype=compute_dtype,
                                           remat=remat), tp=tp)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        feats = self.vit(images)["x_prenorm"][:, 1:, :]
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True).clamp(min=1e-12)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) preprocessed crops -> (B, P, C) L2-normalized features."""
        rows = None if self.tp is None else self.tp.split_rows(images)
        if rows is None:
            return self.features(images)
        return self.tp.gather_rows(self.features(rows))
