"""Masked patch gathers (port of gigapose_tpu/ops/gather.py).

Fixed-shape: invalid points read patch 0 and are flagged in the returned mask,
which the consumer applies. The JAX package's one-hot matmul variant is a TPU
device trick (gathers lower to slow loops there); on the GPU this plain gather
is the direct form.
"""

from __future__ import annotations

from typing import Tuple

import torch


def patch_index_to_location(index: torch.Tensor, num_patches: int) -> torch.Tensor:
    """Flat patch index (...,) -> (..., 2) [x, y] grid location (float32)."""
    h = torch.div(index, num_patches, rounding_mode="floor")
    w = index % num_patches
    return torch.stack([w, h], dim=-1).to(torch.float32)


def gather_patches(
    features: torch.Tensor, points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """features (B, P, C) patch-major, points (B, N, 2) [x, y] patch coords
    with (-1, -1) invalid -> ((B, N, C) gathered, (B, N) bool valid)."""
    B, P, C = features.shape
    num_patches = int(round(P ** 0.5))
    x = points[..., 0].to(torch.int64)
    y = points[..., 1].to(torch.int64)
    valid = (x >= 0) & (y >= 0) & (x < num_patches) & (y < num_patches)
    idx = torch.where(valid, y * num_patches + x, 0).clamp(0, P - 1)
    out = torch.gather(features, 1, idx[..., None].expand(B, idx.shape[1], C))
    return out, valid


def patch_location_to_index(location: torch.Tensor, num_patches: int) -> torch.Tensor:
    """(..., 2) [x, y] grid location -> flat patch index (...,) int32."""
    return (location[..., 1] * num_patches + location[..., 0]).to(torch.int32)
