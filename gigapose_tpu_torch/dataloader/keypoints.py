"""Ground-truth patch correspondences between two crops, on the trainer's
device (port of gigapose_tpu/dataloader/keypoints.py).

From the grid of patch centres of each crop: the mask lookup in both crops;
each source centre uncropped to the full image, lifted through its depth,
moved by the relative SE3, reprojected into the target camera and cropped
again; a second mask lookup there; then the nearest valid target centre must
lie within MAX_DIST pixels. Coordinates come back in patch units with -1 for
invalid points. Fixed shapes and no Python loop over the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gigapose_tpu_torch.lib3d.affine import apply_affine, inverse_crop_affine
from gigapose_tpu_torch.lib3d.geometry import (
    depth_at, project_points, transform_points, unproject_points,
)

MAX_DIST = 1000.0


class KeypointView(NamedTuple):
    """One view of the pair (batched): intrinsics, full-image depth, crop
    mask and crop affine."""

    K: torch.Tensor  # (B, 3, 3)
    depth: torch.Tensor  # (B, H, W)
    mask: torch.Tensor  # (B, h, w) crop-resolution object mask (0 / 1)
    M: torch.Tensor  # (B, 3, 3)


def grid_centers(tar_size: int, patch_size: int, device=None) -> torch.Tensor:
    """(P, 2) [x, y] patch-centre pixels of a crop, row-major."""
    xs = torch.arange(0, tar_size, patch_size, dtype=torch.float32, device=device) + patch_size / 2
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def _mask_lookup(points, mask, valid):
    """valid & point inside the image & mask >= 0.5 at its floored pixel."""
    H, W = mask.shape[-2], mask.shape[-1]
    x, y = points[..., 0], points[..., 1]
    inside = (x >= 0) & (y >= 0) & (x < W) & (y < H)
    return valid & inside & (depth_at(points, mask) >= 0.5)


def sample_keypoints(T_src2tar: torch.Tensor, src: KeypointView, tar: KeypointView,
                     tar_size: int = 224, patch_size: int = 14):
    """-> dict(src_pts, tar_pts (B, P, 2) patch units, -1 invalid; valid
    (B, P)): src_pts are the source centres reprojected into the target
    crop, tar_pts the target's own grid at the same patch index."""
    B = T_src2tar.shape[0]
    grid = grid_centers(tar_size, patch_size, T_src2tar.device).expand(B, -1, 2)
    ones = torch.ones(grid.shape[:-1], dtype=torch.bool, device=grid.device)
    src_valid = _mask_lookup(grid, src.mask, ones)
    tar_valid = _mask_lookup(grid, tar.mask, ones)

    src_full = apply_affine(inverse_crop_affine(src.M), grid)
    src_3d = unproject_points(src_full, src.K, src.depth)
    src_reproj = project_points(transform_points(T_src2tar, src_3d), tar.K)
    src_in_tar_crop = apply_affine(tar.M, src_reproj)
    src_valid = _mask_lookup(src_in_tar_crop, tar.mask, src_valid)
    src_valid &= src_3d[..., 2] > 1e-8  # zero depth unprojects to the origin

    d2 = ((src_in_tar_crop[:, :, None, :] - grid[:, None, :, :]) ** 2).sum(-1)  # (B, P, P)
    d2 = torch.where(tar_valid[:, None, :], d2, torch.full_like(d2, float("inf")))
    src_valid &= torch.sqrt(d2.min(dim=-1).values) < MAX_DIST

    valid = src_valid & tar_valid
    neg = torch.full((), -1.0, device=grid.device)
    return {"src_pts": torch.where(valid[..., None], src_in_tar_crop / patch_size, neg),
            "tar_pts": torch.where(valid[..., None], grid / patch_size, neg),
            "valid": valid}
