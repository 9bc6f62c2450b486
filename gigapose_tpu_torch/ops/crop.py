"""Batched square crop-resize-pad (port of gigapose_tpu/ops/crop.py).

The whole batch is one fixed-shape inverse warp driven by the crop affine M
(out_pixel = M @ in_pixel), with the original GigaPose's floor/round pad
arithmetic: s = target / max(box_w, box_h), the resized box has floor(dim * s)
pixels, and the pads centre the short side.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def crop_resize_affine(boxes_xyxy: torch.Tensor, target_size: int = 224) -> torch.Tensor:
    """(B, 4) integer [x0, y0, x1, y1] boxes -> (B, 3, 3) float32 crop affines."""
    b = boxes_xyxy.to(torch.float32)
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    # a tensor quotient: `int / tensor` is evaluated as int * (1 / tensor),
    # 1 ulp off the correctly rounded quotient for boxes such as 120 px
    scale = torch.full_like(w, float(target_size)) / torch.maximum(w, h)
    out_w = torch.floor(w * scale)
    out_h = torch.floor(h * scale)
    square = w == h
    zero = torch.zeros_like(scale)
    pad_left = torch.where(
        square, zero, torch.clamp(torch.floor((target_size - out_w) / 2), min=0.0)
    )
    pad_top = torch.where(square, zero, torch.floor((target_size - out_h) / 2))
    tx = -b[..., 0] * scale + pad_left
    ty = -b[..., 1] * scale + pad_top
    ones = torch.ones_like(scale)
    return torch.stack(
        [
            torch.stack([scale, zero, tx], dim=-1),
            torch.stack([zero, scale, ty], dim=-1),
            torch.stack([zero, zero, ones], dim=-1),
        ],
        dim=-2,
    )


def warp_affine_nearest(
    images: torch.Tensor,
    M: torch.Tensor,
    target_size: int = 224,
    fill: float = 0.0,
    bbox: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-warp (B, C, H, W) images by crop affines M with nearest
    sampling -> (B, C, target_size, target_size). With `bbox` (B, 4) xyxy,
    source pixels outside the box read as `fill`."""
    B, C, H, W = images.shape
    dev = images.device
    grid = torch.arange(target_size, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")  # (T, T)
    s = M[:, 0, 0][:, None, None]
    tx = M[:, 0, 2][:, None, None]
    ty = M[:, 1, 2][:, None, None]
    # nearest source pixel of each target pixel; the +1e-6 keeps exact
    # integer sample positions from flooring one pixel low
    sx = torch.floor((gx - tx) / s + 1e-6)
    sy = torch.floor((gy - ty) / s + 1e-6)

    valid = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
    if bbox is not None:
        bx = bbox.to(torch.float32)
        valid &= (
            (sx >= bx[:, 0, None, None])
            & (sx < bx[:, 2, None, None])
            & (sy >= bx[:, 1, None, None])
            & (sy < bx[:, 3, None, None])
        )
    ix = torch.clamp(sx, 0, W - 1).to(torch.int64)
    iy = torch.clamp(sy, 0, H - 1).to(torch.int64)
    idx = (iy * W + ix).reshape(B, 1, -1).expand(B, C, target_size * target_size)
    out = torch.gather(images.reshape(B, C, H * W), 2, idx)
    out = out.reshape(B, C, target_size, target_size)
    return torch.where(valid[:, None], out, torch.full_like(out, fill))


def crop_resize_pad(
    images: torch.Tensor, boxes_xyxy: torch.Tensor, target_size: int = 224
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop + resize + pad the batch to (B, C, T, T); returns (crops, M)."""
    M = crop_resize_affine(boxes_xyxy, target_size)
    crops = warp_affine_nearest(images, M, target_size, bbox=boxes_xyxy)
    return crops, M
