"""Retrieval plots (port of gigapose_tpu/utils/vis.py): keypoint
correspondences, the RANSAC affine's warp over the query, and image grids.

The plots are drawn into numpy arrays and written with dataloader/png.py,
pixel for pixel as the JAX package draws them with PIL's ImageDraw. Its C
library truncates each float coordinate towards zero; then its filled
ellipse of a box 3 or 4 pixels wide and high (the plots' dots: 4 wide, or 3
where truncation towards zero shortens a box across the image's edge) is the
box with its four corner pixels left out, and its one-pixel line is
Bresenham's between the integer end points, both ends drawn.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from gigapose_tpu_torch.pipeline.templates import RGB_MEAN, RGB_STD

_PALETTE = (
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
)


def denormalize_rgb(img) -> np.ndarray:
    """(3, H, W) CLIP-normalized -> (H, W, 3) uint8."""
    x = np.asarray(img.detach().cpu() if hasattr(img, "detach") else img)
    x = x * RGB_STD.reshape(3, 1, 1) + RGB_MEAN.reshape(3, 1, 1)
    return (np.clip(x, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)


def _color(i: int):
    return _PALETTE[i % len(_PALETTE)]


def _point(canvas: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < canvas.shape[1] and 0 <= y < canvas.shape[0]:
        canvas[y, x] = color


def draw_dot(canvas: np.ndarray, x0: float, y0: float, x1: float, y1: float, color) -> None:
    """ImageDraw.ellipse([x0, y0, x1, y1], fill=color) for boxes 3 or 4
    pixels wide and high."""
    xa, ya, xb, yb = int(x0), int(y0), int(x1), int(y1)
    if not (3 <= xb - xa <= 4 and 3 <= yb - ya <= 4):
        raise ValueError(f"draw_dot draws boxes 3 or 4 pixels wide, not {(xa, ya, xb, yb)}")
    dot = np.ones((yb - ya + 1, xb - xa + 1), bool)
    dot[[0, 0, -1, -1], [0, -1, 0, -1]] = False
    ys, xs = np.nonzero(dot)
    ys, xs = ys + ya, xs + xa
    H, W = canvas.shape[:2]
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    canvas[ys[ok], xs[ok]] = color


def draw_line(canvas: np.ndarray, xa: float, ya: float, xb: float, yb: float, color) -> None:
    """ImageDraw.line([xa, ya, xb, yb], fill=color, width=1)."""
    x0, y0, x1, y1 = int(xa), int(ya), int(xb), int(yb)
    dx, xs = (x1 - x0, 1) if x1 >= x0 else (x0 - x1, -1)
    dy, ys = (y1 - y0, 1) if y1 >= y0 else (y0 - y1, -1)
    if dx == 0:
        for _ in range(dy):
            _point(canvas, x0, y0, color)
            y0 += ys
    elif dy == 0:
        for _ in range(dx):
            _point(canvas, x0, y0, color)
            x0 += xs
    elif dx > dy:  # Bresenham, shallow
        e = 2 * dy - dx
        for _ in range(dx):
            _point(canvas, x0, y0, color)
            if e >= 0:
                y0 += ys
                e -= 2 * dx
            e += 2 * dy
            x0 += xs
    else:  # Bresenham, steep
        e = 2 * dx - dy
        for _ in range(dy):
            _point(canvas, x0, y0, color)
            if e >= 0:
                x0 += xs
                e -= 2 * dy
            e += 2 * dx
            y0 += ys
    _point(canvas, x1, y1, color)  # the last point


def plot_keypoints(src_img, tar_img, src_pts: np.ndarray, tar_pts: np.ndarray,
                   patch_size: int = 14, max_points: int = 64) -> np.ndarray:
    """Side-by-side pair (H, 2W, 3) with matched patch centres joined in
    colour. Points are patch coordinates, -1 invalid."""
    a, b = denormalize_rgb(src_img), denormalize_rgb(tar_img)
    H, W = a.shape[:2]
    canvas = np.concatenate([a, b], axis=1)
    src_pts, tar_pts = np.asarray(src_pts), np.asarray(tar_pts)
    valid = np.where((src_pts[:, 0] >= 0) & (tar_pts[:, 0] >= 0))[0]
    for j, i in enumerate(valid[:max_points]):
        sx, sy = (src_pts[i] * patch_size + patch_size / 2).tolist()
        tx, ty = (tar_pts[i] * patch_size + patch_size / 2).tolist()
        c = _color(j)
        draw_dot(canvas, sx - 2, sy - 2, sx + 2, sy + 2, c)
        draw_dot(canvas, W + tx - 2, ty - 2, W + tx + 2, ty + 2, c)
        draw_line(canvas, sx, sy, W + tx, ty, c)
    return canvas


def plot_affine_warp(src_img, tar_img, M: np.ndarray) -> np.ndarray:
    """The template crop, the query crop, and the template warped by the
    RANSAC affine blended over the query: (H, 3W, 3)."""
    src = denormalize_rgb(src_img)
    tar = denormalize_rgb(tar_img)
    H, W = src.shape[:2]
    Minv = np.linalg.inv(np.asarray(M, np.float64))
    ys, xs = np.mgrid[0:H, 0:W]
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(H * W)], 0)
    spts = Minv @ pts
    sx = np.round(spts[0] / spts[2]).astype(int)
    sy = np.round(spts[1] / spts[2]).astype(int)
    ok = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
    warped = np.zeros_like(src)
    warped.reshape(-1, 3)[ok] = src[sy[ok], sx[ok]]
    blend = (0.5 * warped + 0.5 * tar).astype(np.uint8)
    return np.concatenate([src, tar, blend], axis=1)


def image_grid(images: Sequence[np.ndarray], nrow: int = 8) -> np.ndarray:
    """(h, w, 3) images tiled row-major, nrow per row (torchvision's
    save_image layout); no images give one black pixel."""
    if not len(images):
        return np.zeros((1, 1, 3), np.uint8)
    h, w = images[0].shape[:2]
    ncol = (len(images) + nrow - 1) // nrow
    canvas = np.zeros((ncol * h, nrow * w, 3), np.uint8)
    for i, img in enumerate(images):
        y, x = (i // nrow) * h, (i % nrow) * w
        img = np.asarray(img)[:h, :w]
        canvas[y:y + img.shape[0], x:x + img.shape[1]] = img
    return canvas
