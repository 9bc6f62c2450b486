"""Render-and-compare geometry ops (port of gigapose_tpu/refiner/ops.py).

Robust projection, deepim crop boxes, crop-camera intrinsics, ortho6d
rotations, pose normalization, the autodepth initial pose and the
reference-point pose update; batched and in f32 throughout, as the JAX
package runs them with precision="highest". Products of small matrices are
written as sums of broadcast products (no TF32 path can reach them); the
crop is the JAX package's separable form, two batched matmuls with
hat-kernel weights, which the refiner runs with TF32 off.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _matvec(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) x (B, N, 3) -> (B, N, 3): sum_j M[b, i, j] p[b, n, j]."""
    return (M[:, None, :, :] * p[:, :, None, :]).sum(-1)


def project_points_robust(points: torch.Tensor, K: torch.Tensor, TCO: torch.Tensor,
                          z_min: float = 0.1) -> torch.Tensor:
    """(B, N, 3) object points -> (B, N, 2) pixels with z clamped >= z_min."""
    p_cam = _matvec(TCO[:, :3, :3], points) + TCO[:, None, :3, 3]
    suv = _matvec(K, p_cam)
    z = suv[..., 2:3].clamp_min(z_min)
    return suv[..., :2] / z


def boxes_from_uv(uv: torch.Tensor) -> torch.Tensor:
    """(B, N, 2) -> (B, 4) xyxy."""
    return torch.cat([uv.amin(dim=1), uv.amax(dim=1)], dim=-1)


def deepim_boxes(rend_center_uv: torch.Tensor, obs_boxes: torch.Tensor,
                 rend_boxes: torch.Tensor, im_size: Tuple[int, int], lamb: float = 1.4,
                 clamp: bool = False) -> torch.Tensor:
    """Square crop box centred on the reference point covering both the
    observed and rendered extents, enlarged by lamb, aspect matched to the
    render size (ref: deepim_boxes, cropping.py:52-95)."""
    h, w = im_size
    u, v = rend_center_uv[:, 0, 0], rend_center_uv[:, 0, 1]
    boxes = torch.stack([obs_boxes, rend_boxes], dim=1)  # (B, 2, 4)
    dx = torch.maximum((boxes[..., 0] - u[:, None]).abs(),
                       (boxes[..., 2] - u[:, None]).abs()).amax(dim=1)
    dy = torch.maximum((boxes[..., 1] - v[:, None]).abs(),
                       (boxes[..., 3] - v[:, None]).abs()).amax(dim=1)
    aspect = w / h
    xdist = torch.maximum(dx, dy * aspect) * lamb
    ydist = torch.maximum(dx / aspect, dy) * lamb
    box = torch.stack([u - xdist, v - ydist, u + xdist, v + ydist], dim=-1)
    if clamp:
        hi = torch.tensor([w, h, w, h], dtype=box.dtype, device=box.device)
        box = torch.minimum(box.clamp_min(0.0), hi)
    return box


def get_K_crop_resize(K: torch.Tensor, boxes: torch.Tensor, orig_size,
                      crop_resize) -> torch.Tensor:
    """Intrinsics of the fictive camera of a crop + resize (ref:
    camera_geometry.py:70-115)."""
    final_width, final_height = max(crop_resize), min(crop_resize)
    crop_w = boxes[:, 2] - boxes[:, 0]
    crop_h = boxes[:, 3] - boxes[:, 1]
    cj = (boxes[:, 0] + boxes[:, 2]) / 2
    ci = (boxes[:, 1] + boxes[:, 3]) / 2
    cx = K[:, 0, 2] + (crop_w - 1) / 2 - cj
    cy = K[:, 1, 2] + (crop_h - 1) / 2 - ci
    center_x = (crop_w - 1) / 2
    center_y = (crop_h - 1) / 2
    # tensor quotients: torch computes `number / tensor` as number * (1 / tensor)
    scale_x = torch.full_like(crop_w, float(final_width)) / crop_w
    scale_y = torch.full_like(crop_h, float(final_height)) / crop_h
    scaled_center_x = (final_width - 1) / 2
    scaled_center_y = (final_height - 1) / 2
    out = torch.zeros_like(K)
    out[:, 0, 0] = scale_x * K[:, 0, 0]
    out[:, 1, 1] = scale_y * K[:, 1, 1]
    out[:, 0, 2] = scaled_center_x + scale_x * (cx - center_x)
    out[:, 1, 2] = scaled_center_y + scale_y * (cy - center_y)
    out[:, 2, 2] = 1.0
    return out


def _hat_weights(g: torch.Tensor, size: int, r: int) -> torch.Tensor:
    """(B, n*r) sub-sample coordinates -> (B, n, size) averaged bilinear
    weights: the hat kernel max(0, 1 - |h - (g - 0.5)|) over pixel indices h
    (indices outside [0, size) do not exist, so their mass drops, as
    roi_align's zero padding)."""
    Bn = g.shape[0]
    n = g.shape[1] // r
    h = torch.arange(size, dtype=g.dtype, device=g.device)
    w = torch.zeros((Bn, n, size), dtype=g.dtype, device=g.device)
    for p in range(r):
        c = g[:, p::r, None] - 0.5
        w = w + (1.0 - (h[None, None, :] - c).abs()).clamp_min(0.0)
    return w / r


def crop_images_to_boxes(images: torch.Tensor, boxes: torch.Tensor,
                         output_size: Tuple[int, int], sampling_ratio: int = 1) -> torch.Tensor:
    """(B, C, H, W) crop-resize to output_size from xyxy boxes, roi_align
    style: each output bin averages sampling_ratio^2 bilinear samples on a
    regular sub-grid; out-of-image samples read 0. Two batched matmuls with
    per-box hat-kernel weights, out = Wy @ img @ Wx^T (the JAX package's
    separable form)."""
    oh, ow = output_size
    H, W = images.shape[-2:]
    r = sampling_ratio

    def grid(lo, hi, n):
        steps = torch.arange(n * r, dtype=lo.dtype, device=lo.device) + 0.5
        return lo[:, None] + steps[None, :] * (hi - lo)[:, None] / (n * r)

    Wy = _hat_weights(grid(boxes[:, 1], boxes[:, 3], oh), H, r)  # (B, oh, H)
    Wx = _hat_weights(grid(boxes[:, 0], boxes[:, 2], ow), W, r)  # (B, ow, W)
    tmp = torch.matmul(Wy[:, None], images)  # (B, C, oh, W)
    return torch.matmul(tmp, Wx[:, None].transpose(-1, -2))  # (B, C, oh, ow)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def rotation_from_ortho6d(o6d: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt (Zhou et al. CVPR19; ref:
    rotations.py:24-40). Columns are the orthonormalized axes."""
    x = o6d[..., 0:3]
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-8)
    z = _cross(x, o6d[..., 3:6])
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True).clamp_min(1e-8)
    y = _cross(z, x)
    return torch.stack([x, y, z], dim=-1)


def normalize_T(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation from its first two columns (ref:
    transform_ops.py:100-130)."""
    R = rotation_from_ortho6d(torch.cat([T[..., :3, 0], T[..., :3, 1]], dim=-1))
    out = torch.zeros_like(T)
    out[..., :3, :3] = R
    out[..., :3, 3] = T[..., :3, 3]
    out[..., 3, 3] = 1.0
    return out


def TCO_init_from_boxes_autodepth_with_R(boxes_2d: torch.Tensor, points: torch.Tensor,
                                         K: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Initial pose from a detection box and a rotation hypothesis: the object
    at z_guess, its projected extent measured, depth rescaled so the extent
    matches the box (ref: cosypose_ops.py:170-223)."""
    B = boxes_2d.shape[0]
    z_guess = 1.0
    fxfy = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)
    cxcy = K[:, :2, 2]
    centers = (boxes_2d[:, :2] + boxes_2d[:, 2:]) / 2
    xy_init = (centers - cxcy) * z_guess / fxfy
    t0 = torch.cat([xy_init, torch.full((B, 1), z_guess, dtype=R.dtype, device=R.device)], -1)
    p_cam = _matvec(R, points) + t0[:, None, :]
    dxy_3d = p_cam[..., :2].amax(dim=1) - p_cam[..., :2].amin(dim=1)
    bb_dxy = boxes_2d[:, 2:] - boxes_2d[:, :2] + 1.0
    z = (fxfy * dxy_3d / bb_dxy).mean(dim=-1, keepdim=True)
    xy = (centers - cxcy) * z / fxfy
    out = torch.zeros((B, 4, 4), dtype=R.dtype, device=R.device)
    out[:, :3, :3] = R
    out[:, :2, 3] = xy
    out[:, 2, 3] = z[:, 0]
    out[:, 3, 3] = 1.0
    return out


def pose_update_with_reference_point(TCO: torch.Tensor, K: torch.Tensor, vxvyvz: torch.Tensor,
                                     dR: torch.Tensor, tCR: torch.Tensor) -> torch.Tensor:
    """The megapose pose update (ref: cosypose_ops.py:32-60): image-space
    offsets and relative depth move the reference point; dR rotates about it."""
    zsrc = tCR[:, 2:3]
    ztgt = vxvyvz[:, 2:3] * zsrc
    fxfy = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)
    xy = (vxvyvz[:, :2] / fxfy + tCR[:, :2] / zsrc) * ztgt
    tCR_out = torch.cat([xy, ztgt], dim=-1)
    tCO_out = (dR * (TCO[:, :3, 3] - tCR)[:, None, :]).sum(-1) + tCR_out
    out = TCO.clone()
    out[:, :3, 3] = tCO_out
    out[:, :3, :3] = (dR[:, :, :, None] * TCO[:, None, :3, :3]).sum(2)
    return out
