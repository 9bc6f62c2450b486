"""Projective and rotation geometry on torch tensors (port of
gigapose_tpu/lib3d/geometry.py).

Every function broadcasts over leading axes. The JAX package contracts its
small pose matrices at precision="highest"; here they are f32 products, which
stay f32 on the card as long as TF32 is off for matmuls
(pipeline/estimator.set_f32_matmul_precision). The Euler-angle extractions
are closed form, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def cos_sin(angle: torch.Tensor) -> torch.Tensor:
    """(...,) angle -> (..., 2) [cos, sin]."""
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def cos_sin_to_angle(cs: torch.Tensor) -> torch.Tensor:
    """(..., 2) [cos, sin] -> angle in [0, 2pi)."""
    return torch.remainder(torch.atan2(cs[..., 1], cs[..., 0]), TWO_PI)


def project_points(points3d: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., 3, 3) -> (..., N, 2) pixel coordinates."""
    p = torch.einsum("...ij,...nj->...ni", K, points3d)
    return p[..., :2] / p[..., 2:3]


def depth_at(points2d: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Depth (..., H, W) read at the floored integer pixel of (..., N, 2)
    points, coordinates clamped into the image -> (..., N)."""
    H, W = depth.shape[-2], depth.shape[-1]
    x = points2d[..., 0].to(torch.int64).clamp(0, W - 1)
    y = points2d[..., 1].to(torch.int64).clamp(0, H - 1)
    return torch.gather(depth.reshape(depth.shape[:-2] + (H * W,)), -1, y * W + x)


def unproject_points(points2d: torch.Tensor, K: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Lift (..., N, 2) pixel coordinates to camera space through a (..., H,
    W) depth map read at the floored pixel (clamped into bounds; callers
    carry validity masks)."""
    d = depth_at(points2d, depth)
    pts_h = torch.cat([points2d, torch.ones_like(points2d[..., :1])], dim=-1)
    rays = torch.einsum("...ij,...nj->...ni", torch.linalg.inv(K), pts_h)
    return rays * d[..., None]


def transform_points(T: torch.Tensor, points3d: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) SE3 to (..., N, 3) points."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], points3d) + T[..., None, :3, 3]


def euler_z_zxy(R: torch.Tensor) -> torch.Tensor:
    """First angle of the extrinsic z-x-y Euler decomposition of (..., 3, 3)
    R = Ry(c) Rx(b) Rz(a): a = atan2(R[1, 0], R[1, 1])."""
    return torch.atan2(R[..., 1, 0], R[..., 1, 1])


def euler_z_zyx(R: torch.Tensor) -> torch.Tensor:
    """First angle of the extrinsic z-y-x Euler decomposition of (..., 3, 3)
    R = Rx(c) Ry(b) Rz(a): a = atan2(-R[0, 1], R[0, 0])."""
    return torch.atan2(-R[..., 0, 1], R[..., 0, 0])


def relative_scale(src_K, tar_K, src_pose, tar_pose, src_M, tar_M) -> torch.Tensor:
    """2D scale of the source -> target mapping:
    (z_src / z_tar) * (|tar_M| / |src_M|) / (f_src / f_tar)."""
    rel_z = src_pose[..., 2, 3] / tar_pose[..., 2, 3]
    rel_crop = (torch.linalg.vector_norm(tar_M[..., :2, 0], dim=-1)
                / torch.linalg.vector_norm(src_M[..., :2, 0], dim=-1))
    rel_focal = src_K[..., 0, 0] / tar_K[..., 0, 0]
    return rel_z * rel_crop / rel_focal


def relative_inplane(src_pose: torch.Tensor, tar_pose: torch.Tensor) -> torch.Tensor:
    """In-plane angle in [0, 2pi) of R_tar R_src^T about the camera z axis."""
    rel_R = torch.einsum("...ij,...kj->...ik", tar_pose[..., :3, :3], src_pose[..., :3, :3])
    return torch.remainder(euler_z_zxy(rel_R) + TWO_PI, TWO_PI)


def geodesic_distance_cos_sin(pred_cs, gt_cs, normalize: bool = False, eps: float = 0.0):
    """Mean angular distance between (..., 2) cos / sin pairs."""
    if normalize:
        pred_cs = pred_cs / torch.linalg.vector_norm(pred_cs, dim=-1, keepdim=True)
        gt_cs = gt_cs / torch.linalg.vector_norm(gt_cs, dim=-1, keepdim=True)
    cos_diff = torch.clamp((pred_cs * gt_cs).sum(-1), -1.0 + eps, 1.0 - eps)
    return torch.arccos(cos_diff).mean()


def opencv_to_opengl(T: torch.Tensor) -> torch.Tensor:
    """Flip the y and z camera axes of (..., 4, 4) poses (an involution)."""
    flip = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=T.dtype, device=T.device)
    return T * flip[:, None]


def rotation_geodesic_deg(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic distance in degrees between (..., 3, 3) rotations."""
    tr = torch.einsum("...ij,...ij->...", R2, R1)  # trace(R2 R1^T)
    return torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)))


def inplane_to_rotation(inplane_deg: torch.Tensor) -> torch.Tensor:
    """Rz(-inplane_deg) as (..., 3, 3)."""
    a = torch.deg2rad(-inplane_deg)
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], dim=-2)


def compute_inplane_deg(rot_query_cv: torch.Tensor, rot_template_cv: torch.Tensor) -> torch.Tensor:
    """In-plane angle in degrees between query and template rotations: the
    z (zyx) Euler angle of R_template R_query^T."""
    delta = torch.einsum("...ij,...kj->...ik", rot_template_cv, rot_query_cv)
    return torch.rad2deg(euler_z_zyx(delta))
