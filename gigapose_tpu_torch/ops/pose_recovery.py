"""Closed-form 6D pose recovery from 2D affine hypotheses (port of
gigapose_tpu/ops/pose_recovery.py).

1. rotation  R = normalize(M) @ R_template            (in-plane x viewpoint)
2. 2D centre: the template's projected centre through the affine chain
   inv(query_crop_M) @ M @ template_crop_M
3. depth     z = (z_template / scale2d(chain)) * (f_query / f_template)
4. t = z * (K_query^-1 @ centre) / its third component
"""

from __future__ import annotations

import torch

from gigapose_tpu_torch.lib3d.affine import inverse_crop_affine, normalize_affine


def recover_poses(
    query_M: torch.Tensor,  # (B, 3, 3) query crop affine
    query_K: torch.Tensor,  # (B, 3, 3) query intrinsics
    view_ids: torch.Tensor,  # (B, k) retrieved template view indices
    pred_Ms: torch.Tensor,  # (B, k, 3, 3) RANSAC affines (template crop -> query crop)
    template_K: torch.Tensor,  # (B, 3, 3) template intrinsics of each query's object
    template_Ms: torch.Tensor,  # (B, V, 3, 3) crop affines of the object's templates
    template_poses: torch.Tensor,  # (B, V, 4, 4) object poses of the templates
) -> torch.Tensor:
    """-> (B, k, 4, 4) object poses in the query camera."""
    B, k = view_ids.shape
    V = template_Ms.shape[1]
    ids = view_ids.to(torch.int64).clamp(0, V - 1)  # JAX gathers clip
    temp_Ms = torch.gather(template_Ms, 1, ids[..., None, None].expand(B, k, 3, 3))
    temp_poses = torch.gather(template_poses, 1, ids[..., None, None].expand(B, k, 4, 4))

    R = normalize_affine(pred_Ms) @ temp_poses[..., :3, :3]

    temp_z = temp_poses[..., 2, 3]
    center_t = torch.einsum("bij,bkj->bki", template_K, temp_poses[..., :3, 3])
    center_t = center_t / center_t[..., 2:3]

    chain = inverse_crop_affine(query_M)[:, None] @ pred_Ms @ temp_Ms  # (B, k, 3, 3)
    center_q = torch.einsum("bkij,bkj->bki", chain, center_t)

    scale2d = torch.linalg.vector_norm(chain[..., :2, 0], dim=-1)
    focal_ratio = query_K[:, None, 0, 0] / template_K[:, None, 0, 0]
    query_z = (temp_z / scale2d) * focal_ratio

    ray = torch.einsum("bij,bkj->bki", torch.linalg.inv(query_K), center_q)
    ray = ray / ray[..., 2:3]
    t = ray * query_z[..., None]

    top = torch.cat([R, t[..., None]], dim=-1)  # (B, k, 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(B, k, 1, 4)], dim=-2)
