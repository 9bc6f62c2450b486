"""One-correspondence 2D-affine RANSAC, dense and masked (port of
gigapose_tpu/ops/ransac.py).

Each valid correspondence n proposes a complete affine (its regressed scale
and cos/sin fix the linear part, its point pair the translation), so RANSAC is
a dense (N proposals x N validators) error matrix plus an argmax:

- proposals come only from valid correspondences;
- each proposal is validated on all *other* valid correspondences;
- inlier score = sum of the matching scores of inliers (err <= pixel_threshold);
- best proposal by score, ties to the lowest index (torch.argmax is first-index);
- failed = best score == 0; a row with no valid correspondence keeps M = I,
  failed = False, and argmax over its all -inf scores picks 0.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RansacResult:
    M: torch.Tensor  # (..., 3, 3) best affine (patch -> patch, pixel units)
    failed: torch.Tensor  # (...,) bool
    inliers: torch.Tensor  # (..., N) bool, inliers of the best proposal (not itself)
    inlier_scores: torch.Tensor  # (..., N) f32, score where inlier else 0


def ransac_affine(
    src_pts: torch.Tensor,
    tar_pts: torch.Tensor,
    scores: torch.Tensor,
    rel_scale: torch.Tensor,
    rel_cossin: torch.Tensor,
    valid: torch.Tensor,
    pixel_threshold: float = 14.0,
    patch_size: int = 14,
) -> RansacResult:
    """src_pts / tar_pts (..., N, 2) patch coords, scores (..., N),
    rel_scale (..., N), rel_cossin (..., N, 2), valid (..., N) bool ->
    RansacResult with pixel-unit affines."""
    src = src_pts * patch_size
    tar = tar_pts * patch_size
    c, s = rel_cossin[..., 0], rel_cossin[..., 1]
    sc = rel_scale
    a11, a12 = sc * c, -sc * s
    a21, a22 = sc * s, sc * c
    tx = tar[..., 0] - (a11 * src[..., 0] + a12 * src[..., 1])
    ty = tar[..., 1] - (a21 * src[..., 0] + a22 * src[..., 1])

    # error of proposal n on validator m: (..., N, M)
    px = (a11[..., :, None] * src[..., None, :, 0]
          + a12[..., :, None] * src[..., None, :, 1] + tx[..., :, None])
    py = (a21[..., :, None] * src[..., None, :, 0]
          + a22[..., :, None] * src[..., None, :, 1] + ty[..., :, None])
    err = torch.sqrt((tar[..., None, :, 0] - px) ** 2 + (tar[..., None, :, 1] - py) ** 2)

    N = src_pts.shape[-2]
    not_self = ~torch.eye(N, dtype=torch.bool, device=src.device)
    inlier = (err <= pixel_threshold) & valid[..., None, :] & valid[..., :, None] & not_self
    score_inliers = (inlier * scores[..., None, :]).sum(dim=-1)
    score_inliers = torch.where(
        valid, score_inliers, torch.full_like(score_inliers, -torch.inf)
    )

    best = torch.argmax(score_inliers, dim=-1)
    take_best = lambda x: torch.gather(x, -1, best[..., None])[..., 0]
    best_score = take_best(score_inliers)
    any_valid = valid.any(dim=-1)
    failed = any_valid & (best_score == 0)

    top = torch.stack(
        [
            torch.stack([take_best(a11), take_best(a12), take_best(tx)], dim=-1),
            torch.stack([take_best(a21), take_best(a22), take_best(ty)], dim=-1),
        ],
        dim=-2,
    )
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=src.dtype, device=src.device)
    M = torch.cat([top, bottom.expand(top.shape[:-2] + (1, 3))], dim=-2)
    eye = torch.eye(3, dtype=src.dtype, device=src.device).expand(M.shape)
    M = torch.where(any_valid[..., None, None], M, eye)

    idx = best[..., None, None].expand(best.shape + (1, N))
    best_inliers = torch.gather(inlier, -2, idx)[..., 0, :] & any_valid[..., None]
    inlier_scores = torch.where(best_inliers, scores, torch.zeros_like(scores))
    return RansacResult(M=M, failed=failed, inliers=best_inliers, inlier_scores=inlier_scores)
