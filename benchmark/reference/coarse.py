"""Plain reference of GigaPose's coarse stage on one image's detections,
from the paper (arXiv 2311.14155, Sec. 3) and the public reference code's
arithmetic: crop and resize, AE patch features, template retrieval by
masked patch similarity with a cycle check, IST scale / in-plane regression
per correspondence, one-correspondence affine RANSAC, closed-form 6D
recovery. Plain PyTorch in float32; imports nothing of the program.

Unlike the program, which keeps only the best RANSAC proposal of the top-k
views, the reference returns what a judge needs: every view's similarity
score, and for any view every proposal's inlier score and pose.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.nets import Quant

RGB_MEAN = (0.48145466, 0.4578275, 0.40821073)
RGB_STD = (0.26862954, 0.26130258, 0.27577711)


def crop_affine(boxes: torch.Tensor, size: int) -> torch.Tensor:
    """(B, 4) integer xyxy boxes -> (B, 3, 3) crop similarities: the box's
    long side scaled to `size`, floor-sized, the short side centred."""
    b = boxes.to(torch.float32)
    w, h = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
    s = torch.full_like(w, float(size)) / torch.maximum(w, h)
    square = w == h
    zero = torch.zeros_like(s)
    left = torch.where(square, zero, torch.clamp(torch.floor((size - torch.floor(w * s)) / 2), min=0))
    top = torch.where(square, zero, torch.floor((size - torch.floor(h * s)) / 2))
    M = torch.zeros(len(b), 3, 3, device=b.device)
    M[:, 0, 0] = s
    M[:, 1, 1] = s
    M[:, 0, 2] = -b[:, 0] * s + left
    M[:, 1, 2] = -b[:, 1] * s + top
    M[:, 2, 2] = 1
    return M


def crop_nearest(images: torch.Tensor, M: torch.Tensor, boxes: torch.Tensor,
                 size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size): each output pixel reads its
    nearest source pixel through M^-1; pixels outside the box or the image
    read 0."""
    B, C, H, W = images.shape
    g = torch.arange(size, dtype=torch.float32, device=images.device)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    s, tx, ty = (M[:, 0, 0, None, None], M[:, 0, 2, None, None], M[:, 1, 2, None, None])
    sx = torch.floor((gx - tx) / s + 1e-6)
    sy = torch.floor((gy - ty) / s + 1e-6)
    bx = boxes.to(torch.float32)[:, :, None, None]
    ok = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H) & (sx >= bx[:, 0]) & (sx < bx[:, 2]) \
        & (sy >= bx[:, 1]) & (sy < bx[:, 3])
    idx = (sy.clamp(0, H - 1) * W + sx.clamp(0, W - 1)).long().reshape(B, 1, -1)
    out = torch.gather(images.reshape(B, C, H * W), 2, idx.expand(B, C, size * size))
    return out.reshape(B, C, size, size) * ok[:, None]


def normalise(rgb: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(RGB_MEAN, device=rgb.device).reshape(3, 1, 1)
    std = torch.tensor(RGB_STD, device=rgb.device).reshape(3, 1, 1)
    return (rgb - mean) / std


def patch_mask(mask: torch.Tensor, n: int) -> torch.Tensor:
    """(..., H, W) -> (..., n * n): the pixel at floor(i * H / n) of each patch."""
    H, W = mask.shape[-2:]
    ys = (torch.arange(n, device=mask.device) * H) // n
    xs = (torch.arange(n, device=mask.device) * W) // n
    return mask[..., ys, :][..., :, xs].reshape(mask.shape[:-2] + (n * n,))


def crops_of(rgba: torch.Tensor, boxes: torch.Tensor, size: int, n: int):
    """(B, 4, H, W) float RGBA in [0, 1] and boxes -> (normalised crops,
    patch masks, crop affines)."""
    M = crop_affine(boxes, size)
    c = crop_nearest(rgba, M, boxes, size)
    return normalise(c[:, :3]), patch_mask(c[:, 3], n), M


def loc(index: torch.Tensor, n: int) -> torch.Tensor:
    """Flat patch index -> [x, y] float grid location."""
    return torch.stack([index % n, torch.div(index, n, rounding_mode="floor")], -1).float()


@dataclasses.dataclass
class Retrieval:
    sim_avg: torch.Tensor  # (V,) every view's score
    idx_t2s: torch.Tensor  # (V, P) best template patch of each query patch
    score_t2s: torch.Tensor  # (V, P)
    valid: torch.Tensor  # (V, P) bool


def retrieve(tar: torch.Tensor, tar_mask: torch.Tensor, src: torch.Tensor,
             src_mask: torch.Tensor, sim_threshold: float, patch_threshold: int,
             n: int) -> Retrieval:
    """One query (P, C) against its object's V views (V, P, C): cosine
    similarity, masked and zeroed below the threshold; nearest neighbours
    both ways (first index on ties); the cycle check within patch_threshold
    patches; the reference's guards against patch 0; the view score is the
    masked similarity summed over query patches, over P."""
    P = tar.shape[0]
    tar = tar / torch.linalg.vector_norm(tar, dim=-1, keepdim=True).clamp(min=1e-8)
    src = src / torch.linalg.vector_norm(src, dim=-1, keepdim=True).clamp(min=1e-8)
    sim = torch.einsum("tc,vsc->vts", tar, src)
    sim = sim * src_mask[:, None, :] * tar_mask[None, :, None]
    sim = torch.where(sim < sim_threshold, torch.zeros_like(sim), sim)
    s_t2s, i_t2s = sim.max(dim=2)
    s_s2t, i_s2t = sim.max(dim=1)
    ok = s_t2s >= sim_threshold
    cyc = torch.gather(i_s2t, 1, i_t2s)
    dist = torch.linalg.vector_norm(loc(cyc, n) - loc(torch.arange(P, device=tar.device), n), dim=-1)
    ok &= (dist <= patch_threshold) & (torch.gather(s_s2t, 1, i_t2s) >= sim_threshold)
    ok &= (tar_mask[None] > 0) & (torch.gather(src_mask, 1, i_t2s) > 0) & (i_s2t != 0) & (i_t2s != 0)
    sim_avg = (s_t2s * ok).sum(dim=1) / P
    return Retrieval(sim_avg, i_t2s, s_t2s, ok)


@dataclasses.dataclass
class Hypotheses:
    """Every RANSAC proposal of one (query, view) pair."""

    scores: torch.Tensor  # (N,) inlier score of each proposal / P (-inf: no proposal)
    poses: torch.Tensor  # (N, 4, 4) the pose each proposal recovers
    best: float  # the best proposal's score (0 when none is valid)


def hypotheses(r: Retrieval, v: int, tar_ist: torch.Tensor, src_ist: torch.Tensor,
               regressor, quant: Quant, q_M: torch.Tensor, q_K: torch.Tensor,
               t_M: torch.Tensor, t_K: torch.Tensor, t_pose: torch.Tensor,
               pixel_threshold: float, patch_size: int, n: int) -> Hypotheses:
    """The view's correspondences (query patch t -> template patch
    idx_t2s[t]), regressed scale and in-plane rotation per correspondence,
    each valid one proposing an affine validated on the other valid ones
    (inlier within pixel_threshold), and each proposal's pose: rotation =
    in-plane rotation x the template's, translation from the template
    centre carried through the affine chain, depth scaled by the chain's
    scale and the focal ratio."""
    P = r.idx_t2s.shape[1]
    valid = r.valid[v]
    if not bool(valid.any()):  # no proposal: the identity affine, score 0
        eye = torch.eye(3, device=valid.device)[None]
        return Hypotheses(torch.zeros(1, device=valid.device),
                          recover(eye, q_M, q_K, t_M, t_K, t_pose), 0.0)
    tar_pts = loc(torch.arange(P, device=valid.device), n)
    src_pts = loc(r.idx_t2s[v], n)
    pair = torch.cat([tar_ist, src_ist[r.idx_t2s[v]]], dim=-1)
    scale, cs = regressor(pair, quant)
    src, tar = src_pts * patch_size, tar_pts * patch_size
    c, s = cs[:, 0], cs[:, 1]
    a = torch.stack([torch.stack([scale * c, -scale * s], -1),
                     torch.stack([scale * s, scale * c], -1)], -2)  # (N, 2, 2)
    t = tar - torch.einsum("nij,nj->ni", a, src)
    proj = torch.einsum("nij,mj->nmi", a, src) + t[:, None]
    err = torch.linalg.vector_norm(tar[None] - proj, dim=-1)
    eye = torch.eye(P, dtype=torch.bool, device=valid.device)
    inl = (err <= pixel_threshold) & valid[None] & valid[:, None] & ~eye
    score = (inl * r.score_t2s[v][None]).sum(dim=1)
    score = torch.where(valid, score, torch.full_like(score, -torch.inf)) / P
    best = float(score.max())
    M = torch.zeros(P, 3, 3, device=valid.device)
    M[:, :2, :2], M[:, :2, 2], M[:, 2, 2] = a, t, 1
    return Hypotheses(score, recover(M, q_M, q_K, t_M, t_K, t_pose), best)


def recover(M: torch.Tensor, q_M: torch.Tensor, q_K: torch.Tensor, t_M: torch.Tensor,
            t_K: torch.Tensor, t_pose: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) template-crop -> query-crop affines -> (N, 4, 4) poses."""
    sc = torch.linalg.vector_norm(M[:, :2, 0], dim=-1)
    rot = torch.zeros_like(M)
    rot[:, :2, :2] = M[:, :2, :2] / sc[:, None, None]
    rot[:, 2, 2] = 1
    R = rot @ t_pose[:3, :3]
    c = t_K @ t_pose[:3, 3]
    c = c / c[2]
    inv_q = torch.linalg.inv(q_M)
    chain = inv_q @ M @ t_M
    cq = chain @ c
    z = t_pose[2, 3] / torch.linalg.vector_norm(chain[:, :2, 0], dim=-1) * (q_K[0, 0] / t_K[0, 0])
    ray = cq @ torch.linalg.inv(q_K).T
    tvec = ray / ray[:, 2:3] * z[:, None]
    out = torch.zeros(len(M), 4, 4, device=M.device)
    out[:, :3, :3], out[:, :3, 3], out[:, 3, 3] = R, tvec, 1
    return out


def pose_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance of pose a (4, 4) from each of poses b (N, 4, 4): the
    Frobenius distance of the rotations plus the translation's distance
    relative to b's."""
    dr = torch.linalg.matrix_norm(a[None, :3, :3] - b[:, :3, :3])
    dt = torch.linalg.vector_norm(a[None, :3, 3] - b[:, :3, 3], dim=-1) / \
        torch.linalg.vector_norm(b[:, :3, 3], dim=-1).clamp(min=1e-9)
    return dr + dt


def judge_detection(sim_avg: torch.Tensor, hyps: dict, views: torch.Tensor,
                    scores: torch.Tensor, pose0: torch.Tensor, tie: float) -> dict:
    """The gaps of one served detection (its k view ids, k RANSAC scores,
    its top pose) against the reference. `tie` is one inlier's largest
    weight in a RANSAC score (1 / P): an inlier that flips at the pixel
    threshold between two roundings moves a score by at most that much.
    - view_gap: how far the lowest of the served views' reference scores
      lies below the reference's k-th best view (0 when every served view
      is among the reference's top k, up to ties);
    - score_gap: the widest distance between a served view's RANSAC score
      and the reference's best proposal score for that view;
    - score_excess: the same less `tie`, and not below 0;
    - pose_gap: the distance of the served top pose from the nearest of the
      reference's proposals, over all the served views, whose score lies
      within 2 `tie` of the best of them: the program's choice of view and
      proposal, held to the reference's up to near-ties."""
    vids = views.long()
    kth = torch.topk(sim_avg, len(vids)).values[-1]
    view_gap = float((kth - sim_avg[vids]).clamp(min=0).max())
    score_gap = max(abs(float(scores[j]) - hyps[int(v)].best) for j, v in enumerate(vids))
    best = max(hyps[int(v)].best for v in vids)
    near = torch.cat([hyps[int(v)].poses[hyps[int(v)].scores >= best - 2 * tie] for v in vids])
    pose_gap = float(pose_distance(pose0, near).min())
    return dict(view_gap=view_gap, score_gap=score_gap, score_excess=max(score_gap - tie, 0.0),
                pose_gap=pose_gap)
