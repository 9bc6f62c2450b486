"""Template retrieval by patch similarity + cycle consistency: the float
reference (port of gigapose_tpu/ops/matching.py).

For each query crop, the cosine similarity of its P patch features against
all N templates x P patches of its object; mutual nearest neighbours with a
cycle check; the per-template averaged similarity; the top-k templates with
their patch correspondences. The quirks of the original are kept:

- sim is thresholded to 0 *before* the argmax, so the argmax of an all-zero
  row is 0 and the `idx != 0` guards drop patch-0 matches;
- the `idx_s2t != 0` guard is read at query-patch position t although the
  array is indexed by template patch.

Rankings use a stable descending sort (ties -> lowest index, as
jax.lax.top_k); torch.topk orders ties differently.
"""

from __future__ import annotations

import dataclasses

import torch

from gigapose_tpu_torch.ops.gather import patch_index_to_location


@dataclasses.dataclass
class MatchResult:
    """Top-k template matches for each query crop (all fixed-shape)."""

    ids: torch.Tensor  # (B, k) int32 template (view) indices
    scores: torch.Tensor  # (B, k) f32 averaged patch similarity per template
    score_pts: torch.Tensor  # (B, k, P) f32 per-query-patch best similarity
    src_pts: torch.Tensor  # (B, k, P, 2) f32 matched template patch [x, y]; -1 invalid
    tar_pts: torch.Tensor  # (B, k, P, 2) f32 query patch [x, y]; -1 invalid
    valid: torch.Tensor  # (B, k, P) bool correspondence validity


def downsample_mask(mask: torch.Tensor, num_patches: int) -> torch.Tensor:
    """(..., H, W) image mask -> (..., P) flat patch mask by nearest sampling
    (pixel floor(i * H / num_patches))."""
    H, W = mask.shape[-2], mask.shape[-1]
    dev = mask.device
    ys = (torch.arange(num_patches, device=dev) * H) // num_patches
    xs = (torch.arange(num_patches, device=dev) * W) // num_patches
    m = mask[..., ys, :][..., :, xs]
    return m.reshape(mask.shape[:-2] + (num_patches * num_patches,))


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis; ties
    resolve to the lowest index, like jax.lax.top_k."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def select_top_k(sim_avg, idx_t2s, score_t2s, valid, k: int, num_patches: int) -> MatchResult:
    """Top-k views of the per-view outputs (B, V) / (B, V, P) and their
    correspondences in the -1-sentinel point convention."""
    B, _, P = idx_t2s.shape
    scores, ids = top_k_stable(sim_avg, k)
    take = lambda a: torch.gather(a, 1, ids[..., None].expand(B, k, P))
    sel_valid = take(valid).bool()
    sel_spts = take(score_t2s)
    sel_src = patch_index_to_location(take(idx_t2s), num_patches)
    grid = patch_index_to_location(torch.arange(P, device=idx_t2s.device), num_patches)
    neg = torch.full((), -1.0, device=idx_t2s.device)
    tar_pts = torch.where(sel_valid[..., None], grid.expand(B, k, P, 2), neg)
    src_pts = torch.where(sel_valid[..., None], sel_src, neg)
    return MatchResult(
        ids=ids.to(torch.int32),
        scores=scores,
        score_pts=sel_spts,
        src_pts=src_pts,
        tar_pts=tar_pts,
        valid=sel_valid,
    )


def match_templates(
    tar_feat: torch.Tensor,
    src_feats: torch.Tensor,
    tar_mask: torch.Tensor,
    src_masks: torch.Tensor,
    k: int = 5,
    sim_threshold: float = 0.5,
    patch_threshold: int = 3,
    num_patches: int = 16,
) -> MatchResult:
    """tar_feat (B, P, C) query features (L2-normalized here), src_feats
    (B, N, P, C) the templates of each query's object, tar_mask (B, P),
    src_masks (B, N, P) -> MatchResult with the top-k templates per query."""
    B, N, P, C = src_feats.shape
    tar_f = tar_feat / torch.linalg.vector_norm(tar_feat, dim=-1, keepdim=True).clamp(min=1e-8)
    src_f = src_feats / torch.linalg.vector_norm(src_feats, dim=-1, keepdim=True).clamp(min=1e-8)
    tar_m = tar_mask.to(tar_f.dtype)
    src_m = src_masks.to(src_f.dtype)

    sim = torch.einsum("btc,bnsc->bnts", tar_f, src_f)  # (B, N, P_tar, P_src)
    sim = sim * src_m[:, :, None, :] * tar_m[:, None, :, None]
    sim = torch.where(sim < sim_threshold, torch.zeros_like(sim), sim)

    score_t2s, idx_t2s = sim.max(dim=3)[0], torch.argmax(sim, dim=3)
    score_s2t, idx_s2t = sim.max(dim=2)[0], torch.argmax(sim, dim=2)
    mask_sim = score_t2s >= sim_threshold

    if patch_threshold > 0:
        idx_cycle = torch.gather(idx_s2t, 2, idx_t2s)
        sim_cycle = torch.gather(score_s2t, 2, idx_t2s)
        loc_cycle = patch_index_to_location(idx_cycle, num_patches)
        loc_gt = patch_index_to_location(
            torch.arange(P, device=sim.device).expand(B, N, P), num_patches
        )
        dist = torch.linalg.vector_norm(loc_cycle - loc_gt, dim=-1)
        mask_cycle = (dist <= patch_threshold) & (sim_cycle >= sim_threshold)
    else:
        mask_cycle = torch.ones_like(mask_sim)

    mask_t2s = torch.gather(src_m, 2, idx_t2s) > 0
    mask_nonzero = (tar_m[:, None, :] > 0) & mask_t2s & (idx_s2t != 0) & (idx_t2s != 0)
    mask_all = mask_sim & mask_cycle & mask_nonzero

    any_valid = mask_all.sum(dim=2) > 0
    sim_avg = torch.where(
        any_valid,
        (score_t2s * mask_all).sum(dim=2) / (num_patches**2),
        torch.zeros((), dtype=score_t2s.dtype, device=sim.device),
    )
    return select_top_k(sim_avg, idx_t2s, score_t2s, mask_all, k, num_patches)


def match_pair(src_feat, tar_feat, src_mask, tar_mask, sim_threshold: float = 0.5,
               patch_threshold: int = 3, num_patches: int = 16):
    """One source / target pair per sample (the val/matching metric's
    matcher): match_templates at N=1, k=1. -> (src_pts, tar_pts, valid,
    score_pts), each with the pair axis dropped."""
    r = match_templates(tar_feat, src_feat[:, None], tar_mask, src_mask[:, None], k=1,
                        sim_threshold=sim_threshold, patch_threshold=patch_threshold,
                        num_patches=num_patches)
    return r.src_pts[:, 0], r.tar_pts[:, 0], r.valid[:, 0], r.score_pts[:, 0]
