"""Validation metrics (port of gigapose_tpu/training/validate.py).

`val/matching`: the mean pixel distance, in patch units, between the
ground-truth and the predicted source location of each query patch where
both exist (ops/matching.match_pair); `val/scale_err` and `val/angle_err`
(degrees) of the IST predictions on the ground-truth pairs; and
`val/num_matches`, the predicted correspondences per pair.
"""

from __future__ import annotations

from typing import Dict

import torch

from gigapose_tpu_torch.lib3d.geometry import cos_sin
from gigapose_tpu_torch.ops.matching import match_pair
from gigapose_tpu_torch.training.state import TrainBatch


@torch.no_grad()
def validation_metrics(ae_net, ist_net, batch: TrainBatch, sim_threshold: float = 0.5,
                       patch_threshold: int = 3, num_patches: int = 16) -> Dict[str, torch.Tensor]:
    """The nets as they are called here: eval mode (running BatchNorm
    statistics) is the caller's to set."""
    src_feat, tar_feat = ae_net(batch.src_img), ae_net(batch.tar_img)
    pred_src, _, pred_valid, _ = match_pair(src_feat, tar_feat, batch.src_mask, batch.tar_mask,
                                            sim_threshold=sim_threshold,
                                            patch_threshold=patch_threshold,
                                            num_patches=num_patches)
    gt_valid = batch.src_pts[..., 0] >= 0
    both = (gt_valid & pred_valid).to(torch.float32)
    d = torch.linalg.vector_norm(batch.src_pts - pred_src, dim=-1)
    matching = (d * both).sum() / both.sum().clamp(min=1)

    out = ist_net(batch.src_img, batch.tar_img, batch.src_pts, batch.tar_pts)
    v = (out.valid & gt_valid).to(torch.float32)
    B, P = v.shape
    gt_scale = batch.rel_scale[:, None].expand(B, P)
    gt_cs = cos_sin(batch.rel_inplane)[:, None].expand(B, P, 2)
    n = v.sum().clamp(min=1)
    scale_err = ((out.scale - gt_scale).abs() * v).sum() / n
    cos_diff = torch.clamp((out.cossin * gt_cs).sum(-1), -1, 1)
    angle_err = torch.rad2deg((torch.arccos(cos_diff) * v).sum() / n)
    return {"val/matching": matching, "val/scale_err": scale_err, "val/angle_err": angle_err,
            "val/num_matches": pred_valid.sum() / pred_valid.shape[0]}
