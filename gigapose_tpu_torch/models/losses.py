"""Training losses (port of gigapose_tpu/models/losses.py).

All mask-aware, in fixed shapes: invalid rows are weighted out of every mean,
which gives the mean over the valid elements that the original GigaPose
computes after compacting them.
"""

from __future__ import annotations

from typing import Optional

import torch


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-8)


def _masked_mean(err: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """sum(err * valid) / max(sum(valid), 1)."""
    v = valid.to(err.dtype)
    return (err * v).sum() / v.sum().clamp(min=1.0)


def pairwise_cosine(a: torch.Tensor, b: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """(N, C) x (M, C) -> (N, M) cosine similarity."""
    if normalize:
        a, b = _unit(a), _unit(b)
    return a @ b.T


def info_nce_loss(query_feat: torch.Tensor, ref_feat: torch.Tensor, valid: torch.Tensor,
                  tau: float = 0.1, compute_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """InfoNCE over matched pairs with in-batch negatives: row i of query
    matches row i of ref, (N,) `valid` flags the pairs. Invalid columns are
    masked to -1e9, so they act as no negative, and the mean runs over the
    valid rows only.

    compute_dtype=torch.bfloat16 keeps the (N, N) logit matrix in bf16, as
    the JAX package's knob does: the product of the bf16 unit features and
    its division by bf16(tau) in bf16, the log-sum-exp accumulated in f32
    about the row's (bf16) maximum, and the positive logit exact: taken in
    f32 from the pair's rows, it replaces the diagonal's bf16 term in the
    sum (log1p of the difference)."""
    q, r = _unit(query_feat), _unit(ref_feat)
    if compute_dtype is not None:
        pos = (q * r).sum(-1) / tau  # (N,) f32 positive logits
        logits = (q.to(compute_dtype) @ r.T.to(compute_dtype)) / torch.tensor(
            tau, dtype=compute_dtype, device=q.device)
        logits = torch.where(valid[None, :], logits,
                             torch.full_like(logits, -1e9))
        m = logits.amax(dim=1).detach().to(torch.float32)
        lse = m + torch.log(torch.exp(logits.to(torch.float32) - m[:, None]).sum(dim=1))
        diag = torch.diagonal(logits).to(torch.float32)
        lse = lse + torch.log1p(torch.exp(pos - lse) - torch.exp(diag - lse))
        return _masked_mean(lse - pos, valid)
    logits = (q @ r.T) / tau  # (N, N)
    logits = torch.where(valid[None, :], logits, torch.full_like(logits, -1e9))
    losses = torch.logsumexp(logits, dim=1) - torch.diagonal(logits)
    return _masked_mean(losses, valid)


def scale_loss(pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor, log: bool = True,
               loss: str = "l2") -> torch.Tensor:
    """L2 (or L1) on the (log-)scale; the prediction is clipped at 1e-6
    before the log."""
    if log:
        pred = torch.log(pred.clamp(min=1e-6))
        gt = torch.log(gt)
    err = (pred - gt).abs() if loss == "l1" else (pred - gt) ** 2
    return _masked_mean(err, valid)


def inplane_loss(pred_cossin: torch.Tensor, gt_cossin: torch.Tensor, valid: torch.Tensor,
                 loss: str = "geodesic", normalize: bool = False,
                 eps: float = 1e-6) -> torch.Tensor:
    """Geodesic (arccos of the clipped cosine, clip at +-(1 - eps)) or lp
    loss on (..., 2) [cos, sin]."""
    if normalize:
        pred_cossin, gt_cossin = _unit(pred_cossin), _unit(gt_cossin)
    if loss == "geodesic":
        cos_diff = torch.clamp((pred_cossin * gt_cossin).sum(-1), -1 + eps, 1 - eps)
        return _masked_mean(torch.arccos(cos_diff), valid)
    d = pred_cossin - gt_cossin
    err = d.abs() if loss == "l1" else d**2
    return _masked_mean(err.mean(-1), valid)


def l2_warmup_losses(pred_scale, pred_cossin, gt_scale, gt_cossin, valid):
    """Plain MSE on the scale and on [cos, sin] (the first warm_up_steps)."""
    s = _masked_mean((pred_scale - gt_scale) ** 2, valid)
    i = _masked_mean(((pred_cossin - gt_cossin) ** 2).mean(-1), valid)
    return s, i
