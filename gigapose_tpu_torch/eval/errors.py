"""Pose errors for BOP / ModelNet evaluation (port of
gigapose_tpu/eval/errors.py).

- MSSD, MSPD, ADD and ADD-S are torch functions in f32 on a `device`
  (cuda:0 unless the caller names another device), every input cast to f32
  first, as the JAX package's `_np` casts them; each returns a Python float.
- depth_im_to_dist_im, vsd_error, auc_posecnn and angular_error_deg are
  numpy f64 on the host, as in the JAX package.

Conventions: rotations (3,3) row-major, translations mm, points mm (N,3).
Symmetries are a stacked set (S,3,3) + (S,3) from scorer.symmetry_set
(bop_toolkit semantics: the identity is present unless the object has a
continuous symmetry, in which case only discretized compositions appear).
"""

from __future__ import annotations

import numpy as np
import torch

from gigapose_tpu_torch.utils.device import resolve_device

__all__ = [
    "mssd_error",
    "mspd_error",
    "add_error",
    "adds_error",
    "vsd_error",
    "auc_posecnn",
    "angular_error_deg",
]


def as_f32(a, device) -> torch.Tensor:
    """a (numpy, a Python sequence or a tensor) as an f32 tensor on device."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def _transform(R, t, pts):
    """(…,3,3),(…,3),(N,3) -> (…,N,3)."""
    return torch.einsum("...ij,nj->...ni", R, pts) + t[..., None, :]


def _gt_under_symmetries(R_g, t_g, sym_R, sym_t, pts):
    # gt pose composed with each symmetry: x -> R_g (S_R x + S_t) + t_g
    return _transform(R_g @ sym_R, (R_g @ sym_t[..., None])[..., 0] + t_g, pts)


def _project(K, pts):
    """(3,3), (…,N,3) -> (…,N,2)."""
    uvw = torch.einsum("ij,...nj->...ni", K, pts)
    return uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-9)


def _mssd(R_e, t_e, R_g, t_g, sym_R, sym_t, pts):
    gt = _gt_under_symmetries(R_g, t_g, sym_R, sym_t, pts)
    est = _transform(R_e, t_e, pts)  # (N,3)
    d = torch.linalg.vector_norm(est[None] - gt, dim=-1)  # (S,N)
    return d.amax(1).amin()  # max over verts, min over syms


def _mspd(R_e, t_e, R_g, t_g, sym_R, sym_t, pts, K):
    gt = _project(K, _gt_under_symmetries(R_g, t_g, sym_R, sym_t, pts))  # (S,N,2)
    est = _project(K, _transform(R_e, t_e, pts))
    d = torch.linalg.vector_norm(est[None] - gt, dim=-1)
    return d.amax(1).amin()


def _add(R_e, t_e, R_g, t_g, pts):
    return torch.linalg.vector_norm(_transform(R_e, t_e, pts) - _transform(R_g, t_g, pts),
                                    dim=-1).mean()


def _adds(R_e, t_e, R_g, t_g, pts):
    est = _transform(R_e, t_e, pts)
    gt = _transform(R_g, t_g, pts)
    # chamfer from gt to the closest est point (bop_toolkit 'adi' direction)
    d = torch.linalg.vector_norm(gt[:, None, :] - est[None, :, :], dim=-1)  # (N,N)
    return d.amin(1).mean()


def _run(fn, *args, device=None) -> float:
    dev = resolve_device(device, "the pose errors")
    with torch.inference_mode():
        return float(fn(*[as_f32(a, dev) for a in args]))


def _default_syms(sym_R, sym_t):
    if sym_R is None:
        return np.eye(3)[None], np.zeros((1, 3))
    return sym_R, sym_t


def mssd_error(R_e, t_e, R_g, t_g, pts, sym_R=None, sym_t=None, device=None) -> float:
    """Maximum Symmetry-aware Surface Distance (BOP19), mm."""
    sym_R, sym_t = _default_syms(sym_R, sym_t)
    return _run(_mssd, R_e, t_e, R_g, t_g, sym_R, sym_t, pts, device=device)


def mspd_error(R_e, t_e, R_g, t_g, pts, K, sym_R=None, sym_t=None, device=None) -> float:
    """Maximum Symmetry-aware Projection Distance (BOP19), px (un-normalized:
    the caller scales thresholds by im_width/640 per the BOP19 protocol)."""
    sym_R, sym_t = _default_syms(sym_R, sym_t)
    return _run(_mspd, R_e, t_e, R_g, t_g, sym_R, sym_t, pts, K, device=device)


def add_error(R_e, t_e, R_g, t_g, pts, device=None) -> float:
    return _run(_add, R_e, t_e, R_g, t_g, pts, device=device)


def adds_error(R_e, t_e, R_g, t_g, pts, device=None) -> float:
    return _run(_adds, R_e, t_e, R_g, t_g, pts, device=device)


def angular_error_deg(R_e, R_g) -> float:
    cos = (np.trace(np.asarray(R_e).T @ np.asarray(R_g)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def depth_im_to_dist_im(depth_im: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Depth (z along the optical axis) -> distance from the camera center,
    bop_toolkit misc.depth_im_to_dist_im_fast: dist = z * ||((u-cx)/fx,
    (v-cy)/fy, 1)||. Zero (invalid/background) stays zero."""
    d = np.asarray(depth_im, np.float64)
    K = np.asarray(K, np.float64)
    h, w = d.shape
    xs = (np.arange(w, dtype=np.float64) - K[0, 2]) / K[0, 0]
    ys = (np.arange(h, dtype=np.float64) - K[1, 2]) / K[1, 1]
    norm = np.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2 + 1.0)
    return d * norm


def vsd_error(depth_est: np.ndarray, depth_gt: np.ndarray, depth_test: np.ndarray,
              delta: float = 15.0, taus=(20.0,), K: np.ndarray = None) -> np.ndarray:
    """Visible Surface Discrepancy (BOP19 'step' cost), host numpy f64.

    depth_est / depth_gt: rendered object depth (mm, 0 = background) at the
    estimated / ground-truth pose; depth_test: the captured scene depth (mm,
    0 = invalid). A rendered pixel is visible where the scene depth is
    invalid or the render lies within delta behind it (bop_toolkit
    visib_mode='bop19'); the estimate is also visible on the rendered
    pixels where the gt is. With K, all three depth images are first
    converted to distance images (depth_im_to_dist_im), as bop_toolkit's
    vsd() does. -> one error per tau in [0, 1]; 1 where both visibility
    masks are empty."""
    if K is not None:
        depth_est = depth_im_to_dist_im(depth_est, K)
        depth_gt = depth_im_to_dist_im(depth_gt, K)
        depth_test = depth_im_to_dist_im(depth_test, K)
    d_e = np.asarray(depth_est, np.float64)
    d_g = np.asarray(depth_gt, np.float64)
    d_t = np.asarray(depth_test, np.float64)

    def visib(d):
        rendered = d > 0
        no_meas = d_t <= 0
        return rendered & (no_meas | (d <= d_t + delta))

    v_g = visib(d_g)
    v_e = visib(d_e) | ((d_e > 0) & v_g)
    union = v_e | v_g
    n_union = int(union.sum())
    errs = []
    for tau in taus:
        if n_union == 0:
            errs.append(1.0)
            continue
        both = v_e & v_g
        diff_ok = both & (np.abs(d_e - d_g) <= tau)
        errs.append(1.0 - diff_ok.sum() / n_union)
    return np.asarray(errs)


def auc_posecnn(errors: np.ndarray, max_err: float = 0.1) -> float:
    """PoseCNN-style ADD AUC up to max_err: the area under the monotonized
    accuracy-vs-error step curve, normalized by max_err; errors above
    max_err count as never correct; nan when none is at most max_err."""
    errors = np.sort(np.asarray(errors, np.float64))
    n = errors.shape[0]
    if n == 0:
        return float("nan")
    acc = np.arange(1, n + 1) / n
    keep = errors <= max_err
    if not keep.any():
        return float("nan")
    rec = np.concatenate(([0.0], errors[keep], [max_err]))
    prec = np.concatenate(([0.0], acc[keep], [acc[keep][-1]]))
    prec = np.maximum.accumulate(prec)
    ids = np.where(rec[1:] != rec[:-1])[0] + 1
    return float(((rec[ids] - rec[ids - 1]) * prec[ids]).sum() / max_err)
