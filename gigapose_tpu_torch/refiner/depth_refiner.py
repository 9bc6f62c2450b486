"""Depth-based pose refinement (port of gigapose_tpu/refiner/depth_refiner.py).

- DepthRefiner: the `refine_pose(TCO, depth, K, label) -> (TCO, error)`
  interface.
- ICPDepthRefiner: point-to-point ICP between the model's depth rendered at
  the predicted pose (the host C++ rasterizer, render/rasterizer.py) and the
  observed depth, one Kabsch / Umeyama solve per iteration; numpy in f64 on
  the host (a per-detection tail step, not a throughput path).
- TeaserppRefiner: raises unless the `teaserpp_python` native binding is
  importable, as in the JAX package.

No CLI calls it, in either package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from gigapose_tpu_torch.render.rasterizer import Rasterizer


def backproject_depth(depth: np.ndarray, K: np.ndarray, stride: int = 4,
                      max_points: int = 2000) -> np.ndarray:
    """(H, W) depth -> (N, 3) camera-space points (zero depths skipped)."""
    H, W = depth.shape
    ys, xs = np.mgrid[0:H:stride, 0:W:stride]
    d = depth[ys, xs]
    ok = d > 1e-6
    xs, ys, d = xs[ok], ys[ok], d[ok]
    x = (xs - K[0, 2]) / K[0, 0] * d
    y = (ys - K[1, 2]) / K[1, 1] * d
    pts = np.stack([x, y, d], axis=1)
    if len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[idx]
    return pts


def kabsch_umeyama(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rigid transform T (4x4) minimizing ||T(src) - dst||."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_d - R @ mu_s
    return T


class DepthRefiner:
    """The interface of a depth refiner."""

    def refine_pose(self, TCO: np.ndarray, depth: np.ndarray, K: np.ndarray,
                    label: int) -> Tuple[np.ndarray, float]:
        raise NotImplementedError


@dataclasses.dataclass
class ICPDepthRefiner(DepthRefiner):
    """Rendered depth -> observed depth ICP."""

    rasterizers: Dict[int, Rasterizer]
    unit_to_m: Dict[int, float]  # mesh unit in metres per label
    n_iterations: int = 10
    max_correspondence_dist: float = 0.02  # meters
    render_size: Tuple[int, int] = (480, 640)

    def refine_pose(self, TCO, depth, K, label):
        r = self.rasterizers[int(label)]
        scale = self.unit_to_m[int(label)]
        pose = TCO.copy()
        pose[:3, 3] /= scale
        H, W = self.render_size
        _, rend_depth = r.render(K, pose, W, H)
        src = backproject_depth(rend_depth * scale, K)  # model surface (pred pose)
        dst_all = backproject_depth(depth, K)
        if len(src) < 10 or len(dst_all) < 10:
            return TCO, np.inf
        T_total = np.eye(4)
        cur = src.copy()
        err = np.inf
        for _ in range(self.n_iterations):
            # nearest neighbors (brute force; point counts are small)
            d2 = ((cur[:, None] - dst_all[None]) ** 2).sum(-1)
            nn = d2.argmin(1)
            dist = np.sqrt(d2[np.arange(len(cur)), nn])
            ok = dist < self.max_correspondence_dist
            if ok.sum() < 10:
                break
            T = kabsch_umeyama(cur[ok], dst_all[nn[ok]])
            cur = (T[:3, :3] @ cur.T).T + T[:3, 3]
            T_total = T @ T_total
            err = float(dist[ok].mean())
        out = TCO.copy()
        out[:3, :3] = T_total[:3, :3] @ TCO[:3, :3]
        out[:3, 3] = T_total[:3, :3] @ TCO[:3, 3] + T_total[:3, 3]
        return out, err


class TeaserppRefiner(DepthRefiner):
    """TEASER++ global registration: an optional native dependency, the same
    interface."""

    def __init__(self, *args, **kwargs):
        try:
            import teaserpp_python  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "TeaserppRefiner needs the teaserpp_python native binding "
                "(github.com/MIT-SPARK/TEASER-plusplus); use ICPDepthRefiner "
                "otherwise"
            ) from e
