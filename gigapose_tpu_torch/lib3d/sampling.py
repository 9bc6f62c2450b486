"""Viewpoint sampling (port of gigapose_tpu/lib3d/sampling.py; ref:
src/lib3d/farthest_sampling.py:6-77 and template_transform.farthest_sampling
:157-163)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def farthest_point_sampling(points: np.ndarray, num_samples: int,
                            start: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy farthest-point sampling over (N, D) points, from `start`;
    -> (the selected points, their indices)."""
    N = len(points)
    num_samples = min(num_samples, N)
    idx = np.zeros(num_samples, np.int64)
    idx[0] = start
    d = np.linalg.norm(points - points[start], axis=1)
    for i in range(1, num_samples):
        idx[i] = int(np.argmax(d))
        d = np.minimum(d, np.linalg.norm(points - points[idx[i]], axis=1))
    return points[idx], idx


def farthest_viewpoints(obj_poses_cv: np.ndarray, num_views: int) -> np.ndarray:
    """Indices of `num_views` viewing directions by farthest-point sampling
    of the poses' z-rows. The reference samples them after converting to
    OpenGL; that flip is an isometry, so the raw z-rows give the same
    indices."""
    _, idx = farthest_point_sampling(obj_poses_cv[:, 2, :3], num_views)
    return idx
