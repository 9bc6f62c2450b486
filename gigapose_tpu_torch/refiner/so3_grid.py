"""Deterministic SO(3) hypothesis grids of the coarse classifier (port of
gigapose_tpu/refiner/so3_grid.py).

MegaPose's coarse model scores every rotation of a fixed SO(3) grid per
detection. The grids are public data from "Generating Uniform Incremental
Grids on SO(3) Using the Hopf Fibration" (Yershova et al.), tables of (x, y,
z, w) quaternions; the 72- and 576-point tables are vendored under
gigapose_tpu_torch/assets/ unchanged, because the released checkpoints'
hypothesis ids index their row order.
"""

from __future__ import annotations

import os

import numpy as np

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")


def quat_xyzw_to_matrix(q: np.ndarray) -> np.ndarray:
    """(..., 4) unit quaternions in (x, y, z, w) order -> (..., 3, 3)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - z * w)
    R[..., 0, 2] = 2 * (x * z + y * w)
    R[..., 1, 0] = 2 * (x * y + z * w)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - x * w)
    R[..., 2, 0] = 2 * (x * z - y * w)
    R[..., 2, 1] = 2 * (y * z + x * w)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def load_so3_grid(resolution: int = 576) -> np.ndarray:
    """(N, 3, 3) f64 rotation matrices, N == resolution, in the table's row
    order (the reference's load_SO3_grid)."""
    path = os.path.join(_ASSET_DIR, f"so3_grid_{resolution}.qua")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no SO(3) grid asset for resolution {resolution} "
            f"(have: {sorted(os.listdir(_ASSET_DIR))})"
        )
    quats = np.loadtxt(path)
    if quats.shape != (resolution, 4):
        raise ValueError(f"{path}: {quats.shape} entries, not ({resolution}, 4)")
    return quat_xyzw_to_matrix(quats)
