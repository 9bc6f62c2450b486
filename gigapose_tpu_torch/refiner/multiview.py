"""Multi-view hypothesis cameras of the MegaPose refiner (port of
gigapose_tpu/refiner/multiview.py, host numpy in f64).

Given an object pose hypothesis TCO and its reference point tCR, place
virtual cameras on a sphere of radius |tCR| around the original camera,
each looking at the reference point with the original camera's up vector,
and return the object pose in each virtual camera's frame (the reference's
make_TCO_multiview, which PosePredictor.forward renders from). The look-at
algebra is closed-form in the CV camera convention (+x right, +y down, +z
forward); the offset tables are the reference's Panda3D ones (x right, y
forward, z up) converted once to CV axes: (x, y, z) -> (x, -z, y).
"""

from __future__ import annotations

import numpy as np

# Offsets in the "camera pointing at the reference point" frame, CV axes
# (right, down, forward), scaled by |tCR| at use time. Converted from the
# reference's Panda3D-frame tables via (x, y, z)_p3d -> (x, -z, y).
_FRONT_1 = np.array([[0.0, 0.0, 0.0]])
_FRONT_3 = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
_FRONT_5 = np.array(
    [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
     [0.0, -1.0, 0.0], [0.0, 1.0, 0.0]]
)


def _sphere_26() -> np.ndarray:
    """The 26-neighbourhood offsets, converted to CV axes."""
    out = []
    for y in (0, 1, 2):
        for x in (0, -1, 1):
            for z in (0, 1, -1):
                if x == 0 and y == 1 and z == 0:
                    continue
                out.append([float(x), float(-z), float(y)])
    return np.array(out)


_OFFSETS = {
    "TCO+front_1view": _FRONT_1,
    "TCO+front_3views": _FRONT_3,
    "TCO+front_5views": _FRONT_5,
    "sphere_26views": _sphere_26(),
}


def look_at_cv(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Rotation whose columns are the axes of a CV camera at `eye` looking at
    `target` with up-hint `up` (all in the parent frame)."""
    z = target - eye
    zn = np.linalg.norm(z)
    if zn < 1e-12:
        return np.eye(3)
    z = z / zn
    x = np.cross(-up, z)
    xn = np.linalg.norm(x)
    if xn < 1e-12:  # degenerate: view direction parallel to up
        x = np.cross(z, np.array([1.0, 0.0, 0.0]))
        xn = np.linalg.norm(x)
        if xn < 1e-12:
            x = np.array([0.0, 1.0, 0.0])
            xn = 1.0
    x = x / xn
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


def make_TCO_multiview(
    TCO: np.ndarray,  # (B, 4, 4)
    tCR: np.ndarray,  # (B, 3)
    multiview_type: str = "TCO+front_3views",
    n_views: int = 1,
    remove_TCO_rendering: bool = False,
    views_inplane_rotations: bool = False,
) -> np.ndarray:
    """(B, n_total, 4, 4) object pose per virtual camera.

    n_views == 1 short-circuits to the original camera only (the reference's
    first branch, multiview.py:190-197) regardless of multiview_type. View 0
    is the original camera unless remove_TCO_rendering.
    """
    TCO = np.asarray(TCO, np.float64)
    tCR = np.asarray(tCR, np.float64)
    B = TCO.shape[0]
    if n_views == 1:
        TCV_O = TCO[:, None]
        if views_inplane_rotations:
            raise ValueError("views_inplane_rotations requires n_views > 1")
        return TCV_O

    offsets = _OFFSETS.get(multiview_type)
    if offsets is None:
        raise ValueError(f"unknown multiview_type {multiview_type!r}")
    up = np.array([0.0, -1.0, 0.0])  # CV camera up = -y

    TCV_O = []
    for b in range(B):
        r = tCR[b]
        radius = np.linalg.norm(r)
        if not np.isfinite(radius) or radius < 1e-9:
            # NaN/degenerate pose: reference falls back to identity cameras
            # (multiview.py:44-46 guards !isfinite)
            views = [TCO[b]] * (len(offsets) + (0 if remove_TCO_rendering else 1))
            TCV_O.append(np.stack(views))
            continue
        R_point = look_at_cv(np.zeros(3), r, up)
        views = [] if remove_TCO_rendering else [TCO[b]]
        for off in offsets:
            p_v = R_point @ (off * radius)
            R_v = look_at_cv(p_v, r, up)
            T_c0_cv = np.eye(4)
            T_c0_cv[:3, :3] = R_v
            T_c0_cv[:3, 3] = p_v
            views.append(np.linalg.inv(T_c0_cv) @ TCO[b])
        TCV_O.append(np.stack(views))
    out = np.stack(TCV_O)

    if views_inplane_rotations:
        if not remove_TCO_rendering:
            raise ValueError(
                "views_inplane_rotations requires remove_TCO_rendering "
                "(reference asserts the same, multiview.py:240)"
            )
        Bv, V = out.shape[:2]
        reps = np.repeat(out[:, :, None], 4, axis=2)  # (B, V, 4, 4, 4)
        for idx, angle in enumerate((np.pi / 2, np.pi, 3 * np.pi / 2), start=1):
            c, s = np.cos(angle), np.sin(angle)
            dR = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            reps[:, :, idx, :3, :3] = dR @ reps[:, :, idx, :3, :3]
        out = reps.reshape(Bv, V * 4, 4, 4)
    return out


def multiview_tCR(TCV_O: np.ndarray) -> np.ndarray:
    """(B, V, 4, 4) -> (B, V, 3): reference point (object origin) position in
    each virtual camera frame (pose_rigid.py:556-560 with tOR = 0)."""
    return TCV_O[..., :3, 3].copy()
