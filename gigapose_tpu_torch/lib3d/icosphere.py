"""Icosphere template viewpoints (numpy; port of gigapose_tpu/lib3d/icosphere.py).

The reference regenerates the pose assets of the original GigaPose from
Blender's canonical icosahedron plus edge-midpoint subdivision simulated in
float32, sorted by (elevation, azimuth) with azimuth = atan2(x, y). This is the
same arithmetic, so the port's template poses equal the JAX package's bit for
bit (tests/test_torch_ops.py). level 0 -> 42 views, 1 -> 162, 2 -> 642.
"""

from __future__ import annotations

import functools
import math

import numpy as np

RADIUS_MM = 1000.0

# Blender's canonical icosahedron (mesh-primitive vertex table, radius 200)
_BLENDER_ICOVERT = np.array(
    [
        [0.0, 0.0, -200.0],
        [144.72, -105.144, -89.443],
        [-55.277, -170.128, -89.443],
        [-178.885, 0.0, -89.443],
        [-55.277, 170.128, -89.443],
        [144.72, 105.144, -89.443],
        [55.277, -170.128, 89.443],
        [-144.72, -105.144, 89.443],
        [-144.72, 105.144, 89.443],
        [55.277, 170.128, 89.443],
        [178.885, 0.0, 89.443],
        [0.0, 0.0, 200.0],
    ],
    dtype=np.float64,
)
_BLENDER_ICOFACE = [
    (0, 1, 2), (1, 0, 5), (0, 2, 3), (0, 3, 4), (0, 4, 5),
    (1, 5, 10), (2, 1, 6), (3, 2, 7), (4, 3, 8), (5, 4, 9),
    (1, 10, 6), (2, 6, 7), (3, 7, 8), (4, 8, 9), (5, 9, 10),
    (6, 10, 11), (7, 6, 11), (8, 7, 11), (9, 8, 11), (10, 9, 11),
]

_f32 = np.float32


def _subdivide_f32(verts, faces, spherize: bool):
    """One round of edge-midpoint subdivision in float32. spherize=True
    renormalizes each new midpoint at once (Blender's primitive); False keeps
    raw midpoints (normalized afterwards by _script_normalize)."""
    verts = [v.copy() for v in verts]
    cache: dict[tuple[int, int], int] = {}

    def midpoint(i: int, j: int) -> int:
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = ((verts[key[0]] + verts[key[1]]) * _f32(0.5)).astype(_f32)
            if spherize:
                m = (m / _f32(np.linalg.norm(m.astype(np.float64)))).astype(_f32)
            cache[key] = len(verts)
            verts.append(m)
        return cache[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
    return np.stack(verts), new_faces


def _script_normalize(v: np.ndarray) -> np.ndarray:
    """Per-vertex normalization in Python float64, stored back to float32."""
    out = v.copy()
    for i in range(len(v)):
        norm = math.sqrt(float(v[i, 0]) ** 2 + float(v[i, 1]) ** 2 + float(v[i, 2]) ** 2)
        for c in range(3):
            out[i, c] = _f32(float(v[i, c]) / norm)
    return out


def _look_at(cam_location: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world pose with +z forward (OpenCV-style look-at, with the
    pole fallback of the original template-pose script)."""
    forward = target - cam_location
    forward = forward / np.linalg.norm(forward)
    tmp = np.array([0.0, 0.0, -1.0])
    if min(np.linalg.norm(cam_location - tmp), np.linalg.norm(cam_location + tmp)) < 1e-3:
        tmp = np.array([0.0, -1.0, 0.0])
    right = np.cross(tmp, forward)
    right = right / np.linalg.norm(right)
    up = np.cross(forward, right)
    up = up / np.linalg.norm(up)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, up, forward, cam_location
    return pose


@functools.lru_cache(maxsize=None)
def icosphere_views(level: int = 1) -> np.ndarray:
    """(V, 3) unit-sphere viewpoints sorted by (elevation, atan2(x, y))."""
    verts = (_BLENDER_ICOVERT / 200.0).astype(_f32)
    faces = list(_BLENDER_ICOFACE)
    verts, faces = _subdivide_f32(verts, faces, spherize=True)
    for _ in range(level):
        verts, faces = _subdivide_f32(verts, faces, spherize=False)
        verts = _script_normalize(verts)
    el = [math.atan2(float(z), math.hypot(float(x), float(y))) for x, y, z in verts]
    az = [math.atan2(float(x), float(y)) for x, y, z in verts]
    order = sorted(range(len(verts)), key=lambda i: (el[i], az[i]))
    return verts[order].astype(np.float64)


@functools.lru_cache(maxsize=None)
def template_camera_poses(level: int = 1, radius: float = RADIUS_MM) -> np.ndarray:
    """(V, 4, 4) camera-to-world poses, +z looking at the origin, at `radius`."""
    poses = np.stack([_look_at(v, np.zeros(3)) for v in icosphere_views(level)])
    poses[:, :3, 3] *= radius
    return poses


@functools.lru_cache(maxsize=None)
def template_object_poses(level: int = 1, radius: float = RADIUS_MM) -> np.ndarray:
    """(V, 4, 4) object poses in the camera frame: inverses of the camera poses."""
    cam = template_camera_poses(level, radius)
    obj = np.zeros_like(cam)
    R_t = np.transpose(cam[:, :3, :3], (0, 2, 1))
    obj[:, :3, :3] = R_t
    obj[:, :3, 3] = -np.einsum("vij,vj->vi", R_t, cam[:, :3, 3])
    obj[:, 3, 3] = 1.0
    return obj
