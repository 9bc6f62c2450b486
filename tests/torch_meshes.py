"""Seeded meshes and views for the rasterizer's tests (CPU and card).

Each mesh is (verts (V, 3) f32 in metres, faces (F, 3) int32, colors (V, 3)
f32 in [0, 255]); `views` stacks B views of one mesh at 0.5 m in front of a
camera of focal length 572 px (about 1,100 px per metre there), with the
special views the cull must survive: one across the camera plane, one
edge-on to the cube's faces, one with the object partly off the view.
"""

import numpy as np
import torch
from scipy.spatial.transform import Rotation

K = np.array([[572.4114, 0, 40], [0, 573.57043, 32], [0, 0, 1.0]], np.float32)


def _colors(rng, n):
    return rng.uniform(0, 255, (n, 3)).astype(np.float32)


def cube():
    s = 0.04
    verts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)], np.float32)
    faces = np.array([(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
                      (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)], np.int32)
    return verts, faces, (verts / s * 100 + 128).astype(np.float32)


def soup(seed, n_verts=300, n_faces=2000):
    """Random triangles over a 3 cm cloud: long, crossing, interpenetrating."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(0, 0.03, (n_verts, 3)).astype(np.float32)
    faces = np.stack([rng.choice(n_verts, 3, replace=False) for _ in range(n_faces)])
    return verts, faces.astype(np.int32), _colors(rng, n_verts)


def slivers(seed, n=600):
    """Triangles with one edge of 1e-7-8e-7 m (about 1e-4-1e-3 px at 0.5 m)
    and two of about 1 cm, and as many needles: three nearly collinear
    vertices 1e-7-1e-6 m off their line, every edge long."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 0.02, (n, 3))
    b = a + rng.normal(0, 0.01, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = b + d * rng.uniform(1e-7, 8e-7, (n, 1))
    p = rng.normal(0, 0.02, (n, 3))
    q = p + rng.normal(0, 0.015, (n, 3))
    r = p + (q - p) * rng.uniform(0.1, 0.9, (n, 1)) + d * rng.uniform(1e-7, 1e-6, (n, 1))
    verts = np.concatenate([a, b, c, p, q, r]).astype(np.float32)
    i = np.arange(n)
    faces = np.concatenate([np.stack([i, i + n, i + 2 * n], 1),
                            np.stack([i + 3 * n, i + 4 * n, i + 5 * n], 1)])
    return verts, faces.astype(np.int32), _colors(rng, len(verts))


def subpixel(seed, n=1500):
    """Triangles of 1e-5-5e-4 m (about 0.01-0.5 px): most cover no pixel
    centre, some one."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 0.02, (n, 1, 3))
    verts = (a + rng.normal(0, 1, (n, 3, 3)) * rng.uniform(1e-5, 5e-4, (n, 1, 1)))
    faces = np.arange(3 * n).reshape(n, 3)
    return verts.reshape(-1, 3).astype(np.float32), faces.astype(np.int32), \
        _colors(rng, 3 * n)


def coincident(seed):
    """The cube's faces twice over, the second copy with the winding
    reversed, and one face four times: every covered pixel ties in depth."""
    verts, faces, colors = cube()
    faces = np.concatenate([faces, faces[:, ::-1], np.repeat(faces[3:4], 4, 0)])
    return verts, np.ascontiguousarray(faces), colors


def sphere(seed, n=71, radius=0.04):
    """A closed latitude-longitude sphere of 2 n (n - 1) faces (9,940 at
    n = 71), displaced by seeded waves; thin faces at the poles."""
    rng = np.random.default_rng(seed)
    th, ph = np.meshgrid(np.linspace(0, np.pi, n + 1)[1:-1],
                         np.linspace(0, 2 * np.pi, n, endpoint=False), indexing="ij")
    r = 1 + 0.05 * np.sin(3 * th) * np.cos(4 * ph)
    ring = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)],
                    -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, 1]], ring, [[0, 0, -1]]]) * radius
    j, jn = np.arange(n), (np.arange(n) + 1) % n
    ringv = lambda i, jj: 1 + i * n + jj
    faces = [np.stack([np.zeros(n, int), ringv(0, j), ringv(0, jn)], 1)]
    for i in range(n - 2):
        a, b, c, d = ringv(i, j), ringv(i, jn), ringv(i + 1, j), ringv(i + 1, jn)
        faces += [np.stack([a, c, b], 1), np.stack([b, c, d], 1)]
    last = 1 + (n - 1) * n
    faces.append(np.stack([np.full(n, last), ringv(n - 2, jn), ringv(n - 2, j)], 1))
    return verts.astype(np.float32), np.concatenate(faces).astype(np.int32), \
        _colors(rng, len(verts))


def needles(seed, n=400):
    """Screen-space needles (vertices (x, y, 1) in pixels, for K = T = I):
    an edge from a pixel centre along an integer step, so that it passes
    exactly through pixel centres where rounding alone decides the inside
    test, and the third vertex 1e-6-1e-2 px off that edge; a quarter reach
    out to 300 px beyond the view."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-8, 72, (n, 2)) + 0.5
    step = rng.integers(-5, 6, (n, 2))
    step[(step == 0).all(1)] = (1, 1)
    reach = np.where(rng.random(n) < 0.25, rng.integers(20, 60, n), rng.integers(2, 12, n))
    b = a + step * reach[:, None]
    perp = np.stack([-step[:, 1], step[:, 0]], 1) / np.linalg.norm(step, axis=1, keepdims=True)
    c = a + (b - a) * rng.uniform(0.05, 0.95, (n, 1)) \
        + perp * (rng.choice([-1, 1], (n, 1)) * 10.0 ** rng.uniform(-6, -2, (n, 1)))
    xy = np.concatenate([a, b, c])
    verts = np.concatenate([xy, np.ones((3 * n, 1))], 1).astype(np.float32)
    faces = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], 1)
    return verts, faces.astype(np.int32), _colors(rng, 3 * n)


MESHES = dict(cube=lambda: cube(), soup=lambda: soup(3), slivers=lambda: slivers(4),
              subpixel=lambda: subpixel(5), coincident=lambda: coincident(6),
              sphere=lambda: sphere(7), needles=lambda: needles(8))
# meshes given in screen pixels, seen through K = T = I
SCREEN = ("needles",)


def views(name, B, seed, pad=64):
    """B views of MESHES[name], faces padded with (0, 0, 0) rows to a
    multiple of pad: random poses at 0.5 m; view 0 across the camera plane
    (the object 1 cm in front of it), the last edge-on to the cube's faces,
    view 1 (for B > 2) with the object 5 cm to the side, partly off the
    view. A screen-space mesh is seen through K = I and T = I shifted by
    b / (4 B) px in x and y in view b. -> (verts, faces, colors, K, T) CPU
    tensors, batched."""
    verts, faces, colors = MESHES[name]()
    faces = np.concatenate([faces, np.zeros(((-len(faces)) % pad, 3), np.int32)])
    rep = lambda a: torch.from_numpy(np.ascontiguousarray(np.repeat(a[None], B, 0)))
    if name in SCREEN:
        T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        T[:, 0, 3] = T[:, 1, 3] = np.arange(B) / (4 * B)
        return rep(verts), rep(faces), rep(colors), rep(np.eye(3, dtype=np.float32)), \
            torch.from_numpy(T)
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = Rotation.random(B, random_state=seed).as_matrix()
    T[:, :3, 3] = rng.normal(0, 0.01, (B, 3)) + [0, 0, 0.5]
    T[-1, :3, :3] = Rotation.from_euler("x", 90, degrees=True).as_matrix()
    if B > 2:
        T[1, 0, 3] = 0.05
    T[0, 2, 3] = 0.01
    return rep(verts), rep(faces), rep(colors), rep(K), torch.from_numpy(T)
