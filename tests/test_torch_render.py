"""The port's mesh readers and rasterizers against the JAX package's, CPU.

- render/mesh_io.py against jax_renderer.load_mesh and refiner._load_vertices
  on ascii PLY, binary PLY and OBJ with quads: exact.
- render/rasterizer.py (the port's copy of the C++ rasterizer, built with the
  same compiler and flags) against render/rasterizer.py of the JAX package
  on the cube and on a seeded random mesh: rgba, depth and normals
  bit-identical.
- render/rasterize.py's plain version against jax_renderer.rasterize over a
  batch of poses (edge-on faces, faces behind the camera): masks equal on at
  least 99.9 % of the pixels, and where both hit the same face (equal
  normals, depth within 1e-5 relative) on at least 99.9 %; rgb within 1 step
  (1/255). The two agree to the ulp but not bit for bit: JAX transforms the
  vertices with a matmul, the port with the kernel's explicit sums.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax.numpy as jnp
from gigapose_tpu.refiner.refiner import _load_vertices
from gigapose_tpu.render import jax_renderer as JR
from gigapose_tpu.render.rasterizer import Rasterizer as JaxRasterizer
from gigapose_tpu_torch.render import mesh_io
from gigapose_tpu_torch.render.rasterize import PLAIN_CHUNK, rasterize
from gigapose_tpu_torch.render.rasterizer import Rasterizer
from tests.test_rasterizer import _write_cube_ply

K = np.array([[572.4114, 0, 320], [0, 573.57043, 240], [0, 0, 1.0]], np.float32)


def _random_mesh(seed, n_verts=60, n_faces=120):
    """A seeded triangle soup around the origin (m), with colours."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(0, 0.03, (n_verts, 3)).astype(np.float32)
    faces = np.stack([rng.choice(n_verts, 3, replace=False) for _ in range(n_faces)]).astype(np.int32)
    colors = rng.integers(0, 256, (n_verts, 3)).astype(np.uint8)
    return verts, faces, colors


def _write_ply(path, verts, faces, colors, binary):
    header = (f"ply\nformat {'binary_little_endian' if binary else 'ascii'} 1.0\n"
              "comment written by the test\n"
              f"element vertex {len(verts)}\nproperty float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              f"element face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            v = np.empty(len(verts), [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                      ("r", "u1"), ("g", "u1"), ("b", "u1")])
            v["x"], v["y"], v["z"] = verts.T
            v["r"], v["g"], v["b"] = colors.T
            fr = np.empty(len(faces), [("n", "u1"), ("i", "<i4", (3,))])
            fr["n"], fr["i"] = 3, faces
            f.write(v.tobytes() + fr.tobytes())
        else:
            for p, c in zip(verts, colors):
                f.write(f"{float(p[0])!r} {float(p[1])!r} {float(p[2])!r} {c[0]} {c[1]} {c[2]}\n".encode())
            for a in faces:
                f.write(f"3 {a[0]} {a[1]} {a[2]}\n".encode())


@pytest.fixture
def meshes(tmp_path):
    cube = str(tmp_path / "cube.ply")
    _write_cube_ply(cube, size=0.08)
    soup = _random_mesh(3)
    ascii_ply, binary_ply = str(tmp_path / "soup.ply"), str(tmp_path / "soup_bin.ply")
    _write_ply(ascii_ply, *soup, binary=False)
    _write_ply(binary_ply, *soup, binary=True)
    obj = str(tmp_path / "quads.obj")
    with open(obj, "w") as f:  # a unit square of two quads, vertex colours on some lines
        f.write("# quads\nv 0 0 0 1 0 0\nv 1 0 0 0 1 0\nv 1 1 0 0 0 1\nv 0 1 0 1 1 1\n"
                "v 2 0 0 0.5 0.5 0.5\nv 2 1 0 0.2 0.4 0.6\nf 1/1 2/2 3/3 4/4\nf 2 5 6 3\n")
    return dict(cube=cube, ascii=ascii_ply, binary=binary_ply, obj=obj)


@pytest.mark.parametrize("kind", ["cube", "ascii", "binary", "obj"])
def test_mesh_io_matches_jax_readers(meshes, kind):
    got, want = mesh_io.load_mesh(meshes[kind]), JR.load_mesh(meshes[kind])
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w)
    gv, wv = mesh_io.load_vertices(meshes[kind]), _load_vertices(meshes[kind])
    assert gv.dtype == wv.dtype == np.float64 and np.array_equal(gv, wv)
    if kind == "obj":
        assert len(got[1]) == 4  # two quads, fan-triangulated


def _poses(n, seed, z=0.5):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = Rotation.random(n, random_state=seed).as_matrix()
    T[:, :3, 3] = rng.normal(0, 0.02, (n, 3)) + [0, 0, z]
    return T


@pytest.mark.parametrize("kind", ["cube", "binary"])
def test_host_rasterizer_is_bit_identical_to_jax(meshes, kind):
    mine, ref = Rasterizer(meshes[kind]), JaxRasterizer(meshes[kind])
    assert mine.diameter == ref.diameter and mine.num_vertices == ref.num_vertices
    assert np.array_equal(mine.center, ref.center)
    Kc = K.copy()
    Kc[:2, 2] = [80, 60]
    for T in _poses(3, 5):
        for got, want in zip(mine.render_full(Kc, T, 160, 120), ref.render_full(Kc, T, 160, 120)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert (got != 0).any()
    nan = np.full((4, 4), np.nan, np.float32)
    rgba, depth, nrm = mine.render_full(K, nan, 16, 8)
    assert not rgba.any() and not depth.any() and not nrm.any()


def _batch(verts, faces, colors, B, seed, chunk=16):
    """B copies of a mesh, faces padded with (0, 0, 0) to a multiple of chunk,
    and B poses: the last one edge-on to a face plane of the cube (rotation
    about x by 90 degrees), and the object straddling the camera plane in
    one view (faces behind the camera)."""
    pad = (-len(faces)) % chunk
    faces = np.concatenate([faces, np.zeros((pad, 3), np.int32)])
    T = _poses(B, seed)
    T[-1, :3, :3] = Rotation.from_euler("x", 90, degrees=True).as_matrix()
    T[-1, :3, 3] = [0.0, 0.0, 0.4]
    T[0, 2, 3] = 0.01  # straddles z = 0
    rep = lambda a: torch.from_numpy(np.ascontiguousarray(np.repeat(a[None], B, 0)))
    Kc = K.copy()
    Kc[:2, 2] = [40, 32]
    return (rep(verts), rep(faces), rep(colors.astype(np.float32)), rep(Kc),
            torch.from_numpy(T)), faces


@pytest.mark.parametrize("kind", ["cube", "binary"])
def test_plain_rasterizer_matches_jax(meshes, kind):
    verts, faces, colors = mesh_io.load_mesh(meshes[kind])
    args, padded = _batch(verts, faces, colors, B=4, seed=7)
    H, W = 64, 80
    got = rasterize(*args, H, W)  # CPU tensors: the plain version
    masks = same = total = 0
    rgb_steps = 0
    for b in range(args[0].shape[0]):
        want = JR.rasterize(jnp.asarray(verts), jnp.asarray(padded), jnp.asarray(args[2][b]),
                            jnp.asarray(args[3][b]), jnp.asarray(args[4][b]),
                            width=W, height=H, chunk=16)
        w_rgba, w_depth, w_nrm = (np.asarray(want[k]) for k in ("rgba", "depth", "normals"))
        g_rgba, g_depth, g_nrm = (got[k][b].numpy() for k in ("rgba", "depth", "normals"))
        hit_g, hit_w = g_rgba[..., 3] > 0, w_rgba[..., 3] > 0
        masks += (hit_g == hit_w).sum()
        both = hit_g & hit_w
        face = both & (np.abs(g_nrm - w_nrm).max(-1) <= 1e-5) \
            & (np.abs(g_depth - w_depth) <= 1e-5 * np.abs(w_depth))
        same += face.sum() + (~hit_g & ~hit_w).sum()
        total += H * W
        rgb_steps = max(rgb_steps, int(np.abs(g_rgba[face].astype(int) - w_rgba[face]).max(initial=0)))
        assert hit_w.any() and (w_depth[~hit_w] == 0).all() and (g_depth[~hit_g] == 0).all()
    assert masks / total >= 0.999 and same / total >= 0.999, (masks / total, same / total)
    assert rgb_steps <= 1


@pytest.mark.parametrize("faces,chunk", [([[0, 0, 0], [0, 1, 2], [0, 1, 2]], 4),
                                         ([[0, 0, 0], [0, 1, 2], [0, 0, 0], [0, 1, 2]], 2)])
def test_plain_rasterizer_face_ids_are_first_of_equal_depth(faces, chunk):
    """Two coincident triangles, in one chunk of the plain version's scan
    and, where `chunk` splits the faces, in two (padding moves the second
    triangle to index PLAIN_CHUNK): every pixel goes to the first (face 1);
    degenerate (0, 0, 0) faces never win."""
    if chunk < len(faces):
        faces = faces[:2] + [[0, 0, 0]] * (PLAIN_CHUNK - 2) + faces[3:]
    v = np.array([[-0.05, -0.05, 0], [0.05, -0.05, 0], [0, 0.05, 0]], np.float32)
    T = torch.eye(4)[None]
    T[0, 2, 3] = 0.5
    Kc = torch.tensor(K)[None].clone()
    Kc[0, :2, 2] = 16
    out = rasterize(torch.tensor(v)[None], torch.tensor([faces], dtype=torch.int32),
                    torch.full((1, 3, 3), 100.0), Kc, T, 32, 32)
    hit = out["rgba"][0, ..., 3] > 0
    assert hit.sum() > 50 and (out["face_id"][0][hit] == 1).all()
    assert (out["face_id"][0][~hit] == 0).all()
