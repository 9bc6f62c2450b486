"""The CUDA rasterizer (csrc/rasterizer.cu) against its plain PyTorch version,
and the refine loop with the device renderer on the card against the CPU.

Marked `cuda`: each test skips where torch.cuda.is_available() is false (the
decision is taken in the fixture, never at import). Imports no jax, so it
runs on a machine with PyTorch and the CUDA toolkit only:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_render.py -q

The kernel is built with -fmad=false and rounds each product and sum as the
plain version does: hit masks and face ids agree on all but 1e-4 of the
pixels (none here), rgb within 1 step and depth within 1 ulp where both hit
the same face. The refine loop on the card against the CPU: poses and
scores within 1e-3, from cuDNN's convolutions summing in another order than
the CPU's (1e-6 relative), which a uint8 render now and then turns into one
step at a pixel.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gigapose_tpu_torch.render import rasterize as RZ
from gigapose_tpu_torch.refiner.refiner import RefinerConfig, RenderCompareRefiner

pytestmark = pytest.mark.cuda

K = np.array([[572.4114, 0, 40], [0, 573.57043, 32], [0, 0, 1.0]], np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    return torch.device("cuda", 0)


def _cube():
    s = 0.04
    verts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)], np.float32)
    faces = np.array([(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
                      (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)], np.int32)
    return verts, faces, (verts / s * 100 + 128).astype(np.float32)


def _soup(seed, n_verts=300, n_faces=2000):
    rng = np.random.default_rng(seed)
    verts = rng.normal(0, 0.03, (n_verts, 3)).astype(np.float32)
    faces = np.stack([rng.choice(n_verts, 3, replace=False) for _ in range(n_faces)])
    return verts, faces.astype(np.int32), rng.uniform(0, 255, (n_verts, 3)).astype(np.float32)


def _inputs(mesh, B, seed, pad=64):
    """B views of a mesh (faces padded with (0, 0, 0) rows): random poses,
    one edge-on to the cube's faces, one straddling the camera plane."""
    verts, faces, colors = mesh
    faces = np.concatenate([faces, np.zeros(((-len(faces)) % pad, 3), np.int32)])
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = Rotation.random(B, random_state=seed).as_matrix()
    T[:, :3, 3] = rng.normal(0, 0.01, (B, 3)) + [0, 0, 0.5]
    T[-1, :3, :3] = Rotation.from_euler("x", 90, degrees=True).as_matrix()
    T[0, 2, 3] = 0.01
    rep = lambda a: torch.from_numpy(np.ascontiguousarray(np.repeat(a[None], B, 0)))
    return rep(verts), rep(faces), rep(colors), rep(K), torch.from_numpy(T)


def _ulps(got, want):
    _, e = torch.frexp(want)
    return (got - want).abs() / torch.ldexp(torch.ones_like(want), e - 24)


@pytest.mark.parametrize("mesh,size", [("cube", (64, 80)), ("soup", (64, 80)),
                                       ("soup", (37, 53)), ("cube", (160, 160))])
def test_rasterizer_matches_plain(dev, mesh, size):
    args = [a.to(dev) for a in _inputs(_cube() if mesh == "cube" else _soup(3), 6, 5)]
    H, W = size
    before = RZ.rasterize.launches
    got = RZ.rasterize(*args, H, W)
    assert RZ.rasterize.launches == before + 1
    want = RZ.rasterize_plain(*args, H, W)
    torch.cuda.synchronize()
    hit_g, hit_w = got["rgba"][..., 3] > 0, want["rgba"][..., 3] > 0
    same = hit_g & hit_w & (got["face_id"] == want["face_id"])
    mismatch = ((hit_g != hit_w) | (hit_g & hit_w & ~same)).float().mean().item()
    assert hit_w.any() and mismatch <= 1e-4, mismatch
    assert (got["rgba"][..., :3].int() - want["rgba"][..., :3].int()).abs()[same].max() <= 1
    assert _ulps(got["depth"][same], want["depth"][same]).max() <= 1
    assert (got["normals"] - want["normals"]).abs()[same].max() <= 1e-6
    for k in ("rgba", "depth", "normals", "face_id"):  # nothing off the object
        assert not got[k][~hit_g].any(), k


def test_rasterizer_refuses_what_it_does_not_take(dev):
    args = [a.to(dev) for a in _inputs(_cube(), 2, 1)]
    with pytest.raises(TypeError):
        RZ.rasterize(args[0], args[1].long(), *args[2:], 8, 8)
    with pytest.raises(ValueError):
        RZ.rasterize(args[0], args[1], args[2][:1], *args[3:], 8, 8)
    with pytest.raises(ValueError):
        RZ.rasterize(args[0], args[1].cpu(), *args[2:], 8, 8)
    with pytest.raises(ValueError):
        RZ.rasterize(args[0], args[1].transpose(1, 2).contiguous().transpose(1, 2), *args[2:], 8, 8)


def _write_cube_ply(path):
    verts, faces, colors = _cube()
    with open(path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                f"element face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n")
        for v, c in zip(verts, colors.astype(np.uint8)):
            f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        for a in faces:
            f.write(f"3 {a[0]} {a[1]} {a[2]}\n")


def test_refine_batch_device_on_the_card_matches_the_cpu(dev, tmp_path):
    mesh = str(tmp_path / "cube.ply")
    _write_cube_ply(mesh)
    cfg = RefinerConfig(n_iterations=2, render_size=(64, 64), n_sample_points=8, renderer="device")
    card = RenderCompareRefiner.create({1: mesh}, config=cfg, refiner_width=8, scorer_width=8,
                                       device=dev)
    cpu = RenderCompareRefiner.create({1: mesh}, config=cfg, refiner_width=8, scorer_width=8,
                                      device="cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        w = card.refiner_net.pose_head.weight
        w.copy_(torch.from_numpy(rng.normal(0, 0.01, tuple(w.shape)).astype(np.float32)))
    cpu.refiner_net.load_state_dict(card.refiner_net.state_dict())
    cpu.scorer_net.load_state_dict(card.scorer_net.state_dict())
    B = 3
    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = [0.02, -0.01, 0.5]
    Kf = np.array([[572.4, 0, 320], [0, 573.5, 240], [0, 0, 1.0]], np.float32)
    rgba, _ = card.meshes.rasterizers[1].render(Kf, gt, 640, 480)
    img = np.repeat(rgba[..., :3].transpose(2, 0, 1).astype(np.float32)[None] / 255.0, B, 0)
    init = np.repeat(gt[None], B, 0)
    init[:, :3, 3] += rng.uniform(-0.02, 0.02, (B, 3))
    args = (img, np.repeat(Kf[None], B, 0), np.ones(B, np.int64), init)
    before = RZ.rasterize.launches
    got_T, got_s = card.refine_batch(*args)
    assert RZ.rasterize.launches - before == 2 + 1 + 2  # iterations, score, keep_best_init
    want_T, want_s = cpu.refine_batch(*args)
    np.testing.assert_allclose(got_T, want_T, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_s, want_s, atol=1e-3, rtol=0)
    card.meshes.close()
    cpu.meshes.close()
