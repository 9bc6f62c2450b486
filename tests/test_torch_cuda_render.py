"""The CUDA rasterizer (csrc/rasterizer.cu) against its plain PyTorch version,
and the refine loop with the device renderer on the card against the CPU.

Marked `cuda`: each test skips where torch.cuda.is_available() is false (the
decision is taken in the fixture, never at import). Imports no jax, so it
runs on a machine with PyTorch and the CUDA toolkit only:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_render.py -q

The kernel is built with -fmad=false and rounds each product and sum as the
plain version does, and its cull is conservative against the rounded inside
test (tests/test_torch_render.py holds the boxes on the CPU): hit masks,
face ids, rgba, the depth's bits and the normals equal the plain version's
on the cube, a triangle soup, slivers, sub-pixel faces, a 9,940-face
sphere, coincident faces (ties) and screen-space needles whose edges pass
through pixel centres (tests/torch_meshes.py). Template stacks at 640x480
(icosphere views, the object at 0.4 m) are bit-equal too: a 9,940-face
sphere, and a 99,904-face one whose 162 views take two launches
(render/templates.py:render_view_stack, checked at the views on each side
of the cut); the device template renderer writes, on the card, the files
that its plain version writes on the CPU. The refine loop on the card
against the CPU: poses and scores within 1e-3, from cuDNN's convolutions summing in another order than
the CPU's (1e-6 relative), which a uint8 render now and then turns into one
step at a pixel; the same for the MegaPose refiner (host renders with
normals), and its SO(3)-grid scores.
"""

import numpy as np
import pytest
import torch

from gigapose_tpu_torch.dataloader.png import decode_png
from gigapose_tpu_torch.render import rasterize as RZ
from gigapose_tpu_torch.render import templates as TP
from gigapose_tpu_torch.refiner.megapose_refiner import MegaposeRefiner, MegaposeRefinerConfig
from gigapose_tpu_torch.refiner.refiner import RefinerConfig, RenderCompareRefiner
from torch_meshes import cube, sphere, views

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("mesh,size", [("cube", (64, 80)), ("soup", (64, 80)),
                                       ("soup", (37, 53)), ("cube", (160, 160)),
                                       ("slivers", (64, 80)), ("subpixel", (64, 80)),
                                       ("sphere", (64, 80)), ("sphere", (160, 160)),
                                       ("coincident", (64, 80)), ("needles", (64, 80))])
def test_rasterizer_matches_plain(dev, mesh, size):
    """Bit-equal: hit masks, face ids, rgba, the depth's bits and the
    normals, on every pixel."""
    args = [a.to(dev) for a in views(mesh, 6, 5)]
    H, W = size
    before = RZ.rasterize.launches
    got = RZ.rasterize(*args, H, W)
    assert RZ.rasterize.launches == before + 1
    want = RZ.rasterize_plain(*args, H, W)
    torch.cuda.synchronize()
    hit_w = want["rgba"][..., 3] > 0
    assert hit_w.any()
    assert torch.equal(got["face_id"], want["face_id"])
    assert torch.equal(got["rgba"], want["rgba"])
    assert torch.equal(got["depth"].view(torch.int32), want["depth"].view(torch.int32))
    assert torch.equal(got["normals"].view(torch.int32), want["normals"].view(torch.int32))


def test_rasterizer_refuses_what_it_does_not_take(dev):
    args = [a.to(dev) for a in views("cube", 2, 1)]
    with pytest.raises(TypeError):
        RZ.rasterize(args[0], args[1].long(), *args[2:], 8, 8)
    with pytest.raises(ValueError):
        RZ.rasterize(args[0], args[1], args[2][:1], *args[3:], 8, 8)
    with pytest.raises(ValueError):
        RZ.rasterize(args[0], args[1].cpu(), *args[2:], 8, 8)
    with pytest.raises(ValueError):
        RZ.rasterize(args[0], args[1].transpose(1, 2).contiguous().transpose(1, 2), *args[2:], 8, 8)


@pytest.mark.parametrize("shared", [("verts", "faces", "colors"), ("verts",), ("faces",),
                                    ("colors",)])
def test_rasterizer_takes_one_mesh_expanded_over_the_batch(dev, shared):
    """verts, faces and colors given as one mesh expanded over the views
    (batch stride 0) render as their contiguous copies, bit for bit; K and T
    so expanded are refused."""
    mesh = [a[:1].to(dev) for a in views("sphere", 1, 5)[:3]]
    K, T = (a.to(dev) for a in views("sphere", 6, 5)[3:])
    copies = [m.expand(6, *m.shape[1:]).contiguous() for m in mesh]
    args = [m.expand(6, *m.shape[1:]) if name in shared else c
            for name, m, c in zip(("verts", "faces", "colors"), mesh, copies)]
    got = RZ.rasterize(*args, K, T, 64, 80)
    want = RZ.rasterize(*copies, K, T, 64, 80)
    assert (want["rgba"][..., 3] > 0).any()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="contiguous"):
        RZ.rasterize(*args, K[:1].expand(6, 3, 3), T, 64, 80)


def _write_cube_ply(path):
    verts, faces, colors = cube()
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


@pytest.mark.parametrize("n_views", [1, 4])
def test_megapose_refiner_on_the_card_matches_the_cpu(dev, tmp_path, n_views):
    """The MegaPose refiner (WideResNet-34 width 0.125, 60x80, host renders
    with normals) on the card against the same nets on the CPU: refine_batch
    over 2 iterations at n_rendered_views 1 and 4, and classify_coarse on
    the 72-grid, within 1e-3."""
    mesh = str(tmp_path / "cube.ply")
    _write_cube_ply(mesh)
    cfg = MegaposeRefinerConfig(n_iterations=2, render_size=(60, 80), n_sample_points=8,
                                n_rendered_views=n_views)
    card = MegaposeRefiner.create({1: mesh}, config=cfg, width=0.125, device=dev)
    cpu = MegaposeRefiner.create({1: mesh}, config=cfg, width=0.125, device="cpu")
    with torch.no_grad():  # a pose head near the identity update
        card.refiner_net.pose_fc.weight.mul_(0.05)
        card.refiner_net.pose_fc.bias.copy_(torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1]))
    cpu.refiner_net.load_state_dict(card.refiner_net.state_dict())
    cpu.coarse_net.load_state_dict(card.coarse_net.state_dict())
    B = 3
    rng = np.random.default_rng(1)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = [0.02, -0.01, 0.5]
    Kf = np.array([[572.4, 0, 320], [0, 573.5, 240], [0, 0, 1.0]], np.float32)
    rgba, _ = card.meshes.rasterizers[1].render(Kf, gt, 640, 480)
    img = np.repeat(rgba[..., :3].transpose(2, 0, 1).astype(np.float32)[None] / 255.0, B, 0)
    init = np.repeat(gt[None], B, 0)
    init[:, :3, 3] += rng.uniform(-0.02, 0.02, (B, 3))
    args = (img, np.repeat(Kf[None], B, 0), np.ones(B, np.int64), init)
    got_T, got_s = card.refine_batch(*args)
    want_T, want_s = cpu.refine_batch(*args)
    np.testing.assert_allclose(got_T, want_T, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_s, want_s, atol=1e-3, rtol=0)
    ys, xs = np.nonzero(rgba[..., 3])
    box = np.array([[xs.min(), ys.min(), xs.max(), ys.max()]], np.float32)
    one = [a[:1] for a in args[:3]]
    got = card.classify_coarse(*one, box, grid_size=72)
    want = cpu.classify_coarse(*one, box, grid_size=72)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3, rtol=0)
    card.meshes.close()
    cpu.meshes.close()


def _plain_views(verts, faces, colors, poses, dev, views_):
    """The plain version on the card at some views of a 640x480 stack, 4 at a time."""
    put = lambda a, n: torch.as_tensor(a, device=dev)[None].expand(n, *a.shape).contiguous()
    out = {"rgba": [], "depth": []}
    for s in range(0, len(views_), 4):
        sel = views_[s:s + 4]
        o = RZ.rasterize_plain(put(verts, len(sel)), put(faces, len(sel)), put(colors, len(sel)),
                               put(TP.TEMPLATE_K, len(sel)),
                               torch.as_tensor(poses[sel], device=dev), 480, 640)
        for k in out:
            out[k].append(o[k].cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


@pytest.mark.parametrize("n,level,launches,check", [(71, 0, 1, None), (224, 1, 2, [0, 88, 89, 161])])
def test_template_stack_matches_plain(dev, n, level, launches, check, monkeypatch):
    """Icosphere views at 640x480 through the kernel, in as many launches
    as views_per_launch allows (99,904 faces: 89 views a launch), equal to
    the plain version bit for bit."""
    verts, faces, colors = sphere(3, n=n)
    poses = TP.template_poses(level).astype(np.float32)
    poses[:, :3, 3] /= 1000.0
    timing = {}
    before = RZ.rasterize.launches
    rgba, depth = TP.render_view_stack(verts, faces, colors, TP.TEMPLATE_K, poses, 480, 640, dev,
                                       timing=timing)
    assert RZ.rasterize.launches - before == timing["launches"] == launches
    check = list(range(len(poses))) if check is None else check
    want = _plain_views(verts, faces, colors, poses, dev, check)
    assert (want["rgba"][..., 3] > 0).all(axis=(1, 2)).sum() == 0 and want["rgba"][..., 3].any()
    np.testing.assert_array_equal(rgba[check], want["rgba"])
    np.testing.assert_array_equal(depth[check].view(np.int32), want["depth"].view(np.int32))
    if level == 0:  # a cut into launches of 16 equals one launch
        cut = {}
        monkeypatch.setattr(TP, "views_per_launch", lambda *shape: 16)
        rgba16, depth16 = TP.render_view_stack(verts, faces, colors, TP.TEMPLATE_K, poses, 480,
                                               640, dev, timing=cut)
        assert cut["launches"] == 3
        np.testing.assert_array_equal(rgba16, rgba)
        np.testing.assert_array_equal(depth16.view(np.int32), depth.view(np.int32))


def test_device_template_files_on_the_card_equal_the_cpu(dev, tmp_path):
    mesh = str(tmp_path / "cube.ply")
    _write_cube_ply(mesh)
    before = RZ.rasterize.launches
    assert TP.render_template_views_device(mesh, str(tmp_path / "card"), level=0, device=dev) == 42
    assert RZ.rasterize.launches == before + 1
    TP.render_template_views_device(mesh, str(tmp_path / "cpu"), level=0, device="cpu")
    names = sorted(p.name for p in (tmp_path / "card").iterdir())
    assert len(names) == 84 and names == sorted(p.name for p in (tmp_path / "cpu").iterdir())
    for name in names:
        got, want = (decode_png((tmp_path / d / name).read_bytes()) for d in ("card", "cpu"))
        np.testing.assert_array_equal(got, want)
