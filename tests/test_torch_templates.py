"""Template rendering of the port (render/rasterizer.py:render_template_views,
render/templates.py, scripts/render_templates.py) against the JAX package's,
on the cube PLYs of tests/test_rasterizer.py in metres and in mm, with and
without vertex colours.

- renderer=native: the port's host C++ and the JAX package's build of
  native/ render the same views; the decoded RGBA and depth PNGs are equal
  pixel for pixel, and the object_poses npys are equal.
- renderer=device on the CPU (the rasterizer's plain version) against the
  JAX package's renderer=jax at 64x80 (K scaled), level 0, to the
  tolerances of tests/test_torch_render.py::test_plain_rasterizer_matches_jax:
  alpha masks and hit pixels agree on at least 99.9 % of the view, rgb
  within one step and depth within 1 mm (one truncation step) there.
- the launch split: views per launch at the wrapper's limits, and a stack
  cut in several launches equal to one launch.
"""

import os
import os.path as osp

import numpy as np
import pytest
import torch
from PIL import Image

from gigapose_tpu_torch.dataloader.png import decode_png
from gigapose_tpu_torch.render import rasterize as RZ
from gigapose_tpu_torch.render import templates as TP
from gigapose_tpu_torch.render.mesh_io import load_mesh
from gigapose_tpu_torch.scripts import render_templates as port_cli
from test_rasterizer import _write_cube_ply

# (cube side, vertex colours): metres and mm, coloured and grey
CUBES = {"m_colors": (0.05, True), "m_grey": (0.05, False), "mm_colors": (60.0, True),
         "mm_grey": (60.0, False)}


def _cad_dir(root, kind):
    cad = osp.join(root, "models")
    os.makedirs(cad, exist_ok=True)
    size, colors = CUBES[kind]
    _write_cube_ply(osp.join(cad, "obj_000003.ply"), size=size, colors=colors)
    return cad


def _read(path, pil=False):
    if pil:
        return np.asarray(Image.open(path))
    with open(path, "rb") as f:
        return decode_png(f.read())


def _views(obj_dir, pil=False):
    n = len([f for f in os.listdir(obj_dir) if f.endswith("_depth.png")])
    rgba = np.stack([_read(osp.join(obj_dir, f"{v:06d}.png"), pil) for v in range(n)])
    depth = np.stack([_read(osp.join(obj_dir, f"{v:06d}_depth.png"), pil) for v in range(n)])
    return rgba, depth


@pytest.mark.parametrize("kind", sorted(CUBES))
def test_native_templates_equal_the_jax_script(tmp_path, kind):
    from gigapose_tpu.scripts.render_templates import main as jax_main

    cad = _cad_dir(str(tmp_path), kind)
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_main([f"cad_dir={cad}", f"out_dir={jax_out}", "level=0"])
    done = port_cli.main([f"cad_dir={cad}", f"out_dir={port_out}", "level=0"])
    assert done == {"000003": 42}
    want_rgba, want_depth = _views(osp.join(jax_out, "000003"), pil=True)
    got_rgba, got_depth = _views(osp.join(port_out, "000003"))
    assert got_rgba.dtype == np.uint8 and got_depth.dtype == np.uint16
    assert got_rgba.shape == (42, 480, 640, 4) and got_depth.shape == (42, 480, 640)
    assert (got_rgba[..., 3] > 0).any() and got_depth.max() > 0
    np.testing.assert_array_equal(got_rgba, want_rgba)
    np.testing.assert_array_equal(got_depth, want_depth)
    got_poses = np.load(osp.join(port_out, "object_poses", "000003.npy"))
    want_poses = np.load(osp.join(jax_out, "object_poses", "000003.npy"))
    assert got_poses.dtype == want_poses.dtype
    np.testing.assert_array_equal(got_poses, want_poses)


def _scaled_K(H, W):
    K = TP.TEMPLATE_K.copy()
    K[0] *= W / 640.0
    K[1] *= H / 480.0
    return K


@pytest.mark.parametrize("kind", sorted(CUBES))
def test_device_templates_match_the_jax_renderer(tmp_path, kind):
    from gigapose_tpu.render.jax_renderer import render_template_views_jax

    cad = _cad_dir(str(tmp_path), kind)
    mesh = osp.join(cad, "obj_000003.ply")
    H, W = 64, 80
    K = _scaled_K(H, W)
    render_template_views_jax(mesh, str(tmp_path / "jax"), K=K, width=W, height=H, level=0)
    timing = {}
    n = TP.render_template_views_device(mesh, str(tmp_path / "port"), K=K, width=W, height=H,
                                        level=0, device="cpu", timing=timing)
    assert n == 42 and timing["launches"] >= 1 and timing["encode_s"] > 0
    w_rgba, w_depth = _views(str(tmp_path / "jax"), pil=True)
    g_rgba, g_depth = _views(str(tmp_path / "port"))
    hit_g, hit_w = g_rgba[..., 3] > 0, w_rgba[..., 3] > 0
    both = hit_g & hit_w
    close = both & (np.abs(g_rgba[..., :3].astype(int) - w_rgba[..., :3]).max(-1) <= 1) \
        & (np.abs(g_depth.astype(int) - w_depth) <= 1)
    total = hit_g.size
    assert hit_w.sum() > 0.01 * total
    assert (hit_g == hit_w).sum() / total >= 0.999
    assert (close.sum() + (~hit_g & ~hit_w).sum()) / total >= 0.999
    assert (g_depth[~hit_g] == 0).all() and (g_rgba[~hit_g] == 0).all()


def test_views_per_launch_at_the_wrapper_limits():
    # B * F * H < 2^32: F * H = 2^28 -> 15 views; 2^32 / (99,904 * 480) -> 89
    assert RZ.views_per_launch(1 << 20, 1 << 8, 4, 8) == 15
    assert RZ.views_per_launch(99904, 480, 640, 49954) == 89
    # B * max(H * W, V, F) < 2^31
    assert RZ.views_per_launch(12, 1024, 1024, 8) == 2047
    assert RZ.views_per_launch(12, 4, 4, 1 << 30) == 1
    assert RZ.views_per_launch(12, 4, 4, 1 << 31) == 0
    assert RZ.views_per_launch(12, 1 << 15, (1 << 15) + 1, 8) == 0  # H + W > 2^16
    for F, H, W, V in ((1 << 20, 1 << 8, 4, 8), (99904, 480, 640, 49954), (12, 1024, 1024, 8),
                       (12, 4, 4, 1 << 30), (19800, 480, 640, 9902)):
        n = RZ.views_per_launch(F, H, W, V)
        RZ.check_limits(n, V, F, H, W)
        with pytest.raises(ValueError, match="2\\^31"):
            RZ.check_limits(n + 1, V, F, H, W)


def test_a_stack_in_several_launches_equals_one_launch(tmp_path, monkeypatch):
    _write_cube_ply(str(tmp_path / "cube.ply"), size=0.05, colors=True)
    verts, faces, colors = load_mesh(str(tmp_path / "cube.ply"))
    poses = TP.template_poses(0)[:12].astype(np.float32)
    poses[:, :3, 3] /= 1000.0
    H, W = 64, 80
    args = (verts, faces, colors.astype(np.float32), _scaled_K(H, W), poses, H, W, "cpu")
    one, several = {}, {}
    rgba1, depth1 = TP.render_view_stack(*args, timing=one)
    monkeypatch.setattr(TP, "views_per_launch", lambda *shape: 5)
    rgba5, depth5 = TP.render_view_stack(*args, timing=several)
    assert one["launches"] == 1 and several["launches"] == 3
    assert (rgba1[..., 3] > 0).any()
    np.testing.assert_array_equal(rgba5, rgba1)
    np.testing.assert_array_equal(depth5.view(np.int32), depth1.view(np.int32))
    # one launch of the whole stack is the rasterizer's own batch
    stack = lambda a: torch.as_tensor(a)[None].expand(12, *a.shape).contiguous()
    want = RZ.rasterize(stack(verts), stack(faces), stack(colors.astype(np.float32)),
                        stack(args[3]), torch.as_tensor(poses), H, W)
    np.testing.assert_array_equal(rgba1, want["rgba"].numpy())


def test_both_renderer_names_and_the_jax_refusal(tmp_path, monkeypatch):
    """renderer=native and renderer=device (here on the CPU) write the same
    layout; the device files are the device renderer's own output; masks
    agree with the host renders on 99.9 % of the pixels. Both renderers are
    held to 120x160 (K scaled) here, so that the plain version stays quick
    on the CPU. renderer=jax and unknown options raise. With renderer=device
    and num_workers=2 the views are rendered in this process (no pool is
    made)."""
    from gigapose_tpu_torch.render import rasterizer as TR

    H, W = 120, 160
    small = lambda fn: (lambda *a, **k: fn(*a, width=W, height=H, K=_scaled_K(H, W), **k))
    monkeypatch.setattr(TP, "render_template_views_device", small(TP.render_template_views_device))
    monkeypatch.setattr(TR, "render_template_views", small(TR.render_template_views))
    cad = _cad_dir(str(tmp_path), "m_colors")
    common = [f"cad_dir={cad}", "level=0"]
    port_cli.main(common + [f"out_dir={tmp_path / 'native'}"])
    monkeypatch.setattr(port_cli.mp, "get_context",
                        lambda *a: pytest.fail("renderer=device made a process pool"))
    done = port_cli.main(common + [f"out_dir={tmp_path / 'device'}", "renderer=device",
                                   "device=cpu", "num_workers=2"])
    assert done == {"000003": 42}
    nat_rgba, nat_depth = _views(str(tmp_path / "native" / "000003"))
    dev_rgba, dev_depth = _views(str(tmp_path / "device" / "000003"))
    assert dev_rgba.shape == nat_rgba.shape == (42, H, W, 4)
    verts, faces, colors = load_mesh(osp.join(cad, "obj_000003.ply"))
    poses = TP.template_poses(0).astype(np.float32)
    poses[:, :3, 3] /= 1000.0
    rgba, depth = TP.render_view_stack(verts, faces, colors, _scaled_K(H, W), poses, H, W, "cpu")
    np.testing.assert_array_equal(dev_rgba, rgba)
    np.testing.assert_array_equal(dev_depth, TP.depth_mm_u16(depth, 1000.0))
    np.testing.assert_array_equal(np.load(tmp_path / "native" / "object_poses" / "000003.npy"),
                                  np.load(tmp_path / "device" / "object_poses" / "000003.npy"))
    assert (dev_rgba[..., 3] > 0).any()
    assert ((dev_rgba[..., 3] > 0) == (nat_rgba[..., 3] > 0)).mean() >= 0.999
    with pytest.raises(ValueError, match="renderer=device"):
        port_cli.main(common + [f"out_dir={tmp_path / 'jax'}", "renderer=jax"])
    with pytest.raises(ValueError, match="native or device"):
        port_cli.main(common + [f"out_dir={tmp_path / 'x'}", "renderer=pyrender"])
    with pytest.raises(ValueError, match="width"):
        port_cli.main(common + [f"out_dir={tmp_path / 'x'}", "width=320"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="renderer=device runs on the CUDA card"):
            port_cli.main(common + [f"out_dir={tmp_path / 'x'}", "renderer=device"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TP.render_template_views_device(osp.join(cad, "obj_000003.ply"), str(tmp_path / "x"))


def test_native_pool_spawns_and_writes_the_same_views(tmp_path):
    """num_workers=2 renders the objects in a pool of spawned processes and
    writes the files that one process writes."""
    cad = osp.join(str(tmp_path), "models")
    os.makedirs(cad)
    _write_cube_ply(osp.join(cad, "obj_000001.ply"), size=0.05, colors=True)
    _write_cube_ply(osp.join(cad, "obj_000002.ply"), size=60.0, colors=False)
    common = [f"cad_dir={cad}", "level=0"]
    assert port_cli.main(common + [f"out_dir={tmp_path / 'one'}"]) == \
        port_cli.main(common + [f"out_dir={tmp_path / 'pool'}", "num_workers=2"]) == \
        {"000001": 42, "000002": 42}
    for obj in ("000001", "000002"):
        for a, b in zip(_views(str(tmp_path / "one" / obj)), _views(str(tmp_path / "pool" / obj))):
            np.testing.assert_array_equal(a, b)


def test_filter0_png_is_the_pixels_with_a_zero_byte_per_row():
    """encode_png's filter-0 rows (what template views are written with):
    each row its zero filter byte and then its pixels' bytes, big-endian for
    16 bits; decoded back exactly, as PIL reads them."""
    import io
    import zlib

    from gigapose_tpu_torch.dataloader.png import SIGNATURE, encode_png

    rng = np.random.default_rng(0)
    for img in (rng.integers(0, 256, (7, 5, 4), dtype=np.uint8),
                rng.integers(0, 65536, (6, 9), dtype=np.uint16)):
        data = encode_png(img, 0)
        assert data.startswith(SIGNATURE)
        raw = zlib.decompress(data[41:-16])
        pix = img.astype(">u2").view(np.uint8) if img.dtype == np.uint16 else img
        want = np.concatenate([np.zeros((len(img), 1), np.uint8), pix.reshape(len(img), -1)], 1)
        assert raw == want.tobytes()
        np.testing.assert_array_equal(decode_png(data), img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
