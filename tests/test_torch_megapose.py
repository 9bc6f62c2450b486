"""The port's MegaPose refinement (gigapose_tpu_torch/refiner/megapose_*.py,
multiview.py, so3_grid.py, depth_refiner.py) against the JAX package's, CPU.

Same inputs, made with numpy from a seed, through both:
- the nets (WideResNet-18 and -34 at width 0.25, the pose and the logits
  heads, VanillaResNet34) at 64x64 on flax variables made with numpy
  (kernels random, BatchNorm scale, bias, mean and var random), bridged by
  models.convert.megapose_flax_to_torch: within 2e-4 absolute; and the
  other way, the port's seeded state_dict() through the JAX converters
  (megapose_pose_model_to_flax, megapose_backbone_to_flax,
  vanilla_resnet34_to_flax), which read the reference torch modules' key
  names: within 2e-4;
- the SO(3) grids: the asset bytes identical, the matrices equal;
- make_TCO_multiview for every multiview_type and option: exactly equal;
- MeshStore.render_batch(render_normals=True) and render_multiview_batch:
  RGB bytes equal, normals within 1e-6;
- the tiny MegaposeRefiner (width 0.125, 60x80, 8 points) on the same
  variables (a pose head near the identity update, so that the renders
  stay on the object), on a metre cube and a millimetre sphere:
  refine_batch over 2 iterations at n_rendered_views 1 and 4
  (TCO+front_3views), score_batch, and classify_coarse on the 72-grid:
  poses and scores within 2e-4, the GigaPose refiner's tolerance
  (tests/test_torch_refiner.py: the two packages' crop boxes are 1 ulp
  apart, and the random BatchNorm scales amplify that); the top-1 grid row
  equal wherever its score leads the second by more than 2e-4. Where the
  crop cameras are an ulp apart (XLA rounds the crop box's products and
  sums in other ways than PyTorch: fused multiply-adds, a reciprocal for a
  division by a constant), the interpolated vertex colours of hundreds of
  pixels round to the next uint8 step, and the random nets move a score
  by up to 3.4e-4 (2 of the 72-grid's 144 hypotheses here):
  classify_coarse holds the scores of the hypotheses whose crop cameras
  are bit-equal in both packages to 2e-4 (they read 3e-7) and the others
  to 1e-3;
- from_checkpoints on checkpoints the test writes with the older key names:
  equal to the bridged nets; a dropped key raises; without a checkpoint
  the pose head is the identity update (the init poses come back);
- ICPDepthRefiner on the scene of tests/test_aux.py:test_icp_depth_refiner:
  exactly equal (the same numpy on bit-identical renders).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gigapose_tpu.refiner import depth_refiner as JDepth
from gigapose_tpu.refiner import megapose_net as JN
from gigapose_tpu.refiner import megapose_refiner as JM
from gigapose_tpu.refiner import multiview as JMV
from gigapose_tpu.refiner import so3_grid as JG
from gigapose_tpu.refiner.refiner import MeshStore as JMeshStore
from gigapose_tpu.render.rasterizer import Rasterizer as JRasterizer
from gigapose_tpu_torch.models.convert import megapose_flax_to_torch
from gigapose_tpu_torch.refiner import depth_refiner as D
from gigapose_tpu_torch.refiner import megapose_net as N
from gigapose_tpu_torch.refiner import megapose_refiner as M
from gigapose_tpu_torch.refiner import multiview as MV
from gigapose_tpu_torch.refiner import ops as O
from gigapose_tpu_torch.refiner import so3_grid as G
from gigapose_tpu_torch.refiner.refiner import MeshStore, crop_prep
from gigapose_tpu_torch.render.rasterizer import Rasterizer
from tests.test_rasterizer import _write_cube_ply

K = np.array([[572.4114, 0, 320], [0, 573.57043, 240], [0, 0, 1.0]], np.float32)
NET_TOL = 2e-4
POSE_TOL, SCORE_TOL = 2e-4, 2e-4
# a score whose crop camera differs between the packages by an ulp (see the
# docstring)
ULP_CAMERA_TOL = 1e-3
TINY = dict(n_iterations=2, render_size=(60, 80), n_sample_points=8)
IDENTITY_6D_V = np.array([1, 0, 0, 0, 1, 0, 0, 0, 1], np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def flax_vars(net, in_shape, seed, head_scale=1.0):
    """Variables of a flax MegaPose net made with numpy on the tree of
    net.init (traced, not compiled): kernels normal with std 1 / sqrt(fan
    in) (the pose head's times head_scale), BatchNorm scale, bias, mean and
    var random (flax's 1 / 0 / 0 / 1 would hide a wrong mapping), dense
    biases 0, the pose head's the identity update."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros(in_shape))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        shape, name = leaf.shape, names[-1]
        if name == "kernel":
            scale = head_scale if "pose_fc" in names else 1.0
            a = rng.normal(0, scale / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        elif name == "mean":
            a = rng.normal(0, 0.1, shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "bias" and "pose_fc" in names:
            a = IDENTITY_6D_V
        elif name == "bias" and names[-2] in ("views_logits_head", "fc"):
            a = np.zeros(shape)
        else:  # BatchNorm bias
            a = rng.normal(0, 0.05, shape)
        return np.asarray(a, np.float32)

    return flax.core.unfreeze(jax.tree_util.tree_map_with_path(fill, shapes))


NETS = {
    "wrn18_map": (lambda: JN.MegaposeWideResNet(JN.CONFIG[18], 0.25, pool=False),
                  lambda: N.MegaposeWideResNet(N.CONFIG[18], 0.25, n_inputs=6, pool=False), 6),
    "wrn34_pose": (lambda: JN.MegaposePoseHeadNet(JN.CONFIG[34], 0.25, "pose"),
                   lambda: N.MegaposePoseHeadNet(N.CONFIG[34], 0.25, "pose", n_inputs=9), 9),
    "wrn34_logits": (lambda: JN.MegaposePoseHeadNet(JN.CONFIG[34], 0.25, "renderings_logits", 4),
                     lambda: N.MegaposePoseHeadNet(N.CONFIG[34], 0.25, "renderings_logits", 4,
                                                   n_inputs=9), 9),
    "vanilla34": (lambda: JN.VanillaResNet34(n_features=32),
                  lambda: N.VanillaResNet34(n_features=32, n_inputs=6), 6),
}


def _flax_out(net, variables, x):
    return np.asarray(jax.jit(net.apply)(variables, jnp.asarray(x)))


@pytest.mark.parametrize("name", sorted(NETS))
def test_nets_match_flax_through_the_bridge(name):
    jnet_fn, pnet_fn, cin = NETS[name]
    jnet, port = jnet_fn(), pnet_fn().eval()
    x = np.random.default_rng(1).normal(size=(2, cin, 64, 64)).astype(np.float32)
    v = flax_vars(jnet, x.shape, 0)
    port.load_state_dict(megapose_flax_to_torch(v), strict=True)
    with torch.no_grad():
        got = port(_t(x)).numpy()
    want = _flax_out(jnet, v, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=NET_TOL, rtol=0)


def _randomized_port(pnet, seed):
    """The port's net with seeded weights and random BatchNorm statistics."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in pnet.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / max(1.0, p[0].numel()) ** 0.5)
        for m in pnet.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    return pnet.eval()


@pytest.mark.parametrize("name", ["wrn18_map", "wrn34_pose", "wrn34_logits", "vanilla34"])
def test_port_state_dict_converts_through_the_jax_converters(name):
    """The port's keys are the reference torch modules' own: the JAX
    converters read them and give flax variables with the same outputs."""
    jnet_fn, pnet_fn, cin = NETS[name]
    port = _randomized_port(pnet_fn(), 3)
    sd = port.state_dict()
    if name == "wrn18_map":
        params, stats = JN.megapose_backbone_to_flax(sd, JN.CONFIG[18], prefix="")
    elif name == "vanilla34":
        params, stats = JN.vanilla_resnet34_to_flax(sd)
    else:
        head = "pose" if name.endswith("pose") else "renderings_logits"
        params, stats = JN.megapose_pose_model_to_flax(sd, JN.CONFIG[34], head=head)
    x = np.random.default_rng(4).normal(size=(2, cin, 64, 64)).astype(np.float32)
    with torch.no_grad():
        got = port(_t(x)).numpy()
    want = _flax_out(jnet_fn(), {"params": params, "batch_stats": stats}, x)
    np.testing.assert_allclose(got, want, atol=NET_TOL, rtol=0)
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("n", [72, 576])
def test_so3_grids_match_jax(n):
    name = f"so3_grid_{n}.qua"
    with open(f"{G._ASSET_DIR}/{name}", "rb") as a, open(f"{JG._ASSET_DIR}/{name}", "rb") as b:
        assert a.read() == b.read()
    got, want = G.load_so3_grid(n), JG.load_so3_grid(n)
    assert got.shape == (n, 3, 3) and got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mtype,n_views,remove,inplane", [
    ("TCO+front_1view", 2, False, False), ("TCO+front_3views", 4, False, False),
    ("TCO+front_5views", 6, False, False), ("sphere_26views", 27, False, False),
    ("TCO+front_3views", 1, False, False), ("TCO+front_3views", 3, True, False),
    ("TCO+front_3views", 3, True, True)])
def test_make_tco_multiview_matches_jax(mtype, n_views, remove, inplane):
    rng = np.random.default_rng(5)
    B = 4
    TCO = np.tile(np.eye(4), (B, 1, 1))
    TCO[:, :3, :3] = Rotation.random(B, random_state=6).as_matrix()
    TCO[:, :3, 3] = rng.normal(0, 0.05, (B, 3)) + [0, 0, 0.5]
    TCO[-1, :3, 3] = 0.0  # a degenerate reference point
    kw = dict(remove_TCO_rendering=remove, views_inplane_rotations=inplane)
    got = MV.make_TCO_multiview(TCO, TCO[:, :3, 3], mtype, n_views, **kw)
    want = JMV.make_TCO_multiview(TCO, TCO[:, :3, 3], mtype, n_views, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(MV.multiview_tCR(got), JMV.multiview_tCR(want))


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """A cube in metres (label 1) and a sphere in millimetres (label 2)."""
    from bench import _write_sphere_ply

    d = tmp_path_factory.mktemp("megapose_meshes")
    cube, sphere = str(d / "cube.ply"), str(d / "sphere.ply")
    _write_cube_ply(cube, size=0.08)
    _write_sphere_ply(sphere, radius_m=0.05, levels=2)
    return {1: cube, 2: sphere}


def _poses(B, seed):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = Rotation.random(B, random_state=seed).as_matrix()
    T[:, :3, 3] = rng.normal(0, 0.03, (B, 3)) + [0, 0, 0.5]
    return T


def test_normals_renders_match_jax(meshes):
    ours, theirs = MeshStore(meshes, 8), JMeshStore(meshes, 8)
    labels = np.array([1, 2, 2, 1])
    T = _poses(4, 7)
    Kc = np.repeat(np.array([[300, 0, 40], [0, 300, 30], [0, 0, 1.0]], np.float32)[None], 4, 0)
    got = ours.render_batch(labels, T, Kc, (60, 80), render_normals=True)
    want = theirs.render_batch(labels, T, Kc, (60, 80), render_normals=True)
    assert got.shape == want.shape == (4, 6, 60, 80) and got.dtype == want.dtype == np.float32
    assert np.array_equal(got[:, :3], want[:, :3])  # RGB: the same bytes / 255
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], atol=1e-6, rtol=0)
    fg = got[:, :3].any(1)
    assert fg.mean() > 0.05 and (got[:, 3:][~np.repeat(fg[:, None], 3, 1)] == 0).all()
    TV = np.stack([T, _poses(4, 8)], 1)
    KV = np.stack([Kc, Kc * [[1.1], [1.1], [1]]], 1).astype(np.float32)
    got = ours.render_multiview_batch(labels, TV, KV, (60, 80), render_normals=True)
    want = theirs.render_multiview_batch(labels, TV, KV, (60, 80), render_normals=True)
    assert got.shape == (4, 12, 60, 80)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="f32"):
        ours.render_batch(labels, T, Kc, (60, 80), out_dtype=np.uint8, render_normals=True)
    ours.close()


def tiny_megapose_nets(jcfg, width=0.125):
    """The JAX MegaposeRefiner's two nets at `width` and numpy-made
    variables for jcfg's render size and inputs (flax's init skipped, which
    takes seconds on the CPU): (rnet, its variables, cnet, its variables);
    the pose head near the identity update, so that poses move by a few
    millimetres and degrees."""
    H, W = jcfg.render_size
    rnet = JN.MegaposePoseHeadNet(JN.CONFIG[34], width, "pose")
    cnet = JN.MegaposePoseHeadNet(JN.CONFIG[34], width, "renderings_logits", 1)
    return (rnet, flax_vars(rnet, (1, jcfg.n_inputs, H, W), 1, head_scale=0.05),
            cnet, flax_vars(cnet, (1, 3 + jcfg.n_render_channels, H, W), 2))


def load_bridged_(port, rv, cv):
    """The port's MegaposeRefiner with the JAX variables rv / cv."""
    port.refiner_net.load_state_dict(megapose_flax_to_torch(rv), strict=True)
    port.coarse_net.load_state_dict(megapose_flax_to_torch(cv), strict=True)
    return port


def _refiners(meshes, n_views=1):
    """The JAX MegaposeRefiner at width 0.125 (tiny_megapose_nets) and the
    port's with the same weights."""
    cfg = dict(TINY, n_rendered_views=n_views)
    jcfg = JM.MegaposeRefinerConfig(**cfg)
    rnet, rv, cnet, cv = tiny_megapose_nets(jcfg)
    ref = JM.MegaposeRefiner(rnet, rv, cnet, cv, JMeshStore(meshes, 8), jcfg)
    port = M.MegaposeRefiner.create(meshes, config=M.MegaposeRefinerConfig(**cfg), width=0.125,
                                    device="cpu")
    return ref, load_bridged_(port, rv, cv)


def _scene(meshes, B=4):
    """The cube and the sphere rendered at their ground truths into one
    image; init poses a few cm and degrees off."""
    r = {l: JRasterizer(p) for l, p in meshes.items()}
    gts = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    gts[:, :3, :3] = Rotation.from_euler("xyz", [[20, 30, 0], [-10, 40, 15]],
                                         degrees=True).as_matrix()
    gts[:, :3, 3] = [[0.06, -0.01, 0.5], [-0.07, 0.02, 0.55]]
    img = np.zeros((480, 640, 3), np.uint8)
    for label, gt, unit in ((1, gts[0], 1.0), (2, gts[1], 1e-3)):
        pose = gt.copy()
        pose[:3, 3] /= unit
        rgba, _ = r[label].render(K, pose, 640, 480)
        img[rgba[..., 3] > 0] = rgba[..., :3][rgba[..., 3] > 0]
    labels = np.array([1 + i % 2 for i in range(B)])
    init = gts[labels - 1].copy()
    rng = np.random.default_rng(9)
    init[:, :3, 3] += rng.uniform(-0.01, 0.01, (B, 3))
    init[:, :3, :3] = Rotation.from_rotvec(rng.uniform(-0.1, 0.1, (B, 3))).as_matrix().astype(
        np.float32) @ init[:, :3, :3]
    images = np.repeat(img.transpose(2, 0, 1)[None].astype(np.float32) / 255.0, B, 0)
    return images, np.repeat(K[None], B, 0), labels, init


@pytest.mark.parametrize("n_views", [1, 4])
def test_refine_batch_matches_jax(meshes, n_views):
    ref, port = _refiners(meshes, n_views)
    args = _scene(meshes)
    want_T, want_s = ref.refine_batch(*args)
    port.timing = {}
    got_T, got_s = port.refine_batch(*args)
    assert got_T.shape == (4, 4, 4) and got_s.shape == (4,)
    np.testing.assert_allclose(got_T, want_T, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(got_s, want_s, atol=SCORE_TOL, rtol=0)
    assert np.abs(want_T - args[3]).max(axis=(1, 2)).min() > 1e-2  # every pose moved
    assert sorted(port.timing) == ["fetch", "render", "update", "upload"]
    # score_batch alone, at the init poses
    np.testing.assert_allclose(port.score_batch(*args), ref.score_batch(*args), atol=SCORE_TOL,
                               rtol=0)
    port.meshes.close()


def _cameras_agree(ref, port, images, Ks, labels, boxes, grid_size):
    """(B, M) bool: whether the two packages' scoring passes render
    hypothesis m of detection b through the same camera: each package's own
    autodepth pose, normalized, and crop intrinsics, bit for bit."""
    crop_step, _, _, _, init_step = ref._device_steps()
    grid = G.load_so3_grid(grid_size).astype(np.float32)
    M = len(grid)
    out = np.zeros((len(labels), M), bool)
    for b in range(len(labels)):
        rep = lambda a: np.repeat(a[b:b + 1], M, 0)
        img, Kb, box = rep(images), rep(Ks), rep(boxes)
        pts = rep(port._points(labels)).astype(np.float32)
        TCO_j = np.asarray(init_step(box, pts, Kb, grid))
        want = [np.asarray(a) for a in crop_step(img, Kb, TCO_j, pts)]
        TCO_p = O.TCO_init_from_boxes_autodepth_with_R(_t(box), _t(pts), _t(Kb), _t(grid))
        got = [a.numpy() for a in crop_prep(_t(img), _t(Kb), TCO_p, _t(pts), (60, 80), 1.4)]
        out[b] = (got[0] == want[0]).all(axis=(1, 2)) & (got[2] == want[2]).all(axis=(1, 2))
    return out


def test_classify_coarse_matches_jax(meshes):
    """Scores within SCORE_TOL wherever the two packages render the
    hypothesis through the same camera; elsewhere within ULP_CAMERA_TOL
    (see the module's docstring). The top-1 pose equal wherever its score
    leads the second by more than SCORE_TOL."""
    ref, port = _refiners(meshes)
    images, Ks, labels, _ = _scene(meshes, B=2)
    boxes = np.array([[330, 150, 470, 290], [120, 210, 260, 370]], np.float32)
    want_T, want_s = ref.classify_coarse(images, Ks, labels, boxes, top_k=2, grid_size=72)
    got_T, got_s = port.classify_coarse(images, Ks, labels, boxes, top_k=2, grid_size=72)
    assert got_s.shape == (2, 72) and got_T.shape == (2, 2, 4, 4)
    alike = _cameras_agree(ref, port, images, Ks, labels, boxes, 72)
    gap = np.abs(got_s - want_s)
    assert alike.sum() >= 20 and gap[alike].max() <= SCORE_TOL, (alike.sum(), gap[alike].max())
    assert gap.max() <= ULP_CAMERA_TOL, gap.max()
    top = np.sort(want_s, axis=1)[:, ::-1]
    clear = top[:, 0] - top[:, 1] > SCORE_TOL
    assert clear.any()
    assert (got_s.argmax(1) == want_s.argmax(1))[clear].all()
    np.testing.assert_allclose(got_T[clear, 0], want_T[clear, 0], atol=POSE_TOL, rtol=0)
    port.meshes.close()


def test_from_checkpoints_loads_older_key_names(meshes, tmp_path):
    """A refiner and a coarse checkpoint in the released layout with the
    older names (backbone.backbone.*, backbone.head.0.*), one under
    "state_dict" and one at the top, the coarse one also carrying a pose
    head: the loaded nets equal the bridged ones; a dropped key raises."""
    _, port = _refiners(meshes)
    old = lambda sd: {("backbone." + k if k.startswith("backbone.") else k): v
                      for k, v in sd.items()}
    rsd = old(port.refiner_net.state_dict())
    csd = {(k.replace("views_logits_head.", "backbone.head.0.")): v
           for k, v in old(port.coarse_net.state_dict()).items()}
    csd.update({k: v for k, v in rsd.items() if k.startswith("pose_fc.")})
    rpath, cpath = str(tmp_path / "refiner.pth.tar"), str(tmp_path / "coarse.pth.tar")
    torch.save({"state_dict": rsd, "epoch": 3}, rpath)
    torch.save(csd, cpath)
    cfg = M.MegaposeRefinerConfig(**TINY)
    loaded = M.MegaposeRefiner.from_checkpoints(rpath, cpath, meshes, config=cfg, width=0.125,
                                                device="cpu")
    for a, b in ((loaded.refiner_net, port.refiner_net), (loaded.coarse_net, port.coarse_net)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sb if "num_batches" not in k)
    fresh = M.MegaposeRefiner.from_checkpoints(None, None, meshes, config=cfg, width=0.125,
                                               device="cpu")
    assert not torch.equal(fresh.refiner_net.pose_fc.weight, port.refiner_net.pose_fc.weight)
    # no checkpoint: the pose head is the identity update, the poses stay
    args = _scene(meshes, B=2)
    out, _ = fresh.refine_batch(*args)
    np.testing.assert_allclose(out, args[3], atol=1e-5)
    del rsd["backbone.backbone.layer2.0.downsample.weight"]
    torch.save({"state_dict": rsd}, rpath)
    with pytest.raises(KeyError, match="layer2.0.downsample.weight"):
        M.MegaposeRefiner.from_checkpoints(rpath, None, meshes, config=cfg, width=0.125,
                                           device="cpu")
    for r in (loaded, fresh, port):
        r.meshes.close()


def test_megapose_refiner_runs_on_the_card_by_default(meshes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.MegaposeRefiner.create(meshes, config=M.MegaposeRefinerConfig(**TINY), width=0.125)


def test_icp_depth_refiner_matches_jax(tmp_path):
    """The scene of tests/test_aux.py:test_icp_depth_refiner (a tilted cube
    0.5 m away, the init 1.4 cm off): equal to the JAX refiner, which
    halves the error."""
    mesh = str(tmp_path / "cube.ply")
    _write_cube_ply(mesh, size=0.08)
    Kc = np.array([[572.4, 0, 320], [0, 573.5, 240], [0, 0, 1.0]], np.float32)
    gt = np.eye(4)
    gt[:3, :3] = Rotation.from_euler("xyz", [25, 30, 10], degrees=True).as_matrix()
    gt[:3, 3] = [0.0, 0.0, 0.5]
    _, depth = Rasterizer(mesh).render(Kc, gt.astype(np.float32), 640, 480)
    init = gt.copy()
    init[:3, 3] += [0.008, -0.005, 0.01]
    kw = dict(n_iterations=15, max_correspondence_dist=0.05)
    got, got_err = D.ICPDepthRefiner({1: Rasterizer(mesh)}, {1: 1.0}, **kw).refine_pose(
        init, depth, Kc, 1)
    want, want_err = JDepth.ICPDepthRefiner({1: JRasterizer(mesh)}, {1: 1.0}, **kw).refine_pose(
        init, depth, Kc, 1)
    assert np.array_equal(got, want) and got_err == want_err
    assert np.linalg.norm(got[:3, 3] - gt[:3, 3]) < 0.5 * np.linalg.norm(init[:3, 3] - gt[:3, 3])
    src = np.random.default_rng(10).normal(size=(50, 3))
    assert np.array_equal(D.kabsch_umeyama(src, src[::-1] + 1), JDepth.kabsch_umeyama(src, src[::-1] + 1))
    assert np.array_equal(D.backproject_depth(depth, Kc, 3, 500),
                          JDepth.backproject_depth(depth, Kc, 3, 500))
    with pytest.raises(ImportError, match="teaserpp_python"):
        D.TeaserppRefiner()
