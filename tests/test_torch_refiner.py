"""The port's refiner (gigapose_tpu_torch/refiner/) against the JAX package's, CPU.

Same inputs, made with numpy from a seed, through both:
- each function of refiner/ops.py: within 1e-5, relative and absolute
  (1e-4 for pixel coordinates and the autodepth pose, values of hundreds:
  f32 sums in another order);
- RefinerNet and CoarseScorerNet at width 8 with seeded variables (jax_vars:
  a random pose head and BatchNorm statistics, which the identity head and
  mean 0 / var 1 would hide), converted by
  models.convert.refiner_flax_to_torch: within 1e-5;
- build_device_meshes and the decimation: exact;
- refine_batch with the host renderer (against the JAX host loop in one
  chunk and pipelined in two: per-sample results do not depend on the
  split) and the device renderer, at 64x64 with 2 iterations, on those
  nets, with
  keep_best_init off (every pose must move by more than 1e-2) and on (the
  referee keeps one init and two refined poses): poses and scores within
  2e-4. The two packages' crop boxes are 1 ulp apart, which moves the crops
  by up to 3e-5 and now and then a uint8 render by one step at a pixel; the
  random BatchNorm scales amplify that into 1e-5 to 1.2e-4 over 2
  iterations and the scoring passes.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gigapose_tpu.refiner import device_render as JDR
from gigapose_tpu.refiner import ops as JO
from gigapose_tpu.refiner.network import CoarseScorerNet as JScorer
from gigapose_tpu.refiner.network import RefinerNet as JRefiner
from gigapose_tpu.refiner.refiner import RefinerConfig as JConfig
from gigapose_tpu.refiner.refiner import RenderCompareRefiner as JRefinerLoop
from gigapose_tpu_torch.models.convert import refiner_flax_to_torch
from gigapose_tpu_torch.refiner import device_render as DR
from gigapose_tpu_torch.refiner import ops as O
from gigapose_tpu_torch.refiner.network import CoarseScorerNet, RefinerNet
from gigapose_tpu_torch.refiner.refiner import (
    RefinerConfig,
    RenderCompareRefiner,
    no_tf32,
)
from tests.test_rasterizer import _write_cube_ply

K = np.array([[572.4114, 0, 320], [0, 573.57043, 240], [0, 0, 1.0]], np.float32)
POSE_TOL, SCORE_TOL = 2e-4, 2e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _poses(B, seed):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = Rotation.random(B, random_state=seed).as_matrix()
    T[:, :3, 3] = rng.normal(0, 0.03, (B, 3)) + [0, 0, 0.5]
    return T


def test_ops_match_jax():
    rng = np.random.default_rng(0)
    B = 5
    T = _poses(B, 1)
    Ks = np.repeat(K[None], B, 0)
    pts = rng.normal(0, 0.04, (B, 12, 3)).astype(np.float32)
    close = lambda got, want, tol=1e-5: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    JO_ = {n: jax.jit(getattr(JO, n)) for n in (
        "project_points_robust", "boxes_from_uv", "rotation_from_ortho6d", "normalize_T",
        "TCO_init_from_boxes_autodepth_with_R", "pose_update_with_reference_point")}

    uv = O.project_points_robust(_t(pts), _t(Ks), _t(T))
    close(uv, JO_["project_points_robust"](jnp.asarray(pts), jnp.asarray(Ks), jnp.asarray(T)), 1e-4)
    boxes = O.boxes_from_uv(uv)
    close(boxes, JO_["boxes_from_uv"](jnp.asarray(uv.numpy())), 0)
    center = uv[:, :1] + 3.0
    for clamp in (False, True):
        got = O.deepim_boxes(center, boxes, boxes + 5.0, (480, 640), 1.4, clamp=clamp)
        want = jax.jit(JO.deepim_boxes, static_argnums=(3, 4, 5))(
            jnp.asarray(center.numpy()), jnp.asarray(boxes.numpy()),
            jnp.asarray(boxes.numpy() + 5.0), (480, 640), 1.4, clamp)
        close(got, want)
    crop_boxes = np.array([[3.3, 5.1, 40.2, 30.7], [-5.0, 10.0, 70.0, 60.0], [10, 10, 20, 20],
                           [0, 0, 64, 48], [30.5, 2.25, 90.0, 66.0]], np.float32)
    close(O.get_K_crop_resize(_t(Ks), _t(crop_boxes), (48, 64), (16, 24)),
          jax.jit(JO.get_K_crop_resize, static_argnums=(2, 3))(
              jnp.asarray(Ks), jnp.asarray(crop_boxes), (48, 64), (16, 24)))
    img = rng.uniform(size=(B, 3, 48, 64)).astype(np.float32)
    for r in (1, 4):
        close(O.crop_images_to_boxes(_t(img), _t(crop_boxes), (16, 24), r),
              jax.jit(JO.crop_images_to_boxes, static_argnums=(2, 3))(
                  jnp.asarray(img), jnp.asarray(crop_boxes), (16, 24), r))
    o6 = rng.normal(size=(B, 6)).astype(np.float32)
    close(O.rotation_from_ortho6d(_t(o6)), JO_["rotation_from_ortho6d"](jnp.asarray(o6)))
    Tn = T.copy()
    Tn[:, :3, :3] *= 1.03
    close(O.normalize_T(_t(Tn)), JO_["normalize_T"](jnp.asarray(Tn)))
    R = T[:, :3, :3].copy()
    close(O.TCO_init_from_boxes_autodepth_with_R(_t(crop_boxes), _t(pts), _t(Ks), _t(R)),
          JO_["TCO_init_from_boxes_autodepth_with_R"](jnp.asarray(crop_boxes), jnp.asarray(pts),
                                                  jnp.asarray(Ks), jnp.asarray(R)), 1e-4)
    v = rng.normal(0, 5, (B, 3)).astype(np.float32)
    v[:, 2] = rng.uniform(0.8, 1.2, B)
    dR = Rotation.random(B, random_state=3).as_matrix().astype(np.float32)
    tCR = T[:, :3, 3] + 0.01
    close(O.pose_update_with_reference_point(_t(T), _t(Ks), _t(v), _t(dR), _t(tCR)),
          JO_["pose_update_with_reference_point"](jnp.asarray(T), jnp.asarray(Ks), jnp.asarray(v),
                                              jnp.asarray(dR), jnp.asarray(tCR)))


def jax_vars(net, seed, size=64):
    """Seeded variables of a JAX RefinerNet / CoarseScorerNet, made with
    numpy on the tree of net.init (traced, not compiled): kernels normal
    with std 1 / sqrt(fan_in), the pose head's kernel small and random (the
    identity head would leave every pose where it is), BatchNorm scale,
    bias, mean and var random (flax's 1 / 0 / 0 / 1 would hide a wrong
    mapping); Dense biases 0, as flax initialises them."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 6, size, size)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        shape, name = leaf.shape, names[-1]
        if name == "kernel":
            std = (0.08 if "pose_head" in names else 1.0) / np.sqrt(np.prod(shape[:-1]))
            a = rng.normal(0, std, shape)
        elif name == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        elif name == "mean":
            a = rng.normal(0, 0.1, shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "bias" and names[-2] in ("pose_head", "logit_head"):
            a = np.zeros(shape)
        else:  # BatchNorm bias
            a = rng.normal(0, 0.05, shape)
        return a.astype(np.float32)

    return flax.core.unfreeze(jax.tree_util.tree_map_with_path(fill, shapes))


@pytest.mark.parametrize("jnet,tnet", [(JRefiner, RefinerNet), (JScorer, CoarseScorerNet)])
def test_nets_match_jax_through_the_bridge(jnet, tnet):
    net = jnet(width=8)
    v = jax_vars(net, 1)
    port = tnet(width=8).eval()
    port.load_state_dict(refiner_flax_to_torch(v), strict=True)
    x = np.random.default_rng(2).uniform(size=(3, 6, 64, 64)).astype(np.float32)
    with torch.no_grad():
        got = port(_t(x)).numpy()
    want = np.asarray(jax.jit(net.apply)(v, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if jnet is JRefiner:  # the perturbed head moves the update off the identity
        assert np.abs(want - np.eye(3)[:, :3].reshape(-1)[None]).max() > 1e-2


def test_device_meshes_match_jax(tmp_path):
    from bench import _write_sphere_ply

    cube, sphere = str(tmp_path / "cube.ply"), str(tmp_path / "sphere.ply")
    _write_cube_ply(cube, size=0.08)
    _write_sphere_ply(sphere, radius_m=0.05, levels=2)  # 320 faces
    paths, units = {1: cube, 2: sphere}, {1: 1.0, 2: 1e-3}
    for max_faces in (None, 200):
        got = DR.build_device_meshes(paths, units, torch.device("cpu"), max_faces=max_faces)
        want = JDR.build_device_meshes(paths, units, chunk=64, max_faces=max_faces)
        assert got.label_to_row == want.label_to_row
        for f in ("verts", "faces", "colors"):
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert g.dtype == w.dtype and np.array_equal(g, w), f
        assert np.array_equal(got.rows_for(np.array([2, 1, 2])), want.rows_for(np.array([2, 1, 2])))
    v, f, c = (np.asarray(a) for a in (want.verts[1], want.faces[1], want.colors[1]))
    for budget in (250, 150):
        mine = DR.decimate_vertex_clustering(v, f, c, budget)
        ref = JDR.decimate_vertex_clustering(v, f, c, budget)
        assert len(mine[1]) <= budget
        for g, w in zip(mine, ref):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def _refiners(tmp_path, jax_chunks=1, port_chunks=1, **cfg):
    """The JAX refiner at width 8 with seeded variables (jax_vars), its host
    loop in `jax_chunks` pipelined chunks, and the port's with the same
    variables through the bridge, its host loop in `port_chunks`."""
    from gigapose_tpu.refiner.refiner import MeshStore as JMeshStore

    mesh = str(tmp_path / "cube.ply")
    _write_cube_ply(mesh, size=0.08)
    kw = dict(n_iterations=2, render_size=(64, 64), n_sample_points=8, **cfg)
    rnet, snet = JRefiner(width=8), JScorer(width=8)
    ref = JRefinerLoop(rnet, jax_vars(rnet, 1), snet, jax_vars(snet, 4),
                       JMeshStore({1: mesh}, 8), JConfig(pipeline_chunks=jax_chunks, **kw))
    port = RenderCompareRefiner.create({1: mesh}, config=RefinerConfig(pipeline_chunks=port_chunks,
                                                                       **kw),
                                       refiner_width=8, scorer_width=8, device="cpu")
    port.refiner_net.load_state_dict(refiner_flax_to_torch(ref.refiner_vars), strict=True)
    port.scorer_net.load_state_dict(refiner_flax_to_torch(ref.scorer_vars), strict=True)
    return ref, port


def _port(tmp_path, **cfg):
    mesh = str(tmp_path / "cube.ply")
    _write_cube_ply(mesh, size=0.08)
    return RenderCompareRefiner.create(
        {1: mesh}, config=RefinerConfig(n_iterations=2, render_size=(64, 64), n_sample_points=8,
                                        **cfg), refiner_width=8, scorer_width=8, device="cpu")


def _scene(ref, B=3):
    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = [0.02, -0.01, 0.5]
    rgba, _ = ref.meshes.rasterizers[1].render(K, gt, 640, 480)
    img = rgba[..., :3].transpose(2, 0, 1).astype(np.float32)[None] / 255.0
    init = np.repeat(gt[None], B, 0)
    init[:, :3, 3] += [[0.01, 0.005, 0.03], [-0.01, 0.0, 0.02], [0.0, 0.01, -0.02]][:B]
    return np.repeat(img, B, 0), np.repeat(K[None], B, 0), np.ones(B, np.int64), init


CHUNK_TOL = 1e-6


@pytest.fixture(scope="module")
def runs():
    """refine_batch results shared by the cases of one loop form: the JAX
    loop's per (renderer, chunks, keep), the port's one chunk per
    (renderer, keep); every case builds the same seeded nets and scene."""
    return {}


@pytest.mark.parametrize("renderer,chunks,keep,port_chunks", [
    ("host", 1, False, 1), ("host", 2, True, 1), ("host", 2, True, 2), ("host", 2, True, 3),
    ("host", 2, False, 1), ("host", 2, False, 2), ("host", 2, False, 3),
    ("device", 1, False, 1), ("device", 1, True, 1)])
def test_refine_batch_matches_jax(tmp_path, runs, renderer, chunks, keep, port_chunks):
    """`chunks`: the JAX host loop's pipelined chunks; `port_chunks`: the
    port's (config.pipeline_chunks). The port's chunked loop also holds to
    its own one-chunk loop within CHUNK_TOL: each sample's result does not
    depend on the split, up to the CPU convolutions' sums, whose order
    changes with the batch size (a few ulps; 3e-8 read here)."""
    ref, port = _refiners(tmp_path, jax_chunks=chunks, renderer=renderer, keep_best_init=keep,
                          port_chunks=port_chunks)
    args = _scene(ref)
    if (renderer, chunks, keep) not in runs:
        runs[renderer, chunks, keep] = ref.refine_batch(*args)
    want_T, want_s = runs[renderer, chunks, keep]
    got_T, got_s = port.refine_batch(*args)
    assert got_T.shape == (3, 4, 4) and got_s.shape == (3,)
    np.testing.assert_allclose(got_T, want_T, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(got_s, want_s, atol=SCORE_TOL, rtol=0)
    if port_chunks == 1:
        runs["port", renderer, keep] = got_T, got_s
    else:
        if ("port", renderer, keep) not in runs:
            one = dataclasses.replace(port, config=dataclasses.replace(port.config,
                                                                       pipeline_chunks=1))
            runs["port", renderer, keep] = one.refine_batch(*args)
        one_T, one_s = runs["port", renderer, keep]
        np.testing.assert_allclose(got_T, one_T, atol=CHUNK_TOL, rtol=0)
        np.testing.assert_allclose(got_s, one_s, atol=CHUNK_TOL, rtol=0)
    moved = np.abs(want_T - args[3]).max(axis=(1, 2))
    if keep:  # the referee keeps the init (normalized) or the refined pose: with
        # these seeds the first hypothesis's init, the other two refined
        kept = moved < 1e-6
        assert (kept | (moved > 1e-2)).all() and kept.any() and not kept.all()
    else:
        assert moved.min() > 1e-2  # every pose moved
    np.testing.assert_allclose(got_T[:, :3, :3] @ got_T[:, :3, :3].transpose(0, 2, 1),
                               np.repeat(np.eye(3)[None], 3, 0), atol=1e-5)
    port.meshes.close()


def test_host_u8_renders_are_exact_and_timing_sums(tmp_path):
    """The uint8 upload is exact (u8 / 255 on the device == the host's f32
    renders), and the host loop's phase timing collects its three phases."""
    port = _port(tmp_path)
    Kc = np.array([[572.4, 0, 32], [0, 573.5, 32], [0, 0, 1.0]], np.float32)[None]
    T = np.eye(4, dtype=np.float32)[None]
    T[:, 2, 3] = 0.5
    u8 = port.meshes.render_batch(np.array([1]), T, Kc, (64, 64), out_dtype=np.uint8)
    f32 = port.meshes.render_batch(np.array([1]), T, Kc, (64, 64))
    assert u8.dtype == np.uint8 and u8.any()
    assert torch.equal(port._upload(u8), torch.from_numpy(f32))
    port.timing = {}
    port.refine_batch(*_scene(port, B=3))
    assert sorted(port.timing) == ["fetch", "render", "upload_update"]
    port.meshes.close()


def test_keep_best_init_keeps_a_better_init(tmp_path):
    """With a referee that prefers the render closest to the observed crop,
    a perfect init survives a refiner that degrades it, in both loops; with
    keep_best_init off the degraded pose comes back."""
    for renderer in ("host", "device"):
        port = _port(tmp_path, renderer=renderer)
        with torch.no_grad():
            port.refiner_net.pose_head.weight.zero_()
            port.refiner_net.pose_head.bias.zero_()
            port.refiner_net.pose_head.bias[8] = 0.3  # push every pose 30 % deeper
        port._score = lambda crops, renders: torch.exp(-10 * (crops - renders).abs().mean((1, 2, 3)))
        img, Ks, labels, _ = _scene(port, B=1)
        gt = np.eye(4, dtype=np.float32)[None]
        gt[:, :3, 3] = [0.02, -0.01, 0.5]
        out, scores = port.refine_batch(img, Ks, labels, gt)
        np.testing.assert_allclose(out, gt, atol=1e-5)
        assert float(scores[0]) > 0.5
        off = dataclasses.replace(port, config=dataclasses.replace(port.config,
                                                                   keep_best_init=False))
        assert np.abs(off.refine_batch(img, Ks, labels, gt)[0] - gt).max() > 1e-2
        port.meshes.close()


def test_refiner_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """create() without a device takes cuda:0 and raises where there is no
    card; no_tf32 turns TF32 off for the call and restores the flags."""
    mesh = str(tmp_path / "cube.ply")
    _write_cube_ply(mesh, size=0.08)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RenderCompareRefiner.create({1: mesh}, refiner_width=8, scorer_width=8)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.enabled)
    with no_tf32():
        assert not cudnn.allow_tf32 and not matmul.allow_tf32 and cudnn.enabled == before[2]
    assert (cudnn.allow_tf32, matmul.allow_tf32, cudnn.enabled) == before
