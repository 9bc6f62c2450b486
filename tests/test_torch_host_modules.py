"""The port's last host modules against the JAX package's (CPU):

- utils/vis.py: every plot's pixels equal to the JAX package's PIL drawing on
  the same inputs (no pixel may differ), and the coarse CLI with vis_every=1
  writing vis/match_*.png and vis/warp_*.png;
- lib3d/sampling.py: the same indices as the JAX package's;
- detector.py: the same dicts and the same json bytes for a model callable
  built here; the torchvision constructor raises ImportError without
  torchvision;
- utils/dashboard.py: the same HTML bytes for run directories written here;
- models/convert.py's DINOv2 hub and HF maps: the port's AENet on the mapped
  state dict against the JAX AENet on dinov2_hub_to_flax /
  dinov2_hf_to_flax of the same dict, to tests/test_torch_models.py's f32
  tolerance (atol 2e-5), with LayerScale raised to 0.3 so that the blocks
  move the features.
"""

import json
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gigapose_tpu import detector as jdet
from gigapose_tpu.lib3d import sampling as jsampling
from gigapose_tpu.lib3d.icosphere import template_object_poses
from gigapose_tpu.models import convert as jconvert
from gigapose_tpu.models.ae_net import AENet as JAENet
from gigapose_tpu.utils import dashboard as jdash
from gigapose_tpu.utils import vis as jvis
from gigapose_tpu_torch import cli
from gigapose_tpu_torch import detector as tdet
from gigapose_tpu_torch.dataloader.png import decode_png
from gigapose_tpu_torch.lib3d import sampling as tsampling
from gigapose_tpu_torch.models import convert as tconvert
from gigapose_tpu_torch.models.ae_net import AENet
from gigapose_tpu_torch.models.vit import VIT_CONFIGS, ViT
from gigapose_tpu_torch.scripts import synthetic_bop
from gigapose_tpu_torch.utils import dashboard as tdash
from gigapose_tpu_torch.utils import vis as tvis
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (a fixture)


def _crops(rng):
    return [rng.normal(size=(3, 224, 224)).astype(np.float32) for _ in range(2)]


def _points(rng, kind):
    """Patch coordinates as the estimator gives them (0..15, rows of -1
    invalid), fractional ones, and ones in (-1, 0) whose dots cross the
    image's edge (PIL truncates towards zero: boxes 3 pixels wide)."""
    pts = rng.integers(0, 16, size=(256, 2)).astype(np.float32)
    pts[rng.random(256) < 0.3] = -1
    if kind == "fractional":
        pts += rng.uniform(0, 1, pts.shape).astype(np.float32)
    elif kind == "edge":
        pts = rng.uniform(-0.99, 16, pts.shape).astype(np.float32)
    return pts


@pytest.mark.parametrize("kind", ["patches", "fractional", "edge"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plot_keypoints_pixels_equal_jax(kind, seed):
    rng = np.random.default_rng(seed)
    src, tar = _crops(rng)
    sp, tp = _points(rng, kind), _points(rng, kind)
    want = np.asarray(jvis.plot_keypoints(src, tar, sp, tp))
    got = tvis.plot_keypoints(torch.from_numpy(src), tar, sp, tp)
    assert got.dtype == np.uint8 and got.shape == want.shape == (224, 448, 3)
    assert int((got != want).any(-1).sum()) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plot_affine_warp_and_grid_pixels_equal_jax(seed):
    rng = np.random.default_rng(seed)
    src, tar = _crops(rng)
    M = np.array([[1.1, 0.1, 3.0], [-0.05, 0.9, -4.0], [0, 0, 1]])
    M[:2] += rng.normal(scale=0.05, size=(2, 3))
    want = np.asarray(jvis.plot_affine_warp(src, tar, M))
    got = tvis.plot_affine_warp(src, tar, M)
    assert got.shape == want.shape == (224, 672, 3)
    assert int((got != want).any(-1).sum()) == 0
    tiles = [rng.integers(0, 256, (10, 12, 3), dtype=np.uint8) for _ in range(3 + 4 * seed)]
    assert np.array_equal(tvis.image_grid(tiles, nrow=4),
                          np.asarray(jvis.image_grid([Image.fromarray(t) for t in tiles], nrow=4)))
    assert np.array_equal(tvis.image_grid([]), np.asarray(jvis.image_grid([])))


def test_coarse_cli_vis_every_writes_the_plots(tmp_path, monkeypatch):
    """vis_every=1 on the two-image fixture: one match and one warp plot per
    image, the sizes of plot_keypoints / plot_affine_warp."""
    monkeypatch.setenv("GIGAPOSE_TINY", "1")
    root = synthetic_bop.build(str(tmp_path), n_test_images=2)
    cli.main([f"machine.root_dir={root}", "test_dataset_name=tudl", "run_id=vis",
              "data.template.num_templates=8", "device=cpu", "vis_every=1"])
    vis_dir = osp.join(root, "results", "large_vis", "vis")
    assert sorted(os.listdir(vis_dir)) == ["match_000000.png", "match_000001.png",
                                           "warp_000000.png", "warp_000001.png"]
    for name, width in (("match_000001.png", 448), ("warp_000000.png", 672)):
        with open(osp.join(vis_dir, name), "rb") as f:
            img = decode_png(f.read())
        assert img.shape == (224, width, 3)


@pytest.mark.parametrize("n,d,k,start", [(50, 3, 12, 0), (200, 5, 40, 7), (10, 2, 20, 3)])
def test_farthest_point_sampling_matches_jax(n, d, k, start):
    pts = np.random.default_rng(n).normal(size=(n, d))
    got_pts, got = tsampling.farthest_point_sampling(pts, k, start)
    want_pts, want = jsampling.farthest_point_sampling(pts, k, start)
    assert np.array_equal(got, want) and np.array_equal(got_pts, want_pts)


@pytest.mark.parametrize("level,views", [(0, 10), (1, 42), (2, 162)])
def test_farthest_viewpoints_matches_jax(level, views):
    poses = template_object_poses(level)
    assert np.array_equal(tsampling.farthest_viewpoints(poses, views),
                          jsampling.farthest_viewpoints(poses, views))


def _model_fn(rgbs):
    """Three detections per image: soft masks around mask_th, two of one
    class (so one-instance-per-class drops one)."""
    outs = []
    for i, rgb in enumerate(rgbs):
        H, W = rgb.shape[:2]
        rng = np.random.default_rng(i)
        masks = rng.uniform(0.5, 1.0, size=(3, H, W)).astype(np.float32)
        outs.append({
            "boxes": np.array([[4, 2, 12, 10], [4.5, 12, 12, 20.25], [20, 2, 30, 10]], np.float32),
            "scores": np.array([0.9, 0.4 + 0.3 * i, 0.8], np.float32),
            "labels": np.array([5, 5, 7], np.int64),
            "masks": masks,
        })
    return outs


@pytest.mark.parametrize("kwargs", [
    {}, {"detection_th": 0.45}, {"one_instance_per_class": True},
    {"mask_th": 0.7, "category_id_map": {5: 1, 7: 2}}])
def test_detector_matches_jax(kwargs, tmp_path):
    rgbs = [np.zeros((32, 40, 3), np.uint8), np.zeros((24, 36, 3), np.uint8)]
    got = tdet.Detector(_model_fn, **kwargs)(rgbs, [3, 3], [11, 12], detection_time=0.25)
    want = jdet.Detector(_model_fn, **kwargs)(rgbs, [3, 3], [11, 12], detection_time=0.25)
    assert got == want and len(got) >= 3
    tdet.save_detections_json(got, str(tmp_path / "port.json"))
    jdet.save_detections_json(want, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    # the helpers alone, on dicts that already carry instance ids
    dets = [dict(d) for d in got] + [{**got[0], "instance_id": 9}]
    assert tdet.add_instance_ids(tdet.filter_one_instance_per_class(
        [dict(d) for d in dets])) == jdet.add_instance_ids(
        jdet.filter_one_instance_per_class([dict(d) for d in dets]))


def test_detector_maskrcnn_needs_torchvision():
    try:
        import torchvision  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="torchvision"):
            tdet.Detector.from_torchvision_maskrcnn(3, device="cpu")
    else:
        det = tdet.Detector.from_torchvision_maskrcnn(3, device="cpu")
        assert callable(det.model_fn)


def _write_run(d, seed, config_name, config_text):
    os.makedirs(osp.join(d, "vis"))
    rng = np.random.default_rng(seed)
    with open(osp.join(d, "metrics.jsonl"), "w") as f:
        for step in range(1, 8):
            rec = {"step": step * 10, "time": 1.0e9 + step, "total": float(rng.normal()),
                   "infoNCE": float(rng.uniform(1, 6)), "tag": "x"}
            if step % 3 == 0:
                rec["val/matching"] = float(rng.uniform())
            f.write(json.dumps(rec) + "\n")
        f.write('{"step": 80, "tot')  # a torn tail line of a live run
    with open(osp.join(d, config_name), "w") as f:
        f.write(config_text)
    for i in range(2):
        path = osp.join(d, "vis", f"match_{i:06d}.png")
        Image.fromarray(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)).save(path)
        os.utime(path, (1.0e9 + i, 1.0e9 + i))


def test_dashboard_html_equals_jax(tmp_path):
    a, b = str(tmp_path / "run_a"), str(tmp_path / "run_b")
    _write_run(a, 0, "config.json", json.dumps({"model": {"lr": 0.001, "name": "a"},
                                                "seed": 1}))
    _write_run(b, 1, "config.yaml", "model:\n  lr: 0.002\n  name: b\nseed: 1\nflag: true\n")
    runs = {"run_a": a, "run_b": b}
    for fields in (None, ["total", "val/matching"]):
        got = tdash.build_dashboard(runs, str(tmp_path / "port.html"), fields=fields,
                                    title="runs")
        want = jdash.build_dashboard(runs, str(tmp_path / "jax.html"), fields=fields,
                                     title="runs")
        with open(got) as f1, open(want) as f2:
            assert f1.read() == f2.read()
    # one run alone (every config key listed), through main
    tdash.main([f"run_dirs={a}", f"out={tmp_path / 'one.html'}"])
    jdash.main([f"run_dirs={a}", f"out={tmp_path / 'one_jax.html'}"])
    port = (tmp_path / "one.html").read_text().replace("gigapose_tpu_torch runs", "T")
    assert port == (tmp_path / "one_jax.html").read_text().replace("gigapose_tpu runs", "T")


def _hub_state_dict(name, seed):
    """A DINOv2 hub state dict of `name`'s shape: a port ViT's leaves
    (LayerScale 0.3) plus the hub's mask_token, which the AE does not use."""
    gen = torch.Generator().manual_seed(seed)
    vit = ViT(VIT_CONFIGS[name])
    sd = {}
    for k, v in vit.state_dict().items():
        sd[k] = (torch.full_like(v, 0.3) if k.endswith("gamma")
                 else torch.randn(v.shape, generator=gen) * 0.05)
    sd["mask_token"] = torch.zeros(1, VIT_CONFIGS[name].embed_dim)
    return sd


def _hub_to_hf(sd, depth):
    hf = {"embeddings.cls_token": sd["cls_token"],
          "embeddings.position_embeddings": sd["pos_embed"],
          "embeddings.patch_embeddings.projection.weight": sd["patch_embed.proj.weight"],
          "embeddings.patch_embeddings.projection.bias": sd["patch_embed.proj.bias"],
          "embeddings.mask_token": sd["mask_token"],
          "layernorm.weight": sd["norm.weight"], "layernorm.bias": sd["norm.bias"]}
    for i in range(depth):
        b, o = f"blocks.{i}.", f"encoder.layer.{i}."
        for w in ("weight", "bias"):
            for n, t in zip(("query", "key", "value"), sd[b + f"attn.qkv.{w}"].chunk(3)):
                hf[o + f"attention.attention.{n}.{w}"] = t
            hf[o + f"attention.output.dense.{w}"] = sd[b + f"attn.proj.{w}"]
            for n in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
                hf[o + f"{n}.{w}"] = sd[b + f"{n}.{w}"]
        hf[o + "layer_scale1.lambda1"] = sd[b + "ls1.gamma"]
        hf[o + "layer_scale2.lambda1"] = sd[b + "ls2.gamma"]
    return hf


@pytest.mark.parametrize("layout,name", [("hub", "vit_tiny_test"),
                                         ("hub", "vit_tiny_swiglu_test"),
                                         ("hf", "vit_tiny_test")])
def test_dinov2_maps_match_jax(layout, name):
    depth = VIT_CONFIGS[name].depth
    sd = _hub_state_dict(name, seed=3)
    if layout == "hf":
        sd = _hub_to_hf(sd, depth)
        flax_vit = jconvert.dinov2_hf_to_flax(sd, depth)
        port_sd = tconvert.dinov2_hf_to_torch(sd, depth)
    else:
        flax_vit = jconvert.dinov2_hub_to_flax(sd, depth)
        port_sd = tconvert.dinov2_hub_to_torch(sd, depth)
    x = np.random.default_rng(4).normal(size=(2, 3, 224, 224)).astype(np.float32)
    want = np.asarray(JAENet(model_name=name).apply(
        {"params": {"vit": jax.tree_util.tree_map(jnp.asarray, flax_vit)}}, jnp.asarray(x)))
    ae = AENet(name).eval()
    ae.load_state_dict(port_sd, strict=True)
    with torch.no_grad():
        got = ae(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 256, VIT_CONFIGS[name].embed_dim)
    np.testing.assert_allclose(got, want, atol=2e-5)
