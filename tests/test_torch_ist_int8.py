"""The port's int8 IST serving path (models/ist_int8, ops/qconv) == the JAX
package's (gigapose_tpu/models/ist_int8.py) on the CPU, at the JAX tests'
tiny IST (initial_dim 16, block_dims 16/16/24/32, descriptor 32, input
256), with random BatchNorm statistics so that the fold is exercised.

The port's plain versions accumulate the int8 codes exactly and round each
scale, quotient, product and sum as JAX's "ref" backend does; at these
widths (K <= 9 * 32 = 288, partial sums below 127^2 * 288 < 2^24) JAX's f32
accumulation is exact too, and the resize samples the same points (models/
ist_net.align_corners_points). So the tolerance is 0 throughout, apart from
the calibration absmaxes (1 ulp, as stated) and the CLI, whose crops come
from another crop kernel (the bounds of tests/test_torch_cli.py).
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test as jax_cli
from gigapose_tpu.models import ist_int8 as J8
from gigapose_tpu.models.ist_net import ISTBackbone as JISTBackbone
from gigapose_tpu.models.ist_net import ISTNet as JISTNet
from gigapose_tpu.models.ist_net import Regressor as JRegressor
from gigapose_tpu.utils.config import load_config as jax_load_config
from gigapose_tpu_torch import cli
from gigapose_tpu_torch.dataloader import bop_io
from gigapose_tpu_torch.models import convert
from gigapose_tpu_torch.models import ist_int8 as T8
from gigapose_tpu_torch.models.ist_net import ISTBackbone, ISTNet, Regressor
from gigapose_tpu_torch.ops import qconv as QC
from gigapose_tpu_torch.pipeline.runner import CoarseRunner
from gigapose_tpu_torch.utils.config import load_config
from tests import synthetic_bop

T = torch.as_tensor
TINY = dict(initial_dim=16, block_dims=(16, 16, 24, 32), descriptor_size=32, input_size=256)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _nets(seed=0):
    """The JAX tiny ISTNet with random BatchNorm statistics, and the port's
    twin with the same weights."""
    jnet = JISTNet(backbone=JISTBackbone(**TINY), regressor=JRegressor(hidden_dim=32))
    d = jnp.zeros((1, 3, 224, 224), jnp.float32)
    pts = jnp.zeros((1, 4, 2), jnp.float32)
    v = _tree(jnet.init(jax.random.PRNGKey(seed), d, d, pts, pts))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 2.0, x.shape) if "var" in jax.tree_util.keystr(path)
                         else rng.normal(scale=0.1, size=x.shape)).astype(np.float32),
        v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    net = ISTNet(ISTBackbone(**TINY), Regressor(64, hidden_dim=32)).eval()
    net.load_state_dict(convert.ist_flax_to_torch(v), strict=True)
    return jnet, v, net


def _images(seed, B):
    return np.random.default_rng(seed).normal(size=(B, 3, 224, 224)).astype(np.float32)


def _assert_trees_equal(got, want):
    assert got.keys() == want.keys()
    for k in ("conv1", "out"):
        assert got[k].keys() == want[k].keys()
        for f in got[k]:
            assert torch.equal(got[k][f], want[k][f]), (k, f)
    assert len(got["layers"]) == len(want["layers"])
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        assert g.keys() == w.keys(), i
        for name in g:
            for f in g[name]:
                assert g[name][f].dtype == w[name][f].dtype
                assert torch.equal(g[name][f], w[name][f]), (i, name, f)


def test_prepare_int8_ist_params_matches_jax():
    """wq equal, ws (BN scale folded in) and b bit-equal, down convs where
    the stage strides; the weight (O, KH*KW*I) K-contiguous."""
    jnet, v, net = _nets(1)
    want = convert.ist_int8_params_flax_to_torch(_tree(J8.prepare_int8_ist_params(v, jnet.backbone)))
    got = T8.prepare_int8_ist_params(net)
    _assert_trees_equal(got, want)
    assert [("down" in b) for b in got["layers"]] == [False, False] + [True, False] * 3
    assert got["conv1"]["wq"].shape == (16, 7 * 7 * 3) and got["conv1"]["wq"].is_contiguous()


@pytest.mark.parametrize("ks,stride,pad,residual,relu,static", [
    (7, 2, 3, False, True, False),  # the stem: K = 147, not a multiple of 16
    (3, 1, 1, True, True, False),
    (3, 2, 1, False, True, True),
    (1, 2, 0, False, False, False),
    (1, 1, 0, False, False, True),
])
def test_qconv_ops_match_jax_qconv(ks, stride, pad, residual, relu, static):
    """ops/qconv's act_scale -> quantize_act -> qconv on CPU tensors (the
    plain versions) == JAX's _qconv (backend "ref") on odd shapes, with the
    residual and ReLU applied to JAX's output as its forward does: equal."""
    rng = np.random.default_rng(ks + 10 * stride)
    B, H, W, C, O = 2, 13, 11, 3 if ks == 7 else 24, 20
    x = (rng.normal(size=(B, H, W, C)) * rng.uniform(0.5, 3, (B, 1, 1, 1))).astype(np.float32)
    k = rng.normal(size=(ks, ks, C, O)).astype(np.float32)
    wq, ws = J8._quantize_conv_weight(k)
    layer = {"wq": wq, "ws": ws, "b": jnp.asarray(rng.normal(size=O), jnp.float32)}
    if static:
        layer["sa"] = jnp.asarray(np.abs(x).max() * 0.7 / 127.0, jnp.float32)  # clips
    want = J8._qconv(jnp.asarray(x), layer, stride, pad, "ref")
    OH, OW = QC.out_size(H, ks, stride, pad), QC.out_size(W, ks, stride, pad)
    res = rng.normal(size=(B, OH, OW, O)).astype(np.float32)
    if residual:
        want = want + res
    want = np.asarray(jax.nn.relu(want) if relu else want)
    tl = convert.ist_int8_params_flax_to_torch(
        {"conv1": _tree(layer), "layers": [], "out": _tree(layer)})["conv1"]
    xt = T(x)
    sx = tl["sa"] if static else QC.act_scale(xt)
    if not static:
        np.testing.assert_array_equal(
            sx.numpy(), np.maximum(np.abs(x).max(axis=(1, 2, 3)) / np.float32(127), 1e-12))
    xq = QC.quantize_act(xt, sx)
    assert xq.dtype == torch.int8 and int(xq.abs().max()) <= 127
    got = QC.qconv(xq, sx, tl["wq"], tl["ws"], tl["b"], stride, pad,
                   T(res) if residual else None, relu)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_dynamic_features_match_jax_ref():
    jnet, v, net = _nets(2)
    x = _images(2, 2)
    jq = J8.prepare_int8_ist_params(v, jnet.backbone)
    want = np.asarray(J8.ist_features_int8(jq, jnp.asarray(x), 256, backend="ref"))
    with torch.no_grad():
        got = T8.ist_features_int8(T8.prepare_int8_ist_params(net), T(x)).numpy()
    assert got.shape == want.shape == (2, 256, 32)
    np.testing.assert_array_equal(got, want)


def test_act_absmax_and_static_features_match_jax():
    """Calibration absmaxes within 1 ulp of JAX's (the same reduction of the
    same values; measured equal), then the static path on held-out images
    with scales attached from each side's own absmaxes: equal features."""
    jnet, v, net = _nets(3)
    calib, x = _images(3, 2), _images(4, 2)
    jq = J8.prepare_int8_ist_params(v, jnet.backbone)
    tq = T8.prepare_int8_ist_params(net)
    ja = J8.ist_act_absmax(jq, jnp.asarray(calib), 256, backend="ref")
    with torch.no_grad():
        ta = T8.ist_act_absmax(tq, T(calib))
    assert len(ta) == len(ja) == 1 + 2 * 8 + 3 + 1
    ulp = np.spacing(np.float32(ja))
    assert (np.abs(np.float32(ta) - np.float32(ja)) <= ulp).all()
    js = J8.attach_static_act_scales(jq, ja, margin=1.1)
    ts = T8.attach_static_act_scales(tq, ta, margin=1.1)
    _assert_trees_equal(ts, convert.ist_int8_params_flax_to_torch(_tree(js)))
    want = np.asarray(J8.ist_features_int8(js, jnp.asarray(x), 256, backend="ref"))
    with torch.no_grad():
        got = T8.ist_features_int8(ts, T(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_static_on_the_calibration_image_equals_dynamic():
    """At B=1 the calibration absmax and the dynamic per-image absmax are
    the same number, and max(a / 127, 1e-12) in Python floats rounded once
    to f32 is the f32 quotient: every scale, hence every output, is equal."""
    _, _, net = _nets(4)
    x = T(_images(5, 1))
    q = T8.ISTNetInt8.from_ist_net(net).eval()
    with torch.no_grad():
        dyn = q.features(x)
        q.calibrate(x, margin=1.0)
        sta = q.features(x)
    assert not q.static_pending and "sa" in q.params["conv1"]
    assert torch.equal(sta, dyn)


def test_attach_static_scales_raises_on_a_list_of_the_wrong_length():
    """JAX raises ValueError for a long list and a bare StopIteration for a
    short one; the port raises ValueError for both."""
    _, _, net = _nets(5)
    tq = T8.prepare_int8_ist_params(net)
    n = 1 + 2 * 8 + 3 + 1
    T8.attach_static_act_scales(tq, [1.0] * n)
    for wrong in (n - 1, n + 1):
        with pytest.raises(ValueError, match=f"{wrong} calibration absmaxes"):
            T8.attach_static_act_scales(tq, [1.0] * wrong)


def test_int8_ist_net_regress_and_training_mode():
    """regress (and the float net under it) is the float net's; features
    has the float features' shape and stays close to them (the JAX test's
    mean cosine gate, > 0.995); training mode raises."""
    jnet, v, net = _nets(6)
    q = T8.ISTNetInt8.from_ist_net(net).eval()
    assert next(q.parameters()) is next(net.parameters())
    rng = np.random.default_rng(6)
    x = T(_images(6, 2))
    with torch.no_grad():
        feats, ref = q.features(x), net.features(x)
        pts = T(rng.integers(0, 16, size=(2, 8, 2)).astype(np.float32))
        got, want = q.regress(feats, feats, pts, pts), net.regress(feats, feats, pts, pts)
        assert torch.equal(got.scale, want.scale) and torch.equal(got.cossin, want.cossin)
        both = q(x, x, pts, pts)
    assert torch.equal(both.scale, q.regress(feats, feats, pts, pts).scale)
    assert feats.shape == ref.shape == (2, 256, 32)
    cos = torch.nn.functional.cosine_similarity(feats, ref, dim=-1)
    assert float(cos.mean()) > 0.995
    q.train()
    with pytest.raises(NotImplementedError, match="inference-only"):
        q.features(x)
    with pytest.raises(NotImplementedError, match="inference-only"):
        q.calibrate(x)


def test_int8_ist_refuses_attention_stages():
    net = ISTNet(ISTBackbone(**TINY, num_attn_heads=2), Regressor(64, hidden_dim=32))
    with pytest.raises(NotImplementedError, match="attention-free"):
        T8.ISTNetInt8.from_ist_net(net)


def _tiny_estimator():
    return cli.build_estimator(load_config("test", ["device=cpu", "model.serving_quant=off"]),
                               tiny=True)


@pytest.mark.parametrize("ist", [True, "static"])
def test_onboarding_calibrates_static_scales_once(tmp_path, monkeypatch, ist):
    """quantize_serving(ist=...) then CoarseRunner.onboard: with static
    scales the first onboarding calibrates once, on the first object's first
    16 template crops (prepared as onboarding prepares them), before any
    feature is extracted; a second onboarding does not calibrate again. With
    dynamic scales nothing is calibrated."""
    root = synthetic_bop.build(str(tmp_path), num_templates=18)
    tdir = osp.join(root, "datasets", "templates", "tudl")
    est = _tiny_estimator().quantize_serving(ist=ist)
    assert isinstance(est.ist_net, T8.ISTNetInt8)
    assert est.ist_net.static_pending == (ist == "static")
    calls = []
    calibrate = T8.ISTNetInt8.calibrate

    def spy(self, images, margin=1.0):
        calls.append((images.clone(), margin, self.static_pending))
        return calibrate(self, images, margin)

    monkeypatch.setattr(T8.ISTNetInt8, "calibrate", spy)
    runner = CoarseRunner.onboard(est, template_dir=tdir, save_dir=str(tmp_path / "r"),
                                  dataset_name="tudl")
    CoarseRunner.onboard(est, template_dir=tdir, save_dir=str(tmp_path / "r2"),
                         dataset_name="tudl")
    assert torch.isfinite(runner.store.ist_features).all()
    if ist is True:
        assert calls == []
        return
    assert len(calls) == 1 and calls[0][1] == 1.1 and calls[0][2]
    assert not est.ist_net.static_pending
    from gigapose_tpu_torch.dataloader.templates_disk import list_objects, load_object_templates
    from gigapose_tpu_torch.pipeline.templates import prepare_template_crops

    first = list_objects(tdir)[0]
    rgba = load_object_templates(tdir, first, None, 1.0, as_uint8=True)["rgba"]
    assert len(rgba) == 18
    want = prepare_template_crops(rgba[:16], torch.device("cpu"))
    assert torch.equal(calls[0][0], want)


def test_cache_tag_suffixes():
    """-int8 for the int8 AE, then -int8ist / -int8ists for the int8 IST
    with dynamic / static scales, as test.py tags them."""
    cfg = load_config("test", ["device=cpu", "onboarding_cache=tiny"])
    tags = []
    for ist in (None, False, True, "static"):
        est = _tiny_estimator()
        if ist is not None:
            est.quantize_serving(ist=ist)
        tags.append(cli._cache_tag(cfg, est))
    assert tags == ["tiny", "tiny-int8", "tiny-int8-int8ist", "tiny-int8-int8ists"]
    assert cli._cache_tag(load_config("test", ["device=cpu"]), _tiny_estimator()) is None


NAME = "large-pbrreal-rgb-mmodel_tudl-test_{}{}.csv"


def _csv(root, run_id, multi):
    path = osp.join(root, "results", f"large_{run_id}", "predictions",
                    NAME.format(run_id, "MultiHypothesis" if multi else ""))
    return bop_io.load_bop_csv(path, extra_column="instance_id" if multi else None)


def test_cli_serves_static_int8_ist_as_test_py(tmp_path, monkeypatch):
    """Both CLIs with model.serving_quant=int8 model.serving_quant_ist=
    int8-static on the synthetic fixture (GIGAPOSE_TINY nets, JAX's init in
    the port's nets before they are quantized), an f32 store.

    The two packages' crops are up to 1 ulp apart (ROADMAP C: XLA's fused
    CPU code), and a quantizer turns such a difference into whole int8
    steps: an absmax an ulp apart moves a scale, a value at a rounding
    boundary moves a code, and the random tiny IST carries each step through
    21 convolutions. So the IST stores are not held to test_torch_cli.py's
    2e-5 (the int8 path on equal inputs is, exactly, in the tests above):
    they are held to a mean |difference| within one int8 step of the output
    convolution's output (its absmax / 127; measured a third of it) and a
    per-descriptor cosine above 0.999 (measured 0.99935 at the least). The
    AE store (int8 too) holds 2e-6 of its largest value, the rows hold
    their ids, the scores 1e-4; R and t, regressed from the IST features by
    a random net, are checked finite and orthonormal (they moved by up to
    4.2e-3 and 3.6 mm)."""
    est = jax_cli.build_estimator(jax_load_config("test"), tiny=True)
    ae_sd = convert.ae_flax_to_torch(_tree(est.ae_params))
    ist_sd = convert.ist_flax_to_torch(_tree(est.ist_vars))
    quantize = cli._maybe_quantize

    def load_then_quantize(est, cfg):
        est.ae_net.load_state_dict(ae_sd, strict=True)
        est.ist_net.load_state_dict(ist_sd, strict=True)
        return quantize(est, cfg)

    monkeypatch.setattr(cli, "_maybe_quantize", load_then_quantize)
    monkeypatch.setenv("GIGAPOSE_TINY", "1")
    root = synthetic_bop.build(str(tmp_path))
    common = [f"machine.root_dir={root}", "test_dataset_name=tudl",
              "data.template.num_templates=8", "model.feature_dtype=f32",
              "model.serving_quant=int8", "model.serving_quant_ist=int8-static"]
    jax_cli.main(common + ["run_id=jax", "onboarding_cache=jax"])
    runner = cli.main(common + ["run_id=port", "device=cpu", "onboarding_cache=port"])
    assert isinstance(runner.estimator.ist_net, T8.ISTNetInt8)
    assert not runner.estimator.ist_net.static_pending
    tdir = osp.join(root, "datasets", "templates", "tudl")
    port = np.load(osp.join(tdir, "onboarded_port-int8-int8ists.npz"))
    ref = np.load(osp.join(tdir, "onboarded_jax-int8-int8ists.npz"))
    ae_diff = np.abs(port["ae_features"] - ref["ae_features"])
    assert ae_diff.max() <= 2e-6 * np.abs(ref["ae_features"]).max()
    a, b = port["ist_features"], ref["ist_features"]
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).mean() <= np.abs(b).max() / 127
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.min() > 0.999
    for multi in (False, True):
        got, want = _csv(root, "port", multi), _csv(root, "jax", multi)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for key in ("scene_id", "im_id", "obj_id", "instance_id"):
                assert g.get(key) == w.get(key), key
            np.testing.assert_allclose(g["score"], w["score"], atol=1e-4)
            assert np.isfinite(g["t"]).all()
            np.testing.assert_allclose(g["R"] @ g["R"].T, np.eye(3), atol=1e-4)
