"""Port networks == flax networks under one random init (CPU, f32).

The flax params come from jax.random.PRNGKey inits and enter the port through
the weight bridge (gigapose_tpu_torch/models/convert.py). Tolerances: the ViT
and AE agree to atol 2e-5 (f32 matmuls over <= 256-wide contractions and a
softmax, summed in another order); the IST backbone, whose activations grow
to O(10) through ten convolutions with 3x3x512 contractions, to rtol 1e-4 /
atol 1e-4; the regressor MLP to 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapose_tpu.models import convert as jconvert
from gigapose_tpu.models.ae_net import AENet as JAENet
from gigapose_tpu.models.ist_net import ISTBackbone as JISTBackbone
from gigapose_tpu.models.ist_net import ISTNet as JISTNet
from gigapose_tpu.models.ist_net import Regressor as JRegressor
from gigapose_tpu.models.vit import ViT as JViT
from gigapose_tpu.models.vit import VIT_CONFIGS as J_VIT_CONFIGS
from gigapose_tpu_torch.models import convert as tconvert
from gigapose_tpu_torch.models.ae_net import AENet
from gigapose_tpu_torch.models.ist_net import (
    ISTBackbone, ISTNet, ISTResult, Regressor, fill_invalid,
)
from gigapose_tpu_torch.models.vit import VIT_CONFIGS, ViT

T = torch.as_tensor


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, B, S):
    return np.random.default_rng(seed).normal(size=(B, 3, S, S)).astype(np.float32)


def _bump_layerscale(params, value=0.3):
    """LayerScale inits at 1e-5, which hides the blocks; raise it so the test
    sees the attention / MLP arithmetic."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.full_like(x, value) if "gamma" in jax.tree_util.keystr(path) else x,
        params,
    )


@pytest.mark.parametrize("name,size", [("vit_tiny_test", 224), ("vit_tiny_test", 56),
                                       ("vit_tiny_swiglu_test", 56)])
def test_vit_matches_flax(name, size):
    """56 crops give a 4x4 grid: the antialiased bicubic pos-embed resize."""
    x = _images(0, 2, size)
    jvit = JViT(J_VIT_CONFIGS[name])
    params = _bump_layerscale(jvit.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = jvit.apply({"params": params}, jnp.asarray(x))
    vit = ViT(VIT_CONFIGS[name]).eval()
    vit.load_state_dict(tconvert.vit_flax_to_torch(to_numpy(params)), strict=True)
    with torch.no_grad():
        got = vit(T(x))
    for key in ("x_prenorm", "x_norm"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-5, rtol=1e-5)


def test_ae_net_matches_flax():
    x = _images(1, 3, 224)
    jae = JAENet(model_name="vit_tiny_test")
    variables = {"params": _bump_layerscale(jae.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])}
    want = np.asarray(jae.apply(variables, jnp.asarray(x)))
    ae = AENet("vit_tiny_test").eval()
    ae.load_state_dict(tconvert.ae_flax_to_torch(to_numpy(variables)), strict=True)
    with torch.no_grad():
        got = ae(T(x)).numpy()
    assert got.shape == (3, 256, 64)
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_ae_net_bf16_compute_close_to_flax_bf16():
    """bf16 matmuls round at the same cast points in both packages, but each
    library's bf16 kernels round differently: features agree to cosine
    similarity > 0.999 per patch (f32 agreement is the test above)."""
    x = _images(2, 2, 224)
    jae = JAENet(model_name="vit_tiny_test", compute_dtype="bfloat16")
    variables = {"params": _bump_layerscale(jae.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])}
    want = np.asarray(jae.apply(variables, jnp.asarray(x)))
    ae = AENet("vit_tiny_test", compute_dtype="bfloat16").eval()
    ae.load_state_dict(tconvert.ae_flax_to_torch(to_numpy(variables)), strict=True)
    with torch.no_grad():
        got = ae(T(x)).numpy()
    assert got.dtype == np.float32
    assert (got * want).sum(-1).min() > 0.999


def _small_ist(jax_side: bool):
    kw = dict(initial_dim=16, block_dims=(16, 24, 32, 48), descriptor_size=32, input_size=256)
    if jax_side:
        return JISTNet(backbone=JISTBackbone(**kw), regressor=JRegressor(hidden_dim=32))
    return ISTNet(backbone=ISTBackbone(**kw), regressor=Regressor(64, hidden_dim=32)).eval()


def _ist_variables(jnet, seed=4):
    d = jnp.zeros((1, 3, 224, 224), jnp.float32)
    pts = jnp.zeros((1, 4, 2), jnp.float32)
    variables = to_numpy(jnet.init(jax.random.PRNGKey(seed), d, d, pts, pts))
    # non-trivial BatchNorm statistics, so eval-mode BN is exercised
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 2.0, x.shape) if "var" in jax.tree_util.keystr(path)
                         else rng.normal(scale=0.1, size=x.shape)).astype(np.float32),
        variables["batch_stats"],
    )
    return {"params": variables["params"], "batch_stats": stats}


def test_ist_backbone_and_regressor_match_flax():
    jnet = _small_ist(True)
    variables = _ist_variables(jnet)
    net = _small_ist(False)
    net.load_state_dict(tconvert.ist_flax_to_torch(variables), strict=True)
    x = _images(5, 2, 224)
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), method=jnet.features))
    with torch.no_grad():
        got = net.features(T(x)).numpy()
    assert got.shape == want.shape == (2, 256, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    rng = np.random.default_rng(6)
    src_f = rng.normal(size=(2, 256, 32)).astype(np.float32)
    tar_f = rng.normal(size=(2, 256, 32)).astype(np.float32)
    src_pts = rng.integers(-1, 16, size=(2, 40, 2)).astype(np.float32)
    tar_pts = rng.integers(-1, 16, size=(2, 40, 2)).astype(np.float32)
    args = (src_f, tar_f, src_pts, tar_pts)
    want = jnet.apply(variables, *map(jnp.asarray, args), method=jnet.regress)
    with torch.no_grad():
        got = net.regress(*map(T, args))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), atol=1e-5)
    np.testing.assert_allclose(got.cossin.numpy(), np.asarray(want.cossin), atol=1e-5)
    scale, cossin = fill_invalid(got)
    assert (scale.numpy()[~got.valid.numpy()] == -1000).all()
    assert (cossin.numpy()[~got.valid.numpy()] == -1000).all()


def test_spatial_transformer_not_ported():
    """The SpatialTransformer stages are built (attention1 after stage 2,
    attention2 after stage 4) and start as the identity: proj_out is zero,
    so the backbone's features equal those of the same weights without the
    stages."""
    torch.manual_seed(0)
    kw = dict(initial_dim=16, block_dims=(16, 16, 24, 32), descriptor_size=32)
    with_attn = ISTBackbone(**kw, num_attn_heads=4).eval()
    plain = ISTBackbone(**kw).eval()
    for name in ("attention1", "attention2"):
        st = getattr(with_attn, name)
        assert not st.proj_out.weight.any() and not st.proj_out.bias.any()
    assert not hasattr(plain, "attention1")
    plain.load_state_dict({k: v for k, v in with_attn.state_dict().items()
                           if not k.startswith("attention")}, strict=True)
    x = T(_images(9, 2, 224))
    with torch.no_grad():
        assert torch.equal(with_attn(x), plain(x))


def test_ist_spatial_transformer_matches_flax(monkeypatch):
    """The float IST with num_attn_heads=2 (GroupNorm, self-attention twice,
    GEGLU with the tanh GELU, proj_out randomized so that the stages show)
    against flax at the tiny config, with the weights through the bridge:
    the IST's 1e-4 tolerances. The resize samples the JAX package's points
    here (models/ist_net.align_corners_points): the float IST's own
    torch.linspace points are up to an ulp off them, which the random
    attention stages carry to 1.4e-3."""
    from gigapose_tpu_torch.models import ist_net as tist_net

    monkeypatch.setattr(tist_net, "resize_bilinear_align_corners", functools.partial(
        tist_net.resize_bilinear_align_corners, points=tist_net.align_corners_points))
    kw = dict(initial_dim=16, block_dims=(16, 16, 24, 32), descriptor_size=32, input_size=256,
              num_attn_heads=2)
    jnet = JISTNet(backbone=JISTBackbone(**kw), regressor=JRegressor(hidden_dim=32))
    variables = _ist_variables(jnet, seed=8)
    rng = np.random.default_rng(8)
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.normal(scale=0.2, size=x.shape).astype(np.float32)
                         if "proj_out" in jax.tree_util.keystr(path) else x),
        variables["params"])
    net = ISTNet(ISTBackbone(**kw), Regressor(64, hidden_dim=32)).eval()
    net.load_state_dict(tconvert.ist_flax_to_torch(variables), strict=True)
    x = _images(10, 2, 224)
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), method=jnet.features))
    jnet0 = JISTNet(backbone=JISTBackbone(**{**kw, "num_attn_heads": 0}),
                    regressor=JRegressor(hidden_dim=32))
    without = np.asarray(jnet0.apply(
        {"params": {**variables["params"], "backbone": {
            k: v for k, v in variables["params"]["backbone"].items()
            if not k.startswith("attention")}}, "batch_stats": variables["batch_stats"]},
        jnp.asarray(x), method=jnet0.features))
    assert np.abs(want - without).max() > 0.1  # the stages move the features
    with torch.no_grad():
        got = net.features(T(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["vit_tiny_test", "vit_tiny_swiglu_test"])
def test_bridge_round_trip_vit(name):
    """torch -> flax (gigapose_tpu/models/convert.py) -> torch is the identity."""
    torch.manual_seed(0)
    vit = ViT(VIT_CONFIGS[name])
    for p in vit.parameters():
        torch.nn.init.normal_(p)
    sd = {k: v.detach().clone() for k, v in vit.state_dict().items()}
    flax_params = jconvert.dinov2_hub_to_flax(sd, VIT_CONFIGS[name].depth)
    back = tconvert.vit_flax_to_torch(flax_params)
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


def test_bridge_round_trip_ist():
    net = _small_ist(False)
    torch.manual_seed(1)
    for name, t in net.state_dict().items():
        if t.is_floating_point():
            t.copy_(torch.rand_like(t) + 0.5)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    bb_params, bb_stats = jconvert.ist_backbone_to_flax(sd, prefix="backbone.")
    reg = jconvert.regressor_to_flax(sd, prefix="regressor.")
    back = tconvert.ist_flax_to_torch(
        {"params": {"backbone": bb_params, "regressor": reg},
         "batch_stats": {"backbone": bb_stats}}
    )
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
