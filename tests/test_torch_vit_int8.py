"""Port int8 serving forward (gigapose_tpu_torch/models/vit_int8.py) == JAX
models/vit_int8.py, and the quantized coarse slice == JAX
`quantize_serving(backend="ref")`.

One flax init drives both packages through the weight bridge; LayerScale is
raised from 1e-5 to 0.3 so that the blocks' int8 arithmetic shows in the
features. Tolerances:
- prepare_int8_params: every array exact (relayouts, IEEE division, round
  half to even); the int8 bridge is the identity on values;
- each block alone agrees to ulps (tests/test_torch_qmm.py); through the
  network, sums taken in another order (the f32 patch embed, LN means,
  softmax and attention sums) move values by ulps, and now and then that
  flips one int8 by one step, which moves that token's branch by ~0.5 % of
  its range. Attention then spreads the move to every token of the next
  block. So the features agree to atol 5e-3 (unit vectors of 64 channels),
  per-token cosine > 0.9999, the pre-norm tokens (values up to ~5) to
  atol 2e-2 and the final LayerNorm's output (2.5x the pre-norm scale) to
  5e-2; a wiring fault gives O(1) differences;
- token padding at the block: exact (masked keys give exp = 0 exactly;
  rows are independent);
- the slice: view ids exact; similarity and RANSAC scores 1e-4; poses
  rtol 1e-4 / atol 1e-3 mm, as the float slice (tests/test_torch_pipeline.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapose_tpu.models.ae_net import AENet as JAENet
from gigapose_tpu.models.ist_net import ISTBackbone as JISTBackbone
from gigapose_tpu.models.ist_net import ISTNet as JISTNet
from gigapose_tpu.models.ist_net import Regressor as JRegressor
from gigapose_tpu.models import vit_int8 as jv8
from gigapose_tpu.models.vit import VIT_CONFIGS as J_VIT_CONFIGS
from gigapose_tpu.pipeline import estimator as jest
from gigapose_tpu.pipeline import templates as jtemplates
from gigapose_tpu_torch.models import convert as tconvert
from gigapose_tpu_torch.models import vit_int8 as v8
from gigapose_tpu_torch.models.ae_net import AENet
from gigapose_tpu_torch.models.ist_net import ISTBackbone, ISTNet, Regressor
from gigapose_tpu_torch.models.vit import VIT_CONFIGS, ViT
from gigapose_tpu_torch.ops import qmm as Q
from gigapose_tpu_torch.pipeline import estimator as test
from gigapose_tpu_torch.pipeline import templates as ttemplates

T = torch.as_tensor
J_CFG = J_VIT_CONFIGS["vit_tiny_test"]


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bump_layerscale(params, value=0.3):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.full_like(x, value) if "gamma" in jax.tree_util.keystr(path) else x,
        params,
    )


@pytest.fixture(scope="module")
def tiny_ae():
    """JAX AENet variables (numpy), the port AENet on the same weights, and
    2 images of 224 x 224 (257 tokens)."""
    images = np.random.default_rng(0).uniform(-1, 1, (2, 3, 224, 224)).astype(np.float32)
    jae = JAENet(model_name="vit_tiny_test")
    params = _bump_layerscale(jae.init(jax.random.PRNGKey(0), jnp.asarray(images))["params"])
    variables = to_numpy({"params": params})
    ae = AENet("vit_tiny_test").eval()
    ae.load_state_dict(tconvert.ae_flax_to_torch(variables), strict=True)
    return jae, variables, ae, images


def _flat(qp):
    out = {k: v for k, v in qp.items() if k != "blocks"}
    for i, b in enumerate(qp["blocks"]):
        out.update({f"blocks.{i}.{k}": v for k, v in b.items()})
    return out


def test_prepare_int8_params_and_bridge_match_jax(tiny_ae):
    _, variables, ae, _ = tiny_ae
    cfg = VIT_CONFIGS["vit_tiny_test"]
    want = _flat(to_numpy(jv8.prepare_int8_params(variables, J_CFG)))
    for tree in (v8.prepare_int8_params(ae), v8.prepare_int8_params(ae.vit),
                 tconvert.int8_params_flax_to_torch(to_numpy(jv8.prepare_int8_params(
                     variables, J_CFG)))):
        got = _flat(tree)
        assert got.keys() == want.keys()
        assert len(tree["blocks"]) == cfg.depth
        for k, w in want.items():
            g = got[k]
            assert g.dtype == (torch.int8 if k.endswith("_wq") else torch.float32), k
            if k.endswith("_wq"):
                assert g.t().is_contiguous(), k  # K-contiguous for the GEMM
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
def test_ae_forward_int8_matches_jax(tiny_ae, backend):
    _, variables, ae, images = tiny_ae
    jqp = jv8.prepare_int8_params(variables, J_CFG)
    want = np.asarray(jv8.ae_forward_int8(jqp, jnp.asarray(images), J_CFG, backend=backend))
    q = v8.AENetInt8.from_ae_net(ae).eval()
    with torch.inference_mode():
        got = q(T(images)).numpy()
        feats_f32 = ae(T(images)).numpy()
    assert got.shape == want.shape == (2, 256, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    assert (got * want).sum(-1).min() > 0.9999
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    # quantization-level agreement with the float AE (the JAX gate, cos > 0.99)
    assert (got * feats_f32).sum(-1).min() > 0.99


def test_vit_forward_int8_x_norm_matches_jax(tiny_ae):
    _, variables, ae, images = tiny_ae
    jqp = jv8.prepare_int8_params(variables, J_CFG)
    want = jv8.vit_forward_int8(jqp, jnp.asarray(images[:1]), J_CFG, backend="ref")
    got = v8.vit_forward_int8(v8.prepare_int8_params(ae), T(images[:1]),
                              VIT_CONFIGS["vit_tiny_test"])
    for key, atol in (("x_prenorm", 2e-2), ("x_norm", 5e-2)):
        a, b = got[key].numpy()[0], np.asarray(want[key])[0]
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=key)
        cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
        assert cos.min() > 0.9999, key


def test_padded_tokens_do_not_change_real_tokens(tiny_ae):
    """The network does not pad (Np = N); padding stays possible at the
    block: a block's attention on N = 257 tokens against the same tokens
    followed by 7 or 63 masked ones (any values) gives identical real rows."""
    _, _, ae, _ = tiny_ae
    cfg = VIT_CONFIGS["vit_tiny_test"]
    blk = v8.prepare_int8_params(ae)["blocks"][1]
    B, N, C = 2, 257, cfg.embed_dim
    rng = np.random.default_rng(5)
    x = T(rng.normal(size=(B, N, C)).astype(np.float32))
    args = [blk[k] for k in ("qkv_wq", "qkv_ws", "qkv_b", "proj_wq", "proj_ws", "proj_b",
                             "n1g", "n1b", "ls1")]
    base = Q.qmm_attn_block(x.reshape(B * N, C), *args, torch.zeros((1, N)), batch=B,
                            num_heads=cfg.num_heads).reshape(B, N, C)
    for pad in (7, 63):
        xp = torch.cat([x, T(rng.normal(size=(B, pad, C)).astype(np.float32) * 10)], dim=1)
        kb = torch.where(torch.arange(N + pad) < N, 0.0, -1e9).reshape(1, N + pad)
        got = Q.qmm_attn_block(xp.reshape(B * (N + pad), C), *args, kb, batch=B,
                               num_heads=cfg.num_heads).reshape(B, N + pad, C)
        assert torch.equal(got[:, :N], base), pad


def test_aenet_int8_module(tiny_ae):
    _, _, ae, images = tiny_ae
    q = v8.AENetInt8.from_ae_net(ae)
    assert not list(q.parameters())
    sd = q.state_dict()
    assert sd["blocks.0.qkv_wq"].dtype == torch.int8 and sd["top.embed_kernel"].shape == (588, 64)
    twin = v8.AENetInt8(q.cfg, q.params).to(torch.device("cpu"))
    assert twin.params["blocks"][1]["fc2_wq"].t().is_contiguous()  # .to keeps the layout
    with torch.inference_mode():
        assert torch.equal(twin(T(images[:1])), q(T(images[:1])))


def test_swiglu_refused():
    vit = ViT(VIT_CONFIGS["vit_tiny_swiglu_test"])
    with pytest.raises(NotImplementedError, match="SwiGLU"):
        v8.prepare_int8_params(vit)


def _slice_nets(seed=0):
    """Tiny AE + IST in both packages on one flax init (as test_qmm.py's
    quantized-estimator test builds them)."""
    jae = JAENet(model_name="vit_tiny_test")
    jist = JISTNet(
        backbone=JISTBackbone(initial_dim=16, block_dims=(16, 16, 24, 32),
                              descriptor_size=32, input_size=256),
        regressor=JRegressor(hidden_dim=32),
    )
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    d = jnp.zeros((1, 3, 224, 224), jnp.float32)
    pts = jnp.zeros((1, 4, 2), jnp.float32)
    ae_vars = to_numpy({"params": _bump_layerscale(jae.init(k1, d)["params"])})
    ist_vars = to_numpy(jist.init(k2, d, d, pts, pts))
    ae = AENet("vit_tiny_test").eval()
    ae.load_state_dict(tconvert.ae_flax_to_torch(ae_vars))
    ist = ISTNet(
        ISTBackbone(initial_dim=16, block_dims=(16, 16, 24, 32), descriptor_size=32,
                    input_size=256),
        Regressor(64, hidden_dim=32),
    ).eval()
    ist.load_state_dict(tconvert.ist_flax_to_torch(ist_vars))
    return (jae, ae_vars, jist, ist_vars), (ae, ist)


def test_quantized_slice_matches_jax():
    """The coarse slice after quantize_serving in both packages: a store of
    random features and 3 random query crops (the worst case for retrieval:
    only the int8 query path decides it)."""
    (jae, ae_vars, jist, ist_vars), (ae, ist) = _slice_nets()
    rng = np.random.default_rng(3)
    B, V, P, C, C_ist = 3, 6, 256, 64, 32
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    K = np.array([[572.4, 0, 320], [0, 573.6, 240], [0, 0, 1.0]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    poses[:, :, 2, 3] = 400.0
    store = dict(ae_features=f(1, V, P, C), ist_features=f(1, V, P, C_ist),
                 masks=np.ones((1, V, P), np.float32),
                 Ms=np.tile(np.eye(3, dtype=np.float32), (1, V, 1, 1)), poses=poses, K=K[None])
    batch = dict(crops=f(B, 3, 224, 224), masks=np.ones((B, P), np.float32),
                 labels=np.zeros(B, np.int32), Ks=np.tile(K[None], (B, 1, 1)),
                 Ms=np.tile(np.eye(3, dtype=np.float32)[None], (B, 1, 1)),
                 valid=np.ones(B, bool))

    j_est = jest.GigaPoseEstimator(ae_net=jae, ist_net=jist, ae_params=ae_vars,
                                   ist_vars=ist_vars, config=jest.EstimatorConfig(k=2))
    j_est.quantize_serving(backend="ref")
    want = j_est(jtemplates.TemplateStore(**{k: jnp.asarray(v) for k, v in store.items()}),
                 jest.DetectionBatch(**{k: jnp.asarray(v) for k, v in batch.items()}))

    est = test.GigaPoseEstimator(ae, ist, test.EstimatorConfig(k=2))
    assert est.quantize_serving() is est
    assert isinstance(est.ae_net, v8.AENetInt8)
    got = est(ttemplates.TemplateStore(**{k: T(v) for k, v in store.items()}),
              test.DetectionBatch(**{k: T(v) for k, v in batch.items()}))
    np.testing.assert_array_equal(got.view_ids.numpy(), np.asarray(want.view_ids))
    for name in ("sim_scores", "scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), rtol=1e-4, atol=1e-3)
    for fld in dataclasses.fields(got):
        assert np.isfinite(getattr(got, fld.name).numpy().astype(np.float32)).all(), fld.name
    # a second call keeps the quantized net
    q = est.ae_net
    assert est.quantize_serving().ae_net is q


@pytest.mark.parametrize("ist", [True, "static"])
def test_int8_ist_refused(ist):
    est = test.GigaPoseEstimator.create("vit_tiny_test", seed=0, ist_descriptor_size=32,
                                           device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        est.quantize_serving(ist=ist)
    assert isinstance(est.ae_net, AENet)  # nothing was swapped
