"""Port pipeline == JAX pipeline: onboarding, request preparation and the whole
coarse slice, on the same numpy inputs and one random init (CPU, f32).

Tolerances: crops, masks and affines use power-of-two crop scales, so they
are exact; features agree to atol 2e-5 (AE) and rtol / atol 1e-4 (IST, see
tests/test_torch_models.py). The slice's view ids, failed flags and RANSAC
inlier masks are exact; scores and sim scores agree to 1e-4; poses to
rtol 1e-4 / atol 1e-3 (translations are hundreds of mm, and recovery divides
by the RANSAC scale).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapose_tpu.dataloader.test_set import ImageDetections
from gigapose_tpu.models.ae_net import AENet as JAENet
from gigapose_tpu.models.ist_net import ISTBackbone as JISTBackbone
from gigapose_tpu.models.ist_net import ISTNet as JISTNet
from gigapose_tpu.models.ist_net import Regressor as JRegressor
from gigapose_tpu.pipeline import estimator as jest
from gigapose_tpu.pipeline import templates as jtemplates
from gigapose_tpu.pipeline.runner import CoarseRunner
from gigapose_tpu_torch.models import convert as tconvert
from gigapose_tpu_torch.models.ae_net import AENet
from gigapose_tpu_torch.models.ist_net import ISTBackbone, ISTNet, Regressor
from gigapose_tpu_torch.pipeline import estimator as test
from gigapose_tpu_torch.pipeline import templates as ttemplates
from gigapose_tpu_torch.pipeline.runner import pad_bucket, prepare_batch

CPU = torch.device("cpu")
T = torch.as_tensor


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nets(crop, ist_input, seed=0):
    """Tiny AE + IST in both packages with the same flax-initialized weights."""
    jae = JAENet(model_name="vit_tiny_test")
    jist = JISTNet(
        backbone=JISTBackbone(initial_dim=16, block_dims=(16, 16, 24, 32),
                              descriptor_size=32, input_size=ist_input),
        regressor=JRegressor(hidden_dim=32),
    )
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    d = jnp.zeros((1, 3, crop, crop), jnp.float32)
    pts = jnp.zeros((1, 4, 2), jnp.float32)
    ae_vars = to_numpy(jae.init(k1, d))
    ist_vars = to_numpy(jist.init(k2, d, d, pts, pts))
    ae = AENet("vit_tiny_test").eval()
    ae.load_state_dict(tconvert.ae_flax_to_torch(ae_vars))
    ist = ISTNet(
        ISTBackbone(initial_dim=16, block_dims=(16, 16, 24, 32), descriptor_size=32,
                    input_size=ist_input),
        Regressor(64, hidden_dim=32),
    ).eval()
    ist.load_state_dict(tconvert.ist_flax_to_torch(ist_vars))
    return (jae, ae_vars, jist, ist_vars), (ae, ist)


def _templates(seed, V=3, H=96, W=128):
    """RGBA uint8 templates whose alpha boxes are 56 or 112 pixels on the long
    side: crop scales 4 and 2 are exact in f32."""
    rng = np.random.default_rng(seed)
    rgbas = np.zeros((V, 4, H, W), np.uint8)
    for v in range(V):
        side = 56 if v % 2 else 112 - 8 * v
        h = 56 if v % 2 else 80
        y0, x0 = rng.integers(0, H - h), rng.integers(0, W - side)
        rgbas[v, :3, y0:y0 + h, x0:x0 + side] = rng.integers(0, 256, (3, h, side))
        rgbas[v, 3, y0:y0 + h, x0:x0 + side] = 255
        if v % 2 == 0:  # box 112 wide: keep the long side a power-of-two scale
            rgbas[v, 3, y0:y0 + h, x0:x0 + side] = 0
            x0 = min(x0, W - 112)
            rgbas[v, 3, y0:y0 + h, x0:x0 + 112] = 255
    poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    poses[:, 2, 3] = 400.0
    return rgbas, poses


def test_onboarding_matches_jax():
    (jae, ae_vars, jist, ist_vars), (ae, ist) = _nets(224, 256)
    objects = [_templates(0), _templates(1)]
    kw = dict(target_size=224, num_patches=16, chunk=2)
    want = jtemplates.onboard_templates(
        lambda x: jae.apply(ae_vars, x),
        lambda x: jist.apply(ist_vars, x, method=jist.features),
        [o[0] for o in objects], [o[1] for o in objects], **kw,
    )
    with torch.no_grad():
        got = ttemplates.onboard_templates(
            ae, ist.features, [o[0] for o in objects], [o[1] for o in objects], CPU, **kw
        )
    for name in ("masks", "Ms", "poses", "K"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.masks.numpy().mean() > 0.3
    np.testing.assert_allclose(got.ae_features.numpy(), np.asarray(want.ae_features), atol=2e-5)
    np.testing.assert_allclose(got.ist_features.numpy(), np.asarray(want.ist_features),
                               rtol=1e-4, atol=1e-4)
    # the jitted JAX prep turns / std into * (1 / std): 1-ulp differences
    crops = ttemplates.prepare_template_crops(objects[0][0], CPU)
    np.testing.assert_allclose(
        crops.numpy(), np.asarray(jtemplates.prepare_template_crops(objects[0][0])),
        rtol=3e-7, atol=2.5e-7,
    )
    np.testing.assert_array_equal(
        ttemplates.alpha_bboxes(np.zeros((1, 5, 7))), [[0, 0, 7, 5]]
    )


def test_prepare_batch_matches_jax_runner():
    rng = np.random.default_rng(2)
    H, W, N = 120, 160, 5
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    boxes = np.array([[0, 0, 56, 56], [10, 20, 66, 48], [100, 5, 156, 117],
                      [30, 30, 58, 44], [5, 60, 117, 116]], np.int32)
    masks = np.zeros((N, H, W), np.uint8)
    for n, (x0, y0, x1, y1) in enumerate(boxes):
        masks[n, y0:y1, x0:x1] = rng.uniform(size=(y1 - y0, x1 - x0)) > 0.3
    labels = np.array([1, 2, 1, 3, 2])
    K = np.array([[600.0, 0, 80], [0, 600.0, 60], [0, 0, 1]], np.float32)
    image = ImageDetections(
        scene_id=1, im_id=0, rgb=rgb, K=K, labels=labels, obj_ids=labels,
        boxes_xyxy=boxes, masks=masks, scores=np.ones(N), detection_time=0.0, test_list=[],
    )
    runner = CoarseRunner(estimator=None, store=None, save_dir="", dataset_name="synthetic")
    want = runner.prepare_batch(image)
    got = prepare_batch(rgb, masks, boxes, labels, K, CPU)
    assert pad_bucket(N) == 8 and pad_bucket(200) == 256
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)


def _slice_world(est_j, B=3, V=5, npat=4, seed=1):
    """A store of V templates of one object onboarded through the JAX nets
    (as tests/test_pipeline.py's net-driven world), queries that copy
    template v_star, and a padded detection row."""
    jae, ae_vars, jist, ist_vars = est_j
    rng = np.random.default_rng(seed)
    P = npat * npat
    templates = rng.uniform(size=(V, 3, 56, 56)).astype(np.float32)
    v_star = 3
    crops = np.stack([templates[v_star]] * B)
    crops[1] += 0.05 * rng.normal(size=crops[1].shape).astype(np.float32)
    store_ae = np.array(jae.apply(ae_vars, jnp.asarray(templates)))[None]
    store_ist = np.array(jist.apply(ist_vars, jnp.asarray(templates), method=jist.features))[None]
    masks = (rng.uniform(size=(1, V, P)) > 0.1).astype(np.float32)
    Ms = np.tile(np.eye(3, dtype=np.float32), (1, V, 1, 1))
    Ms[..., 0, 0] = Ms[..., 1, 1] = 0.5
    poses = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    poses[..., 2, 3] = 400.0
    K = np.array([[[500.0, 0, 28], [0, 500, 28], [0, 0, 1]]], np.float32)
    store = dict(ae_features=store_ae, ist_features=store_ist, masks=masks, Ms=Ms,
                 poses=poses, K=K)
    batch = dict(
        crops=crops,
        masks=(rng.uniform(size=(B, P)) > 0.1).astype(np.float32),
        labels=np.zeros(B, np.int32),
        Ks=np.tile(K[0], (B, 1, 1)),
        Ms=np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
        valid=np.array([True] * (B - 1) + [False]),
    )
    return store, batch, v_star


@pytest.mark.parametrize("fused", [True, False])
def test_coarse_slice_matches_jax(fused):
    """JAX coarse_forward with the Pallas matcher (interpret mode) against the
    port's coarse_forward, on one store and batch."""
    est_j, (ae, ist) = _nets(56, 64)
    store, batch, v_star = _slice_world(est_j)
    jae, ae_vars, jist, ist_vars = est_j
    cfg_j = jest.EstimatorConfig(k=2, num_patches=4, patch_size=14, use_pallas_matching=True)
    want = jest.coarse_forward(
        jae, jist, ae_vars, ist_vars,
        jtemplates.TemplateStore(**{k: jnp.asarray(v) for k, v in store.items()}),
        jest.DetectionBatch(**{k: jnp.asarray(v) for k, v in batch.items()}),
        cfg=cfg_j,
    )
    cfg_t = test.EstimatorConfig(k=2, num_patches=4, patch_size=14, use_pallas_matching=fused)
    est = test.GigaPoseEstimator(ae, ist, cfg_t)
    got = est(
        ttemplates.TemplateStore(**{k: T(v) for k, v in store.items()}),
        test.DetectionBatch(**{k: T(v) for k, v in batch.items()}),
    )
    for name in ("view_ids", "failed", "ransac_valid", "src_pts", "tar_pts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("scores", "sim_scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got.M.numpy(), np.asarray(want.M), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), rtol=1e-4, atol=1e-3)
    ids = got.view_ids.numpy()
    assert all(v_star in ids[b] for b in range(2))
    for f in dataclasses.fields(got):
        assert np.isfinite(getattr(got, f.name).numpy().astype(np.float32)).all(), f.name


def test_estimator_create_is_seeded():
    a = test.GigaPoseEstimator.create("vit_tiny_test", seed=3, ist_descriptor_size=32,
                                        device="cpu")
    b = test.GigaPoseEstimator.create("vit_tiny_test", seed=3, ist_descriptor_size=32,
                                        device="cpu")
    c = test.GigaPoseEstimator.create("vit_tiny_test", seed=4, ist_descriptor_size=32,
                                        device="cpu")
    pa, pb, pc = (dict(e.ae_net.named_parameters()) for e in (a, b, c))
    w = "vit.blocks.0.attn.qkv.weight"
    assert torch.equal(pa[w], pb[w]) and not torch.equal(pa[w], pc[w])
    # flax-style init: lecun-normal std, LayerScale 1e-5, zero bias
    assert abs(pa[w].std().item() - 64 ** -0.5) < 0.02
    assert torch.all(pa["vit.blocks.0.ls1.gamma"] == 1e-5)
    assert torch.all(pa["vit.blocks.0.attn.qkv.bias"] == 0)
    assert not a.ae_net.training and not a.ist_net.training
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        a.quantize_serving(ist=True)
    assert type(a.quantize_serving().ae_net).__name__ == "AENetInt8"


def test_estimator_create_defaults_to_the_card():
    """With no device, create() puts both nets on cuda:0; with no card it
    raises rather than fall back to the CPU (decided here, not at import)."""
    kw = dict(seed=0, ist_descriptor_size=32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            test.GigaPoseEstimator.create("vit_tiny_test", **kw)
        return
    est = test.GigaPoseEstimator.create("vit_tiny_test", **kw)
    cuda0 = torch.device("cuda", 0)
    for net in (est.ae_net, est.ist_net):
        assert {p.device for p in net.parameters()} == {cuda0}
