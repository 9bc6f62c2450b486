"""The view-sharded store (parallel/sharded_store.py) on the GPU: the store
split over [cuda:0] * S gives bit for bit the matching kernel's result on the
whole store (ids, scores, per-patch scores, correspondences, validity, the
gathered IST features), for a bf16 store (match_bf16_kernel) and an f32 store
(split_tf32_kernel + match_f32_kernel), S in {2, 4}, V = 13 (padding views),
with S matching launches per call. Each (detection, view) is computed alone
by the kernel, so the split changes no bit.

Marked `cuda`: skips where torch.cuda.is_available() is false (decided in the
fixture). Imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_parallel.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from gigapose_tpu_torch.ops import fused_matching as fm
from gigapose_tpu_torch.parallel.sharded_store import sharded_match_and_gather, shard_template_store
from gigapose_tpu_torch.pipeline.estimator import EstimatorConfig
from gigapose_tpu_torch.pipeline.templates import TemplateStore

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    return torch.device("cuda", 0)


def _world(dev, dtype, B=8, O=2, V=13, npat=16, C=64, seed=0):
    """Unit features; each query a noisy copy of one view of its object."""
    rng = np.random.default_rng(seed)
    P = npat * npat
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    ae = unit(rng.standard_normal((O, V, P, C))).astype(np.float32)
    labels = rng.integers(0, O, B).astype(np.int32)
    tar = unit(ae[labels, rng.integers(0, V, B)] + 0.3 * rng.standard_normal((B, P, C)))
    store = TemplateStore(
        ae_features=torch.as_tensor(ae).to(dev, dtype),
        ist_features=torch.as_tensor(rng.standard_normal((O, V, P, 32))).to(dev, torch.float32),
        masks=torch.as_tensor(rng.uniform(size=(O, V, P)) > 0.2).to(dev, torch.float32),
        Ms=torch.eye(3, device=dev).expand(O, V, 3, 3).contiguous(),
        poses=torch.eye(4, device=dev).expand(O, V, 4, 4).contiguous(),
        K=torch.eye(3, device=dev).expand(O, 3, 3).contiguous())
    return (store, torch.as_tensor(tar.astype(np.float32)).to(dev, dtype),
            torch.as_tensor(rng.uniform(size=(B, P)) > 0.1).to(dev, torch.float32),
            torch.as_tensor(labels).to(dev))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sharded_match_is_bit_equal_to_the_whole_store(dev, dtype, S):
    store, tar, tar_masks, labels = _world(dev, dtype)
    cfg = EstimatorConfig(k=3, num_patches=16, use_pallas_matching=True)
    want = fm.fused_match_templates(tar, store.ae_features, tar_masks, store.masks, labels,
                                    k=cfg.k, sim_threshold=cfg.sim_threshold,
                                    patch_threshold=cfg.patch_threshold, num_patches=16)
    V = store.ist_features.shape[1]
    want_ist = store.ist_features.reshape(-1, 256, 32)[labels.long()[:, None] * V + want.ids.long()]
    assert (want.scores[:, 0] > 0).all(), "no query matched: the world is broken"
    sharded = shard_template_store(store, [dev] * S)
    before = fm.fused_match_scores.launches
    got, got_ist = sharded_match_and_gather(tar, tar_masks, labels, sharded, cfg)
    assert fm.fused_match_scores.launches - before == S
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    assert torch.equal(got_ist, want_ist)
