"""The fused matching CUDA kernel against its plain PyTorch version, on the GPU.

Marked `cuda`: each test skips where torch.cuda.is_available() is false (the
decision is taken in the fixture, never at import). Imports no jax, so it
runs on a machine with PyTorch and the CUDA toolkit only:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

idx_t2s / valid / top-k ids are exact; scores agree to atol 1e-4 (f32 sums
of C exact products in another order). The planted worlds keep every
non-planted similarity far below the threshold, so no near-tie can flip an
argmax; exact 0.0 ties are the common case and must resolve to index 0.
"""

import numpy as np
import pytest
import torch

from gigapose_tpu_torch.ops import fused_matching as fm
from gigapose_tpu_torch.ops.matching import select_top_k

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    return torch.device("cuda", 0)


def _world(seed, B, O, V, npat, C, planted=True):
    rng = np.random.default_rng(seed)
    P = npat * npat
    tar = rng.standard_normal((B, P, C), dtype=np.float32)
    store = rng.standard_normal((O, V, P, C), dtype=np.float32)
    labels = rng.integers(0, O, size=B).astype(np.int32)
    if planted:
        for b in range(B):
            take = rng.integers(0, P, size=P // 2)
            store[labels[b], b % V, take] = tar[b, take] + 0.05 * rng.standard_normal(
                (len(take), C), dtype=np.float32)
    tar /= np.linalg.norm(tar, axis=-1, keepdims=True)
    store /= np.linalg.norm(store, axis=-1, keepdims=True)
    tmask = (rng.uniform(size=(B, P)) > 0.2).astype(np.float32)
    smask = (rng.uniform(size=(O, V, P)) > 0.2).astype(np.float32)
    return tar, store, tmask, smask, labels


def _to(dev, world, dtype):
    tar, store, tmask, smask, labels = world
    return (torch.as_tensor(tar).to(dev, dtype), torch.as_tensor(store).to(dev, dtype),
            torch.as_tensor(tmask).to(dev), torch.as_tensor(smask).to(dev),
            torch.as_tensor(labels).to(dev))


def _assert_same(args, npat, patch_threshold=3, sim_threshold=0.5, k=5):
    kw = dict(sim_threshold=sim_threshold, patch_threshold=patch_threshold, num_patches=npat)
    before = fm.fused_match_scores.launches
    got = fm.fused_match_scores(*args, **kw)
    assert fm.fused_match_scores.launches == before + 1
    want = fm.match_scores_plain(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-4)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[3], want[3])
    k = min(k, args[1].shape[1])
    assert torch.equal(select_top_k(*got, k=k, num_patches=npat).ids,
                       select_top_k(*want, k=k, num_patches=npat).ids)
    return want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    dict(B=4, O=2, V=6, npat=4, C=64),
    dict(B=3, O=3, V=7, npat=10, C=1000),  # P=100 and C not multiples of the tiles
    dict(B=5, O=2, V=20, npat=16, C=384),  # ViT-S width at the serving P
])
def test_kernel_matches_plain(dev, dtype, shape):
    npat = shape["npat"]
    _assert_same(_to(dev, _world(0, **shape), dtype), npat)
    _assert_same(_to(dev, _world(1, **shape), dtype), npat, patch_threshold=0,
                 sim_threshold=0.4)


def test_tie_world(dev):
    """No planted match: nearly every similarity is below the threshold, so
    columns are all-zero ties and most views score exactly 0."""
    world = _world(2, B=4, O=2, V=30, npat=16, C=128, planted=False)
    want = _assert_same(_to(dev, world, torch.float32), 16)
    assert float((want[0] == 0).float().mean()) > 0.9
    assert int((want[1] == 0).sum()) > 0.9 * want[1].numel()


def test_fractional_masks_and_clamped_labels(dev):
    tar, store, tmask, smask, labels = _world(3, B=4, O=2, V=8, npat=8, C=96)
    rng = np.random.default_rng(4)
    tmask = (tmask * rng.uniform(0.2, 1.0, tmask.shape)).astype(np.float32)
    smask = (smask * rng.uniform(0.2, 1.0, smask.shape)).astype(np.float32)
    _assert_same(_to(dev, (tar, store, tmask, smask, labels), torch.float32), 8)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    args = list(_to(dev, _world(5, B=2, O=1, V=3, npat=4, C=32), torch.float32))
    kw = dict(num_patches=4)
    bad = [
        (0, args[0].to(torch.float16), TypeError),  # dtype
        (1, args[1].to(torch.bfloat16), TypeError),  # tar / store dtypes differ
        (2, args[2].to(torch.float64), TypeError),
        (4, args[4].to(torch.int64), TypeError),
        (0, args[0].transpose(1, 2).contiguous().transpose(1, 2), ValueError),  # strides
        (3, args[3].cpu(), ValueError),  # device
    ]
    for i, value, exc in bad:
        a = list(args)
        a[i] = value
        with pytest.raises(exc):
            fm.fused_match_scores(*a, **kw)
    big = _to(dev, _world(6, B=1, O=1, V=1, npat=17, C=8), torch.float32)
    with pytest.raises(ValueError, match="patches"):
        fm.fused_match_scores(*big, num_patches=17)
