"""gigapose_tpu_torch ops == gigapose_tpu ops on the same numpy inputs (CPU).

Tolerances: the icosphere is the same f32 / f64 arithmetic in both packages
and must agree exactly; so must the nearest-sample crop, given one affine. Affine, RANSAC and recovery
algebra agree to f32 rounding (atol 1e-5 on O(1) values, rtol 1e-5 where the
values are hundreds of mm); a different summation order moves the last bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapose_tpu.lib3d import affine as jaffine
from gigapose_tpu.lib3d import icosphere as jico
from gigapose_tpu.ops import crop as jcrop
from gigapose_tpu.ops import gather as jgather
from gigapose_tpu.ops import matching as jmatching
from gigapose_tpu.ops.pose_recovery import recover_poses as j_recover_poses
from gigapose_tpu.ops.ransac import ransac_affine as j_ransac_affine
from gigapose_tpu_torch.lib3d import affine as taffine
from gigapose_tpu_torch.lib3d import icosphere as tico
from gigapose_tpu_torch.ops import crop as tcrop
from gigapose_tpu_torch.ops import gather as tgather
from gigapose_tpu_torch.ops import matching as tmatching
from gigapose_tpu_torch.ops.pose_recovery import recover_poses as t_recover_poses
from gigapose_tpu_torch.ops.ransac import ransac_affine as t_ransac_affine

T = torch.as_tensor
J = jnp.asarray


@pytest.mark.parametrize("level", [0, 1])
def test_icosphere_poses_identical(level):
    np.testing.assert_array_equal(tico.icosphere_views(level), jico.icosphere_views(level))
    np.testing.assert_array_equal(
        tico.template_object_poses(level), jico.template_object_poses(level)
    )
    assert tico.template_object_poses(1).shape == (162, 4, 4)


def test_affine_helpers():
    rng = np.random.default_rng(0)
    M = np.zeros((5, 3, 3), np.float32)
    s = rng.uniform(0.3, 3.0, 5).astype(np.float32)
    M[:, 0, 0] = M[:, 1, 1] = s
    M[:, :2, 2] = rng.uniform(-100, 100, (5, 2))
    M[:, 2, 2] = 1
    np.testing.assert_allclose(
        taffine.inverse_crop_affine(T(M)).numpy(),
        np.asarray(jaffine.inverse_crop_affine(J(M))), rtol=1e-6, atol=1e-5,
    )
    A = rng.normal(size=(4, 2, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        taffine.normalize_affine(T(A)).numpy(),
        np.asarray(jaffine.normalize_affine(J(A))), rtol=1e-6, atol=1e-6,
    )


def test_gather_patches():
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(2, 16, 8)).astype(np.float32)
    pts = rng.integers(-1, 5, size=(2, 10, 2)).astype(np.float32)  # 4 is out of grid
    pts[0, 0] = -1
    got, gv = tgather.gather_patches(T(feats), T(pts))
    want, wv = jgather.gather_patches(J(feats), J(pts))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx = rng.integers(0, 256, size=(3, 7))
    np.testing.assert_array_equal(
        tgather.patch_index_to_location(T(idx), 16).numpy(),
        np.asarray(jgather.patch_index_to_location(J(idx), 16)),
    )


def _crop_world(seed, B=6, H=70, W=90):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(B, 4, H, W)).astype(np.float32)
    x0 = rng.integers(0, W - 20, B)
    y0 = rng.integers(0, H - 20, B)
    w = rng.integers(5, W - x0 + 1)
    h = rng.integers(5, H - y0 + 1)
    h[0] = w[0] = min(w[0], h[0])  # a square box takes the no-pad branch
    boxes = np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.int32)
    return images, boxes


@pytest.mark.parametrize("seed,target", [(0, 224), (1, 56), (2, 32)])
def test_crop_resize_pad(seed, target):
    """The affines agree to 1 ulp: XLA's fused CPU code rounds some of
    s = T / max(w, h) and -x0 * s + pad differently from the unfused f32 ops.
    Given the same affine, the nearest-sample warp is exact, with and
    without the bbox."""
    images, boxes = _crop_world(seed)
    got, gM = tcrop.crop_resize_pad(T(images), T(boxes), target)
    want, wM = jcrop.crop_resize_pad(J(images), J(boxes), target)
    wM = np.array(wM)
    np.testing.assert_allclose(gM.numpy(), wM, rtol=1.2e-7, atol=0)
    np.testing.assert_array_equal(
        got.numpy(), tcrop.warp_affine_nearest(T(images), gM, target, bbox=T(boxes)).numpy()
    )
    for bbox in (None, boxes):
        np.testing.assert_array_equal(
            tcrop.warp_affine_nearest(
                T(images), T(wM), target, bbox=None if bbox is None else T(bbox)
            ).numpy(),
            np.asarray(jcrop.warp_affine_nearest(
                J(images), J(wM), target, bbox=None if bbox is None else J(bbox)
            )),
        )
    # power-of-two scales are exact in both: the whole crop is identical
    pow2 = np.array([[3, 5, 59, 61], [10, 2, 38, 58], [0, 0, 14, 7]], np.int32)
    got, _ = tcrop.crop_resize_pad(T(images[:3]), T(pow2), 224)
    want, _ = jcrop.crop_resize_pad(J(images[:3]), J(pow2), 224)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_crop_scale_is_the_correctly_rounded_quotient():
    """s = T / max(w, h) is one f32 division, as numpy and the JAX package
    compute it: `int / tensor` in torch is int * (1 / tensor), 1 ulp off for
    a 120-px box (224 / 120), which moved whole crops by a pixel."""
    boxes = np.array([[0, 0, 120, 120], [380, 100, 500, 220], [3, 4, 100, 101],
                      [5, 5, 155, 60], [7, 1, 104, 33]], np.int32)
    side = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]).astype(np.float32)
    for target in (224, 56):
        got = tcrop.crop_resize_affine(T(boxes), target)[:, 0, 0].numpy()
        np.testing.assert_array_equal(got, np.float32(target) / side)
        want = np.asarray(jcrop.crop_resize_affine(J(boxes), target))[:, 0, 0]
        np.testing.assert_array_equal(got, want)


def test_downsample_mask():
    rng = np.random.default_rng(3)
    m = (rng.uniform(size=(2, 3, 224, 224)) > 0.5).astype(np.float32)
    for npat in (4, 16):
        np.testing.assert_array_equal(
            tmatching.downsample_mask(T(m), npat).numpy(),
            np.asarray(jmatching.downsample_mask(J(m), npat)),
        )


def _ransac_world(seed, B=3, k=2, N=24, patch=14):
    """Planted inliers under a known similarity + uniform outliers; every
    inlier's error is far from the pixel threshold (margin >= 4 px), so
    summation-order differences cannot flip the inlier test."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 16, size=(B, k, N, 2)).astype(np.float32)
    s, a = 1.2, 0.4
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    tar_px = np.einsum("ij,bknj->bkni", s * R, src * patch) + np.array([30.0, -12.0])
    noise = rng.normal(scale=1.0, size=tar_px.shape)
    outlier = rng.uniform(size=(B, k, N)) < 0.3
    tar_px = np.where(outlier[..., None], rng.uniform(0, 224, tar_px.shape), tar_px + noise)
    tar = (tar_px / patch).astype(np.float32)
    scores = rng.uniform(0.5, 1.0, (B, k, N)).astype(np.float32)
    scale = np.full((B, k, N), s, np.float32) + rng.normal(scale=0.01, size=(B, k, N)).astype(np.float32)
    ang = a + rng.normal(scale=0.01, size=(B, k, N))
    cossin = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    valid = rng.uniform(size=(B, k, N)) > 0.15
    valid[0, 1] = False  # a row without any valid correspondence
    return src, tar, scores, scale, cossin, valid


def test_ransac_planted_world():
    args = _ransac_world(0)
    for thr in (14.0, 40.0):
        got = t_ransac_affine(*map(T, args), pixel_threshold=thr, patch_size=14)
        want = j_ransac_affine(*map(J, args), pixel_threshold=thr, patch_size=14)
        np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
        np.testing.assert_array_equal(got.failed.numpy(), np.asarray(want.failed))
        np.testing.assert_allclose(got.M.numpy(), np.asarray(want.M), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(
            got.inlier_scores.numpy(), np.asarray(want.inlier_scores), atol=1e-6
        )
        np.testing.assert_array_equal(got.M[0, 1].numpy(), np.eye(3, dtype=np.float32))
        assert got.inliers[1:].any()


def test_recover_poses():
    rng = np.random.default_rng(4)
    B, k, V = 3, 2, 5
    qM = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    qM[:, 0, 0] = qM[:, 1, 1] = rng.uniform(0.5, 2.0, B)
    qM[:, :2, 2] = rng.uniform(-50, 50, (B, 2))
    K = np.array([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]], np.float32)
    qK = np.tile(K, (B, 1, 1))
    ids = rng.integers(0, V, (B, k)).astype(np.int32)
    pM = np.tile(np.eye(3, dtype=np.float32), (B, k, 1, 1))
    ang = rng.uniform(-1, 1, (B, k))
    sc = rng.uniform(0.7, 1.4, (B, k))
    pM[..., 0, 0] = pM[..., 1, 1] = sc * np.cos(ang)
    pM[..., 0, 1], pM[..., 1, 0] = -sc * np.sin(ang), sc * np.sin(ang)
    pM[..., :2, 2] = rng.uniform(-20, 20, (B, k, 2))
    tK = np.tile(np.array([[572.4, 0, 320], [0, 573.6, 240], [0, 0, 1]], np.float32), (B, 1, 1))
    tM = np.tile(np.eye(3, dtype=np.float32), (B, V, 1, 1))
    tM[..., 0, 0] = tM[..., 1, 1] = rng.uniform(0.5, 1.5, (B, V))
    tM[..., :2, 2] = rng.uniform(-80, 0, (B, V, 2))
    tP = np.tile(tico.template_object_poses(0)[:V].astype(np.float32), (B, 1, 1, 1))
    args = (qM, qK, ids, pM, tK, tM, tP)
    got = t_recover_poses(*map(T, args)).numpy()
    want = np.asarray(j_recover_poses(*map(J, args)))
    np.testing.assert_allclose(got[..., :3, :3], want[..., :3, :3], atol=1e-5)
    np.testing.assert_allclose(got[..., :3, 3], want[..., :3, 3], rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got[..., 3, :], want[..., 3, :])
