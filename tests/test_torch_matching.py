"""Port matching == JAX matching on the same numpy worlds (CPU).

The JAX side runs the fused Pallas kernel in interpret mode (as
tests/test_pallas_matching.py does) and the XLA reference match_templates;
the port side runs the fused kernel's plain version (what the wrapper takes
for CPU tensors) and its own match_templates. View ids, idx, valid and the
-1-sentinel points are exact; scores agree to atol 1e-5 (f32 sums of up to
P = 256 products taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapose_tpu.ops.matching import match_templates as j_match_templates
from gigapose_tpu.ops.pallas_matching import pallas_match_scores, pallas_match_templates
from gigapose_tpu_torch.ops import fused_matching as fm
from gigapose_tpu_torch.ops.matching import match_templates as t_match_templates
from gigapose_tpu_torch.ops.matching import top_k_stable

T = torch.as_tensor
J = jnp.asarray


def _world(seed, B=3, O=2, V=6, npat=4, C=32, ties=False):
    """Planted matches for view (labels[b], b % V) over random features. With
    ties=True the features are far apart, so nearly every view scores 0."""
    rng = np.random.default_rng(seed)
    P = npat * npat
    tar = rng.normal(size=(B, P, C)).astype(np.float32)
    store = rng.normal(size=(O, V, P, C)).astype(np.float32)
    labels = rng.integers(0, O, size=B).astype(np.int32)
    for b in range(B):
        take = rng.integers(0, P, size=P // 2)
        store[labels[b], b % V, take] = tar[b, take] + 0.05 * rng.normal(size=(len(take), C))
    tar /= np.linalg.norm(tar, axis=-1, keepdims=True)
    store /= np.linalg.norm(store, axis=-1, keepdims=True)
    tmask = (rng.uniform(size=(B, P)) > 0.2).astype(np.float32)
    smask = (rng.uniform(size=(O, V, P)) > 0.2).astype(np.float32)
    if ties:
        tmask[:] = 1.0
        smask[:] = 1.0
    return tar, store, tmask, smask, labels


WORLDS = [
    dict(seed=0), dict(seed=1), dict(seed=2, B=5, O=3, V=9),
    dict(seed=3, npat=16, C=64, V=4), dict(seed=4, ties=True, V=12, C=128),
]


def _assert_match_equal(got, want, atol=1e-5):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.src_pts.numpy(), np.asarray(want.src_pts))
    np.testing.assert_array_equal(got.tar_pts.numpy(), np.asarray(want.tar_pts))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=atol)
    np.testing.assert_allclose(got.score_pts.numpy(), np.asarray(want.score_pts), atol=atol)


@pytest.mark.parametrize("world", WORLDS)
def test_fused_plain_matches_pallas_interpret(world):
    npat = world.get("npat", 4)
    tar, store, tmask, smask, labels = _world(**world)
    kw = dict(sim_threshold=0.5, patch_threshold=1, num_patches=npat)
    got = fm.fused_match_scores(T(tar), T(store), T(tmask), T(smask), T(labels), **kw)
    want = pallas_match_scores(J(tar), J(store), J(tmask), J(smask), J(labels),
                               interpret=True, **kw)
    for name, g, w in zip(("sim_avg", "idx_t2s", "score_t2s", "valid"), got, want):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)
    k = 4
    _assert_match_equal(
        fm.fused_match_templates(T(tar), T(store), T(tmask), T(smask), T(labels), k=k, **kw),
        pallas_match_templates(J(tar), J(store), J(tmask), J(smask), J(labels), k=k,
                               interpret=True, **kw),
    )
    if world.get("ties"):
        sim_avg = got[0].numpy()
        assert (sim_avg == 0).mean() > 0.7, "the tie world must leave most views at 0"


@pytest.mark.parametrize("world", WORLDS[:3])
def test_match_templates_matches_xla_reference(world):
    npat = world.get("npat", 4)
    tar, store, tmask, smask, labels = _world(**world)
    kw = dict(k=3, sim_threshold=0.5, patch_threshold=1, num_patches=npat)
    got = t_match_templates(T(tar), T(store)[T(labels).long()], T(tmask),
                            T(smask)[T(labels).long()], **kw)
    want = j_match_templates(J(tar), J(store)[labels], J(tmask), J(smask)[labels], **kw)
    _assert_match_equal(got, want)
    # the fused path gives the same top-k as the gathered reference
    _assert_match_equal(
        fm.fused_match_templates(T(tar), T(store), T(tmask), T(smask), T(labels), **kw), want
    )


@pytest.mark.parametrize("patch_threshold", [0, 3])
def test_fractional_masks(patch_threshold):
    tar, store, tmask, smask, labels = _world(11)
    rng = np.random.default_rng(5)
    tmask = (tmask * rng.uniform(0.2, 1.0, tmask.shape)).astype(np.float32)
    smask = (smask * rng.uniform(0.2, 1.0, smask.shape)).astype(np.float32)
    kw = dict(k=3, sim_threshold=0.4, patch_threshold=patch_threshold, num_patches=4)
    _assert_match_equal(
        fm.fused_match_templates(T(tar), T(store), T(tmask), T(smask), T(labels), **kw),
        pallas_match_templates(J(tar), J(store), J(tmask), J(smask), J(labels),
                               interpret=True, **kw),
    )


def test_top_k_stable_orders_ties_like_lax_top_k():
    rng = np.random.default_rng(0)
    x = np.zeros((4, 162), np.float32)
    x[:, [7, 100]] = [0.9, 0.3]
    x[1:, rng.integers(0, 162, 20)] = 0.3
    vals, ids = top_k_stable(T(x), 5)
    jv, ji = jax.lax.top_k(J(x), 5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert ids[0].tolist() == [7, 100, 0, 1, 2]


def test_wrapper_contract():
    tar, store, tmask, smask, labels = _world(0)
    args = (T(tar), T(store), T(tmask), T(smask), T(labels))
    with pytest.raises(ValueError, match="sim_threshold > 0"):
        fm.fused_match_scores(*args, sim_threshold=0.0)
    with pytest.raises(ValueError, match="sim_threshold > 0"):
        fm.match_scores_plain(*args, sim_threshold=-0.1)
    # no silent fallback: a device other than cpu / cuda raises
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fm.fused_match_scores(*meta)
    # the plain version never counts as a kernel launch
    before = fm.fused_match_scores.launches
    fm.fused_match_scores(*args)
    assert fm.fused_match_scores.launches == before
