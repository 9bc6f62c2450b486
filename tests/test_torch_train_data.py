"""The port's training data path == the JAX package's (CPU): the PIL-free
RGB augmentation and template rotation byte for byte against Pillow, the
host TrainLoader's records on the synthetic fixture (its PNG directory, and
its JPEG re-encoding in the port's tar shards), and the device prep
(crops, ground-truth correspondences, relative scale and in-plane angle).

Tolerances: augmentation, rotation and the loader's records exactly; the
prepared crops exactly (a nearest-neighbour warp of the same values, then
one normalization); correspondences and the relative geometry to 2e-5 (f32
products of small pose matrices, summed in another order), with the same
validity masks; on random views sample_keypoints' masks agree on all but
0.5 % of the patches (a reprojected point within an f32 rounding of a
mask's pixel edge may land on either side) and the points where both are
valid to 1e-3 patch.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance, ImageFilter

from gigapose_tpu.dataloader import augment as JA
from gigapose_tpu.dataloader import keypoints as JK
from gigapose_tpu.dataloader.scene import DirSceneSource as JDirSceneSource
from gigapose_tpu.dataloader.scene import TarSceneSource as JTarSceneSource
from gigapose_tpu.dataloader.train_set import TrainLoader as JTrainLoader
from gigapose_tpu.dataloader.train_set import prepare_train_batch as j_prepare
from gigapose_tpu_torch.dataloader import augment as A
from gigapose_tpu_torch.dataloader import keypoints as K
from gigapose_tpu_torch.dataloader.scene import DirSceneSource, TarSceneSource
from gigapose_tpu_torch.dataloader.train_set import HostTrainRecords, TrainLoader
from gigapose_tpu_torch.dataloader.train_set import prepare_train_batch
from gigapose_tpu_torch.scripts import convert_to_shards
from tests import synthetic_bop
from tests.torch_image_formats import reencode_rgb
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (a fixture)


def _image(seed, shape):
    """Smooth structure plus noise, so blur and sharpening see edges."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = 127 + 100 * np.sin(xx / (3 + seed % 7))[..., None] * np.cos(yy / 5)[..., None]
    return np.clip(base + r.normal(scale=30, size=shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(37, 53, 3), (120, 160, 3), (5, 3, 3), (2, 9, 3)])
def test_pillow_operations_byte_equal(shape):
    """Each rebuilt Pillow operation on its own, including images narrower
    than the blur's window and than SMOOTH's 3x3."""
    x = _image(sum(shape), shape)
    img = Image.fromarray(x)
    for r in (1, 2, 3):
        assert np.array_equal(A.gaussian_blur(x, r),
                              np.asarray(img.filter(ImageFilter.GaussianBlur(r)))), r
    assert np.array_equal(A.smooth(x), np.asarray(img.filter(ImageFilter.SMOOTH)))
    for factor in (0.0, 0.37, 1.0, 2.5, 17.3, 49.9):
        for enhancer, fn in ((ImageEnhance.Sharpness, A.enhance_sharpness),
                             (ImageEnhance.Contrast, A.enhance_contrast),
                             (ImageEnhance.Brightness, A.enhance_brightness),
                             (ImageEnhance.Color, A.enhance_color)):
            want = np.asarray(enhancer(img).enhance(factor))
            assert np.array_equal(fn(x, factor), want), (enhancer.__name__, factor)
    assert np.array_equal(A.to_luma(x), np.asarray(img.convert("L")))


def test_augment_rgb_byte_equal_for_60_seeds(monkeypatch):
    """augment_rgb draws in the JAX order: 60 seeds give the JAX package's
    bytes, and between them every branch runs (no augmentation, the blur at
    each radius, each enhancer)."""
    reached = {}

    def counting(name, fn):
        def wrapped(*args):
            key = (name, args[1]) if name == "blur" else name
            reached[key] = reached.get(key, 0) + 1
            return fn(*args)
        return wrapped

    for name in ("enhance_sharpness", "enhance_contrast", "enhance_brightness",
                 "enhance_color"):
        monkeypatch.setattr(A, name, counting(name, getattr(A, name)))
    monkeypatch.setattr(A, "gaussian_blur", counting("blur", A.gaussian_blur))
    x = _image(7, (96, 128, 3))
    for seed in range(60):
        want = JA.augment_rgb(x, np.random.default_rng(seed))
        got = A.augment_rgb(x, np.random.default_rng(seed))
        assert np.array_equal(got, want), seed
        if got is x:
            reached["none"] = reached.get("none", 0) + 1
    assert set(reached) == {"none", ("blur", 1), ("blur", 2), ("blur", 3), "enhance_sharpness",
                            "enhance_contrast", "enhance_brightness", "enhance_color"}, reached
    big = _image(8, (480, 640, 3))  # the loader's size, on a seed that blurs
    for seed in (1, 4):
        assert np.array_equal(A.augment_rgb(big, np.random.default_rng(seed)),
                              JA.augment_rgb(big, np.random.default_rng(seed)))


def test_rotations_byte_equal_for_every_integer_angle():
    """rotate_rgba of a float RGBA template and the mode-F depth rotation of
    the loader, at every integer angle on a 96 x 128 image; 90 and 270 on a
    square image (Pillow's transposes); a few angles at 480 x 640."""
    r = np.random.default_rng(0)

    def cases(h, w):
        rgba = r.integers(0, 256, (h, w, 4)).astype(np.float32) / 255.0
        depth = r.uniform(0, 900, (h, w)).astype(np.float32)
        return rgba, depth

    for (h, w), angles in (((96, 128), range(360)), ((64, 64), (90, 180, 270, 45)),
                           ((480, 640), (1, 90, 179, 180, 271, 359))):
        rgba, depth = cases(h, w)
        for angle in angles:
            assert np.array_equal(A.rotate_rgba(rgba, float(angle)),
                                  JA.rotate_rgba(rgba, float(angle))), (h, w, angle)
            want = np.asarray(Image.fromarray(depth).rotate(float(angle)), np.float32)
            assert np.array_equal(A.rotate(depth, float(angle)), want), (h, w, angle)


def _loaders(root, workers, seed=11, shards=None, **kw):
    """The port's and the JAX package's loaders on the fixture's train_pbr
    directory, or on the tar shards in `shards`."""
    split = os.path.join(root, "datasets", "tudl", "train_pbr")
    tdir = os.path.join(root, "datasets", "templates", "tudl")
    args = dict(template_dir=tdir, batch_size=2, seed=seed, num_workers=workers, **kw)
    if shards:
        return (TrainLoader(scene_source=TarSceneSource(shards), **args),
                JTrainLoader(scene_source=JTarSceneSource(shards), **args))
    return (TrainLoader(scene_source=DirSceneSource(split), **args),
            JTrainLoader(scene_source=JDirSceneSource(split), **args))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return synthetic_bop.build(str(tmp_path_factory.mktemp("train_data")))


@pytest.fixture(scope="module")
def jpeg_shards(tmp_path_factory):
    """The fixture's train_pbr split with JPEG rgb images (as every real
    train_pbr split has), in tar shards of 2 images written by the port's
    convert_to_shards."""
    root = synthetic_bop.build(str(tmp_path_factory.mktemp("train_jpg")))
    split = os.path.join(root, "datasets", "tudl", "train_pbr")
    reencode_rgb(split, "jpg")
    shards = os.path.join(root, "shards")
    convert_to_shards.convert(split, shards, shard_size=2)
    return root, shards


@pytest.mark.parametrize("workers,source", [pytest.param(1, "dir", id="1"),
                                            pytest.param(2, "dir", id="2"),
                                            pytest.param(2, "jpeg-shards", id="2-jpeg-shards")])
def test_train_loader_records_equal_jax(fixture_root, jpeg_shards, workers, source):
    """Two epochs of each loader (its master stream carries on): every
    field of every batch equal, augmentation and in-plane rotation on; on
    the PNG directory split and on JPEG tar shards."""
    root, shards = (fixture_root, None) if source == "dir" else jpeg_shards
    port, jax_loader = _loaders(root, workers, shards=shards)
    got = [b for _ in range(2) for b in port]
    want = [b for _ in range(2) for b in jax_loader]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for field in HostTrainRecords.__dataclass_fields__:
            a, b = getattr(g, field), np.asarray(getattr(w, field))
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), field
    assert not np.array_equal(got[0].q_rgb, got[1].q_rgb)  # the stream moved on


def test_prepare_train_batch_matches_jax(fixture_root):
    port, _ = _loaders(fixture_root, 1, seed=3)
    for rec in port:
        want = j_prepare(rec)
        got = prepare_train_batch(rec, "cpu")
        for f in ("src_img", "tar_img", "src_mask", "tar_mask"):
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
        for f in ("src_pts", "tar_pts"):
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert np.array_equal(g < 0, w < 0), f
            np.testing.assert_allclose(g, w, atol=2e-5, err_msg=f)
        assert (got.src_pts[..., 0] >= 0).sum() > 0
        # relative in-plane near 2 pi and near 0 are the same angle
        d = np.abs(got.rel_inplane.numpy() - np.asarray(want.rel_inplane))
        assert np.minimum(d, 2 * np.pi - d).max() <= 2e-5
        np.testing.assert_allclose(got.rel_scale.numpy(), np.asarray(want.rel_scale), rtol=2e-5)


def _random_views(seed, B=3, H=60, W=80, size=56, patch=7):
    """Two views of a random plane: depth, crop masks, intrinsics, crop
    affines and a random relative pose."""
    r = np.random.default_rng(seed)

    def view():
        Kmat = np.array([[r.uniform(60, 90), 0, W / 2], [0, r.uniform(60, 90), H / 2], [0, 0, 1]])
        depth = r.uniform(0.4, 0.6, (B, H, W)) * (r.uniform(size=(B, H, W)) > 0.1)
        mask = (r.uniform(size=(B, size, size)) > 0.2).astype(np.float32)
        s = r.uniform(0.6, 1.0, B)
        M = np.zeros((B, 3, 3))
        M[:, 0, 0] = M[:, 1, 1] = s
        M[:, 0, 2], M[:, 1, 2], M[:, 2, 2] = r.uniform(-5, 5, B), r.uniform(-5, 5, B), 1
        return np.broadcast_to(Kmat, (B, 3, 3)), depth, mask, M

    T = np.tile(np.eye(4), (B, 1, 1))
    for b in range(B):
        a = r.uniform(-0.2, 0.2, 3)
        c, s = np.cos(a), np.sin(a)
        Rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
        Rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
        T[b, :3, :3] = Rz @ Rx
        T[b, :3, 3] = r.uniform(-0.02, 0.02, 3)
    f32 = lambda t: tuple(np.asarray(x, np.float32) for x in t)
    return f32(view()), f32(view()), T.astype(np.float32), size, patch


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_keypoints_matches_jax_on_random_views(seed):
    src, tar, T, size, patch = _random_views(seed)
    want = JK.sample_keypoints(jnp.asarray(T), JK.KeypointView(*map(jnp.asarray, src)),
                               JK.KeypointView(*map(jnp.asarray, tar)), size, patch)
    got = K.sample_keypoints(torch.as_tensor(T), K.KeypointView(*map(torch.as_tensor, src)),
                             K.KeypointView(*map(torch.as_tensor, tar)), size, patch)
    gv, wv = got["valid"].numpy(), np.asarray(want["valid"])
    assert wv.sum() > 20 and (gv != wv).mean() <= 0.005
    both = gv & wv
    for f in ("src_pts", "tar_pts"):
        np.testing.assert_allclose(got[f].numpy()[both], np.asarray(want[f])[both], atol=1e-3)


def _geometry_inputs(seed, B=4, N=7):
    r = np.random.default_rng(seed)

    def rot():
        q = r.normal(size=(B, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        w, x, y, z = q.T
        return np.stack([
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)],
            1).astype(np.float32)

    def pose():
        T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        T[:, :3, :3], T[:, :3, 3] = rot(), r.uniform(-0.1, 0.1, (B, 3))
        T[:, 2, 3] += 0.5
        return T

    K = np.tile(np.array([[600, 0, 320], [0, 610, 240], [0, 0, 1]], np.float32), (B, 1, 1))
    M = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    M[:, 0, 0] = M[:, 1, 1] = r.uniform(0.3, 2.0, B)
    M[:, :2, 2] = r.uniform(-50, 50, (B, 2))
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        angle=f32(r.uniform(-7, 7, B)), cs=f32(r.normal(size=(B, 2))),
        pts3=f32(r.uniform(-0.1, 0.1, (B, N, 3)) + [0, 0, 0.5]),
        pts2=f32(r.uniform(-5, 650, (B, N, 2))), depth=f32(r.uniform(0.3, 0.8, (B, 480, 640))),
        K=K, M=M, T1=pose(), T2=pose(), R1=rot(), R2=rot(), deg=f32(r.uniform(-180, 180, B)),
        scale=f32(r.uniform(0.5, 2, B)), trans=f32(r.normal(size=(B, 2))))


def _geometry_cases():
    from gigapose_tpu.lib3d import affine as JAff
    from gigapose_tpu.lib3d import geometry as JG
    from gigapose_tpu_torch.lib3d import affine as TAff
    from gigapose_tpu_torch.lib3d import geometry as TG

    return [
        ("cos_sin", JG.cos_sin, TG.cos_sin, ("angle",)),
        ("cos_sin_to_angle", JG.cos_sin_to_angle, TG.cos_sin_to_angle, ("cs",)),
        ("project_points", JG.project_points, TG.project_points, ("pts3", "K")),
        ("unproject_points", JG.unproject_points, TG.unproject_points, ("pts2", "K", "depth")),
        ("transform_points", JG.transform_points, TG.transform_points, ("T1", "pts3")),
        ("euler_z_zxy", JG.euler_z_zxy, TG.euler_z_zxy, ("R1",)),
        ("euler_z_zyx", JG.euler_z_zyx, TG.euler_z_zyx, ("R1",)),
        ("relative_scale", JG.relative_scale, TG.relative_scale, ("K", "K", "T1", "T2", "M", "M")),
        ("relative_inplane", JG.relative_inplane, TG.relative_inplane, ("T1", "T2")),
        ("geodesic_distance_cos_sin",
         lambda a, b: JG.geodesic_distance_cos_sin(a, b, normalize=True, eps=1e-6),
         lambda a, b: TG.geodesic_distance_cos_sin(a, b, normalize=True, eps=1e-6), ("cs", "cs")),
        ("opencv_to_opengl", JG.opencv_to_opengl, TG.opencv_to_opengl, ("T1",)),
        ("rotation_geodesic_deg", JG.rotation_geodesic_deg, TG.rotation_geodesic_deg, ("R1", "R2")),
        ("inplane_to_rotation", JG.inplane_to_rotation, TG.inplane_to_rotation, ("deg",)),
        ("compute_inplane_deg", JG.compute_inplane_deg, TG.compute_inplane_deg, ("R1", "R2")),
        ("homogeneous", JAff.homogeneous, TAff.homogeneous, ("pts2",)),
        ("affine2d", lambda c, s, t: JAff.affine2d(JAff.rotation2d(c), s, t),
         lambda c, s, t: TAff.affine2d(TAff.rotation2d(c), s, t), ("cs", "scale", "trans")),
        ("affine2d_bare", lambda c: JAff.affine2d(JAff.rotation2d(c)),
         lambda c: TAff.affine2d(TAff.rotation2d(c)), ("cs",)),
        ("apply_affine", JAff.apply_affine, TAff.apply_affine, ("M", "pts2")),
    ]


@pytest.mark.parametrize("case", range(18), ids=[c[0] for c in _geometry_cases()])
def test_geometry_matches_jax(case):
    """lib3d/geometry.py and the affine helpers training adds, against the
    JAX package's (f32 products of small matrices: rtol 1e-5, atol 1e-5;
    angles compared on the circle)."""
    name, jfn, tfn, names = _geometry_cases()[case]
    x = _geometry_inputs(case)
    want = np.asarray(jfn(*(jnp.asarray(x[n]) for n in names)))
    got = tfn(*(torch.as_tensor(x[n]) for n in names)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if name in ("cos_sin_to_angle", "relative_inplane"):
        d = np.abs(got - want)
        assert np.minimum(d, 2 * np.pi - d).max() <= 1e-5
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 if "deg" not in name else 1e-3)


def test_patch_location_to_index_and_match_pair_match_jax():
    from gigapose_tpu.ops.gather import patch_location_to_index as j_loc
    from gigapose_tpu.ops.matching import match_pair as j_match_pair
    from gigapose_tpu_torch.ops.gather import patch_location_to_index
    from gigapose_tpu_torch.ops.matching import match_pair

    r = np.random.default_rng(0)
    loc = r.integers(0, 16, (3, 9, 2)).astype(np.float32)
    assert np.array_equal(patch_location_to_index(torch.as_tensor(loc), 16).numpy(),
                          np.asarray(j_loc(jnp.asarray(loc), 16)))
    src = r.normal(size=(3, 256, 8)).astype(np.float32)
    tar = (src + 0.3 * r.normal(size=src.shape)).astype(np.float32)
    masks = [(r.uniform(size=(3, 256)) < 0.9).astype(np.float32) for _ in range(2)]
    want = j_match_pair(*(jnp.asarray(a) for a in (src, tar, *masks)))
    got = match_pair(*(torch.as_tensor(a) for a in (src, tar, *masks)))
    for g, w in zip(got, want):
        assert np.allclose(g.numpy(), np.asarray(w), atol=1e-6) and g.numpy().dtype == np.asarray(w).dtype
    assert got[2].sum() > 0
