"""The port's host I/O == the JAX package's on the same files (CPU, exact).

- the PNG codec (gigapose_tpu_torch/dataloader/png.py) against PIL, on
  PIL-written files of every mode the datasets use, and on files whose
  filtered rows this test writes itself, one row filter at a time;
- BOP I/O (RLE, csv, the runtime protocol, the npz merge), the scene readers
  (on PNG, JPEG and TIFF splits), the inference dataset and the template
  loader against gigapose_tpu.dataloader;
- the yaml-free config loader against gigapose_tpu.utils.config (PyYAML),
  and the port's copies of the config files against the JAX package's.
"""

import io
import json
import math
import os
import os.path as osp
import shutil
import struct
import tarfile
import zlib

import numpy as np
import pytest
import yaml
from PIL import Image

from gigapose_tpu.dataloader import bop_io as jbop
from gigapose_tpu.dataloader import scene as jscene
from gigapose_tpu.dataloader import templates_disk as jtemplates
from gigapose_tpu.dataloader import test_set as jtest_set
from gigapose_tpu.utils import config as jconfig
from gigapose_tpu_torch.dataloader import bop_io, png, scene, templates_disk, test_set
from gigapose_tpu_torch.utils import config
from tests import synthetic_bop
from tests.torch_image_formats import reencode_rgb

H, W = 48, 40


def _pil_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pil_read(data: bytes, convert=None) -> np.ndarray:
    img = Image.open(io.BytesIO(data))
    return np.asarray(img.convert(convert) if convert else img)


def _smooth(seed, shape):
    """Smooth gradients plus noise: PIL's adaptive filtering then picks
    Sub, Up, Average and Paeth rows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = 100 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 5.0)
    extra = shape[2:] or (1,)
    img = base.reshape(shape[:2] + (1,)) + np.arange(extra[0]) * 20 + rng.normal(0, 6, shape[:2] + extra)
    return np.clip(img, 0, 255).astype(np.uint8).reshape(shape)


@pytest.mark.parametrize("mode,shape", [("L", (H, W)), ("LA", (H, W, 2)), ("RGB", (H, W, 3)),
                                        ("RGBA", (H, W, 4)), ("RGBA", (480, 640, 4))])
def test_decode_png_matches_pil(mode, shape):
    arr = _smooth(0, shape)
    data = _pil_png(Image.fromarray(arr, mode))
    got = png.decode_png(data)
    np.testing.assert_array_equal(got, _pil_read(data))
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(png.to_rgba(got), _pil_read(data, "RGBA"))


def test_decode_png_16bit_and_palette_match_pil():
    rng = np.random.default_rng(1)
    depth = rng.integers(0, 65536, (H, W)).astype(np.uint16)
    depth[:, :5] = 400  # depth maps are smooth: filtered rows
    data = _pil_png(Image.fromarray(depth))
    got = png.decode_png(data)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, _pil_read(data).astype(np.uint16))
    np.testing.assert_array_equal(got, depth)

    idx = rng.integers(0, 7, (H, W)).astype(np.uint8)
    pal = Image.fromarray(idx, "P")
    pal.putpalette(rng.integers(0, 256, 21).tolist())
    data = _pil_png(pal)
    np.testing.assert_array_equal(png.decode_png(data), _pil_read(data, "RGB"))
    data = _pil_png(pal, transparency=bytes([0, 128, 255, 3]))
    np.testing.assert_array_equal(png.decode_png(data), _pil_read(data, "RGBA"))
    for bits in (1, 2, 4):
        small = Image.fromarray(rng.integers(0, 2 ** bits, (37, 29)).astype(np.uint8), "P")
        data = _pil_png(small, bits=bits)
        np.testing.assert_array_equal(png.decode_png(data), _pil_read(data, "RGB"))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_rows_by_hand(pix: np.ndarray, ftypes, bpp: int) -> bytes:
    """The PNG row filters, pixel by pixel, straight from the specification."""
    out = bytearray()
    rows = pix.astype(int)
    for y, f in enumerate(ftypes):
        out.append(f)
        for i, x in enumerate(rows[y]):
            a = rows[y, i - bpp] if i >= bpp else 0
            b = rows[y - 1, i] if y > 0 else 0
            c = rows[y - 1, i - bpp] if y > 0 and i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            out.append((x - pred) % 256)
    return bytes(out)


@pytest.mark.parametrize("ftypes", [[0], [1], [2], [3], [4], [2, 0, 4, 3, 1, 4, 4, 2, 3, 3]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_decode_hand_filtered_rows(ftypes):
    """Files whose rows this test filters itself: each filter decodes, and
    the encoder writes the same rows."""
    rgba = _smooth(2, (10, 13, 4))
    rgba[3:5] = 255 - rgba[3:5]  # large jumps: the filters' wrap-around
    f = (ftypes * 10)[:10]
    data = png.assemble_png(13, 10, 8, 6, _filter_rows_by_hand(rgba.reshape(10, -1), f, 4))
    np.testing.assert_array_equal(_pil_read(data), rgba)  # a valid file
    np.testing.assert_array_equal(png.decode_png(data), rgba)
    assert zlib.decompress(png.encode_png(rgba, f)[41:-16]) == \
        _filter_rows_by_hand(rgba.reshape(10, -1), f, 4)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "per-row", "adaptive"])
def test_encode_png_round_trips(filt):
    rng = np.random.default_rng(3)
    ftypes = rng.integers(0, 5, 60) if filt == "per-row" else filt
    for arr in (_smooth(4, (60, 50, 3)), _smooth(5, (60, 50, 4)), _smooth(6, (60, 50)),
                _smooth(8, (60, 50, 2)), rng.integers(0, 65536, (60, 50)).astype(np.uint16)):
        data = png.encode_png(arr, ftypes)
        np.testing.assert_array_equal(png.decode_png(data), arr)
        np.testing.assert_array_equal(_pil_read(data).astype(arr.dtype), arr)


def test_encode_png_adaptive_picks_the_least_cost_filter():
    """"adaptive": each row's filter is the first whose residual bytes, read
    as signed, have the least sum of magnitudes (rows filtered by hand)."""
    rgb = _smooth(9, (12, 17, 3))
    rgb[4:7] = np.random.default_rng(9).integers(0, 256, (3, 17, 3))
    rows = rgb.reshape(12, -1)
    cost = np.zeros((12, 5), np.int64)
    for f in range(5):
        filtered = np.frombuffer(_filter_rows_by_hand(rows, [f] * 12, 3), np.uint8)
        cost[:, f] = np.abs(filtered.reshape(12, -1)[:, 1:].view(np.int8).astype(int)).sum(1)
    got = np.frombuffer(zlib.decompress(png.encode_png(rgb, "adaptive")[41:-16]), np.uint8)
    np.testing.assert_array_equal(got.reshape(12, -1)[:, 0], cost.argmin(1))
    assert len(set(cost.argmin(1).tolist())) > 1  # the rows do choose


def test_png_refusals():
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 2)  # no such interlace method
    data = png.SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(b"IDAT", zlib.compress(b"")) \
        + png._chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="interlace method 2"):
        png.decode_png(data)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"\xff\xd8\xff\xe0 a jpeg")
    with pytest.raises(ValueError, match="filter"):
        png.decode_png(png.assemble_png(2, 1, 8, 0, bytes([5, 1, 2])))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="filter"):
        png.encode_png(np.zeros((4, 4), np.uint8), "paeth")


def test_rle_csv_runtime_and_merge_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    masks = [(rng.uniform(size=(37, 23)) > 0.6).astype(np.uint8), np.ones((5, 4), np.uint8),
             np.zeros((5, 4), np.uint8), np.pad(np.ones((30, 20), np.uint8), ((100, 5), (7, 9)))]
    for m in masks:
        rle = bop_io.rle_encode(m)
        assert rle == jbop.rle_encode(m)
        np.testing.assert_array_equal(bop_io.rle_decode(rle), jbop.rle_decode(rle))
        np.testing.assert_array_equal(bop_io.rle_decode(rle), m)
    for counts in ([1, 2, 3], [0, 6], [2, 1, 9]):  # uncompressed; the last overruns 3 x 2
        rle = {"size": [3, 2], "counts": counts}
        np.testing.assert_array_equal(bop_io.rle_decode(rle), jbop.rle_decode(rle))

    results = [dict(scene_id=1, im_id=i, obj_id=5, score=0.5 + i, R=rng.normal(size=(3, 3)),
                    t=rng.normal(size=(3, 1)), time=1.5, instance_id=i) for i in range(3)]
    for extra in (None, "instance_id"):
        a, b = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
        bop_io.save_bop_csv(a, results, extra_column=extra)
        jbop.save_bop_csv(b, results, extra_column=extra)
        assert open(a).read() == open(b).read()
        got, want = bop_io.load_bop_csv(a, extra), jbop.load_bop_csv(b, extra)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])

    rows = [dict(scene_id=1, im_id=i % 2, batch_id=b, time=0.1 * b, additional_time=0.5 + i)
            for i, b in enumerate([0, 0, 1, 2, 2])]
    for refined in (False, True):
        got = bop_io.apply_runtime_protocol([dict(r) for r in rows], refined)
        assert got == jbop.apply_runtime_protocol([dict(r) for r in rows], refined)

    for k in (None, 3):  # top-1 poses, or k hypotheses per detection
        for ds in ("tudl", "lmo"):
            dirs = [tmp_path / f"{ds}{k}{side}" for side in ("port", "jax")]
            for d in dirs:
                d.mkdir()
                for b in range(3):
                    n = b + 1
                    r = np.random.default_rng(b)
                    shape = (n,) if k is None else (n, k)
                    np.savez(d / f"{b:06d}.npz", scene_id=np.full(n, 1), im_id=np.full(n, b),
                             object_id=r.integers(1, 4, n), poses=r.normal(size=shape + (4, 4)),
                             scores=r.uniform(size=shape), time=np.full(n, 0.2 * b),
                             detection_time=np.full(n, 0.05))
            got = bop_io.merge_batched_predictions(str(dirs[0]), ds, "large", 7)
            want = jbop.merge_batched_predictions(str(dirs[1]), ds, "large", 7)
            assert [osp.basename(p) for p in got] == [osp.basename(p) for p in want]
            for g, w in zip(got, want):
                assert open(g).read() == open(w).read()


def _assert_same_fields(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in got.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


def _webdataset_tar(split_dir: str, tar_dir: str, ext: str = "png") -> None:
    """The classic layout's samples as one webdataset shard plus its index
    (the rgb file under rgb.png / rgb.jpg, a gray tif under gray.tif)."""
    os.makedirs(tar_dir)
    index = {}
    rgb_key = {"png": "rgb.png", "jpg": "rgb.jpg", "tif": "gray.tif"}[ext]
    with tarfile.open(osp.join(tar_dir, "shard-000000.tar"), "w") as tf:
        for obs in jscene.DirSceneSource(split_dir):
            key = obs.key
            sdir = osp.join(split_dir, f"{obs.scene_id:06d}")
            im = f"{obs.im_id:06d}"
            load = lambda name: json.load(open(osp.join(sdir, name)))[str(obs.im_id)]
            parts = {
                rgb_key: open(osp.join(sdir, "rgb", f"{im}.{ext}"), "rb").read(),
                "depth.png": open(osp.join(sdir, "depth", im + ".png"), "rb").read(),
                "camera.json": json.dumps(load("scene_camera.json")).encode(),
                "gt.json": json.dumps(load("scene_gt.json")).encode(),
                "gt_info.json": json.dumps(load("scene_gt_info.json")).encode(),
                "mask_visib.json": json.dumps([jbop.rle_encode(m) for m in obs.masks]).encode(),
            }
            for suffix, data in parts.items():
                info = tarfile.TarInfo(f"{key}.{suffix}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
            index[key] = 0
    with open(osp.join(tar_dir, "key_to_shard.json"), "w") as f:
        json.dump(index, f)


@pytest.mark.parametrize("ext", ["png", "jpg", "tif"])
def test_scene_sources_and_inference_dataset_match_jax(tmp_path, ext):
    """On the fixture's PNG splits, and on copies whose rgb images PIL wrote
    as JPEG and as gray LZW TIFF (tests/torch_image_formats.py)."""
    root = synthetic_bop.build(str(tmp_path))
    ds_root = osp.join(root, "datasets")
    train = osp.join(ds_root, "tudl", "train_pbr")
    if ext != "png":
        assert reencode_rgb(train, ext) == 3
        assert reencode_rgb(osp.join(ds_root, "tudl", "test"), ext) == 1
    got = list(scene.DirSceneSource(train))
    want = list(jscene.DirSceneSource(train))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.depth is not None and g.masks is not None
        _assert_same_fields(g, w)

    tar_dir = str(tmp_path / "shards")
    _webdataset_tar(train, tar_dir, ext)
    got = list(scene.TarSceneSource(tar_dir, depth_scale=0.5))
    want = list(jscene.TarSceneSource(tar_dir, depth_scale=0.5))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_same_fields(g, w)
    _assert_same_fields(scene.TarSceneSource(tar_dir).lookup("000001_000002"),
                        jscene.TarSceneSource(tar_dir).lookup("000001_000002"))
    assert scene.TarSceneSource(tar_dir).lookup("000009_000000") is None

    for setting in ("localization", "detection"):
        got = list(test_set.InferenceDataset(ds_root, "tudl", test_setting=setting))
        want = list(jtest_set.InferenceDataset(ds_root, "tudl", test_setting=setting))
        assert len(got) == len(want) == 1
        for g, w in zip(got, want):
            _assert_same_fields(g, w)

    rgb_dir = osp.join(ds_root, "tudl", "test", "000001", "rgb")
    for name in os.listdir(rgb_dir):
        os.remove(osp.join(rgb_dir, name))
    with open(osp.join(rgb_dir, "000000.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 a jpeg")  # a JPEG signature, then no JPEG
    with pytest.raises(ValueError, match="ROADMAP A1b"):
        list(test_set.InferenceDataset(ds_root, "tudl"))


def test_load_object_templates_matches_jax(tmp_path):
    root = synthetic_bop.build(str(tmp_path), num_templates=4)
    src = osp.join(root, "datasets", "templates", "tudl")
    # the port's and the JAX package's caches in separate copies of the set
    tdirs = [str(tmp_path / "port"), str(tmp_path / "jax")]
    for d in tdirs:
        shutil.copytree(src, d)
    assert templates_disk.list_objects(tdirs[0]) == jtemplates.list_objects(tdirs[1]) == [1, 2]
    for use_cache in (True, True, False):  # cold cache, warm cache, no cache
        for kw in (dict(as_uint8=True), dict(as_uint8=False, load_depth=True, scale_factor=10.0)):
            got = templates_disk.load_object_templates(tdirs[0], 2, 3, use_cache=use_cache, **kw)
            want = jtemplates.load_object_templates(tdirs[1], 2, 3, use_cache=use_cache, **kw)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cache = osp.join(tdirs[0], "preprocessed", "000002.npz")
    with np.load(cache) as a, np.load(osp.join(tdirs[1], "preprocessed", "000002.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def _restricted(want, got):
    """`want` cut to the keys of `got`: the port's config copies keep only
    the keys its CLI reads. A key of `got` that `want` lacks stays missing,
    so comparing `got` with the result fails."""
    if not (isinstance(want, dict) and isinstance(got, dict)):
        return want
    return {k: _restricted(want[k], got[k]) for k in got if k in want}


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("value", [
    "1.0e-5", "1e-5", "1.0e5", "+1.0e+05", "1.5E-3", ".5", "3.", "-1.5", "1_0.5_0", "1:30.5",
    "-.inf", ".NaN", "4", "-4", "+4", "0", "-0", "007", "08", "0x1F", "0b101", "1_000",
    "190:20:30", "true", "True", "off", "on", "yes", "NO", "null", "~", "", "'4'", '"4"',
    "'it''s'", '"a\\"b"', "abc", "a b", "abc # comment", "a#b", "int8", "bf16",
    "./gigapose_datasets", "/data/x.ckpt",
])
def test_override_values_parse_as_pyyaml(value):
    got = config.parse_scalar(value)
    assert _same(got, yaml.safe_load(value)), (got, yaml.safe_load(value))
    got = config.load_config("test", [f"a.b.c={value}", "run_id=5"])
    want = jconfig.load_config("test", [f"a.b.c={value}", "run_id=5"])
    assert _same(got["a"]["b"]["c"], want["a"]["b"]["c"])
    rest = {k: v for k, v in got.items() if k != "a"}
    assert rest == _restricted({k: v for k, v in want.items() if k != "a"}, rest)


def test_load_config_matches_jax():
    overrides = ["test_dataset_name=lmo", "model.testing_metric.sim_threshold=1.0e-5",
                 "max_images=null", "model.serving_quant=off", "disable_output=true",
                 "machine.root_dir=/tmp/x"]
    got = config.load_config("test", overrides)
    assert got == _restricted(jconfig.load_config("test", overrides), got)
    assert got.model.testing_metric.sim_threshold == 1e-5 and got.max_images is None
    assert config.load_config("test").model.testing_metric.k == 5
    # model=small: JAX merges model/small.yaml over the loaded config
    with open(osp.join(jconfig.CONFIG_DIR, "model", "small.yaml")) as f:
        small = yaml.safe_load(f)
    want = jconfig.Config(jconfig._deep_merge(jconfig.load_config("test", overrides[:1]),
                                              {"model": small}))
    got = config.load_config("test", overrides[:1], groups={"model": "small"})
    assert got == _restricted(want, got) and got.model.ae_net.backbone == "dinov2_vits14"
    # a model.* override beside model=small is kept (test.py's merge drops it)
    got = config.load_config("test", ["model.feature_dtype=f32"], groups={"model": "small"})
    assert got.model.feature_dtype == "f32" and got.model.ae_net.backbone == "dinov2_vits14"
    with pytest.raises(ValueError):
        config.load_config("test", ["no_equals_sign"])
    with pytest.raises(ValueError):
        config.load_config("test", ["x=[1, 2]"])


@pytest.mark.parametrize("name", ["test.yaml", "model/large.yaml", "model/small.yaml",
                                  "data/bop.yaml", "machine/local.yaml"])
def test_config_copies_match_the_jax_files(name):
    """The port's copies parse to the JAX package's files cut to the keys
    the port's CLI reads (a drift guard), and every key the CLI reads is
    there."""
    with open(osp.join(jconfig.CONFIG_DIR, name)) as f:
        want = yaml.safe_load(f)
    got = config.load_yaml(osp.join(config.CONFIG_DIR, name))
    assert got == _restricted(want, got)
    with open(osp.join(config.CONFIG_DIR, name)) as f:
        assert yaml.safe_load(f) == got
    read = {"test.yaml": ["test_dataset_name", "test_setting", "run_id", "use_multiple",
                          "store_shards", "max_num_dets_per_forward", "disable_output",
                          "save_dir"],
            "data/bop.yaml": ["depth_scale", "template.dir", "template.level",
                              "template.num_templates", "template.scale_factor"],
            "machine/local.yaml": ["root_dir"]}.get(name, [
                "model_name", "ae_net.backbone", "ist_net.descriptor_size", "testing_metric.k",
                "testing_metric.sim_threshold", "testing_metric.patch_threshold",
                "use_pallas_matching", "feature_dtype", "compute_dtype", "serving_quant",
                "ransac.pixel_threshold", "checkpoint_path"])
    keys = lambda d, pre="": [k for n, v in d.items() if n != "defaults"
                              for k in (keys(v, pre + n + ".") if isinstance(v, dict)
                                        else [pre + n])]
    assert sorted(keys(got)) == sorted(read)


@pytest.mark.parametrize("kind", ["palette_trns", "rgba"])
def test_build_obs_keeps_rgb_and_full_query_masks(kind):
    """A palette PNG with a tRNS chunk (decoded to RGBA) and an RGBA PNG
    come out of _build_obs as (H, W, 3), as PIL's convert("RGB") gives
    them, and a mask of ones over the image gives prepare_batch a patch
    mask of ones (the alpha channel must not become the query mask)."""
    import torch

    from gigapose_tpu_torch.pipeline.runner import prepare_batch

    rng = np.random.default_rng(7)
    if kind == "palette_trns":
        img = Image.fromarray(rng.integers(0, 7, (64, 64)).astype(np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 21).tolist())
        data = _pil_png(img, transparency=0)
    else:
        data = _pil_png(Image.fromarray(_smooth(3, (64, 64, 4)), "RGBA"))
    assert png.decode_png(data).shape == (64, 64, 4)
    cam = {"cam_K": [600.0, 0, 32, 0, 600.0, 32, 0, 0, 1]}
    obs = scene._build_obs("000001_000000", {"rgb.png": data,
                                             "camera.json": json.dumps(cam).encode()})
    assert obs.rgb.shape == (64, 64, 3) and obs.rgb.dtype == np.uint8
    np.testing.assert_array_equal(obs.rgb, _pil_read(data, "RGB"))
    batch = prepare_batch(obs.rgb, np.ones((1, 64, 64), np.uint8), np.array([[0, 0, 64, 64]]),
                          np.array([1]), obs.K, torch.device("cpu"))
    assert float(batch.masks[0].mean()) == 1.0
