"""The port's image decoders == PIL 12 on libjpeg-turbo (CPU, exact).

- decode_jpeg (csrc/codecs.cpp through dataloader/jpeg.py): byte-equal to
  np.asarray(Image.open(...)) on files that PIL and cv2 write, at sizes
  from 1 x 1 to 480 x 640 (edges that are no multiple of the MCU), every
  quality class, every chroma subsampling PIL writes and gray, optimized
  Huffman tables, restart intervals (PIL's and cv2's), 4:4:0, Adobe RGB and
  16-bit quantization tables (SOF1); the files it refuses raise ValueError
  naming ROADMAP A1b;
- decode_tiff: PIL's files in every compression x predictor x sample
  layout, and files built here (big-endian, tiles, LZW and PackBits by
  hand); the layouts it refuses;
- decode_png's new modes (1-, 2- and 4-bit gray, 16-bit RGB, RGBA and
  gray + alpha) and Adam7 interlacing of every mode, on files built here
  (PIL writes neither);
- the committed fixtures (tests/data/codecs) against their manifest, which
  PIL wrote, so that chip_smoke.py can check them on a machine without PIL;
- scene._decode_image's choice by signature, _build_obs on 2-D images
  against the JAX package's, and convert_to_shards' files byte-equal to the
  JAX script's.
"""

import hashlib
import io
import json
import os
import os.path as osp
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image, ImageFile

from gigapose_tpu.dataloader import scene as jscene
from gigapose_tpu.scripts import convert_to_shards as jconvert
from gigapose_tpu_torch.dataloader import png, scene
from gigapose_tpu_torch.dataloader.jpeg import decode_jpeg
from gigapose_tpu_torch.dataloader.tiff import decode_tiff
from gigapose_tpu_torch.scripts import convert_to_shards
from tests import synthetic_bop
from tests.data.codecs.make_fixtures import build_png
from tests.data.codecs.make_fixtures import scene as content
from tests.torch_image_formats import reencode_rgb

FIXTURES = osp.join(osp.dirname(__file__), "data", "codecs")
ImageFile.MAXBLOCK = 1 << 24  # PIL writes optimize=True files in one block


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _assert_same(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype,
                                                                 want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- fixtures

MANIFEST = json.load(open(osp.join(FIXTURES, "manifest.json")))


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixtures_match_their_manifest_in_pil_and_in_the_port(name):
    data = open(osp.join(FIXTURES, name), "rb").read()
    entry = MANIFEST[name]
    assert len(data) == entry["bytes"]
    for a in (_pil(data), scene._decode_image(data, name)):
        assert list(a.shape) == entry["shape"] and a.dtype.str == entry["dtype"], name
        assert hashlib.sha256(a.tobytes()).hexdigest() == entry["sha256"], name
    assert sum(e["bytes"] for e in MANIFEST.values()) < 3 * 2 ** 20


# ---------------------------------------------------------------- JPEG

SIZES = [(1, 1), (7, 9), (17, 33), (479, 641), (480, 640)]
QUALITIES = [50, 75, 95, 100]
SUBSAMPLING = [0, 1, 2, "gray"]


def _jpeg_cases():
    """(id, h, w, gray, writer, options): each size with each subsampling
    twice, quality, content and optimize spread over them; then restart
    intervals, cv2's files, 4:4:0, Adobe RGB and 16-bit tables."""
    cases = []
    for i, ((h, w), ss) in enumerate([(s, ss) for s in SIZES for ss in SUBSAMPLING]):
        for k in (0, 1):
            q, noisy, opt = QUALITIES[(i + 2 * k) % 4], (i + k) % 2, (i // 2 + k) % 2 == 1
            kw = dict(quality=q, optimize=opt, **({} if ss == "gray" else dict(subsampling=ss)))
            cid = f"{h}x{w}-q{q}-{ss}-{'noisy' if noisy else 'smooth'}{'-opt' if opt else ''}"
            cases.append((cid, h, w, ss == "gray", noisy, "pil", kw))
    for h, w, ss, kw in ((17, 33, 2, dict(restart_marker_blocks=1)),
                         (479, 641, 1, dict(restart_marker_blocks=7)),
                         (7, 9, "gray", dict(restart_marker_blocks=2)),
                         (480, 640, 0, dict(restart_marker_rows=1))):
        kw = dict(quality=90, **kw, **({} if ss == "gray" else dict(subsampling=ss)))
        cases.append((f"{h}x{w}-{ss}-rst-{list(kw)[1]}", h, w, ss == "gray", 1, "pil", kw))
    for h, w, rst in ((17, 33, 1), (479, 641, 3), (7, 9, 2)):
        cases.append((f"{h}x{w}-cv2-rst{rst}", h, w, False, 1, "cv2",
                      [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, rst]))
    for h, w in ((17, 33), (479, 641)):
        cases.append((f"{h}x{w}-cv2-440", h, w, False, 1, "cv2",
                      [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]))
    cases.append(("17x33-cv2-gray", 17, 33, True, 1, "cv2", [cv2.IMWRITE_JPEG_QUALITY, 80]))
    for h, w in ((7, 9), (480, 640)):
        cases.append((f"{h}x{w}-adobe-rgb", h, w, False, 1, "pil", dict(quality=90, keep_rgb=True)))
    tables = [[300 + 7 * i for i in range(64)], [500 + 3 * i for i in range(64)]]
    cases.append(("17x33-sof1-16bit-tables", 17, 33, False, 1, "pil", dict(qtables=tables)))
    return cases


def _encode(h, w, gray, noisy, writer, options, seed=0) -> bytes:
    img = content(seed + h * w, h, w, 1 if gray else 3, 20.0 if noisy else 0.0)
    if writer == "cv2":
        ok, enc = cv2.imencode(".jpg", img if gray else img[..., ::-1], options)
        assert ok
        return enc.tobytes()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **options)
    return buf.getvalue()


JPEG_CASES = _jpeg_cases()


@pytest.mark.parametrize("h,w,gray,noisy,writer,options", [c[1:] for c in JPEG_CASES],
                         ids=[c[0] for c in JPEG_CASES])
def test_decode_jpeg_equals_pil(h, w, gray, noisy, writer, options):
    data = _encode(h, w, gray, noisy, writer, options)
    if "qtables" in options:
        assert b"\xff\xc1" in data  # a 16-bit table makes the frame SOF1
    if "restart_marker_blocks" in options or writer == "cv2" and cv2.IMWRITE_JPEG_RST_INTERVAL in options:
        assert b"\xff\xdd" in data  # a DRI segment
    _assert_same(decode_jpeg(data), _pil(data))


def _refusal(kind: str) -> bytes:
    base = _encode(17, 33, False, 1, "pil", dict(quality=90))
    if kind == "progressive":
        buf = io.BytesIO()
        Image.fromarray(content(3, 17, 33, 3, 20.0)).save(buf, "JPEG", progressive=True)
        return buf.getvalue()
    if kind == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(content(3, 17, 33, 3, 20.0)).convert("CMYK").save(buf, "JPEG")
        return buf.getvalue()
    if kind == "sof9":  # the frame header of an arithmetic-coded file
        return base.replace(b"\xff\xc0", b"\xff\xc9", 1)
    if kind == "12-bit":
        i = base.index(b"\xff\xc0")
        return base[:i + 4] + bytes([12]) + base[i + 5:]
    if kind == "sampling-4x1":
        return _encode(17, 33, False, 1, "cv2", [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    if kind == "truncated-scan":
        return base[:len(base) * 3 // 4]
    if kind == "truncated-no-eoi":
        return base[:-2]
    assert kind == "truncated-header"
    return base[:100]


@pytest.mark.parametrize("kind,match", [
    ("progressive", "progressive"), ("cmyk", "CMYK"), ("sof9", "arithmetic"),
    ("12-bit", "12-bit"), ("sampling-4x1", "above 2"), ("truncated-scan", "truncated"),
    ("truncated-no-eoi", "truncated"), ("truncated-header", "truncated")])
def test_decode_jpeg_refusals(kind, match):
    data = _refusal(kind)
    if kind.startswith("truncated"):
        with pytest.raises(OSError):  # PIL refuses these too
            _pil(data)
    with pytest.raises(ValueError, match=match) as err:
        decode_jpeg(data)
    assert "ROADMAP A1b" in str(err.value)


def test_decode_jpeg_takes_zero_bits_after_an_early_marker_as_pil():
    """An EOI inside the entropy-coded data: libjpeg reads zero bits for the
    rest of that MCU and leaves the MCUs after it empty (a warning, no
    error), and so does the port."""
    data = _encode(479, 641, False, 1, "pil", dict(quality=90, subsampling=2))
    sos = data.index(b"\xff\xda")
    cut = data[:(sos + len(data)) // 2] + b"\xff\xd9"
    _assert_same(decode_jpeg(cut), _pil(cut))


# ---------------------------------------------------------------- TIFF

def _tiff_image(mode, seed, h=37, w=53):
    r = np.random.default_rng(seed)
    smooth = content(seed, h, w, 4, 6.0)
    if mode == "I;16":
        return smooth[..., 0].astype(np.uint16) * 256 + r.integers(0, 256, (h, w)).astype(np.uint16)
    return {"L": smooth[..., 0], "RGB": smooth[..., :3], "RGBA": smooth}[mode]


@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"])
@pytest.mark.parametrize("mode", ["L", "I;16", "RGB", "RGBA"])
def test_decode_tiff_equals_pil(mode, compression, predictor):
    buf = io.BytesIO()
    Image.fromarray(_tiff_image(mode, 1)).save(
        buf, "TIFF", compression=compression, tiffinfo={317: predictor} if predictor > 1 else {},
        rowsperstrip=8)
    data = buf.getvalue()
    _assert_same(decode_tiff(data), _pil(data))


def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW: a clear code first, MSB-first codes whose width grows one
    code before the decoder's table needs it, a clear when the table is
    full, EOI last."""
    codes, table, w = [256], {bytes([i]): i for i in range(256)}, b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        codes.append(table[w])
        table[wc] = 258 + len(table) - 256
        w = bytes([c])
        if len(table) - 256 + 258 >= 4093:
            codes.append(256)
            table = {bytes([i]): i for i in range(256)}
    codes += [table[w]] if w else []
    codes.append(257)
    bits, since_clear = [], 0
    for code in codes:
        free = 258 + max(0, since_clear - 1)  # the decoder's next entry
        width = 9 if free <= 510 else 10 if free <= 1022 else 11 if free <= 2046 else 12
        bits.append(format(code, f"0{width}b"))
        since_clear = 0 if code == 256 else since_clear + 1
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    return int(s, 2).to_bytes(len(s) // 8, "big")


def _packbits_encode(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes([(257 - run) & 255, data[i]])
            i += run
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _build_tiff(img: np.ndarray, order: str, compression: int, predictor: int = 1,
                tile=None, rows_per_strip=16) -> bytes:
    """A baseline TIFF of a gray, RGB or RGBA uint8 / uint16 image, in strips
    or in tiles of `tile` = (width, height), written here."""
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    px = img.reshape(h, w, spp)
    dtype = np.dtype(order + ("u2" if img.dtype == np.uint16 else "u1"))
    tw, th = tile or (w, rows_per_strip)
    chunks = []
    for y in range(0, h, th):
        for x in range(0, w, tw):
            block = np.zeros((th, tw, spp), img.dtype) if tile else px[y:y + th].copy()
            if tile:
                part = px[y:y + th, x:x + tw]
                block[:part.shape[0], :part.shape[1]] = part
            if predictor == 2:
                block = block.astype(np.int64)
                block[:, 1:] -= block[:, :-1].copy()
                block = (block % (2 ** (8 * dtype.itemsize))).astype(img.dtype)
            raw = block.astype(dtype).tobytes()
            chunks.append({1: raw, 5: _lzw_encode(raw), 8: zlib.compress(raw),
                           32773: _packbits_encode(raw)}[compression])
            if not tile:
                break
    entries = {256: (3, [w]), 257: (3, [h]), 258: (3, [8 * dtype.itemsize] * spp),
               259: (3, [compression]), 262: (3, [1 if spp == 1 else 2]),
               277: (3, [spp]), 284: (3, [1]), 317: (3, [predictor])}
    if spp == 4:
        entries[338] = (3, [2])
    body = bytearray(b"II*\x00" if order == "<" else b"MM\x00*") + b"\x00" * 4
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + b"\x00" * (len(c) % 2)
    counts = [len(c) for c in chunks]
    if tile:
        entries.update({322: (3, [tw]), 323: (3, [th]), 324: (4, offsets), 325: (4, counts)})
    else:
        entries.update({273: (4, offsets), 278: (3, [th]), 279: (4, counts)})
    extra = bytearray()
    ifd_at = len(body)
    n = len(entries)
    data_at = ifd_at + 2 + 12 * n + 4
    ifd = struct.pack(order + "H", n)
    for tag in sorted(entries):
        ftype, values = entries[tag]
        packed = struct.pack(order + ("H" if ftype == 3 else "I") * len(values), *values)
        if len(packed) <= 4:
            ifd += struct.pack(order + "HHI", tag, ftype, len(values)) + packed.ljust(4, b"\x00")
        else:
            ifd += struct.pack(order + "HHII", tag, ftype, len(values), data_at + len(extra))
            extra += packed
    body[4:8] = struct.pack(order + "I", ifd_at)
    return bytes(body + ifd + b"\x00" * 4 + extra)


@pytest.mark.parametrize("order,compression,predictor,tile,mode", [
    (">", 5, 2, None, "I;16"), (">", 1, 1, None, "RGB"), ("<", 5, 2, (16, 16), "RGBA"),
    (">", 8, 2, (32, 16), "L"), (">", 32773, 1, (16, 32), "I;16"), ("<", 32773, 1, None, "L")],
    ids=["MM-strips-lzw-pred2-16bit", "MM-strips-raw-rgb", "II-tiles-lzw-pred2-rgba",
         "MM-tiles-deflate-pred2-gray", "MM-tiles-packbits-16bit", "II-strips-packbits-gray"])
def test_decode_tiff_hand_built_equals_pil(order, compression, predictor, tile, mode):
    """Big-endian files and tiles (PIL writes neither), with LZW and
    PackBits streams this test encodes itself; PIL reads the file and is
    the reference."""
    img = _tiff_image(mode, 2)
    data = _build_tiff(img, order, compression, predictor, tile)
    want = _pil(data)
    np.testing.assert_array_equal(want, img)  # a valid file
    got = decode_tiff(data)
    assert got.dtype == want.dtype.newbyteorder("=")  # I;16B comes back native
    np.testing.assert_array_equal(got, want)


def test_decode_tiff_refusals():
    img = _tiff_image("L", 3)
    for tag, value, match in ((284, 2, "PlanarConfiguration"), (262, 0, "Photometric"),
                              (259, 7, "Compression"), (317, 3, "Predictor"),
                              (339, 3, "SampleFormat")):
        data = bytearray(_build_tiff(img, "<", 1))
        ifd = struct.unpack("<I", data[4:8])[0]
        n = struct.unpack("<H", data[ifd:ifd + 2])[0]
        entries = [data[ifd + 2 + 12 * i:ifd + 14 + 12 * i] for i in range(n)]
        entries = [e for e in entries if struct.unpack("<H", e[:2])[0] != tag]
        entries.append(struct.pack("<HHIHH", tag, 3, 1, value, 0))
        entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])
        data[ifd:ifd + 2 + 12 * n] = struct.pack("<H", len(entries)) + b"".join(entries)
        with pytest.raises(ValueError, match=match) as err:
            decode_tiff(bytes(data))
        assert "ROADMAP A1b" in str(err.value)
    with pytest.raises(ValueError, match="ROADMAP A1b"):  # 8-bit CMYK
        buf = io.BytesIO()
        Image.fromarray(_tiff_image("RGBA", 3)).convert("CMYK").save(buf, "TIFF")
        decode_tiff(buf.getvalue())


# ---------------------------------------------------------------- PNG

PNG_MODES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (4, 8), (4, 16),
             (6, 8), (6, 16), (3, 1), (3, 2), (3, 4), (3, 8)]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", PNG_MODES,
                         ids=[f"color{c}-{d}bit" for c, d in PNG_MODES])
def test_decode_png_modes_and_adam7_equal_pil(color, depth, interlace):
    """Every mode, plain and Adam7-interlaced, at sizes where passes are
    empty (1 x 1, 3 x 5) and where all seven hold pixels; a palette image
    against PIL's convert("RGB")."""
    r = np.random.default_rng(color * 100 + depth)
    for h, w in ((1, 1), (3, 5), (13, 17)):
        samples = r.integers(0, 2 ** depth, (h, w, png._CHANNELS[color]))
        palette = r.integers(0, 256, (2 ** depth, 3)).astype(np.uint8).tobytes() if color == 3 else b""
        data = build_png(samples, depth, color, interlace, palette)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")) if color == 3 else _pil(data)
        _assert_same(png.decode_png(data), want)


# ---------------------------------------------------------------- scene reading

def test_decode_image_picks_the_decoder_by_signature():
    for name in sorted(MANIFEST):
        data = open(osp.join(FIXTURES, name), "rb").read()
        for wrong in ("rgb.png", "gray.tif", "rgb.jpg"):  # the name does not decide
            _assert_same(scene._decode_image(data, wrong), _pil(data))
    for data in (b"GIF89a....", b"BM\x00\x00", b""):
        with pytest.raises(ValueError, match="signature"):
            scene._decode_image(data, "rgb.png")


def _two_d_images():
    gray = content(5, 24, 32, 1, 6.0)
    buf = io.BytesIO()
    Image.fromarray(gray).save(buf, "JPEG", quality=90)
    yield "rgb.jpg", buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(gray).save(buf, "TIFF", compression="tiff_lzw")
    yield "gray.tif", buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(gray.astype(np.uint16) * 257).save(buf, "TIFF", compression="tiff_adobe_deflate")
    yield "gray.tif", buf.getvalue()
    yield "rgb.png", build_png((gray[..., None] > 128).astype(np.uint8), 1, 0)


def test_build_obs_on_two_d_images_equals_jax():
    """A gray JPEG, 8- and 16-bit gray TIFFs and a 1-bit PNG: the JAX
    package repeats the 2-D array to three channels in its own dtype, and
    so does the port."""
    cam = json.dumps({"cam_K": [500, 0, 16, 0, 500, 12, 0, 0, 1]}).encode()
    dtypes = []
    for name, data in _two_d_images():
        parts = {name: data, "camera.json": cam}
        got, want = scene._build_obs("000001_000002", parts), jscene._build_obs("000001_000002", parts)
        _assert_same(got.rgb, want.rgb)
        dtypes.append(got.rgb.dtype)
    assert dtypes == [np.uint8, np.uint8, np.uint16, np.bool_]


def test_convert_to_shards_is_byte_equal_to_jax(tmp_path):
    """The train_pbr split with JPEG rgb, in shards of 2 images: every
    shard and key_to_shard.json byte-equal to the JAX script's."""
    root = synthetic_bop.build(str(tmp_path / "fixture"))
    split = osp.join(root, "datasets", "tudl", "train_pbr")
    assert reencode_rgb(split, "jpg") == 3
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    assert convert_to_shards.main([f"split_dir={split}", f"out_dir={got}", "shard_size=2"]) == 3
    jconvert.main([f"split_dir={split}", f"out_dir={want}", "shard_size=2"])
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names == ["key_to_shard.json", "shard-000000.tar",
                                                "shard-000001.tar"]
    for name in names:
        assert open(osp.join(got, name), "rb").read() == open(osp.join(want, name), "rb").read()
    with pytest.raises(ValueError, match="shardsize"):
        convert_to_shards.main([f"split_dir={split}", f"out_dir={got}", "shardsize=2"])
