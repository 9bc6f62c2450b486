"""The port's image decoders == PIL 12 on libjpeg-turbo 3.1 and libtiff 4.7
(CPU, exact).

- decode_jpeg (csrc/codecs.cpp through dataloader/jpeg.py): byte-equal to
  np.asarray(Image.open(...)) on files that PIL and cv2 write, at sizes
  from 1 x 1 to 480 x 640 (edges that are no multiple of the MCU), every
  quality class, every chroma subsampling PIL writes and gray, optimized
  Huffman tables, restart intervals (PIL's and cv2's), 4:4:0, Adobe RGB and
  16-bit quantization tables (SOF1); progressive files whole and cut after
  each scan (block smoothing); CMYK, YCCK and MJPEG frames without DHT; and
  the files of make_fixtures.encode_jpeg: sampling ratios 1-4, lossless
  predictors, arithmetic coding sequential and progressive. The files PIL
  refuses raise ValueError naming ROADMAP A1b in the port too;
- decode_tiff: PIL's files in every compression x predictor x sample
  layout, and files built here (make_fixtures.build_tiff: big-endian,
  tiles, planar, LZW old and new, PackBits, LZMA, CCITT, JPEG with
  JPEGTables, float predictor, signed, 1-32 bits, WhiteIsZero, CMYK,
  alpha, FillOrder 2, BigTIFF) against PIL, palette files against its RGB,
  big-endian signed and float samples against PIL's array swapped back
  (ROADMAP C); the layouts PIL refuses, refused;
- decode_png's new modes (1-, 2- and 4-bit gray, 16-bit RGB, RGBA and
  gray + alpha) and Adam7 interlacing of every mode, on files built here
  (PIL writes neither);
- the committed fixtures (tests/data/codecs) against their manifest, which
  PIL wrote, so that chip_smoke.py can check them on a machine without PIL;
- scene._decode_image's choice by signature, _build_obs on 2-D images
  against the JAX package's, and convert_to_shards' files byte-equal to the
  JAX script's.
"""

import io
import json
import os
import os.path as osp
import re
import struct

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
from tests.data.codecs.make_fixtures import (array_sha256, build_png, build_tiff, encode_jpeg,
                                             fax_encode, jpeg_segments, keep_scans,
                                             split_jpeg_tables)
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
        assert array_sha256(a) == entry["sha256"], name
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
    sof = base.index(b"\xff\xc0")
    if kind == "progressive":
        buf = io.BytesIO()
        Image.fromarray(content(3, 17, 33, 3, 20.0)).save(buf, "JPEG", progressive=True)
        return buf.getvalue()
    if kind == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(content(3, 17, 33, 3, 20.0)).convert("CMYK").save(buf, "JPEG")
        return buf.getvalue()
    if kind == "sof9":  # a Huffman-coded file relabelled arithmetic: decoded as such
        return base.replace(b"\xff\xc0", b"\xff\xc9", 1)
    if kind == "12-bit":
        return base[:sof + 4] + bytes([12]) + base[sof + 5:]
    if kind == "dnl":  # height 0: defined by a DNL marker
        return base[:sof + 5] + b"\x00\x00" + base[sof + 7:]
    if kind in ("hierarchical", "sof7"):
        return base.replace(b"\xff\xc0", b"\xff\xc5" if kind == "hierarchical" else b"\xff\xc7", 1)
    if kind == "lossless-arithmetic":
        return encode_jpeg(content(3, 17, 33, 1, 5.0), mode="lossless").replace(
            b"\xff\xc3", b"\xff\xcb", 1)
    if kind == "lossless-ycbcr":  # lossless mode converts no colours
        return encode_jpeg(content(3, 17, 33, 3, 5.0), mode="lossless")
    if kind == "2-component":
        return encode_jpeg(content(3, 17, 33, 3, 5.0)[..., :2])
    if kind == "fractional-sampling":
        return encode_jpeg(content(3, 17, 33, 3, 5.0), ((3, 1), (2, 1), (2, 1)))
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
    ("progressive", None), ("cmyk", None), ("sof9", None), ("12-bit", "12-bit"),
    ("sampling-4x1", None), ("truncated-scan", "truncated"), ("truncated-no-eoi", "truncated"),
    ("truncated-header", "truncated"), ("dnl", "DNL"), ("hierarchical", "hierarchical"),
    ("sof7", "hierarchical"), ("lossless-arithmetic", "SOF11"),
    ("lossless-ycbcr", "lossless YCbCr"), ("2-component", "2-component"),
    ("fractional-sampling", "fractional")])
def test_decode_jpeg_refusals(kind, match):
    """The kinds a baseline decoder refuses: where PIL decodes the file (match
    None) the port gives its bytes; where PIL refuses it, so does the port,
    naming ROADMAP A1b."""
    data = _refusal(kind)
    if match is None:
        _assert_same(decode_jpeg(data), _pil(data))
        return
    with pytest.raises((OSError, SyntaxError)):  # PIL refuses these too
        _pil(data)
    with pytest.raises(ValueError, match=match) as err:
        decode_jpeg(data)
    assert "ROADMAP A1b" in str(err.value)


def _progressive_cases():
    """(id, h, w, subsampling, scans kept or None): PIL's progressive files at
    sizes whose MCUs pad the image or not, whole and cut after each scan
    (block smoothing of the coefficients not yet exact; DC only with one)."""
    cases = []
    for h, w in ((7, 9), (17, 33), (61, 93), (64, 96)):
        for ss in (0, 1, 2, "gray"):
            cases.append((f"{h}x{w}-{ss}", h, w, ss, None))
    for h, w, ss, n in ((61, 93, 2, 10), (17, 33, 2, 10), (120, 200, 2, 10), (61, 93, 0, 10),
                        (61, 93, "gray", 6), (64, 96, 1, 10)):
        for keep in range(1, n):
            cases.append((f"{h}x{w}-{ss}-scans{keep}", h, w, ss, keep))
    return cases


@pytest.mark.parametrize("h,w,ss,keep", [c[1:] for c in _progressive_cases()],
                         ids=[c[0] for c in _progressive_cases()])
def test_decode_progressive_jpeg_equals_pil(h, w, ss, keep):
    img = content(h * w + 1, h, w, 1 if ss == "gray" else 3, 12.0)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=85, progressive=True,
                              **({} if ss == "gray" else dict(subsampling=ss)))
    data = buf.getvalue() if keep is None else keep_scans(buf.getvalue(), keep)
    _assert_same(decode_jpeg(data), _pil(data))


def _encoder_cases():
    """(id, sampling, options) of the test-only encoder: sampling ratios 1-4
    (fancy and box upsampling), standard Huffman tables (no DHT), lossless
    predictors 1-7 with point transforms, arithmetic coding sequential and
    progressive, with restarts and DAC conditioning."""
    S = {"444": ((1, 1),) * 3, "420": ((2, 2), (1, 1), (1, 1)), "h3v1": ((3, 1), (1, 1), (1, 1)),
         "h4v2": ((4, 2), (1, 1), (1, 1)), "h2v1-mixed": ((2, 1), (1, 1), (2, 1)),
         "h1v2-chroma": ((2, 2), (2, 1), (2, 1)), "h4v1-h2v1": ((4, 1), (2, 1), (2, 1)),
         "h1v4": ((1, 4), (1, 1), (1, 2)), "gray": ((1, 1),)}
    cases = [(f"huffman-{k}", v, {}) for k, v in S.items()]
    cases += [(f"no-dht-{k}", S[k], dict(dht=False)) for k in ("420", "h4v2", "gray")]
    cases += [(f"lossless-gray-p{p}-pt{p % 3}", S["gray"],
               dict(mode="lossless", predictor=p, point_transform=p % 3)) for p in range(1, 8)]
    cases += [(f"lossless-rgb-{k}", S[k], dict(mode="lossless", predictor=4, ids=[82, 71, 66],
                                                 jfif=False)) for k in ("444", "420", "h3v1")]
    for k in ("444", "420", "h3v1", "gray"):
        cases.append((f"arith-{k}", S[k], dict(arith=True)))
        cases.append((f"arith-{k}-rst2-dac", S[k], dict(arith=True, restart=2, dac=(1, 4, 3))))
        cases.append((f"arith-progressive-{k}", S[k], dict(mode="progressive", arith=True)))
        cases.append((f"arith-progressive-{k}-rst3", S[k],
                      dict(mode="progressive", arith=True, restart=3, dac=(0, 2, 8))))
    return cases


@pytest.mark.parametrize("size", [(7, 9), (40, 56)], ids=["7x9", "40x56"])
@pytest.mark.parametrize("sampling,options", [c[1:] for c in _encoder_cases()],
                         ids=[c[0] for c in _encoder_cases()])
def test_decode_encoded_jpeg_equals_pil(sampling, options, size):
    h, w = size
    img = content(h + w, h, w, len(sampling), 10.0)
    data = encode_jpeg(img, sampling, **options)
    want = _pil(data)
    if options.get("mode") == "lossless" and set(sampling) == {(1, 1)}:  # the samples come back
        pt = options.get("point_transform", 0)
        np.testing.assert_array_equal(want, (img >> pt) << pt)
    _assert_same(decode_jpeg(data), want)


@pytest.mark.parametrize("kind", ["no-dht", "ycck", "cmyk-without-adobe"])
def test_decode_jpeg_markers_equal_pil(kind):
    """MJPEG frames (no DHT: the standard tables), Adobe's YCCK (libjpeg's
    YCCK -> CMYK) and CMYK without an Adobe marker (PIL inverts CMYK
    whatever the markers say)."""
    img = content(9, 61, 93, 3, 8.0)
    buf = io.BytesIO()
    if kind == "no-dht":
        Image.fromarray(img).save(buf, "JPEG", quality=90, subsampling=2)
        data = b"\xff\xd8" + b"".join(seg for m, seg in jpeg_segments(buf.getvalue()) if m != 0xC4)
    else:
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG", quality=90)
        data = buf.getvalue()
        at = data.index(b"Adobe")
        if kind == "ycck":
            data = data[:at + 11] + bytes([2]) + data[at + 12:]
        else:
            data = b"\xff\xd8" + b"".join(seg for m, seg in jpeg_segments(data) if m != 0xEE)
    _assert_same(decode_jpeg(data), _pil(data))


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


def _build_tiff(img: np.ndarray, order: str, compression: int, predictor: int = 1,
                tile=None, rows_per_strip=16) -> bytes:
    """A baseline TIFF of a gray, RGB or RGBA uint8 / uint16 image, in strips
    or in tiles of `tile` = (width, height), written here
    (make_fixtures.build_tiff)."""
    rgba = img.ndim == 3 and img.shape[2] == 4
    return build_tiff(img, order, compression, predictor, tile=tile,
                      rows_per_strip=rows_per_strip, extra=(2,) if rgba else ())


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


def _retag(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian classic TIFF with one SHORT entry set to `value`."""
    data = bytearray(data)
    ifd = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[ifd:ifd + 2])[0]
    entries = [data[ifd + 2 + 12 * i:ifd + 14 + 12 * i] for i in range(n)]
    entries = [e for e in entries if struct.unpack("<H", e[:2])[0] != tag]
    entries.append(struct.pack("<HHIHH", tag, 3, 1, value, 0))
    entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])
    data[ifd:ifd + 2 + 12 * n] = struct.pack("<H", len(entries)) + b"".join(entries)
    return bytes(data)


@pytest.mark.parametrize("tag,value,match", [
    (284, 2, None), (262, 0, None), (259, 7, "JPEG"), (317, 3, None),
    (339, 3, "SampleFormat"), ("cmyk", None, None), ("lzw-predictor3", None, "Predictor")])
def test_decode_tiff_refusals(tag, value, match):
    """Tags a baseline reader refuses, on an 8-bit gray file: where PIL
    decodes the file (match None: planar 2, WhiteIsZero, the float predictor
    on uncompressed data, which libtiff ignores there, an 8-bit CMYK file)
    the port gives its array; where PIL refuses it (JPEG compression of raw
    bytes, the float format or, under LZW, the float predictor on 8-bit
    samples), so does the port."""
    if tag == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(_tiff_image("RGBA", 3)).convert("CMYK").save(buf, "TIFF")
        data = buf.getvalue()
    elif tag == "lzw-predictor3":
        data = build_tiff(_tiff_image("L", 3), "<", 5, predictor=3)
    else:
        data = _retag(_build_tiff(_tiff_image("L", 3), "<", 1), tag, value)
    if match is None:
        _assert_same(decode_tiff(data), _pil(data))
        return
    with pytest.raises((OSError, SyntaxError)):  # PIL refuses these too
        _pil(data)
    with pytest.raises(ValueError, match=match):
        decode_tiff(data)


def _tiff_cases():
    """(id, builder): the layouts and codecs beyond baseline TIFF, each
    file against PIL's np.asarray (palette files against its RGB)."""
    r = np.random.default_rng(5)
    rgba = content(6, 37, 53, 4, 6.0)
    gray = rgba[..., 0]
    floats = (r.normal(size=(37, 53)) * 300).astype(np.float32)
    wide = r.integers(0, 65536, (37, 53, 4)).astype(np.uint16)
    bw = content(7, 37, 53, 1, 30.0) < 120
    cases = []

    def add(name, *args, **kw):  # build_tiff(*args, **kw), built in the test
        cases.append((name, lambda: build_tiff(*args, **kw)))

    def pil(name, img, **kw):  # PIL's own file
        def build():
            buf = io.BytesIO()
            (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(buf, "TIFF", **kw)
            return buf.getvalue()
        cases.append((name, build))

    for order in "<>":
        o = "II" if order == "<" else "MM"
        for c in (1, 5, 8, 32773, 34925):
            p = f"{o}-{c}"
            add(f"{p}-planar2-rgb", rgba[..., :3], order, c, planar=2)
            add(f"{p}-planar2-rgba-tiles", rgba, order, c, planar=2, extra=(2,), tile=(16, 16),
                predictor=2 if c in (5, 8) else 1)
            add(f"{p}-whiteiszero", gray, order, c, photometric=0)
            add(f"{p}-fillorder2", gray, order, c, fill_order=2)
            add(f"{p}-associated-alpha", rgba, order, c, extra=(1,))
            add(f"{p}-rgbx", rgba, order, c, extra=(0,))
            add(f"{p}-rgb16", wide[..., :3], order, c)
            add(f"{p}-rgba16-associated", wide, order, c, extra=(1,))
            add(f"{p}-cmyk16", wide, order, c, photometric=5)
            add(f"{p}-cmyk", rgba, order, c, photometric=5)
            add(f"{p}-int8", gray.astype(np.int8), order, c, sample_format=2)
            add(f"{p}-gray-alpha", rgba[..., :2], order, c, extra=(2,))
            add(f"{p}-lab", rgba[..., :3], order, c, photometric=8)
            for bits in (1, 2, 4):
                v = (gray >> (8 - bits)).astype(np.uint8)
                pal = r.integers(0, 65536, 3 * 2 ** bits).tolist()
                add(f"{p}-{bits}bit-whiteiszero", v, order, c, bits=bits, photometric=0)
                add(f"{p}-{bits}bit-fillorder2", v, order, c, bits=bits, fill_order=2)
                add(f"{p}-{bits}bit-palette", v, order, c, bits=bits, photometric=3,
                    tags={320: (3, pal)})
        for c, preds in ((1, (1,)), (5, (1, 2, 3)), (8, (1, 2, 3)), (34925, (2, 3))):
            for p in preds:
                add(f"{o}-{c}-float-predictor{p}", floats, order, c, predictor=p, sample_format=3)
            for dt in (np.int16, np.int32):
                for p in preds[:2] if c != 1 else (1,):
                    add(f"{o}-{c}-{np.dtype(dt).name}-predictor{p}", (floats * 50).astype(dt),
                        order, c, predictor=p, sample_format=2)
        add(f"{o}-old-style-lzw", rgba[..., :3], order, 5, old_lzw=True)
        add(f"{o}-uint32", r.integers(0, 2 ** 32, (9, 7)).astype(np.uint32), order, 5)
    for c in (1, 8, 34925):
        add(f"bigtiff-{c}-tiles", rgba[..., :3], "<", c, big=True, tile=(16, 32))
        add(f"bigtiff-{c}-float", floats, "<", c, big=True, sample_format=3)
    add("bigtiff-MM", gray, ">", 1, big=True)
    add("float64", floats.astype(np.float64), "<", 8, sample_format=3)
    for mode, c in (("rle", 2), ("g3", 3), ("g3_2d", 3), ("g4", 4)):
        for ph in (0, 1):
            add(f"ccitt-{mode}-photometric{ph}", bw.astype(np.uint8), "<", c, bits=1,
                photometric=ph, rows_per_strip=37, chunks=[fax_encode(bw, mode)],
                tags={292: (4, [int(mode == "g3_2d")])} if c == 3 else None)
    for comp in ("group3", "group4", "tiff_ccitt", "packbits", "tiff_lzw"):
        pil(f"pil-bilevel-{comp}", Image.fromarray(bw), compression=comp, rowsperstrip=10)
    for comp in ("jpeg", "zstd", "lzma"):
        pil(f"pil-rgb-{comp}", rgba[..., :3], compression=comp, rowsperstrip=16)
        if comp != "jpeg":
            pil(f"pil-float-{comp}-predictor3", floats, compression=comp, tiffinfo={317: 3})
    pil("pil-gray-jpeg", gray, compression="jpeg")
    add("ycbcr-one-sample-raw", gray, "<", 1, photometric=6)
    add("ycbcr-one-sample-lzw", gray, "<", 5, photometric=6)
    pil("pil-int32-zstd", (floats * 1e5).astype(np.int32), compression="zstd", tiffinfo={317: 2})
    for ss, sampling in ((2, [2, 2]), (1, [2, 1]), (0, [1, 1])):
        buf = io.BytesIO()
        Image.fromarray(rgba[..., :3]).save(buf, "JPEG", quality=90, subsampling=ss)
        tables, strip = split_jpeg_tables(buf.getvalue())
        add(f"jpeg-ycbcr-{ss}", rgba[..., :3], "<", 7, photometric=6, rows_per_strip=37,
            tags={347: (7, tables), 530: (3, sampling)}, chunks=[strip])
    return cases


TIFF_CASES = _tiff_cases()
# PIL 12 reads big-endian signed and float samples from libtiff (every
# compression but none) in native order as if big-endian: byte-swapped values
# (ROADMAP C). The port gives the values; these cases hold it to PIL's array
# swapped back.
SWAPPED = re.compile(r"^MM-(5|8|32773|34925)-(float|int16|int32)")


@pytest.mark.parametrize("build", [c[1] for c in TIFF_CASES], ids=[c[0] for c in TIFF_CASES])
def test_decode_tiff_kinds_equal_pil(build, request):
    name = request.node.callspec.id
    data = build()
    try:
        im = Image.open(io.BytesIO(data))
        want = np.asarray(im.convert("RGB")) if im.mode == "P" else np.asarray(im)
    except (OSError, SyntaxError):  # PIL refuses the file: so does the port
        with pytest.raises(ValueError, match="A1b|BigTIFF"):
            decode_tiff(data)
        return
    got = decode_tiff(data)
    if SWAPPED.match(name):
        want = (want.astype(np.int16).byteswap().astype(want.dtype) if "int16" in name
                else want.byteswap())
    assert got.shape == want.shape and got.dtype == want.dtype.newbyteorder("="), (
        got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)


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
