"""TIFF decoding on numpy, zlib, lzma and the system's libzstd, with the LZW,
PackBits and CCITT loops in csrc/codecs.cpp and JPEG through
dataloader/jpeg.py: the reader of ITODD's gray images, of depth maps and of
other TIFFs.

`decode_tiff(data)` reads the first image (IFD) of a little- (II) or
big-endian (MM) file, classic or BigTIFF (`II+\\0` / `MM\\0+`, 8-byte
offsets), from strips or tiles, PlanarConfiguration 1 or 2, FillOrder 1 or
2, with compression none (1), CCITT modified Huffman (2), T.4 (3) or T.6
(4), LZW (5, old-style streams too), JPEG (7, with its JPEGTables),
Deflate (8 and 32946), PackBits (32773), LZMA (34925) or zstd (50000), and
predictor 1, 2 (horizontal differencing) or 3 (floating point, under LZW,
Deflate, LZMA and zstd as libtiff applies them). It returns what
`np.asarray(Image.open(...))` gives with PIL 12 on libtiff 4.7:

- bilevel (1 bit): bool (H, W); 2- and 4-bit gray: uint8 scaled to 0-255;
  WhiteIsZero inverted;
- 8-bit gray: uint8; 16-bit: uint16 (PIL's I;16 and I;16B, here in native
  byte order); signed 16- and 32-bit and unsigned 32-bit: int32 (PIL's I);
  32-bit float: float32 (PIL's F); gray + alpha: (H, W, 2);
- RGB, RGBA (associated alpha divided out as PIL's RGBa does, extra
  unspecified samples dropped) and CMYK: (H, W, 3 | 4) uint8, 16-bit ones as
  their high bytes; JPEG-compressed YCbCr as libjpeg's RGB; LAB as stored;
- palette images as RGB (PIL gives the indices: ROADMAP C).

Big-endian signed and float samples come back as their values; PIL reads
libtiff's native-order output of compressed ones as big-endian, byte-swapped
(ROADMAP C). Big-endian BigTIFF and big-endian unsigned 32-bit gray, which
PIL refuses, are refused.

Every other layout raises ValueError naming its tag and ROADMAP A1b, as do
the compressions that PIL reads through libtiff codecs not ported (SGILog,
ThunderScan, NeXT, WebP, the old JPEG of compression 6) and YCbCr without
JPEG compression (but for one uncompressed sample, read as gray).
"""

from __future__ import annotations

import ctypes
import lzma
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from gigapose_tpu_torch.dataloader.jpeg import decode_jpeg, library
from gigapose_tpu_torch.utils import zstd

SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
_U8P = ctypes.POINTER(ctypes.c_uint8)
# TIFF field types -> struct codes (BYTE, ASCII, SHORT, LONG, RATIONAL,
# SBYTE, UNDEFINED, SSHORT, SLONG, SRATIONAL, FLOAT, DOUBLE, IFD, LONG8,
# SLONG8, IFD8)
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
_NAMES = {259: "Compression", 262: "PhotometricInterpretation", 258: "BitsPerSample",
          277: "SamplesPerPixel", 284: "PlanarConfiguration", 317: "Predictor",
          338: "ExtraSamples", 339: "SampleFormat", 266: "FillOrder"}
_COMPRESSIONS = (1, 2, 3, 4, 5, 7, 8, 32946, 32773, 34925, 50000)
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _unsupported(tag: int, value) -> ValueError:
    return ValueError(f"unsupported TIFF: {_NAMES.get(tag, tag)} (tag {tag}) = {value} "
                      f"(ROADMAP A1b)")


def _read_ifd(data: bytes, order: str, big: bool) -> Dict[int, List]:
    off_fmt, count_fmt, entry_size, inline = ("Q", "Q", 20, 8) if big else ("I", "H", 12, 4)
    (offset,) = struct.unpack(order + off_fmt, data[8:16] if big else data[4:8])
    n_size = struct.calcsize(count_fmt)
    head = data[offset:offset + n_size]
    if len(head) < n_size:
        raise ValueError("truncated TIFF directory")
    (count,) = struct.unpack(order + count_fmt, head)
    tags = {}
    for i in range(count):
        at = offset + n_size + entry_size * i
        entry = data[at:at + entry_size]
        if len(entry) < entry_size:
            raise ValueError("truncated TIFF directory")
        tag, ftype = struct.unpack(order + "HH", entry[:4])
        (n,) = struct.unpack(order + count_fmt.replace("H", "I"), entry[4:4 + inline])
        if ftype not in _TYPES:
            continue
        code = _TYPES[ftype]
        size = struct.calcsize(order + code) * n
        value = entry[4 + inline:]
        raw = value[:size] if size <= inline else (
            data[struct.unpack(order + off_fmt, value)[0]:][:size])
        if len(raw) < size:
            raise ValueError("truncated TIFF directory")
        tags[tag] = raw if tag == 347 else list(struct.unpack(order + code * n, raw))
    return tags


def _lzw(chunk: bytes, size: int) -> bytes:
    out = np.empty(size, np.uint8)
    err = ctypes.create_string_buffer(256)
    n = library().gp_tiff_lzw_decode(chunk, len(chunk), out.ctypes.data_as(_U8P), size, err, 256)
    if n < 0:
        raise ValueError(f"cannot decode this TIFF: {err.value.decode()} (ROADMAP A1b)")
    return out[:n].tobytes()


def _packbits(chunk: bytes, size: int) -> bytes:
    out = np.empty(size, np.uint8)
    n = library().gp_packbits_decode(chunk, len(chunk), out.ctypes.data_as(_U8P), size)
    return out[:n].tobytes()


def _fax(chunk: bytes, rows: int, cols: int, compression: int, t4options: int) -> bytes:
    out = np.empty(rows * ((cols + 7) // 8), np.uint8)
    err = ctypes.create_string_buffer(256)
    if library().gp_tiff_fax_decode(chunk, len(chunk), out.ctypes.data_as(_U8P), rows, cols,
                                    compression, t4options, err, 256):
        raise ValueError(f"cannot decode this TIFF: {err.value.decode()} (ROADMAP A1b)")
    return out.tobytes()


def _jpeg(chunk: bytes, tables: bytes, ycbcr: bool) -> np.ndarray:
    """A JPEG strip or tile, its tables from JPEGTables (libtiff's abbreviated
    streams), as libtiff has libjpeg decode it: YCbCr converted to RGB, any
    other photometric without a colour transform."""
    if tables and len(tables) > 4 and chunk[:2] == b"\xff\xd8":
        chunk = tables[:-2] + chunk[2:]  # the tables' SOI .. its EOI, then the strip
    return decode_jpeg(chunk, color_transform=ycbcr)


def _decompress(raw: bytes, compression: int, size: int) -> bytes:
    if compression == 5:
        return _lzw(raw, size)
    if compression in (8, 32946):
        return zlib.decompressobj().decompress(raw, size)
    if compression == 32773:
        return _packbits(raw, size)
    if compression == 34925:
        return lzma.LZMADecompressor().decompress(raw, size)
    if compression == 50000:
        return zstd.decompress(raw, what="TIFF zstd strip")[:size]
    return raw


def _unpredict(block: np.ndarray, predictor: int) -> np.ndarray:
    """Undo predictor 2 (horizontal differencing of each sample's bits,
    wrapping, as libtiff's horAcc) or 3 (libtiff's fpAcc: the row's bytes
    differenced `spp` apart, then gathered from byte planes, most significant
    first) on (rows, cols, spp) samples in the file's byte order -> native
    samples."""
    rows, cols, spp = block.shape
    native = block.astype(block.dtype.newbyteorder("="))
    n = native.itemsize
    if predictor == 2:
        bits = native.view(f"u{n}")
        return np.cumsum(bits, axis=1, dtype=bits.dtype).view(native.dtype)
    raw = np.frombuffer(block.tobytes(), np.uint8).reshape(rows, cols * n, spp)
    raw = np.cumsum(raw, axis=1, dtype=np.uint8).reshape(rows, n, cols * spp)
    msb_first = np.ascontiguousarray(raw.transpose(0, 2, 1))
    return msb_first.view(">" + native.dtype.kind + str(n)).reshape(rows, cols, spp).astype(
        native.dtype)


def _unpack_bits(raw: bytes, rows: int, cols: int, spp: int, depth: int) -> np.ndarray:
    """Rows of `depth`-bit samples (1, 2, 4), each row from a byte boundary ->
    (rows, cols, spp) uint8 sample values."""
    stride = (cols * spp * depth + 7) // 8
    b = np.frombuffer(raw, np.uint8, count=rows * stride).reshape(rows, stride)
    bits = np.unpackbits(b, axis=1)[:, :cols * spp * depth].reshape(rows, cols * spp, depth)
    vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
    return vals.reshape(rows, cols, spp)


def _layout(tags) -> Tuple:
    get = lambda tag, default: tags.get(tag, [default])
    spp = get(277, 1)[0]
    bps = tuple(get(258, 1)) if 258 in tags else (1,)
    bps = bps * spp if len(bps) == 1 else bps
    fmts = tuple(get(339, 1)) if 339 in tags else (1,)
    fmt = fmts[0]
    photometric = get(262, -1)[0]
    extra = tuple(tags.get(338, ()))
    if len(set(bps)) != 1 or len(bps) != spp:
        raise _unsupported(258, list(bps))
    if len(set(fmts)) != 1:
        raise _unsupported(339, list(fmts))
    return spp, bps[0], fmt, photometric, extra


def _sample_dtype(depth: int, fmt: int, order: str) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt)
    if kind is None or (kind == "f" and depth != 32):
        raise _unsupported(339, f"{fmt} with {depth}-bit samples")
    if depth not in (1, 2, 4, 8, 16, 32):
        raise _unsupported(258, f"{depth}-bit samples")
    return np.dtype(np.uint8) if depth < 8 else np.dtype(order + kind + str(depth // 8))


def _to_pil(px: np.ndarray, depth: int, fmt: int, photometric: int, extra: tuple,
            palette) -> np.ndarray:
    """Native (H, W, spp) samples -> PIL's np.asarray (see module doc)."""
    spp = px.shape[2]
    if photometric in (0, 1) and spp == 1:
        a = px[..., 0]
        if depth < 8:
            if depth == 1:
                a = a.astype(bool)
                return ~a if photometric == 0 else a
            a = (a * (255 // (2 ** depth - 1))).astype(np.uint8)
            return 255 - a if photometric == 0 else a
        if depth == 8 and fmt in (1, 2):
            if fmt == 2 and photometric == 0:
                raise _unsupported(339, "signed WhiteIsZero samples")
            a = a.view(np.uint8)  # PIL reads signed bytes as L, unchanged
            return 255 - a if photometric == 0 else a
        if photometric == 0 and fmt != 3 and not (depth == 16 and fmt == 1):
            raise _unsupported(262, f"WhiteIsZero with {depth}-bit samples of format {fmt}")
        if depth == 16 and fmt == 1:
            return a.astype(np.uint16)  # PIL's I;16: WhiteIsZero not inverted
        if fmt == 3:
            return a.astype(np.float32)
        if depth in (16, 32):
            return a.astype(np.int32)  # PIL's I (a uint32 above 2**31 wraps)
        raise _unsupported(258, f"{depth}-bit gray of format {fmt}")
    if photometric == 1 and spp == 2 and depth == 8 and fmt == 1 and extra == (2,):
        return px.astype(np.uint8)  # LA
    if photometric == 3 and spp == 1 and fmt == 1 and depth <= 8 and palette is not None:
        lut = (np.asarray(palette, np.uint32).reshape(3, -1) >> 8).astype(np.uint8).T
        return lut[px[..., 0]]
    if fmt != 1 or depth not in (8, 16):
        raise _unsupported(339 if fmt != 1 else 258, f"{depth}-bit samples of format {fmt} "
                           f"with photometric {photometric}")
    px = (px >> 8).astype(np.uint8) if depth == 16 else px.astype(np.uint8)
    if photometric in (2, 6) and spp >= 3:
        n_color = 3
    elif photometric == 5 and spp >= 4:
        n_color = 4
    elif photometric == 8 and spp == 3:
        return px
    else:
        raise _unsupported(262, f"{photometric} with {spp} x {depth}-bit samples")
    alpha = extra[:1] if spp > n_color else ()
    if len(extra) != spp - n_color and not (spp == 4 and n_color == 3 and not extra):
        raise _unsupported(338, list(extra))
    if photometric == 5:
        if alpha not in ((), (0,)):
            raise _unsupported(338, list(extra))
        return px[..., :4]
    if spp == 3 or alpha == (0,):
        return px[..., :3]
    rgba = px[..., :4]
    if alpha == (1,):  # PIL's RGBa: premultiplied, divided out in integers
        a = rgba[..., 3:].astype(np.int32)
        rgb = np.minimum(rgba[..., :3].astype(np.int32) * 255 // np.maximum(a, 1), 255)
        out = np.concatenate([rgb, a], -1)
        out[(a == 0)[..., 0]] = 0
        return out.astype(np.uint8)
    return rgba


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> PIL's np.asarray of the first image (see module doc)."""
    data = bytes(data)
    if data[:4] not in SIGNATURES:
        raise ValueError("not a TIFF file")
    order = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\x00", b"\x00+")
    if big and order == ">":
        raise ValueError("big-endian BigTIFF (PIL reads none either; ROADMAP A1b)")
    if big and struct.unpack(order + "HH", data[4:8]) != (8, 0):
        raise ValueError("bad BigTIFF header")
    tags = _read_ifd(data, order, big)
    get = lambda tag, default: tags.get(tag, [default])
    width, height = get(256, 0)[0], get(257, 0)[0]
    compression, predictor, planar = get(259, 1)[0], get(317, 1)[0], get(284, 1)[0]
    fill = get(266, 1)[0]
    spp, depth, fmt, photometric, extra = _layout(tags)
    for tag, value, ok in ((284, planar, (1, 2)), (266, fill, (1, 2)), (317, predictor, (1, 2, 3)),
                           (259, compression, _COMPRESSIONS)):
        if value not in ok:
            raise _unsupported(tag, value)
    if width <= 0 or height <= 0:
        raise ValueError(f"TIFF of {width} x {height}")
    if compression in (2, 3, 4) and (depth, spp) != (1, 1):
        raise _unsupported(258, f"CCITT compression of {spp} x {depth}-bit samples")
    jpeg = compression == 7
    if jpeg and (depth != 8 or fmt != 1):
        raise _unsupported(258, f"JPEG compression of {depth}-bit samples")
    if photometric == 6 and not jpeg:
        if spp != 1 or compression != 1:
            raise _unsupported(262, "6 (YCbCr) without JPEG compression")
        photometric = 1  # one uncompressed sample: PIL reads it as L
    dtype = _sample_dtype(depth, fmt, order)
    # libtiff applies no predictor under no compression, PackBits, CCITT or JPEG
    predict = predictor if compression in (5, 8, 32946, 34925, 50000) else 1
    if predict == 3 and fmt != 3:
        raise _unsupported(317, "3 on integer samples")
    if predict == 2 and depth < 8:
        raise _unsupported(317, f"2 on {depth}-bit samples")

    planes = spp if planar == 2 else 1
    per_chunk = 1 if planar == 2 else spp
    if 322 in tags:  # tiles
        tw, th = get(322, 0)[0], get(323, 0)[0]
        offsets, counts = tags.get(324, []), tags.get(325, [])
        grid = [(ty, tx) for ty in range(0, height, th) for tx in range(0, width, tw)]
        chunks = [(p, tw, th, ty, tx) for p in range(planes) for ty, tx in grid]
    else:
        rps = min(get(278, 2 ** 32 - 1)[0], height)
        offsets, counts = tags.get(273, []), tags.get(279, [])
        chunks = [(p, width, min(rps, height - y), y, 0) for p in range(planes)
                  for y in range(0, height, rps)]
    if len(offsets) < len(chunks) or len(counts) < len(chunks):
        raise ValueError("TIFF lists fewer strips or tiles than the image needs")

    out = np.empty((height, width, spp), dtype)
    tables = tags.get(347, b"")
    for (p, cw, ch, y, x), off, cnt in zip(chunks, offsets, counts):
        raw = data[off:off + cnt]
        if fill == 2:  # libtiff reverses the bits of the raw data first
            raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
        if jpeg:
            block = _jpeg(raw, bytes(tables), photometric == 6)
            block = block.reshape(block.shape[0], block.shape[1], -1)
            if (block.shape[2] != per_chunk or block.shape[0] < ch
                    or block.shape[1] < min(cw, width - x)):
                raise ValueError(f"TIFF JPEG strip or tile of shape {block.shape}")
        else:
            if depth < 8:
                size = ch * ((cw * per_chunk * depth + 7) // 8)
            else:
                size = cw * ch * per_chunk * dtype.itemsize
            if compression in (2, 3, 4):
                raw = _fax(raw, ch, cw, compression, get(292, 0)[0] if compression == 3 else 0)
            else:
                raw = _decompress(raw, compression, size)
            if len(raw) < size:
                raise ValueError(f"TIFF strip or tile holds {len(raw)} bytes, {size} expected")
            if depth < 8:
                block = _unpack_bits(raw, ch, cw, per_chunk, depth)
            else:
                block = np.frombuffer(raw, dtype, count=cw * ch * per_chunk).reshape(
                    ch, cw, per_chunk)
                if predict > 1:
                    block = _unpredict(block, predict)
        h, w = min(ch, height - y), min(cw, width - x)
        if planar == 2:
            out[y:y + h, x:x + w, p] = block[:h, :w, 0]
        else:
            out[y:y + h, x:x + w] = block[:h, :w]
    out = out.astype(dtype.newbyteorder("="), copy=False)
    if order == ">" and spp == 1 and depth == 32 and fmt == 1:
        raise _unsupported(258, "big-endian unsigned 32-bit gray (PIL reads none either)")
    return _to_pil(out, depth, fmt, photometric, extra, tags.get(320))
