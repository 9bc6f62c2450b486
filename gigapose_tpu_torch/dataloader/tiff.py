"""TIFF decoding on numpy + zlib, with the LZW and PackBits loops and the
predictor in csrc/codecs.cpp: the reader of ITODD's gray images and of other
uncompressed or losslessly compressed TIFFs.

`decode_tiff(data)` reads the first image (IFD) of a little- (II) or
big-endian (MM) file, from strips or tiles, PlanarConfiguration 1, with
compression none (1), LZW (5), Deflate (8 and 32946, through zlib) or
PackBits (32773) and predictor 1 or 2 (applied, as libtiff applies it,
under LZW and Deflate only). The sample layouts: 8-bit gray,
RGB and RGBA (unassociated alpha), and 16-bit gray. It returns what
`np.asarray(Image.open(...))` gives with PIL: (H, W) uint8 or uint16 (PIL's
modes I;16 and I;16B, here in native byte order), or (H, W, 3 | 4) uint8.
Any other layout, compression or predictor raises ValueError naming its
tag and ROADMAP A1b.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, List

import numpy as np

from gigapose_tpu_torch.dataloader.jpeg import library

SIGNATURES = (b"II*\x00", b"MM\x00*")
_U8P = ctypes.POINTER(ctypes.c_uint8)
# TIFF field types -> struct codes (BYTE, ASCII, SHORT, LONG, RATIONAL,
# SBYTE, UNDEFINED, SSHORT, SLONG)
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i"}
_NAMES = {259: "Compression", 262: "PhotometricInterpretation", 258: "BitsPerSample",
          277: "SamplesPerPixel", 284: "PlanarConfiguration", 317: "Predictor",
          338: "ExtraSamples", 339: "SampleFormat", 266: "FillOrder"}


def _unsupported(tag: int, value) -> ValueError:
    return ValueError(f"unsupported TIFF: {_NAMES.get(tag, tag)} (tag {tag}) = {value} "
                      f"(ROADMAP A1b)")


def _read_ifd(data: bytes, order: str) -> Dict[int, List[int]]:
    (offset,) = struct.unpack(order + "I", data[4:8])
    (count,) = struct.unpack(order + "H", data[offset:offset + 2])
    tags = {}
    for i in range(count):
        entry = data[offset + 2 + 12 * i:offset + 14 + 12 * i]
        if len(entry) < 12:
            raise ValueError("truncated TIFF directory")
        tag, ftype, n = struct.unpack(order + "HHI", entry[:8])
        if ftype not in _TYPES:
            continue
        code = _TYPES[ftype]
        size = struct.calcsize(order + code) * n
        raw = entry[8:8 + size] if size <= 4 else (
            data[struct.unpack(order + "I", entry[8:12])[0]:][:size])
        if len(raw) < size:
            raise ValueError("truncated TIFF directory")
        tags[tag] = list(struct.unpack(order + code * n, raw))
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


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> (H, W) uint8 / uint16 or (H, W, 3 | 4) uint8 (see module doc)."""
    data = bytes(data)
    if data[:4] not in SIGNATURES:
        raise ValueError("not a TIFF file (BigTIFF is ROADMAP A1b)")
    order = "<" if data[:2] == b"II" else ">"
    tags = _read_ifd(data, order)
    get = lambda tag, default: tags.get(tag, [default])
    width, height = get(256, 0)[0], get(257, 0)[0]
    spp = get(277, 1)[0]
    bps = tuple(get(258, 1)) if 258 in tags else (1,)
    compression, photometric = get(259, 1)[0], get(262, -1)[0]
    predictor, planar = get(317, 1)[0], get(284, 1)[0]
    extra = tuple(tags.get(338, ()))
    for tag, value, ok in ((284, planar, (1,)), (266, get(266, 1)[0], (1,)),
                           (339, get(339, 1)[0], (1,)), (317, predictor, (1, 2)),
                           (259, compression, (1, 5, 8, 32946, 32773))):
        if value not in ok:
            raise _unsupported(tag, value)
    if len(set(bps)) != 1 or len(bps) != spp:
        raise _unsupported(258, list(bps))
    depth = bps[0]
    layout = (photometric, spp, depth, extra)
    if layout not in ((1, 1, 8, ()), (1, 1, 16, ()), (2, 3, 8, ()), (2, 4, 8, (2,))):
        raise _unsupported(262 if photometric not in (1, 2) else 258,
                           f"{photometric} with {spp} x {depth}-bit samples"
                           + (f", ExtraSamples {list(extra)}" if extra else ""))
    if width <= 0 or height <= 0:
        raise ValueError(f"TIFF of {width} x {height}")
    dtype = np.dtype(order + "u2") if depth == 16 else np.dtype(np.uint8)

    if 322 in tags:  # tiles
        tw, th = get(322, 0)[0], get(323, 0)[0]
        offsets, counts = tags.get(324, []), tags.get(325, [])
        grid = [(ty, tx) for ty in range(0, height, th) for tx in range(0, width, tw)]
        chunks = [(tw, th, ty, tx) for ty, tx in grid]
    else:
        rps = min(get(278, 2 ** 32 - 1)[0], height)
        offsets, counts = tags.get(273, []), tags.get(279, [])
        chunks = [(width, min(rps, height - y), y, 0) for y in range(0, height, rps)]
    if len(offsets) < len(chunks) or len(counts) < len(chunks):
        raise ValueError("TIFF lists fewer strips or tiles than the image needs")

    out = np.empty((height, width, spp), dtype)
    for (cw, ch, y, x), off, cnt in zip(chunks, offsets, counts):
        raw = data[off:off + cnt]
        size = cw * ch * spp * dtype.itemsize
        if compression == 5:
            raw = _lzw(raw, size)
        elif compression in (8, 32946):
            raw = zlib.decompressobj().decompress(raw, size)
        elif compression == 32773:
            raw = _packbits(raw, size)
        if len(raw) < size:
            raise ValueError(f"TIFF strip or tile holds {len(raw)} bytes, {size} expected")
        block = np.frombuffer(raw, dtype, count=cw * ch * spp).reshape(ch, cw, spp)
        if predictor == 2 and compression in (5, 8, 32946):
            # horizontal differencing, per sample, wrapping; libtiff (and so
            # PIL) ignores the tag under no compression and PackBits
            block = block.copy()
            library().gp_tiff_unpredict(block.ctypes.data_as(_U8P), ch, cw, spp,
                                        dtype.itemsize, int(order == ">"))
        h, w = min(ch, height - y), min(cw, width - x)
        out[y:y + h, x:x + w] = block[:h, :w]
    out = out.astype(dtype.newbyteorder("="), copy=False)
    return out[..., 0] if spp == 1 else out
