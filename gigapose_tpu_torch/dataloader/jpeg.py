"""JPEG decoding: the ctypes binding of csrc/codecs.cpp.

`decode_jpeg(data)` gives what `np.asarray(Image.open(...))` gives with
PIL 12 on libjpeg-turbo 3.1: (H, W, 3) uint8 for a colour file, (H, W) for
a gray one, (H, W, 4) for CMYK and YCCK (inverted, as PIL reads Adobe's
CMYK), byte for byte (libjpeg's islow IDCT, its upsampler by sampling
ratio, its colour tables and block smoothing; see the source's head). The
EXIF orientation is not applied, as np.asarray does not.

It reads baseline and extended sequential, progressive and lossless
frames, Huffman- or arithmetic-coded (SOF0-3, SOF9, SOF10), 8-bit samples,
1, 3 or 4 components with sampling factors 1-4 in integral ratios, 8- and
16-bit quantization tables, optimized or standard (no DHT) Huffman tables
and restart intervals. What PIL on libjpeg-turbo refuses raises ValueError
naming ROADMAP A1b: 12-bit, hierarchical and lossless arithmetic frames, 2
components, fractional sampling ratios, a height defined by DNL, lossless
files in YCbCr, truncated files.

The library is built by kernels/build.py with the host compiler at first
use, never at import; a failed build raises. The decoder runs in C with the
GIL released, so threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

SIGNATURE = b"\xff\xd8\xff"
_ERR_LEN = 256


@functools.cache
def library() -> ctypes.CDLL:
    """csrc/codecs.cpp, built and loaded once per process."""
    from gigapose_tpu_torch.kernels.build import load_library

    lib = load_library("codecs.cpp")
    size_t, u8p, char_p = ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p
    intp = ctypes.POINTER(ctypes.c_int)
    lib.gp_jpeg_header.restype = ctypes.c_int
    lib.gp_jpeg_header.argtypes = [char_p, size_t, intp, intp, intp, intp, char_p, ctypes.c_int]
    lib.gp_jpeg_decode.restype = ctypes.c_int
    lib.gp_jpeg_decode.argtypes = [char_p, size_t, u8p, ctypes.c_int, char_p, ctypes.c_int]
    lib.gp_tiff_lzw_decode.restype = ctypes.c_int64
    lib.gp_tiff_lzw_decode.argtypes = [char_p, size_t, u8p, size_t, char_p, ctypes.c_int]
    lib.gp_packbits_decode.restype = ctypes.c_int64
    lib.gp_packbits_decode.argtypes = [char_p, size_t, u8p, size_t]
    lib.gp_tiff_fax_decode.restype = ctypes.c_int
    lib.gp_tiff_fax_decode.argtypes = [char_p, size_t, u8p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, char_p, ctypes.c_int]
    return lib


def _raise(err: ctypes.Array) -> None:
    raise ValueError(f"cannot decode this JPEG: {err.value.decode()} (ROADMAP A1b)")


def decode_jpeg(data: bytes, color_transform: Optional[bool] = None) -> np.ndarray:
    """JPEG bytes -> (H, W), (H, W, 3) or (H, W, 4) uint8, as PIL's
    np.asarray gives. color_transform: None, libjpeg's choice from the
    markers and component ids (as PIL); True, the components read as YCbCr
    (YCCK); False, as they are. With True or False CMYK is not inverted
    (libtiff's JPEGCOLORMODE_RGB and its raw colour mode)."""
    data = bytes(data)
    lib = library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w, c, adobe = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.gp_jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
                          ctypes.byref(adobe), err, _ERR_LEN):
        _raise(err)
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, np.uint8)
    transform = -1 if color_transform is None else int(color_transform)
    if lib.gp_jpeg_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          transform, err, _ERR_LEN):
        _raise(err)
    if c.value == 4 and color_transform is None:
        np.subtract(255, out, out=out)  # PIL reads CMYK as Adobe's inverted CMYK
    return out
