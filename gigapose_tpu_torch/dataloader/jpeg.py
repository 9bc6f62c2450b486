"""Baseline JPEG decoding: the ctypes binding of csrc/codecs.cpp.

`decode_jpeg(data)` gives what `np.asarray(Image.open(...))` gives with
PIL on libjpeg-turbo: (H, W, 3) uint8 for a colour file, (H, W) for a
gray one, byte for byte (the islow IDCT, fancy upsampling and the
fixed-point YCbCr -> RGB tables of libjpeg's defaults; see the source's
head). The EXIF orientation is not applied, as np.asarray does not.

It reads SOF0 / SOF1 files with 8-bit samples, 1 or 3 components and
sampling factors of 1 or 2 (4:4:4, 4:2:2, 4:2:0, 4:4:0), 8- and 16-bit
quantization tables, optimized Huffman tables and restart intervals.
Progressive, arithmetic-coded, lossless and 12-bit files, CMYK and YCCK,
sampling factors above 2 and truncated files raise ValueError (ROADMAP
A1b), as a truncated file does in PIL.

The library is built by kernels/build.py with the host compiler at first
use, never at import; a failed build raises. The decoder runs in C with the
GIL released, so threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import functools

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
    lib.gp_jpeg_header.argtypes = [char_p, size_t, intp, intp, intp, char_p, ctypes.c_int]
    lib.gp_jpeg_decode.restype = ctypes.c_int
    lib.gp_jpeg_decode.argtypes = [char_p, size_t, u8p, char_p, ctypes.c_int]
    lib.gp_tiff_lzw_decode.restype = ctypes.c_int64
    lib.gp_tiff_lzw_decode.argtypes = [char_p, size_t, u8p, size_t, char_p, ctypes.c_int]
    lib.gp_packbits_decode.restype = ctypes.c_int64
    lib.gp_packbits_decode.argtypes = [char_p, size_t, u8p, size_t]
    lib.gp_tiff_unpredict.restype = None
    lib.gp_tiff_unpredict.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
    return lib


def _raise(err: ctypes.Array) -> None:
    raise ValueError(f"cannot decode this JPEG: {err.value.decode()} (ROADMAP A1b)")


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) or (H, W) uint8, as PIL's np.asarray gives."""
    data = bytes(data)
    lib = library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.gp_jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
                          err, _ERR_LEN):
        _raise(err)
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, np.uint8)
    if lib.gp_jpeg_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          err, _ERR_LEN):
        _raise(err)
    return out
