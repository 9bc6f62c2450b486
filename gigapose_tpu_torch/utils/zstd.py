"""Zstandard decompression on the host, through the system's libzstd.

The orbax reader (utils/ocdbt.py, utils/orbax.py) needs zstd for the
OCDBT nodes and the zarr chunks, and Python 3.12 has none in its standard
library. This binds libzstd.so.1's streaming decoder (ZSTD_decompressStream)
with ctypes: zarr chunks are frames without their content size, which the
one-shot ZSTD_decompress cannot size. The library is loaded at first use,
never at import; a missing library raises OSError naming it, and a corrupt
or truncated frame raises ValueError. There is no other decoder to fall
back to.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

LIBRARY = "libzstd.so.1"


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


@functools.cache
def library() -> ctypes.CDLL:
    """libzstd.so.1, loaded once per process."""
    try:
        lib = ctypes.CDLL(LIBRARY)
    except OSError as e:
        raise OSError(f"zstd: cannot load {LIBRARY} ({e}); the orbax checkpoint reader "
                      "decompresses with the system's libzstd (package libzstd1)") from e
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_createDCtx.restype = vp
    lib.ZSTD_createDCtx.argtypes = []
    lib.ZSTD_freeDCtx.restype = size_t
    lib.ZSTD_freeDCtx.argtypes = [vp]
    lib.ZSTD_decompressStream.restype = size_t
    lib.ZSTD_decompressStream.argtypes = [vp, ctypes.POINTER(_OutBuffer),
                                          ctypes.POINTER(_InBuffer)]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_DStreamOutSize.restype = size_t
    lib.ZSTD_DStreamOutSize.argtypes = []
    lib.ZSTD_versionString.restype = ctypes.c_char_p
    lib.ZSTD_versionString.argtypes = []
    return lib


def version() -> str:
    """The loaded libzstd's version, e.g. "1.5.5"."""
    return library().ZSTD_versionString().decode()


def decompress(data: bytes, expected_size: Optional[int] = None, what: str = "zstd data") -> bytes:
    """Every zstd frame of `data`, decoded and concatenated. A corrupt frame,
    a frame cut short, or (with `expected_size`) another decoded length
    raises ValueError naming `what`."""
    lib = library()
    data = bytes(data)
    if not data:
        raise ValueError(f"{what}: empty zstd input")
    src = _InBuffer(ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), len(data), 0)
    step = max(lib.ZSTD_DStreamOutSize(), (expected_size or 0) + 1)
    buf = ctypes.create_string_buffer(step)
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("zstd: ZSTD_createDCtx failed")
    parts = []
    try:
        while True:
            out = _OutBuffer(ctypes.cast(buf, ctypes.c_void_p), step, 0)
            ret = lib.ZSTD_decompressStream(dctx, ctypes.byref(out), ctypes.byref(src))
            if lib.ZSTD_isError(ret):
                raise ValueError(f"{what}: zstd error {lib.ZSTD_getErrorName(ret).decode()}")
            parts.append(buf.raw[:out.pos])
            if src.pos == src.size:
                if ret == 0:  # the last frame is complete and flushed
                    break
                if out.pos < out.size:  # the decoder wants input that is not there
                    raise ValueError(f"{what}: truncated zstd frame")
    finally:
        lib.ZSTD_freeDCtx(dctx)
    result = b"".join(parts)
    if expected_size is not None and len(result) != expected_size:
        raise ValueError(f"{what}: decoded {len(result)} bytes, expected {expected_size}")
    return result
