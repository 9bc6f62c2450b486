"""PNG codec on numpy + zlib: the image reader of the port's host code.

The JAX package decodes its PNGs with PIL, which the machines that run the
port do not have. This module reads and writes the PNGs of a BOP dataset
and of a rendered template set:

- `decode_png(data)` reads every PNG mode: gray at 1, 2, 4, 8 and 16 bits
  (16-bit: depth maps; big-endian on disk), gray + alpha, RGB and RGBA at 8
  and 16 bits, palette images (bit depths 1, 2, 4 and 8), with all five row
  filters, progressive (Adam7-interlaced) or not. The result is what
  `np.asarray(Image.open(...))` gives: 1-bit gray as bool (PIL's mode 1),
  2- and 4-bit gray scaled to 8 bits (x 85, x 17), 16-bit gray as uint16,
  16-bit RGB, RGBA and gray + alpha as the high bytes of their samples (the
  last widened to RGBA: gray, gray, gray, alpha), as PIL reads them; a
  palette image comes back expanded to RGB, or to RGBA when it carries a
  tRNS chunk, as PIL's `convert("RGB")` / `convert("RGBA")` give it.
- `encode_png(array, filter_type=0)` writes 8-bit gray, gray + alpha, RGB
  and RGBA, and 16-bit gray, with one row filter for every row, one per
  row, or "adaptive": per row the filter whose residual bytes, read as
  signed, have the least sum of magnitudes (libpng's default heuristic,
  which writers such as PIL follow closely), as in real image files.
- `to_rgba(array)` is PIL's `convert("RGBA")` for those 8-bit results.

Decoding None, Sub and Up rows costs one numpy call per row. Average and
Paeth rows depend on the decoded pixel to their left, so those rows (and
every row after the first of them) are decoded as a wavefront: row y runs
one pixel behind row y - 1, and each step decodes one pixel of every row at
once. A 480 x 640 image takes H + W - 1 numpy steps, not H x W Python ones.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel: gray, RGB, palette, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's seven passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) bool / uint8 / uint16 array (see module doc)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat, palette, trns = 8, None, [], None, None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, compression, filter_method, interlace = header
    if compression or filter_method or interlace > 1 or depth not in _DEPTHS.get(color, ()):
        raise ValueError(f"unsupported PNG: color type {color}, bit depth {depth}, "
                         f"interlace method {interlace}")
    ch = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(width - x0) // dx), -(-(height - y0) // dy)) for x0, y0, dx, dy in passes]
    need = sum(h * ((w * ch * depth + 7) // 8 + 1) for w, h in sizes if w > 0 and h > 0)
    if len(raw) < need:
        raise ValueError(f"PNG data holds {len(raw)} bytes, {need} expected")
    img = np.empty((height, width, ch), np.uint16 if depth == 16 else np.uint8)
    offset = 0
    for (x0, y0, dx, dy), (w, h) in zip(passes, sizes):
        if w > 0 and h > 0:  # an empty pass has no rows, not even filter bytes
            img[y0::dy, x0::dx], offset = _samples(raw, offset, w, h, depth, ch)

    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = img[..., 0]
        if int(idx.max()) >= len(palette):
            raise ValueError("palette index out of range")
        if trns is None:
            return palette[idx]
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:min(len(trns), len(palette))] = trns[:len(palette)]
        return np.concatenate([palette[idx], alpha[idx][..., None]], axis=-1)
    if color == 0:
        gray = img[..., 0]
        if depth == 1:
            return gray != 0
        return gray * np.uint8(255 // (2 ** depth - 1)) if depth < 8 else gray
    if depth == 16:  # PIL keeps the high bytes, and widens gray + alpha to RGBA
        img = (img >> 8).astype(np.uint8)
        if color == 4:
            img = img[..., [0, 0, 0, 1]]
    return img


def _samples(raw: bytes, offset: int, width: int, height: int, depth: int, ch: int):
    """One (sub-)image's filtered rows at `offset` of the inflated data ->
    ((height, width, ch) samples, the offset after its rows)."""
    rowbytes = (width * ch * depth + 7) // 8
    end = offset + height * (rowbytes + 1)
    rows = np.frombuffer(raw, np.uint8, count=end - offset, offset=offset).reshape(
        height, rowbytes + 1)
    pix = unfilter(rows[:, 0], rows[:, 1:], max(1, ch * depth // 8))
    if depth == 16:
        return pix.view(">u2").astype(np.uint16).reshape(height, width, ch), end
    if depth == 8:
        return pix.reshape(height, width, ch), end
    # samples packed 8 / depth per byte, high bits first (one channel)
    unpacked = np.unpackbits(pix, axis=1)[:, :width * depth].reshape(height, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (unpacked * weights).sum(-1, dtype=np.uint8)[..., None], end


def unfilter(ftypes: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters. ftypes (H,) filter byte per row, data
    (H, rowbytes) filtered bytes, bpp bytes per pixel (1 below 8 bits) ->
    (H, rowbytes) uint8."""
    H, n = data.shape
    if H and int(ftypes.max()) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftypes.max())}")
    out = np.empty((H, n), np.uint8)
    sequential = np.nonzero(ftypes >= 3)[0]
    first = int(sequential[0]) if len(sequential) else H
    prev = np.zeros(n, np.uint8)
    for y in range(first):
        f, row = ftypes[y], data[y]
        if f == 0:
            out[y] = row
        elif f == 1:  # Sub: running sum per byte of the pixel, mod 256
            out[y] = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:  # Up
            out[y] = row + prev
        prev = out[y]
    if first < H:
        out[first:] = _unfilter_wavefront(ftypes[first:], data[first:], prev, bpp)
    return out


def _unfilter_wavefront(ftypes: np.ndarray, data: np.ndarray, prev: np.ndarray,
                        bpp: int) -> np.ndarray:
    """All five filters, one pixel of every row per step. In skewed storage
    S[u, y + 1] = out[y, u - 2 - y] (u = t + 2, t the step) the left, upper
    and upper-left neighbours of step t's pixels are slices of S[u - 1] and
    S[u - 2]. S[:, 0] holds the row above the block (`prev`); step t writes
    only the rows y with 0 <= t - y < W, so entries outside the image stay
    0, which is the filters' own edge rule."""
    H, n = data.shape
    W = n // bpp
    T = H + W - 1
    ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
    raw = np.zeros((T, H, bpp), np.int16)
    raw[ys + xs, ys] = data.reshape(H, W, bpp)
    S = np.zeros((T + 2, H + 1, bpp), np.int16)
    S[1:W + 1, 0] = prev.reshape(W, bpp)  # S[u, 0] = prev[u - 1]
    ft = ftypes.astype(np.int16)[:, None]
    f1, f2, f3, f4 = ((ft == k).astype(np.int16) for k in (1, 2, 3, 4))
    has_avg, has_paeth = bool(f3.any()), bool(f4.any())
    for t in range(T):
        lo, hi = max(0, t - W + 1), min(H, t + 1)
        a, b, c = S[t + 1, lo + 1:hi + 1], S[t + 1, lo:hi], S[t, lo:hi]
        pred = f1[lo:hi] * a + f2[lo:hi] * b
        if has_avg:
            pred += f3[lo:hi] * ((a + b) >> 1)
        if has_paeth:
            bc, ac = b - c, a - c
            pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
            pred += f4[lo:hi] * np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        S[t + 2, lo + 1:hi + 1] = (raw[t, lo:hi] + pred) & 255
    return S[ys + xs + 2, ys + 1].reshape(H, n).astype(np.uint8)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def assemble_png(width: int, height: int, depth: int, color: int, scanlines: bytes,
                 palette: bytes = b"", trns: bytes = b"") -> bytes:
    """A PNG file from its filtered scanlines (each row's filter byte first)."""
    ihdr = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + (_chunk(b"PLTE", palette) if palette else b"")
            + (_chunk(b"tRNS", trns) if trns else b"")
            + _chunk(b"IDAT", zlib.compress(scanlines, 6)) + _chunk(b"IEND", b""))


def encode_png(array: np.ndarray,
               filter_type: Union[int, Sequence[int], str] = 0) -> bytes:
    """(H, W) uint8 / uint16, or (H, W, 2 | 3 | 4) uint8 -> PNG bytes, every
    row filtered with `filter_type` (0-4), row y with filter_type[y], or
    each row with its least-cost filter ("adaptive", see the module doc)."""
    a = np.asarray(array)
    if a.dtype == np.uint16 and a.ndim == 2:
        depth, color, pix = 16, 0, a.astype(">u2").view(np.uint8).reshape(a.shape[0], -1)
        bpp = 2
    elif a.dtype == np.uint8 and (a.ndim == 2 or (a.ndim == 3 and a.shape[2] in (2, 3, 4))):
        ch = 1 if a.ndim == 2 else a.shape[2]
        depth, color, bpp = 8, {1: 0, 2: 4, 3: 2, 4: 6}[ch], ch
        pix = a.reshape(a.shape[0], -1)
    else:
        raise ValueError(f"cannot encode a {a.dtype} array of shape {a.shape} as PNG")
    H, n = pix.shape
    adaptive = isinstance(filter_type, str)
    if adaptive and filter_type != "adaptive":
        raise ValueError(f"unknown PNG row filter {filter_type!r}")
    ft = np.zeros(H, np.uint8) if adaptive else np.broadcast_to(
        np.asarray(filter_type, np.uint8), (H,))
    if H and int(ft.max()) > 4:
        raise ValueError(f"unknown PNG row filter {int(ft.max())}")
    if not adaptive and not ft.any():  # filter 0 rows are the pixels' own bytes
        rows = np.concatenate([np.zeros((H, 1), np.uint8), pix], axis=1)
        return assemble_png(a.shape[1], H, depth, color, rows.tobytes())
    x = pix.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    if adaptive:  # the first least-cost filter, so ties keep the lower one
        signed = ((x[None] - preds) & 255).astype(np.uint8).view(np.int8)
        ft = np.abs(signed.astype(np.int32)).sum(-1).argmin(0).astype(np.uint8)
    pred = preds[ft.astype(np.int64), np.arange(H)]
    rows = np.concatenate([ft[:, None], ((x - pred) & 255).astype(np.uint8)], axis=1)
    return assemble_png(a.shape[1], H, depth, color, rows.tobytes())


def save_png(path: str, array: np.ndarray,
             filter_type: Union[int, Sequence[int], str] = 0) -> None:
    """encode_png(array, filter_type) written to `path`."""
    with open(path, "wb") as f:
        f.write(encode_png(array, filter_type))


def to_rgba(img: np.ndarray) -> np.ndarray:
    """8-bit gray, gray + alpha, RGB or RGBA (H, W[, C]) -> (H, W, 4) uint8,
    as PIL's convert("RGBA") gives it."""
    if img.dtype != np.uint8:
        raise ValueError(f"to_rgba takes 8-bit images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, ch = img.shape
    opaque = np.full((H, W, 1), 255, np.uint8)
    if ch == 1:
        return np.concatenate([img, img, img, opaque], axis=-1)
    if ch == 2:
        return np.concatenate([img[..., :1]] * 3 + [img[..., 1:]], axis=-1)
    if ch == 3:
        return np.concatenate([img, opaque], axis=-1)
    return img
