"""Writes the image fixtures of the port's decoders, and manifest.json.

    python tests/data/codecs/make_fixtures.py

Run where PIL is installed: the JPEGs and the TIFF are PIL's own files, the
16-bit RGB and the Adam7 PNG (which PIL cannot write) are built here with
zlib. The manifest gives each file's shape, dtype and the sha256 of
`np.asarray(Image.open(file))`'s bytes, so that a machine without PIL
(chip_smoke.py's [codecs] phase) can check the port's decoders against
PIL's result. The content is seeded: smooth shapes with camera-like noise.

Files (1.4 MB):
- jpeg_q95_420.jpg, jpeg_q100_444_opt.jpg, jpeg_q90_422_rst.jpg,
  jpeg_gray_q90.jpg: 480 x 640, one image at four settings (4:2:0; 4:4:4
  with optimized Huffman tables; 4:2:2 with a restart marker every 4 MCUs;
  gray);
- tiff_lzw_pred2.tif: 1280 x 960 gray (ITODD's size), LZW with predictor 2;
- png16_rgb.png: 60 x 80 16-bit RGB; png_adam7_rgb.png: 60 x 80 8-bit RGB,
  Adam7-interlaced.
"""

from __future__ import annotations

import hashlib
import json
import os.path as osp
import struct
import zlib

import numpy as np

HERE = osp.dirname(osp.abspath(__file__))
SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def scene(seed: int, h: int, w: int, ch: int, sigma: float) -> np.ndarray:
    """Smooth shapes (gradients, blobs, a few hard edges) plus Gaussian
    noise of `sigma`, as uint8 (h, w, ch), or (h, w) for ch = 1."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.zeros((h, w, ch))
    for c in range(ch):
        img[..., c] = 90 + 60 * xx + 40 * yy + 30 * np.sin(6 * xx + c) * np.cos(4 * yy - c)
    for _ in range(6):
        cy, cx, rad = r.uniform(0, h / max(h, w)), r.uniform(0, w / max(h, w)), r.uniform(0.03, 0.2)
        inside = (yy - cy) ** 2 + (xx - cx) ** 2 < rad ** 2
        img[inside] = r.uniform(20, 235, ch)
    img += r.normal(0, sigma, img.shape)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """PNG row filters, type ftypes[y] on row y of (h, rowbytes) bytes."""
    out, prev = [], np.zeros(rows.shape[1], np.int16)
    for row, f in zip(rows.astype(np.int16), ftypes):
        left, upleft = np.zeros_like(row), np.zeros_like(row)
        left[bpp:], upleft[bpp:] = row[:-bpp], prev[:-bpp]
        pa, pb, pc = np.abs(prev - upleft), np.abs(left - upleft), np.abs(left + prev - 2 * upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = (np.zeros_like(row), left, prev, (left + prev) >> 1, paeth)[f]
        out.append(bytes([f]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = (samples[..., 0][..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(h, -1), axis=1)


def build_png(samples: np.ndarray, depth: int, color: int, interlace: bool = False,
              palette: bytes = b"") -> bytes:
    """A PNG of (h, w, channels) integer samples at `depth` bits, color type
    `color`, Adam7-interlaced or not; the rows of each pass cycle through
    the five filters."""
    h, w = samples.shape[:2]
    bpp = max(1, CHANNELS[color] * depth // 8)
    data = b""
    for i, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filter_rows(_pack(sub, depth), bpp, [(y + i) % 5 for y in range(len(sub))])
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + (_chunk(b"PLTE", palette) if palette else b"")
            + _chunk(b"IDAT", zlib.compress(data, 9)) + _chunk(b"IEND", b""))


def array_sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    import io

    from PIL import Image, ImageFile

    ImageFile.MAXBLOCK = 1 << 24  # optimize=True writes the whole file at once
    files = {}
    rgb = scene(15, 480, 640, 3, 6.0)
    for name, img, kw in (
            ("jpeg_q95_420.jpg", rgb, dict(quality=95, subsampling=2)),
            ("jpeg_q100_444_opt.jpg", rgb, dict(quality=100, subsampling=0, optimize=True)),
            ("jpeg_q90_422_rst.jpg", rgb, dict(quality=90, subsampling=1, restart_marker_blocks=4)),
            ("jpeg_gray_q90.jpg", rgb.mean(-1).astype(np.uint8), dict(quality=90))):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", **kw)
        files[name] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(scene(16, 960, 1280, 1, 2.0)).save(
        buf, "TIFF", compression="tiff_lzw", tiffinfo={317: 2})
    files["tiff_lzw_pred2.tif"] = buf.getvalue()
    r = np.random.default_rng(17)
    deep = scene(18, 60, 80, 3, 6.0).astype(np.uint16) * 256 + r.integers(0, 256, (60, 80, 3))
    files["png16_rgb.png"] = build_png(deep, 16, 2)
    files["png_adam7_rgb.png"] = build_png(scene(19, 60, 80, 3, 6.0), 8, 2, interlace=True)

    manifest = {}
    for name, data in files.items():
        with open(osp.join(HERE, name), "wb") as f:
            f.write(data)
        a = np.asarray(Image.open(io.BytesIO(data)))
        manifest[name] = {"shape": list(a.shape), "dtype": a.dtype.str, "bytes": len(data),
                          "sha256": array_sha256(a)}
    with open(osp.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v["bytes"] for k, v in manifest.items()}))


if __name__ == "__main__":
    main()
