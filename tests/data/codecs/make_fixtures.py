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
import lzma
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


# ---------------------------------------------------------------- a test-only JPEG encoder
#
# PIL and cv2 write only baseline and progressive Huffman-coded JPEGs at
# their own sampling factors. This encoder writes the rest that libjpeg
# reads: any sampling factors 1-4, Huffman tables left to the standard ones
# (no DHT, as MJPEG frames), arithmetic coding (T.81 Annex D's QM coder, as
# jcarith.c; sequential and progressive with refinement scans, DAC
# conditioning) and lossless frames (predictors 1-7, point transform). PIL
# decodes its files and is the reference; its own output need not equal the
# input.

ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                   48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29,
                   22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
                   47, 55, 62, 63])
LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16,
                   24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109,
                   103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101,
                   72, 92, 95, 98, 112, 100, 103, 99])
STD_DC_BITS = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
               [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
STD_AC_BITS = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d],
               [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77])
STD_AC_VALS = (
    bytes.fromhex("01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    bytes.fromhex("000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))
# T.81 Table D.2: (Qe, next index after MPS, after LPS, switch)
QE = [(0x5a1d, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0), (0x080b, 4, 18, 0),
      (0x03d8, 5, 20, 0), (0x01da, 6, 23, 0), (0x00e5, 7, 25, 0), (0x006f, 8, 28, 0),
      (0x0036, 9, 30, 0), (0x001a, 10, 33, 0), (0x000d, 11, 35, 0), (0x0006, 12, 9, 0),
      (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5a7f, 15, 15, 1), (0x3f25, 16, 36, 0),
      (0x2cf2, 17, 38, 0), (0x207c, 18, 39, 0), (0x17b9, 19, 40, 0), (0x1182, 20, 42, 0),
      (0x0cef, 21, 43, 0), (0x09a1, 22, 45, 0), (0x072f, 23, 46, 0), (0x055c, 24, 48, 0),
      (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0), (0x01b1, 28, 54, 0),
      (0x0144, 29, 56, 0), (0x00f5, 30, 57, 0), (0x00b7, 31, 59, 0), (0x008a, 32, 60, 0),
      (0x0068, 33, 62, 0), (0x004e, 34, 63, 0), (0x003b, 35, 32, 0), (0x002c, 9, 33, 0),
      (0x5ae1, 37, 37, 1), (0x484c, 38, 64, 0), (0x3a0d, 39, 65, 0), (0x2ef1, 40, 67, 0),
      (0x261f, 41, 68, 0), (0x1f33, 42, 69, 0), (0x19a8, 43, 70, 0), (0x1518, 44, 72, 0),
      (0x1177, 45, 73, 0), (0x0e74, 46, 74, 0), (0x0bfb, 47, 75, 0), (0x09f8, 48, 77, 0),
      (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05cd, 51, 48, 0), (0x04de, 52, 50, 0),
      (0x040f, 53, 50, 0), (0x0363, 54, 51, 0), (0x02d4, 55, 52, 0), (0x025c, 56, 53, 0),
      (0x01f8, 57, 54, 0), (0x01a4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
      (0x00f6, 61, 58, 0), (0x00cb, 62, 59, 0), (0x00ab, 63, 61, 0), (0x008f, 32, 61, 0),
      (0x5b12, 65, 65, 1), (0x4d04, 66, 80, 0), (0x412c, 67, 81, 0), (0x37d8, 68, 82, 0),
      (0x2fe8, 69, 83, 0), (0x293c, 70, 84, 0), (0x2379, 71, 86, 0), (0x1edf, 72, 87, 0),
      (0x1aa9, 73, 87, 0), (0x174e, 74, 72, 0), (0x1424, 75, 72, 0), (0x119c, 76, 74, 0),
      (0x0f6b, 77, 74, 0), (0x0d51, 78, 75, 0), (0x0bb6, 79, 77, 0), (0x0a40, 48, 77, 0),
      (0x5832, 81, 80, 1), (0x4d1c, 82, 88, 0), (0x438e, 83, 89, 0), (0x3bdd, 84, 90, 0),
      (0x34ee, 85, 91, 0), (0x2eae, 86, 92, 0), (0x299a, 87, 93, 0), (0x2516, 71, 86, 0),
      (0x5570, 89, 88, 1), (0x4ca9, 90, 95, 0), (0x44d9, 91, 96, 0), (0x3e22, 92, 97, 0),
      (0x3824, 93, 99, 0), (0x32b4, 94, 99, 0), (0x2e17, 86, 93, 0), (0x56a8, 96, 95, 1),
      (0x4f46, 97, 101, 0), (0x47e5, 98, 102, 0), (0x41cf, 99, 103, 0), (0x3c3d, 100, 104, 0),
      (0x375e, 93, 99, 0), (0x5231, 102, 105, 0), (0x4c0f, 103, 106, 0), (0x4639, 104, 107, 0),
      (0x415e, 99, 103, 0), (0x5627, 106, 105, 1), (0x50e7, 107, 108, 0), (0x4b85, 103, 109, 0),
      (0x5597, 109, 110, 0), (0x504f, 107, 111, 0), (0x5a10, 111, 110, 1), (0x5522, 109, 112, 0),
      (0x59eb, 111, 112, 1), (0x5a1d, 113, 113, 0)]


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


class _Bits:
    """Huffman-coded entropy data: MSB-first bits, 0xFF stuffed with 0x00."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with 1 bits
        out, self.out = bytes(self.out), bytearray()
        return out


def _huffman_codes(bits, vals):
    codes, code, k = {}, 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            codes[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


class _QM:
    """jcarith.c's arith_encode and finish_pass (T.81 D.1)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.ct, self.sc, self.zc, self.buffer = 0, 0x10000, 11, 0, 0, -1

    def _emit_pending(self, byte):
        if self.zc:
            self.out += b"\x00" * self.zc
            self.zc = 0
        self.out.append(byte)

    def encode(self, st: list, i: int, val: int):
        sv = st[i]
        qe, nmps, nlps, switch = QE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nlps | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._emit_pending(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self.out.append(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._emit_pending(self.buffer)
                    if self.sc:
                        if self.zc:
                            self.out += b"\x00" * self.zc
                            self.zc = 0
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_pending(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_pending(self.buffer)
            if self.sc:
                if self.zc:
                    self.out += b"\x00" * self.zc
                    self.zc = 0
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            if self.zc:
                self.out += b"\x00" * self.zc
                self.zc = 0
            self.out.append((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                self.out.append((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self.out.append(0)
        out, self.out = bytes(self.out), bytearray()
        self.reset()
        return out


class _ArithStats:
    def __init__(self, dc_L=0, dc_U=1, ac_K=5):
        self.dc_L, self.dc_U, self.ac_K = dc_L, dc_U, ac_K
        self.fixed = [113]
        self.reset_dc()
        self.reset_ac()

    def reset_dc(self):
        self.dc = [0] * 64

    def reset_ac(self):
        self.ac = [0] * 256


def _arith_magnitude(qm, stats, st_list, st, v, ac_k=None):
    """F.8 and F.9: the magnitude category of v (>= 1) and its bits, from
    bin `st` of `st_list`; AC categories above 1 continue at 189 / 217."""
    m, v = 0, v - 1
    if v:
        qm.encode(st_list, st, 1)
        m, v2 = 1, v
        if ac_k is None:
            st, st_list = 20, stats.dc
            while v2 >> 1:
                v2 >>= 1
                qm.encode(st_list, st, 1)
                m <<= 1
                st += 1
        else:
            v2 >>= 1
            if v2:
                qm.encode(st_list, st, 1)
                m <<= 1
                st, st_list = ac_k, stats.ac
                while v2 >> 1:
                    v2 >>= 1
                    qm.encode(st_list, st, 1)
                    m <<= 1
                    st += 1
    qm.encode(st_list, st, 0)
    st += 14
    while m >> 1:
        m >>= 1
        qm.encode(st_list, st, 1 if m & v else 0)


def _arith_dc(qm, stats, state, diff):
    """F.4: one DC difference; state holds the dc_context."""
    st = state["ctx"]
    if diff == 0:
        qm.encode(stats.dc, st, 0)
        state["ctx"] = 0
        return
    qm.encode(stats.dc, st, 1)
    sign = diff < 0
    qm.encode(stats.dc, st + 1, int(sign))
    st += 3 if sign else 2
    state["ctx"] = 8 if sign else 4
    v = abs(diff)
    m = 0
    if v - 1:  # the category, to set the conditioning as jcarith.c does
        m = 1 << ((v - 1).bit_length() - 1)
    if m < ((1 << stats.dc_L) >> 1):
        state["ctx"] = 0
    elif m > ((1 << stats.dc_U) >> 1):
        state["ctx"] += 8
    _arith_magnitude(qm, stats, stats.dc, st, v)


def _arith_ac(qm, stats, block, k0, k1, al):
    """F.5 / G.1.3.2: coefficients k0..k1 (zigzag) of a block, >> al."""
    vals = [int(block[ZIGZAG[k]]) for k in range(64)]
    shifted = [(v if v >= 0 else -v) >> al for v in vals]
    ke = k1
    while ke >= k0 and shifted[ke] == 0:
        ke -= 1
    k = k0
    while k <= ke:
        st = 3 * (k - 1)
        qm.encode(stats.ac, st, 0)
        while shifted[k] == 0:
            qm.encode(stats.ac, st + 1, 0)
            st += 3
            k += 1
        qm.encode(stats.ac, st + 1, 1)
        qm.encode(stats.fixed, 0, int(vals[k] < 0))
        _arith_magnitude(qm, stats, stats.ac, st + 2, shifted[k],
                         ac_k=189 if k <= stats.ac_K else 217)
        k += 1
    if k <= k1:
        qm.encode(stats.ac, 3 * (k - 1), 1)


def _arith_ac_refine(qm, stats, block, k0, k1, al):
    """G.1.3.3 (jcarith.c encode_mcu_AC_refine): bit al of coefficients k0..k1."""
    vals = [int(block[ZIGZAG[k]]) for k in range(64)]
    at = lambda k, a: (vals[k] if vals[k] >= 0 else -vals[k]) >> a
    ke = k1
    while ke >= k0 and at(ke, al) == 0:
        ke -= 1
    kex = ke
    while kex > 0 and at(kex, al + 1) == 0:
        kex -= 1
    k = k0
    while k <= ke:
        st = 3 * (k - 1)
        if k > kex:
            qm.encode(stats.ac, st, 0)
        while True:
            v = at(k, al)
            if v:
                if v >> 1:
                    qm.encode(stats.ac, st + 2, v & 1)
                else:
                    qm.encode(stats.ac, st + 1, 1)
                    qm.encode(stats.fixed, 0, int(vals[k] < 0))
                break
            qm.encode(stats.ac, st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= k1:
        qm.encode(stats.ac, 3 * (k - 1), 1)


def _fdct_blocks(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(8 bh, 8 bw) samples -> (bh, bw, 64) quantized coefficients, natural order."""
    n = np.arange(8)
    c = np.sqrt(np.where(n == 0, 1.0, 2.0) / 8)[:, None] * np.cos(
        (2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    blocks = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).astype(np.float64) - 128
    coef = np.einsum("ui,abij,vj->abuv", c, blocks, c).reshape(bh, bw, 64)
    return np.rint(coef / q).astype(np.int64)


def encode_jpeg(img: np.ndarray, sampling=((1, 1),), mode: str = "sequential",
                arith: bool = False, restart: int = 0, dht: bool = True, predictor: int = 1,
                point_transform: int = 0, ids=None, jfif: bool = True, dac=None) -> bytes:
    """(H, W) or (H, W, C) uint8 -> a JPEG of the planes as they are (no
    colour transform; ids and jfif tell libjpeg how to read them).
    sampling: (h, v) per component; mode: "sequential", "progressive"
    (DC first Al 1 and refine, AC first Al 1 in two bands for component 0,
    AC refine) or "lossless" (SOF3 / Huffman only); arith: arithmetic
    coding (SOF9 / SOF10) with `dac` = (L, U, K) conditioning in a DAC
    segment; dht=False leaves the Huffman tables to the standard ones;
    restart: the DRI interval in MCUs (not with lossless)."""
    px = img.reshape(img.shape[0], img.shape[1], -1)
    H, W, C = px.shape
    sampling = tuple(sampling) * C if len(sampling) == 1 else tuple(sampling)
    ids = ids or list(range(1, C + 1))
    lossless = mode == "lossless"
    assert not (lossless and (arith or restart))
    unit = 1 if lossless else 8
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcux, mcuy = -(-W // (unit * hmax)), -(-H // (unit * vmax))
    planes = []
    for ci, (h, v) in enumerate(sampling):
        full = np.pad(px[..., ci].astype(np.float64),
                      ((0, mcuy * unit * vmax - H), (0, mcux * unit * hmax - W)), mode="edge")
        rh, rv = hmax // h, vmax // v
        planes.append(full.reshape(full.shape[0] // rv, rv, full.shape[1] // rh, rh).mean((1, 3)))
    q = LUMA_Q if not lossless else None
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if not lossless:
        out += _segment(0xDB, bytes([0]) + bytes(int(x) for x in LUMA_Q[ZIGZAG]))
    sof = {("sequential", False): 0xC1, ("progressive", False): 0xC2, ("lossless", False): 0xC3,
           ("sequential", True): 0xC9, ("progressive", True): 0xCA}[(mode, arith)]
    out += _segment(sof, struct.pack(">BHHB", 8, H, W, C) + b"".join(
        bytes([ids[ci], (h << 4) | v, 0]) for ci, (h, v) in enumerate(sampling)))
    tables = [0] + [1] * (C - 1)  # component 0 on tables 0, the others on 1
    if dht and not arith:
        body = b""
        for t in sorted(set(tables)):
            body += bytes([t]) + bytes(STD_DC_BITS[t]) + bytes(range(12))
            if not lossless:
                body += bytes([0x10 | t]) + bytes(STD_AC_BITS[t]) + STD_AC_VALS[t]
        out += _segment(0xC4, body)
    if arith and dac:
        L, U, K = dac
        out += _segment(0xCC, b"".join(bytes([t, (U << 4) | L, 16 + t, K])
                                        for t in sorted(set(tables))))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    if lossless:
        samples = [np.rint(p).astype(np.int64) >> point_transform for p in planes]
    else:
        coefs = [_fdct_blocks(p, q) for p in planes]

    def units(comps, ns):
        """(component, unit row, unit col) in MCU order, MCU by MCU."""
        if ns == 1:
            ci = comps[0]
            h, v = sampling[ci]
            nw = -(-(-(-W * h // hmax)) // unit)
            nh = -(-(-(-H * v // vmax)) // unit)
            for y in range(nh):
                for x in range(nw):
                    yield [(ci, y, x)]
            return
        for my in range(mcuy):
            for mx in range(mcux):
                yield [(ci, my * sampling[ci][1] + by, mx * sampling[ci][0] + bx)
                       for ci in comps for by in range(sampling[ci][1])
                       for bx in range(sampling[ci][0])]

    def scan(comps, ss, se, ah, al):
        ns = len(comps)
        out_scan = _segment(0xDA, bytes([ns]) + b"".join(
            bytes([ids[ci], (tables[ci] << 4) | tables[ci]]) for ci in comps)
                            + bytes([ss, se, (ah << 4) | al]))
        data = bytearray()
        bits, qm = _Bits(), _QM()
        codes = {t: (_huffman_codes(STD_DC_BITS[t], list(range(12))),
                     _huffman_codes(STD_AC_BITS[t], STD_AC_VALS[t])) for t in (0, 1)}
        stats = {t: _ArithStats(*(dac or (0, 1, 5))) for t in (0, 1)}
        pred, ctx, eob = {}, {}, [0]

        def reset():
            for ci in comps:
                pred[ci], ctx[ci] = 0, {"ctx": 0}
                if arith:
                    if mode != "progressive" or (ss == 0 and ah == 0):
                        stats[tables[ci]].reset_dc()
                    if mode != "progressive" or ss:
                        stats[tables[ci]].reset_ac()

        def huff_value(code_table, v):
            s = _category(v)
            code, length = code_table[s if s < 16 else 16]
            bits.put(code, length)
            if 0 < s < 16:
                bits.put(v if v >= 0 else v + (1 << s) - 1, s)

        reset()
        for n, mcu in enumerate(units(comps, ns)):
            if restart and n and n % restart == 0:
                data += qm.finish() if arith else bits.flush()
                data += bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
                reset()
            for ci, y, x in mcu:
                t = tables[ci]
                if lossless:
                    s = samples[ci]
                    if y == 0:
                        p = 1 << (8 - point_transform - 1) if x == 0 else s[y, x - 1]
                    elif x == 0:
                        p = s[y - 1, x]
                    else:
                        ra, rb, rc = s[y, x - 1], s[y - 1, x], s[y - 1, x - 1]
                        p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                             6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
                    d = int(s[y, x] - p) & 0xFFFF
                    huff_value(codes[t][0], d - 0x10000 if d >= 0x8000 else d)
                    continue
                block = coefs[ci][y, x]
                if not arith:
                    if mode == "sequential":
                        huff_value(codes[t][0], int(block[0]) - pred[ci])
                        pred[ci] = int(block[0])
                        run = 0
                        zz = block[ZIGZAG]
                        last = max([k for k in range(1, 64) if zz[k]], default=0)
                        for k in range(1, last + 1):
                            if zz[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                bits.put(*codes[t][1][0xF0])
                                run -= 16
                            s = _category(int(zz[k]))
                            bits.put(*codes[t][1][(run << 4) | s])
                            bits.put(int(zz[k]) if zz[k] >= 0 else int(zz[k]) + (1 << s) - 1, s)
                            run = 0
                        if last < 63:
                            bits.put(*codes[t][1][0])
                    continue
                st = stats[t]
                if mode == "sequential":
                    _arith_dc(qm, st, ctx[ci], int(block[0]) - pred[ci])
                    pred[ci] = int(block[0])
                    _arith_ac(qm, st, block, 1, 63, 0)
                elif ss == 0 and ah == 0:
                    dc = int(block[0]) >> al
                    _arith_dc(qm, st, ctx[ci], dc - pred[ci])
                    pred[ci] = dc
                elif ss == 0:
                    qm.encode(st.fixed, 0, (int(block[0]) >> al) & 1)
                elif ah == 0:
                    _arith_ac(qm, st, block, ss, se, al)
                else:
                    _arith_ac_refine(qm, st, block, ss, se, al)
        data += qm.finish() if arith else bits.flush()
        return out_scan + bytes(data)

    C_all = list(range(C))
    if mode == "progressive":
        assert arith, "PIL writes progressive Huffman files"
        out += scan(C_all, 0, 0, 0, 1)
        out += scan([0], 1, 5, 0, 1)
        for ci in C_all[1:]:
            out += scan([ci], 1, 63, 0, 1)
        out += scan([0], 6, 63, 0, 1)
        out += scan(C_all, 0, 0, 1, 0)
        for ci in C_all:
            out += scan([ci], 1, 63, 1, 0)
    elif lossless:
        out += scan(C_all, predictor, 0, 0, point_transform)
    else:
        out += scan(C_all, 0, 63, 0, 0)
    return bytes(out + b"\xff\xd9")


# ---------------------------------------------------------------- a test-only TIFF writer


def lzw_encode(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW: a clear code first, codes whose width grows one code before
    the decoder's table needs it (old_style: LSB-first codes whose width
    grows as libtiff's LZWDecodeCompat reads them), a clear when the table is
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
    limits = (511, 1023, 2047) if old_style else (510, 1022, 2046)
    acc, nacc, out, since_clear = 0, 0, bytearray(), 0
    for code in codes:
        free = 258 + max(0, since_clear - 1)  # the decoder's next entry
        width = 9 + sum(free > limit for limit in limits)
        if old_style:
            acc |= code << nacc
            nacc += width
            while nacc >= 8:
                out.append(acc & 255)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << width) | code
            nacc += width
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 255)
                nacc -= 8
        since_clear = 0 if code == 256 else since_clear + 1
    if nacc:
        out.append((acc & 255) if old_style else (acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
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


def _fax_codes() -> tuple:
    """T.4's modified Huffman codes, {run: bits} for white and black, read
    from the port's decoder source so that the encoder and decoder share
    one table (PIL, through libtiff, is the reference for both)."""
    import re

    src = open(osp.join(HERE, "..", "..", "..", "gigapose_tpu_torch", "csrc", "codecs.cpp")).read()
    tables = {}
    for name in ("kWhite", "kBlack", "kExtended"):
        body = src[src.index(f"constexpr FaxCode {name}[] = {{"):]
        body = body[:body.index("};")]
        tables[name] = {int(r): b for b, r in re.findall(r'\{"([01]+)", (\d+)\}', body)}
    extended = tables["kExtended"]
    return {**tables["kWhite"], **extended}, {**tables["kBlack"], **extended}


def _changes(row: np.ndarray) -> list:
    """Positions where a bilevel row (1 = black) changes colour, from white."""
    padded = np.concatenate([[0], row.astype(np.int8)])
    return list(np.nonzero(np.diff(padded))[0])


def fax_encode(bw: np.ndarray, mode: str) -> bytes:
    """(H, W) bool, True black -> CCITT data: "rle" (compression 2), "g3"
    (T.4 1D, an EOL before each row), "g3_2d" (T4Options 1: an EOL and a tag
    bit before each row, every other row 2D-coded) or "g4" (T.6)."""
    white, black = _fax_codes()
    out = []
    put = out.append

    def run(length: int, is_black: bool):
        codes = black if is_black else white
        while length >= 2560:
            put(codes[2560])
            length -= 2560
        if length >= 64:
            put(codes[length // 64 * 64])
        put(codes[length % 64])

    h, w = bw.shape
    ref = []
    vert = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010", -3: "0000010"}
    for y in range(h):
        cur = _changes(bw[y])
        two_d = mode == "g4" or (mode == "g3_2d" and y % 2 == 1)
        if mode in ("g3", "g3_2d"):
            put("000000000001" + ("" if mode == "g3" else "0" if two_d else "1"))
        if not two_d:
            pos, colour = 0, False
            for c in cur + [w]:
                run(c - pos, colour)
                pos, colour = c, not colour
            if mode == "rle":
                put("0" * (-len("".join(out)) % 8))
        else:
            a0, colour = -1, False
            c_ext, r_ext = cur + [w, w], ref + [w, w]
            while a0 < w:
                a1 = next(c for c in c_ext if c > a0)
                a2 = next(c for c in c_ext if c > a1) if a1 < w else w
                i = next(k for k, r in enumerate(r_ext)
                         if r > a0 and (k % 2 == int(colour) or r >= w))
                b1 = r_ext[i]
                b2 = r_ext[i + 1] if i + 1 < len(r_ext) else w
                if b2 < a1:
                    put("0001")
                    a0 = b2
                elif abs(a1 - b1) <= 3:
                    put(vert[a1 - b1])
                    a0, colour = a1, not colour
                else:
                    put("001")
                    run(a1 - max(a0, 0), colour)
                    run(a2 - a1, not colour)
                    a0 = a2
        ref = cur
    bits = "".join(out)
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def _predict(block: np.ndarray, predictor: int, order: str) -> bytes:
    """(rows, cols, spp) samples -> the bytes libtiff's predictor 2 (horDiff)
    or 3 (fpDiff) writes, in the file's byte order."""
    if predictor == 1:
        return block.astype(block.dtype.newbyteorder(order)).tobytes()
    rows, cols, spp = block.shape
    n = block.dtype.itemsize
    if predictor == 2:
        bits = np.ascontiguousarray(block).view(f"u{n}")
        diff = bits.copy()
        diff[:, 1:] = bits[:, 1:] - bits[:, :-1]  # wraps
        return diff.astype(np.dtype(order + f"u{n}")).tobytes()
    msb = block.astype(block.dtype.newbyteorder(">")).view(np.uint8).reshape(rows, cols * spp, n)
    planes = msb.transpose(0, 2, 1).reshape(rows, -1).astype(np.int16)
    planes[:, spp:] -= planes[:, :-spp].copy()
    return (planes & 255).astype(np.uint8).tobytes()


def build_tiff(samples: np.ndarray, order: str = "<", compression: int = 1, predictor: int = 1,
               photometric: int = None, planar: int = 1, extra=(), sample_format: int = 1,
               bits: int = None, fill_order: int = 1, tile=None, rows_per_strip: int = 16,
               big: bool = False, tags=None, old_lzw: bool = False, chunks=None) -> bytes:
    """A TIFF of (H, W[, spp]) samples: any dtype (`bits` below 8 packs uint8
    values of that many bits), strips or tiles of `tile` = (width, height),
    PlanarConfiguration `planar`, compression 1, 5 (old_lzw: old-style), 8,
    32773 or 34925, predictor 1-3, FillOrder 2 (each byte bit-reversed),
    classic or BigTIFF; `tags` adds or replaces entries {tag: (type,
    values)}; `chunks`, the strips' or tiles' bytes as written (the samples
    then give the size only)."""
    h, w = samples.shape[:2]
    px = samples.reshape(h, w, -1)
    spp = px.shape[2]
    depth = bits or 8 * px.dtype.itemsize
    photometric = (1 if spp <= 2 else 2) if photometric is None else photometric
    tw, th = tile or (w, rows_per_strip)
    given, chunks = chunks, []
    for plane in range(spp if planar == 2 else 1 if given is None else 0):
        part = px[..., plane:plane + 1] if planar == 2 else px
        for y in range(0, h, th):
            for x in range(0, w, tw if tile else w):
                if tile:
                    block = np.zeros((th, tw, part.shape[2]), px.dtype)
                    sub = part[y:y + th, x:x + tw]
                    block[:sub.shape[0], :sub.shape[1]] = sub
                else:
                    block = part[y:y + th]
                if depth < 8:
                    vals = block.reshape(block.shape[0], -1)
                    bitrows = (vals[..., None] >> np.arange(depth - 1, -1, -1)) & 1
                    raw = np.packbits(bitrows.reshape(block.shape[0], -1).astype(np.uint8),
                                      axis=1).tobytes()
                else:
                    raw = _predict(block, predictor, order)
                raw = {1: lambda b: b, 5: lambda b: lzw_encode(b, old_lzw), 8: zlib.compress,
                       32773: packbits_encode, 34925: lzma.compress}[compression](raw)
                if fill_order == 2:
                    raw = bytes(int(f"{b:08b}"[::-1], 2) for b in raw)
                chunks.append(raw)
    chunks = chunks if given is None else list(given)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [depth] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar]),
               317: (3, [predictor]), 339: (3, [sample_format] * spp)}
    if extra:
        entries[338] = (3, list(extra))
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    entries.update(tags or {})
    off_code, count_code, entry_size, inline = ("Q", "Q", 20, 8) if big else ("I", "H", 12, 4)
    head = (b"II" if order == "<" else b"MM") + (
        struct.pack(order + "HHI", 43, 8, 0) if big else struct.pack(order + "H", 42))
    body = bytearray(head + b"\x00" * (8 if big else 4))
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + b"\x00" * (len(c) % 2)
    counts = [len(c) for c in chunks]
    long_type = 16 if big else 4
    if tile:
        entries.update({322: (3, [tw]), 323: (3, [th]), 324: (long_type, offsets),
                        325: (long_type, counts)})
    else:
        entries.update({273: (long_type, offsets), 278: (3, [th]), 279: (long_type, counts)})
    codes = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 16: "Q"}
    ifd_at = len(body)
    n = len(entries)
    data_at = ifd_at + struct.calcsize(count_code) + entry_size * n + inline
    ifd, extra_data = struct.pack(order + count_code, n), bytearray()
    for tag in sorted(entries):
        ftype, values = entries[tag]
        packed = bytes(values) if isinstance(values, bytes) else struct.pack(
            order + codes[ftype] * len(values), *values)
        ifd += struct.pack(order + "HH" + ("Q" if big else "I"), tag, ftype, len(values))
        if len(packed) <= inline:
            ifd += packed.ljust(inline, b"\x00")
        else:
            ifd += struct.pack(order + off_code, data_at + len(extra_data))
            extra_data += packed + b"\x00" * (len(packed) % 2)
    body[8 if big else 4:16 if big else 8] = struct.pack(order + off_code, ifd_at)
    return bytes(body + ifd + b"\x00" * inline + extra_data)


def jpeg_segments(data: bytes) -> list:
    """A JPEG's (marker, bytes) segments after SOI; a scan's holds its
    entropy-coded data (up to the next marker that is no RSTn)."""
    out, i = [], 2
    while i < len(data):
        m = data[i + 1]
        if m == 0xD9:
            out.append((m, data[i:i + 2]))
            break
        j = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
        if m == 0xDA:
            while not (data[j] == 0xFF and data[j + 1] != 0 and not 0xD0 <= data[j + 1] <= 0xD7):
                j += 1
        out.append((m, data[i:j]))
        i = j
    return out


def keep_scans(data: bytes, n: int) -> bytes:
    """A progressive JPEG with only its first n scans (EOI kept): the file a
    cut download leaves, which libjpeg decodes with block smoothing."""
    segs, scans = jpeg_segments(data), 0
    kept = []
    for m, seg in segs:
        scans += m == 0xDA
        if m != 0xDA or scans <= n:
            kept.append(seg)
    return b"\xff\xd8" + b"".join(kept)


def split_jpeg_tables(data: bytes) -> tuple:
    """A JPEG -> (JPEGTables: SOI, DQT and DHT segments, EOI; the stream
    without them), as libtiff writes JPEG-compressed TIFFs."""
    segs = jpeg_segments(data)
    tables = b"".join(seg for m, seg in segs if m in (0xDB, 0xC4))
    rest = b"".join(seg for m, seg in segs if m not in (0xDB, 0xC4, 0xE0))
    return b"\xff\xd8" + tables + b"\xff\xd9", b"\xff\xd8" + rest


def array_sha256(a: np.ndarray) -> str:
    """sha256 of the array's C-order bytes; a bool array as 0 / 1 bytes (PIL's
    mode "1" arrays hold 0 / 255 bytes under their bool dtype)."""
    a = np.ascontiguousarray(a)
    if a.dtype == bool:
        a = (a.view(np.uint8) != 0).view(np.uint8)
    return hashlib.sha256(a.tobytes()).hexdigest()


def _pil_bytes(Image, io, img, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(buf, fmt, **kw)
    return buf.getvalue()


def jpeg_fixtures(Image, io) -> dict:
    """The JPEGs beyond baseline ones: progressive (one at 480 x 640 for
    timing; at 61 x 93 with its last scan cut and with its DC scans only,
    which libjpeg smooths), no DHT, CMYK and YCCK, 4:1:1 and sampling
    ratios 3 and 4 x 2, lossless and arithmetic-coded."""
    import cv2

    big = scene(15, 480, 640, 3, 6.0)
    small = scene(20, 61, 93, 3, 8.0)
    prog = _pil_bytes(Image, io, small, "JPEG", quality=85, subsampling=2, progressive=True)
    cmyk = _pil_bytes(Image, io, Image.fromarray(small).convert("CMYK"), "JPEG", quality=90)
    adobe = cmyk.index(b"Adobe")
    base = _pil_bytes(Image, io, small, "JPEG", quality=90, subsampling=1)
    ok, c411 = cv2.imencode(".jpg", small[..., ::-1], [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    assert ok
    return {
        "jpeg_progressive_480x640.jpg": _pil_bytes(Image, io, big, "JPEG", quality=90,
                                                   subsampling=2, progressive=True),
        "jpeg_progressive_cut.jpg": keep_scans(prog, len([m for m, _ in jpeg_segments(prog)
                                                          if m == 0xDA]) - 1),
        "jpeg_progressive_dc_only.jpg": keep_scans(prog, 1),
        "jpeg_no_dht.jpg": b"\xff\xd8" + b"".join(
            seg for m, seg in jpeg_segments(base) if m != 0xC4),
        "jpeg_cmyk_adobe.jpg": cmyk,
        "jpeg_ycck.jpg": cmyk[:adobe + 11] + bytes([2]) + cmyk[adobe + 12:],
        "jpeg_411.jpg": c411.tobytes(),
        "jpeg_h3v1.jpg": encode_jpeg(small, ((3, 1), (1, 1), (1, 1))),
        "jpeg_h4v2_no_dht.jpg": encode_jpeg(small, ((4, 2), (1, 1), (1, 1)), dht=False),
        "jpeg_lossless_gray_p7.jpg": encode_jpeg(small[..., 1], mode="lossless", predictor=7),
        "jpeg_lossless_rgb_p4.jpg": encode_jpeg(small, mode="lossless", predictor=4,
                                                ids=[82, 71, 66], jfif=False),
        "jpeg_arith_420_rst.jpg": encode_jpeg(small, ((2, 2), (1, 1), (1, 1)), arith=True,
                                              restart=3, dac=(1, 4, 3)),
        "jpeg_arith_progressive.jpg": encode_jpeg(small, ((2, 1), (1, 1), (1, 1)),
                                                  mode="progressive", arith=True),
    }


def tiff_fixtures(Image, io) -> dict:
    """The TIFFs beyond baseline ones: planar, JPEG (RGB and YCbCr),
    zstd, LZMA, float with predictor 3 (depth maps), signed, WhiteIsZero,
    CMYK, bilevel raw and CCITT RLE / G3 (1D and 2D) / G4, 2- and 4-bit,
    16-bit RGB(A), associated alpha, FillOrder 2, old-style LZW, BigTIFF,
    gray + alpha."""
    r = np.random.default_rng(21)
    rgb = scene(22, 48, 64, 4, 6.0)
    depth = 400 + 300 / 255 * scene(23, 48, 64, 1, 2.0) + r.normal(0, 0.1, (48, 64))
    depth = depth.astype(np.float32)
    bw = scene(24, 48, 64, 1, 30.0) < 120
    tables, strip = split_jpeg_tables(_pil_bytes(Image, io, rgb[..., :3], "JPEG", quality=90,
                                                 subsampling=2))
    wide = r.integers(0, 65536, (48, 64, 4)).astype(np.uint16)
    files = {
        "tiff_planar2_lzw.tif": build_tiff(rgb[..., :3], "<", 5, predictor=2, planar=2),
        "tiff_jpeg_rgb.tif": _pil_bytes(Image, io, rgb[..., :3], "TIFF", compression="jpeg"),
        "tiff_jpeg_ycbcr.tif": build_tiff(rgb[..., :3], "<", 7, photometric=6, rows_per_strip=48,
                                          tags={347: (7, tables), 530: (3, [2, 2])},
                                          chunks=[strip]),
        "tiff_zstd_float_pred3.tif": _pil_bytes(Image, io, depth, "TIFF", compression="zstd",
                                                tiffinfo={317: 3}),
        "tiff_deflate_float_pred3_tiles.tif": build_tiff(depth, "<", 8, predictor=3,
                                                         sample_format=3, tile=(32, 16)),
        "tiff_lzma_rgb.tif": _pil_bytes(Image, io, rgb[..., :3], "TIFF", compression="lzma"),
        "tiff_int16_signed.tif": build_tiff((depth * 40 - 20000).astype(np.int16), ">", 1,
                                            sample_format=2),
        "tiff_int32_lzw.tif": build_tiff((depth * 1e4).astype(np.int32) - 4_000_000, "<", 5,
                                         predictor=2, sample_format=2),
        "tiff_whiteiszero.tif": build_tiff(rgb[..., 0], "<", 32773, photometric=0),
        "tiff_cmyk.tif": _pil_bytes(Image, io, Image.fromarray(rgb[..., :3]).convert("CMYK"),
                                    "TIFF", compression="tiff_adobe_deflate"),
        "tiff_bilevel.tif": _pil_bytes(Image, io, Image.fromarray(bw), "TIFF"),
        "tiff_ccitt_rle.tif": _pil_bytes(Image, io, Image.fromarray(bw), "TIFF",
                                         compression="tiff_ccitt"),
        "tiff_g3.tif": _pil_bytes(Image, io, Image.fromarray(bw), "TIFF", compression="group3"),
        "tiff_g3_2d.tif": build_tiff(bw.astype(np.uint8), "<", 3, bits=1, photometric=0,
                                     rows_per_strip=48, tags={292: (4, [1])},
                                     chunks=[fax_encode(bw, "g3_2d")]),
        "tiff_g4.tif": _pil_bytes(Image, io, Image.fromarray(bw), "TIFF", compression="group4"),
        "tiff_gray4_fill2.tif": build_tiff(rgb[..., 1] >> 4, ">", 1, bits=4, fill_order=2),
        "tiff_gray2_lzw.tif": build_tiff(rgb[..., 2] >> 6, "<", 5, bits=2),
        "tiff_rgb16.tif": build_tiff(wide[..., :3], "<", 8),
        "tiff_rgba16_assoc.tif": build_tiff(wide, ">", 1, extra=(1,)),
        "tiff_rgba_assoc.tif": build_tiff(rgb, "<", 5, extra=(1,)),
        "tiff_lzw_old.tif": build_tiff(rgb[..., :3], "<", 5, old_lzw=True),
        "tiff_bigtiff_tiles.tif": build_tiff(rgb[..., :3], "<", 8, tile=(32, 32), big=True),
        "tiff_gray_alpha.tif": build_tiff(rgb[..., :2], "<", 32773, extra=(2,)),
    }
    return files


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

    files.update(jpeg_fixtures(Image, io))
    files.update(tiff_fixtures(Image, io))

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
