"""Host-side RGB augmentations and template rotation in numpy (port of the
RGB family and `rotate_rgba` of gigapose_tpu/dataloader/augment.py).

The JAX package calls Pillow; the machines that run the port have none. Each
Pillow operation used there is rebuilt here on uint8 arrays, rounding as
Pillow's C code rounds, so that one seed gives the same bytes in both
packages:

- `gaussian_blur`: ImageFilter.GaussianBlur(r), Pillow's extended box blur:
  the box radius from r (BoxBlur.c:ImagingGaussianBlur, f32 and f64 steps
  as there), three horizontal passes, then three vertical ones, each a
  clamped-edge window sum in 8.24 fixed point rounded back to uint8;
- `smooth`: ImageFilter.SMOOTH, the 3x3 kernel (1 1 1, 1 5 1, 1 1 1) / 13
  summed in f32 in Filter.c's order, edge rows and columns kept;
- `blend`: Image.blend, f32 `a + alpha (b - a)` truncated, clipped outside
  alpha in [0, 1];
- `to_luma`: convert("L"), (19595 R + 38470 G + 7471 B + 0x8000) >> 16;
- the enhancers blend with a degenerate image: Sharpness with `smooth`,
  Contrast with the rounded mean of the L image, Brightness with black,
  Color with L copied to the three channels;
- `rotate`: Image.rotate(angle) with NEAREST about the centre, fill 0: 180
  degrees (and 90 / 270 on a square image) as a transpose, any other angle
  through the 16.16 fixed-point affine walk of Geometry.c (images whose
  corners map beyond its range, past 32768 pixels, raise).

The depth-noise family (refiner training) is not ported yet (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class RgbAugmentConfig:
    p_any: float = 0.8
    p_blur: float = 0.4
    blur_interval: Tuple[int, int] = (1, 3)
    p_sharpness: float = 0.3
    sharpness_interval: Tuple[float, float] = (0.0, 50.0)
    p_contrast: float = 0.3
    contrast_interval: Tuple[float, float] = (0.2, 50.0)
    p_brightness: float = 0.5
    brightness_interval: Tuple[float, float] = (0.1, 6.0)
    p_color: float = 0.3
    color_interval: Tuple[float, float] = (0.0, 20.0)


def _box_radius(radius: float, passes: int = 3) -> float:
    """The box radius of Pillow's extended box blur for a Gaussian radius,
    with the C code's f32 variables and f64 library calls."""
    f = np.float32
    sigma2 = f(f(radius) * f(radius) / f(passes))
    L = f(math.sqrt(12.0 * float(sigma2) + 1.0))
    l = f(math.floor((float(L) - 1.0) / 2.0))
    a = f(f(f(2) * l + f(1)) * f(l * f(l + f(1)) - f(3) * sigma2))
    a = f(a / f(f(6) * f(sigma2 - f(l + f(1)) * f(l + f(1)))))
    return float(f(l + a))


def _box_blur_rows(img: np.ndarray, radius: float) -> np.ndarray:
    """One horizontal pass of Pillow's box blur on (H, W, C) uint8: each
    output is the window sum over [x - r, x + r] with weight ww and the two
    pixels beyond it with weight fw, indices clamped to the row, in 8.24
    fixed point."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / np.float32(np.float32(radius) * 2 + 1))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    H, W = img.shape[:2]
    idx = np.clip(np.arange(-r - 1, W + r + 1), 0, W - 1)
    padded = img[:, idx].astype(np.int64)  # column j holds x = j - r - 1
    c = np.concatenate([np.zeros_like(padded[:, :1]), np.cumsum(padded, axis=1)], axis=1)
    x = np.arange(W)
    acc = c[:, x + 2 * r + 2] - c[:, x + 1]  # columns x + 1 .. x + 2r + 1
    far = padded[:, x] + padded[:, x + 2 * r + 2]
    bulk = acc * ww + far * fw
    return ((bulk + (1 << 23)) >> 24).astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """ImageFilter.GaussianBlur(radius) of an (H, W[, C]) uint8 image."""
    if radius == 0:
        return img.copy()
    box = _box_radius(radius, passes)
    out = img if img.ndim == 3 else img[..., None]
    for _ in range(passes):
        out = _box_blur_rows(out, box)
    out = out.transpose(1, 0, 2)
    for _ in range(passes):
        out = _box_blur_rows(out, box)
    out = np.ascontiguousarray(out.transpose(1, 0, 2))
    return out if img.ndim == 3 else out[..., 0]


def _clip8(ss: np.ndarray) -> np.ndarray:
    """Filter.c's clip8: <= 0 -> 0, >= 255 -> 255, else (uint8)(v + 0.5)."""
    out = (ss + np.float32(0.5)).astype(np.int64)
    out = np.where(ss <= 0, 0, np.where(ss >= 255, 255, out))
    return out.astype(np.uint8)


def smooth(img: np.ndarray) -> np.ndarray:
    """ImageFilter.SMOOTH of an (H, W[, C]) uint8 image: the 3x3 kernel
    (1 1 1, 1 5 1, 1 1 1) / 13 in f32, summed row by row as Filter.c sums
    (each row's three products left to right, the row below first), rounded
    and clipped; the outermost rows and columns are copied."""
    f = np.float32
    k1, k5 = f(1) / f(13), f(5) / f(13)
    x = img.astype(np.float32)
    out = img.copy()
    if img.shape[0] < 3 or img.shape[1] < 3:
        return out

    def row(r, kc):  # in[x - 1] k1 + in[x] kc + in[x + 1] k1, left to right
        return (r[:, :-2] * k1 + r[:, 1:-1] * kc) + r[:, 2:] * k1

    ss = f(0) + row(x[2:], k1)
    ss = ss + row(x[1:-1], k5)
    ss = ss + row(x[:-2], k1)
    out[1:-1, 1:-1] = _clip8(ss)
    return out


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """Image.blend(im1, im2, alpha) of uint8 arrays: im1 + alpha (im2 - im1)
    in f32, truncated; outside 0 <= alpha <= 1 clipped to [0, 255] first."""
    a = np.float32(alpha)
    i1 = im1.astype(np.float32)
    temp = i1 + a * (im2.astype(np.float32) - i1)
    if 0.0 <= a <= 1.0:
        return temp.astype(np.uint8)
    return np.where(temp <= 0, 0, np.where(temp >= 255, 255, temp)).astype(np.uint8)


def to_luma(rgb: np.ndarray) -> np.ndarray:
    """convert("L") of (H, W, 3) uint8: ITU-R 601-2 luma in 16.16 fixed point."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def enhance_sharpness(rgb, factor):
    return blend(smooth(rgb), rgb, factor)


def enhance_contrast(rgb, factor):
    luma = to_luma(rgb)
    mean = int(int(luma.sum(dtype=np.int64)) / luma.size + 0.5)
    return blend(np.full_like(rgb, mean), rgb, factor)


def enhance_brightness(rgb, factor):
    return blend(np.zeros_like(rgb), rgb, factor)


def enhance_color(rgb, factor):
    return blend(np.repeat(to_luma(rgb)[..., None], 3, axis=-1), rgb, factor)


def augment_rgb(rgb: np.ndarray, rng: np.random.Generator,
                cfg: RgbAugmentConfig = RgbAugmentConfig()) -> np.ndarray:
    """(H, W, 3) uint8 -> augmented uint8, drawing from `rng` in the JAX
    package's order: the outer gate, the blur gate (and its integer radius),
    then each enhancer's gate and factor."""
    if rng.uniform() > cfg.p_any:
        return rgb
    img = rgb
    if rng.uniform() <= cfg.p_blur:
        img = gaussian_blur(img, int(rng.integers(cfg.blur_interval[0], cfg.blur_interval[1] + 1)))
    for p, interval, enhance in (
        (cfg.p_sharpness, cfg.sharpness_interval, enhance_sharpness),
        (cfg.p_contrast, cfg.contrast_interval, enhance_contrast),
        (cfg.p_brightness, cfg.brightness_interval, enhance_brightness),
        (cfg.p_color, cfg.color_interval, enhance_color),
    ):
        if rng.uniform() <= p:
            img = enhance(img, float(rng.uniform(*interval)))
    return img


def _affine_matrix(angle_deg: float, w: int, h: int):
    """Image.rotate's inverse (destination -> source) affine, in Python
    floats exactly as Pillow computes it."""
    cx, cy = w / 2, h / 2
    angle = -math.radians(angle_deg)
    a, b, d, e = (round(math.cos(angle), 15), round(math.sin(angle), 15),
                  round(-math.sin(angle), 15), round(math.cos(angle), 15))
    c = a * -cx + b * -cy + 0.0
    f = d * -cx + e * -cy + 0.0
    return a, b, c + cx, d, e, f + cy


def rotate(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """Image.rotate(angle_deg) (NEAREST, about the centre, no expand, fill
    0) of an (H, W[, C]) array of any dtype (uint8 RGBA, f32 depth)."""
    angle = angle_deg % 360.0
    h, w = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    a0, a1, a2, a3, a4, a5 = _affine_matrix(angle, w, h)
    if not all(abs(x * a0 + y * a1 + a2) < 32768.0 and abs(x * a3 + y * a4 + a5) < 32768.0
               for x, y in ((0, 0), (w, h), (0, h), (w, 0))):
        raise ValueError(f"rotate: a {w}x{h} image is beyond the 16.16 fixed-point walk")
    # Geometry.c:affine_fixed: the source pixel of (x, y) in 16.16 fixed point
    fix = lambda v: int(math.floor(v * 65536.0 + 0.5))
    ys, xs = np.mgrid[0:h, 0:w]
    xin = (fix(a2 + a0 * 0.5 + a1 * 0.5) + ys * fix(a1) + xs * fix(a0)) >> 16
    yin = (fix(a5 + a3 * 0.5 + a4 * 0.5) + ys * fix(a4) + xs * fix(a3)) >> 16
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.zeros_like(img)
    out[inside] = img[yin[inside], xin[inside]]
    return out


def rotate_rgba(rgba: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rotate an (H, W, 4) RGBA template about its centre. A float image in
    [0, 1] goes through uint8 as in the JAX package: (x * 255) truncated,
    rotated, then / 255."""
    if angle_deg == 0:
        return rgba
    if rgba.dtype == np.uint8:
        return rotate(rgba, angle_deg)
    out = rotate((rgba * 255.0).astype(np.uint8), angle_deg)
    return out.astype(rgba.dtype) / 255.0
