"""Host-side augmentations and template rotation in numpy (port of
gigapose_tpu/dataloader/augment.py).

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

The depth-noise family and `replace_background` (MegaPose-style training
augmentations, below) rebuild the same way Pillow's bicubic resize of F and
RGB images (Resample.c: f64 sums stored as f32; 22-bit fixed-point weights),
ImageDraw's filled ellipse (Draw.c's quarter walk) and Image.rotate(BILINEAR)
of an L mask (Geometry.c's f64 affine and bilinear_filter8).
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


def _rotate_transposed(img: np.ndarray, angle: float):
    """Image.rotate's fast paths, whatever the filter: 0 and 180 degrees, and
    90 / 270 on a square image, as transposes; None for other angles."""
    h, w = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    return None


def rotate(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """Image.rotate(angle_deg) (NEAREST, about the centre, no expand, fill
    0) of an (H, W[, C]) array of any dtype (uint8 RGBA, f32 depth)."""
    angle = angle_deg % 360.0
    fast = _rotate_transposed(img, angle)
    if fast is not None:
        return fast
    h, w = img.shape[:2]
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


# --------------------------------------------------------------------------
# the depth-noise family and background replacement (MegaPose-style training
# augmentations), with the Pillow operations the JAX package uses rebuilt
# in numpy: Image.resize(BICUBIC) of an F and of an RGB image, ImageDraw's
# filled ellipse and Image.rotate(BILINEAR) of an L mask


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's bicubic_filter (a = -0.5), in f64."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _resample_coeffs(in_size: int, out_size: int):
    """Resample.c:precompute_coeffs for the bicubic filter over the whole
    input: per output pixel its first input pixel and the normalized f64
    weights (B, ksize), zero beyond its window."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax)
        w = _bicubic((x + xmin - center + 0.5) * (1.0 / filterscale))
        ww = 0.0
        for v in w:  # the C loop's sum, in order
            ww += v
        kk[xx, :xmax] = w / ww if ww != 0.0 else w
        bounds[xx] = xmin
    return bounds, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int, accumulate):
    """One pass of Pillow's two-pass resample along `axis` (1: horizontal,
    0: vertical) of an (H, W) array: `accumulate(taps (..., out, ksize),
    kk (out, ksize))` sums the window of each output pixel. An axis of
    unchanged size is skipped, as Pillow skips it."""
    in_size = img.shape[axis]
    if in_size == out_size:
        return img
    bounds, kk = _resample_coeffs(in_size, out_size)
    ksize = kk.shape[1]
    idx = np.minimum(bounds[:, None] + np.arange(ksize)[None], in_size - 1)  # weight 0 beyond
    taps = np.take(img, idx, axis=axis)  # axis -> (out, ksize)
    out = accumulate(np.moveaxis(taps, (axis, axis + 1), (-2, -1)), kk)  # (..., out)
    return np.moveaxis(out, -1, axis)


def resize_bicubic_f32(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Image.fromarray(img (H, W) f32).resize((W', H'), BICUBIC): the
    horizontal pass, then the vertical one, each output an f64 sum of its
    window's products in order, stored as f32."""
    W2, H2 = size

    def acc(taps, kk):
        ss = np.zeros(taps.shape[:-1])
        for x in range(kk.shape[1]):
            ss = ss + taps[..., x].astype(np.float64) * kk[:, x]
        return ss.astype(np.float32)

    out = _resample_axis(img.astype(np.float32), W2, 1, acc)
    return _resample_axis(out, H2, 0, acc)


_PRECISION_BITS = 32 - 8 - 2


def resize_bicubic_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Image.fromarray(img (H, W, C) uint8).resize((W', H')) (BICUBIC, the
    default): the weights in 22-bit fixed point, each output the rounded
    integer sum shifted back and clipped to [0, 255], horizontal pass
    first."""
    W2, H2 = size

    def acc(taps, kk):
        k = np.where(kk < 0, np.trunc(-0.5 + kk * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + kk * (1 << _PRECISION_BITS))).astype(np.int64)
        ss = (taps.astype(np.int64) * k).sum(-1) + (1 << (_PRECISION_BITS - 1))
        return np.clip(ss >> _PRECISION_BITS, 0, 255).astype(np.uint8)

    x = np.moveaxis(img, -1, 0)  # (C, H, W)
    x = np.stack([_resample_axis(c, W2, 1, acc) for c in x])
    x = np.stack([_resample_axis(c, H2, 0, acc) for c in x])
    return np.ascontiguousarray(np.moveaxis(x, 0, -1))


def _ellipse_rows(a: int, b: int):
    """ImageDraw's filled ellipse of doubled axes a, b (Draw.c: ellipseNew,
    quarter_next): the outer quarter walked from (a, b % 2) to (a % 2, b) in
    steps of 2 by least |a^2 y^2 + b^2 x^2 - a^2 b^2|; each row y spans +-
    the first x the walk reaches on it -> [(y, x)]."""
    a2, b2 = a * a, b * b
    a2b2 = a2 * b2
    delta = lambda x, y: abs(a2 * y * y + b2 * x * x - a2b2)
    cx, cy, ex, ey = a, b % 2, a % 2, b
    rows = [(cy, cx)]
    while not (cx == ex and cy == ey):
        nx, ny = cx, cy + 2
        nd = delta(nx, ny)
        if cx > 1:
            d = delta(cx - 2, cy + 2)
            if nd > d:
                nx, ny, nd = cx - 2, cy + 2, d
            d = delta(cx - 2, cy)
            if nd > d:
                nx, ny = cx - 2, cy
        cx, cy = nx, ny
        if cy != rows[-1][0]:
            rows.append((cy, cx))
    return rows


def draw_ellipse(canvas: np.ndarray, box: Tuple[int, int, int, int], fill) -> None:
    """ImageDraw.Draw(canvas).ellipse(box, fill=fill) in place on an (H, W)
    array, box (x0, y0, x1, y1) inclusive integers."""
    x0, y0, x1, y1 = (int(v) for v in box)
    a, b = x1 - x0, y1 - y0
    if a < 0 or b < 0 or a + b < 1:  # a fill's ring width a + b below 1 draws nothing
        return
    H, W = canvas.shape
    for y, x in _ellipse_rows(a, b):
        c0, c1 = x0 + (-x + a) // 2, x0 + (x + a) // 2
        lo, hi = max(c0, 0), min(c1 + 1, W)
        for yy in {y0 + (y + b) // 2, y0 + (-y + b) // 2}:
            if 0 <= yy < H and lo < hi:
                canvas[yy, lo:hi] = fill


def rotate_bilinear_l(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """Image.fromarray(img (H, W) uint8, "L").rotate(angle_deg,
    resample=BILINEAR): 0 and 180 degrees (90 and 270 on a square) as a
    transpose, else each output pixel centre mapped back through Pillow's
    affine in f64 and interpolated from its 2 x 2 neighbours (edges clamped),
    truncated; pixels that map outside the image are 0."""
    angle = angle_deg % 360.0
    fast = _rotate_transposed(img, angle)
    if fast is not None:
        return fast
    h, w = img.shape
    a0, a1, a2, a3, a4, a5 = _affine_matrix(angle, w, h)
    ys, xs = np.mgrid[0:h, 0:w]
    xo, yo = xs + 0.5, ys + 0.5
    xin = a0 * xo + a1 * yo + a2
    yin = a3 * xo + a4 * yo + a5
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x, y = np.floor(xin).astype(np.int64), np.floor(yin).astype(np.int64)
    dx, dy = xin - x, yin - y
    src = img.astype(np.int64)
    x0, x1 = np.clip(x, 0, w - 1), np.clip(x + 1, 0, w - 1)
    yc = np.clip(y, 0, h - 1)
    lerp = lambda p, q, d: p + (q - p) * d
    v1 = lerp(src[yc, x0], src[yc, x1], dx)
    has_next = (y + 1 >= 0) & (y + 1 < h)
    y1 = np.clip(y + 1, 0, h - 1)
    v2 = np.where(has_next, lerp(src[y1, x0], src[y1, x1], dx), v1)
    v = lerp(v1, v2, dy)
    return np.where(inside, v.astype(np.uint8), 0).astype(np.uint8)


def depth_gaussian_noise(depth: np.ndarray, rng: np.random.Generator,
                         std_dev: float = 0.02) -> np.ndarray:
    """Additive gaussian noise on the valid (> 0) pixels."""
    out = depth.copy()
    noise = rng.normal(scale=std_dev, size=depth.shape)
    out[depth > 0] += noise[depth > 0]
    return np.clip(out, 0, np.finfo(np.float32).max)


def depth_correlated_gaussian_noise(depth: np.ndarray, rng: np.random.Generator,
                                    std_dev: float = 0.01,
                                    gp_rescale_factor: Tuple[float, float] = (15.0, 40.0)
                                    ) -> np.ndarray:
    """Spatially correlated noise on the valid pixels: a low-resolution
    gaussian field (f32) upsampled bicubic (Pillow's, resize_bicubic_f32)."""
    H, W = depth.shape
    out = depth.copy()
    factor = rng.uniform(*gp_rescale_factor)
    small = rng.normal(0.0, std_dev, (max(int(H / factor), 1), max(int(W / factor), 1)))
    noise = resize_bicubic_f32(small.astype(np.float32), (W, H))
    out[depth > 0] += noise[depth > 0]
    return np.clip(out, 0, np.finfo(np.float32).max)


def depth_missing(depth: np.ndarray, rng: np.random.Generator,
                  max_missing_fraction: float = 0.2) -> np.ndarray:
    """A random share (uniform up to max_missing_fraction) of the valid
    pixels set to 0."""
    out = depth.copy()
    v, u = np.where(depth > 0)
    frac = rng.uniform(0, max_missing_fraction)
    drop = rng.choice(len(u), int(frac * len(u)), replace=False) if len(u) else []
    out[v[drop], u[drop]] = 0
    return out


def depth_dropout(depth: np.ndarray) -> np.ndarray:
    """The whole depth image set to 0."""
    return np.zeros_like(depth)


def _random_ellipses(depth: np.ndarray, rng: np.random.Generator, mean: float,
                     gamma_shape: float, gamma_scale: float):
    """Poisson(mean) ellipses centred on valid pixels: their x and y radii
    (gamma), angles (integer degrees) and (v, u) centres."""
    n = rng.poisson(mean)
    nz = np.argwhere(depth > 0)
    if len(nz) == 0 or n == 0:
        return np.zeros((0,)), np.zeros((0,)), np.zeros((0,)), np.zeros((0, 2), int)
    centers = nz[rng.choice(len(nz), size=n)]
    xr = rng.gamma(gamma_shape, gamma_scale, size=n)
    yr = rng.gamma(gamma_shape, gamma_scale, size=n)
    angles = rng.integers(0, 360, size=n)
    return xr, yr, angles, centers


def _paint_ellipse(canvas: np.ndarray, center_vu, x_radius: int, y_radius: int,
                   angle_deg, value) -> None:
    """A filled ellipse of integer radii, rotated by angle_deg about its
    centre, painted with `value`: drawn into an L mask of side 2r + 1 (r the
    larger radius + 1), rotated bilinear by -angle_deg, thresholded at 127,
    as the JAX package does with Pillow."""
    r = max(x_radius, y_radius) + 1
    size = 2 * r + 1
    m = np.zeros((size, size), np.uint8)
    draw_ellipse(m, (r - x_radius, r - y_radius, r + x_radius, r + y_radius), 255)
    mask = rotate_bilinear_l(m, -float(angle_deg)) > 127
    v, u = int(center_vu[0]), int(center_vu[1])
    H, W = canvas.shape
    v0, v1 = max(v - r, 0), min(v + r + 1, H)
    u0, u1 = max(u - r, 0), min(u + r + 1, W)
    mv0, mu0 = v0 - (v - r), u0 - (u - r)
    sub = mask[mv0:mv0 + (v1 - v0), mu0:mu0 + (u1 - u0)]
    canvas[v0:v1, u0:u1][sub] = value


def depth_ellipse_dropout(depth: np.ndarray, rng: np.random.Generator, mean: float = 10.0,
                          gamma_shape: float = 5.0, gamma_scale: float = 1.0) -> np.ndarray:
    """Random rotated ellipses over valid pixels set to 0 (DexNet style)."""
    out = depth.copy()
    xr, yr, angles, centers = _random_ellipses(depth, rng, mean, gamma_shape, gamma_scale)
    for i in range(len(xr)):
        _paint_ellipse(out, centers[i], round(xr[i]), round(yr[i]), angles[i], 0.0)
    return out


def depth_ellipse_noise(depth: np.ndarray, rng: np.random.Generator, mean: float = 10.0,
                        gamma_shape: float = 5.0, gamma_scale: float = 1.0,
                        std_dev: float = 0.01) -> np.ndarray:
    """A gaussian constant per random ellipse added to the valid pixels."""
    xr, yr, angles, centers = _random_ellipses(depth, rng, mean, gamma_shape, gamma_scale)
    vals = rng.normal(0.0, std_dev, size=len(xr))
    noise = np.zeros_like(depth)
    for i in range(len(xr)):
        _paint_ellipse(noise, centers[i], round(xr[i]), round(yr[i]), angles[i], vals[i])
    out = depth.copy()
    out[depth > 0] += noise[depth > 0]
    return out


def depth_blur(depth: np.ndarray, rng: np.random.Generator,
               factor_interval: Tuple[int, int] = (3, 7)) -> np.ndarray:
    """A k x k box blur, k uniform in factor_interval, anchored as cv2.blur
    anchors it (k // 2 before, (k - 1) // 2 after, edges replicated), summed
    in f64 by cumulative sums."""
    k = int(rng.integers(factor_interval[0], factor_interval[1] + 1))
    pad = ((k // 2, (k - 1) // 2), (k // 2, (k - 1) // 2))
    padded = np.pad(depth, pad, mode="edge").astype(np.float64)
    c = np.cumsum(padded, axis=0)
    rows = c[k - 1:] - np.concatenate([np.zeros((1, c.shape[1])), c[:-k]], 0)
    c2 = np.cumsum(rows, axis=1)
    out = c2[:, k - 1:] - np.concatenate([np.zeros((c2.shape[0], 1)), c2[:, :-k]], 1)
    return (out / (k * k)).astype(depth.dtype)


def depth_background_dropout(depth: np.ndarray, segmentation: np.ndarray) -> np.ndarray:
    """Every background (segmentation 0) pixel set to 0."""
    out = depth.copy()
    out[segmentation == 0] = 0
    return out


def _as_rgb(img: np.ndarray) -> np.ndarray:
    """convert("RGB") of a uint8 gray, RGB or RGBA array."""
    img = np.asarray(img)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


def replace_background(rgb: np.ndarray, segmentation: np.ndarray, backgrounds,
                       rng: np.random.Generator) -> np.ndarray:
    """The background (segmentation 0) pixels of an (H, W, 3) uint8 image
    taken from a random image of an indexable collection of uint8 arrays
    (gray, RGB or RGBA), resized to (W, H) as Pillow's bicubic resize does."""
    out = rgb.copy()
    h, w = rgb.shape[:2]
    bg = _as_rgb(backgrounds[int(rng.integers(0, len(backgrounds)))])
    if bg.shape[:2] != (h, w):
        bg = resize_bicubic_u8(bg, (w, h))
    mask = segmentation == 0
    out[mask] = bg[mask]
    return out
