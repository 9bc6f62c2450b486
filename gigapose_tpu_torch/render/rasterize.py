"""Batched z-buffer rasterizer: wrapper of the CUDA kernel in
csrc/rasterizer.cu, and its plain PyTorch version.

Counterpart of gigapose_tpu/render/jax_renderer.py:200-326 (`rasterize`,
one view, vmapped over the batch by refiner/device_render.py): per view b,

    camera-space vertices -> screen coordinates (-1e9 for z <= 1e-6)
    -> per (pixel, face): affine edge functions at pixel centres (+0.5),
       inside = all barycentrics >= 0, |area| > 1e-9, every depth > 1e-6;
       perspective depth 1 / max(sum w_i / z_i, 1e-30)
    -> the nearest face, the first of equal depth
    -> attributes of that face: perspective-correct vertex colours, flat
       camera-facing normal, shade 0.35 + 0.65 |n_z|, clip to [0, 255],
       truncated to uint8; alpha 255, depth and normal where hit.

Padded (0, 0, 0) faces have zero area and never win a pixel. Inputs: verts
(B, V, 3) f32, faces (B, F, 3) int32, colors (B, V, 3) f32 in [0, 255], K
(B, 3, 3), T (B, 4, 4) object -> camera in the units of verts; the kernel
takes verts, faces and colors each either contiguous or as one contiguous
mesh expanded over the batch (no copy per view). Outputs: a
dict of rgba (B, H, W, 4) uint8, depth (B, H, W) f32 (0 off the object),
normals (B, H, W, 3) f32 and face_id (B, H, W) int32 (0 off the object).

The kernel tests each face only at the pixels where a bound of the inside
test's f32 error lets it accept (a cull box, and for a large box a span per
row) and resolves the z-buffer by a 64-bit (depth, face) key, so it equals
the plain version bit for bit; `cull_boxes_plain` and `cull_row_span`
compute those pixels and `inside_depth` the per-chunk inside test and
depth, for the tests.

Dispatch is by device and nothing else: CUDA tensors launch the kernel (or
raise on what it does not take), CPU tensors take `rasterize_plain`.
`rasterize.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

EPS_Z = 1e-6
EPS_AREA = 1e-9
# faces per step of the plain version's scan (the JAX package's default
# chunk); the result does not depend on it
PLAIN_CHUNK = 64


def _camera(verts: torch.Tensor, K: torch.Tensor, T: torch.Tensor):
    """-> cam (B, V, 3), screen coordinates (B, V, 2). Each product and sum
    rounded on its own, in the kernel's order."""
    x, y, z = verts.unbind(-1)
    row = lambda M, i, a, b, c: (M[:, i, 0, None] * a + M[:, i, 1, None] * b) + M[:, i, 2, None] * c
    cx = row(T, 0, x, y, z) + T[:, 0, 3, None]
    cy = row(T, 1, x, y, z) + T[:, 1, 3, None]
    cz = row(T, 2, x, y, z) + T[:, 2, 3, None]
    good = cz > EPS_Z
    zs = torch.where(good, cz, torch.ones_like(cz))
    far = torch.full_like(cz, -1e9)
    u = torch.where(good, row(K, 0, cx, cy, cz) / zs, far)
    v = torch.where(good, row(K, 1, cx, cy, cz) / zs, far)
    return torch.stack([cx, cy, cz], -1), torch.stack([u, v], -1)


def _pixel_centres(H: int, W: int, dev):
    """(1, 1, 1, W) and (1, 1, H, 1) f32 pixel centres i + 0.5."""
    fx = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5)[None, None, None, :]
    fy = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5)[None, None, :, None]
    return fx, fy


def _face_coords(scr, z, idx):
    """Screen coordinates x0, y0, x1, y1, x2, y2 (B, Tc) and camera depths
    (B, Tc, 3) of faces idx (B, Tc, 3), their doubled signed area and
    validity (|area| > EPS_AREA, every depth > EPS_Z)."""
    bi = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    idx = idx.long()
    p, tz = scr[bi, idx], z[bi, idx]  # (B, Tc, 3, 2), (B, Tc, 3)
    x0, y0, x1, y1, x2, y2 = (p[..., k, c] for k in range(3) for c in range(2))
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    valid = (area.abs() > EPS_AREA) & (tz > EPS_Z).all(-1)
    return (x0, y0, x1, y1, x2, y2), tz, area, valid


def inside_depth(scr, z, idx, height: int, width: int):
    """The inside test and perspective depth of faces idx (B, Tc, 3) at
    every pixel centre, from screen coordinates scr (B, V, 2) and camera
    depths z (B, V): -> inside (B, Tc, H, W) bool and depth (B, Tc, H, W),
    inf where not inside. Each product and sum rounded on its own, in the
    kernel's order."""
    (x0, y0, x1, y1, x2, y2), tz, area, valid = _face_coords(scr, z, idx)
    fx, fy = _pixel_centres(height, width, scr.device)
    inv_area = torch.where(valid, 1.0 / torch.where(valid, area, torch.ones_like(area)),
                           torch.zeros_like(area))
    e = lambda a: a[..., None, None]

    def edge(xa, ya, xb, yb):
        return ((e(xa * yb - xb * ya) + e(ya - yb) * fx) + e(xb - xa) * fy) * e(inv_area)

    w0 = edge(x1, y1, x2, y2)  # (B, Tc, H, W)
    w1 = edge(x2, y2, x0, y0)
    w2 = (1.0 - w0) - w1
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & e(valid)
    iz = 1.0 / tz.clamp_min(EPS_Z)
    inv_z = (w0 * e(iz[..., 0]) + w1 * e(iz[..., 1])) + w2 * e(iz[..., 2])
    depth = torch.where(inside, 1.0 / inv_z.clamp_min(1e-30),
                        torch.full_like(inv_z, float("inf")))
    return inside, depth


# f32 constants of the cull bound (csrc/rasterizer.cu, whose head derives
# it), as the CUDA compiler folds them; an f32-exact constant gives the same
# result whether an operation runs in f32 or in double and is then rounded
_U = np.float32(2.0 ** -24)
_CULL = {k: float(np.float32(c) * _U) for k, c in (("dA", 6.02), ("rho", 2.01), ("e", 4.01))}
_CULL.update(u=float(_U), one=float(np.float32(1.0001)))
# pixels around a cull box for the rounding of its own arithmetic, and the
# most a box may grow beyond its face's screen box before the face is
# tested at the whole view
CULL_SLACK, CULL_REACH_MAX = 0.25, 16384.0
# a face whose box holds more pixels than this is tested row by row, each
# row at cull_row_span's columns only
CULL_SMALL_BOX = 32


def cull_boxes_plain(verts, faces, K, T, height: int, width: int) -> Dict[str, torch.Tensor]:
    """The kernel's cull boxes, in its f32 order: -> box (B, F, 4) int32 as
    first column, last column, first row, last row (empty when first > last:
    invalid faces, faces wholly off the view), whole (B, F) bool (the face's
    error bound failed and it is tested at the whole view), reach (B, F)
    f32 (how far the region the rounded inside test can accept reaches
    beyond the face's screen box, in pixels; 0 where there is no box or a
    whole view), and corners (B, F, 3, 2) f32 and spans (B, F) bool, the
    inputs of cull_row_span. Every pixel centre the inside test accepts lies
    in its face's box, and in its row's span where the box holds more than
    CULL_SMALL_BOX pixels."""
    H, W = height, width
    cam, scr = _camera(verts.float(), K.float(), T.float())
    (x0, y0, x1, y1, x2, y2), _, area, valid = _face_coords(scr, cam[..., 2], faces)
    lo3 = lambda a, b, c: torch.minimum(torch.minimum(a, b), c)
    hi3 = lambda a, b, c: torch.maximum(torch.maximum(a, b), c)
    xmin, xmax, ymin, ymax = lo3(x0, x1, x2), hi3(x0, x1, x2), lo3(y0, y1, y2), hi3(y0, y1, y2)
    D = torch.maximum(xmax - xmin, ymax - ymin)
    M = torch.maximum(hi3(x0.abs(), x1.abs(), x2.abs()), hi3(y0.abs(), y1.abs(), y2.abs()))
    a = area.abs()
    view = float(W + H)
    dA = _CULL["dA"] * (D * D)
    a_low = a - dA
    eps = _CULL["one"] * (dA / a_low + _CULL["rho"]) \
        + _CULL["e"] * ((2.0 * (M * M) + D * view) / a_low)
    t2 = _CULL["u"] + 2.0 * eps
    whole = valid & ~((dA <= 0.25 * a) & ((2.0 * eps + t2) * D <= CULL_REACH_MAX))
    # the corners of the region the rounded test can accept
    corner = lambda a, b, c, tb, tc: (a + tb * (a - b)) + tc * (a - c)
    px = (corner(x0, x1, x2, eps, t2), corner(x1, x0, x2, eps, t2), corner(x2, x0, x1, eps, eps))
    py = (corner(y0, y1, y2, eps, t2), corner(y1, y0, y2, eps, t2), corner(y2, y0, y1, eps, eps))
    lox, hix, loy, hiy = lo3(*px), hi3(*px), lo3(*py), hi3(*py)
    first = lambda lo, n: torch.ceil(((lo - CULL_SLACK) - 0.5).clamp_min(0.0).clamp_max(float(n)))
    last = lambda hi, n: torch.floor(((hi + CULL_SLACK) - 0.5).clamp_min(-1.0)
                                     .clamp_max(float(n - 1)))
    box = torch.stack([first(lox, W), last(hix, W), first(loy, H), last(hiy, H)], -1)
    full = torch.tensor([0.0, W - 1.0, 0.0, H - 1.0], device=box.device)
    box = torch.where(whole[..., None], full, box)
    box = torch.where(valid[..., None], box, torch.tensor([0.0, -1.0, 0.0, -1.0],
                                                          device=box.device))
    reach = torch.stack([xmin - lox, hix - xmax, ymin - loy, hiy - ymax], -1).amax(-1)
    spans = valid & ~whole & (torch.maximum(torch.maximum(-lox, hix),
                                            torch.maximum(-loy, hiy)) <= CULL_REACH_MAX)
    return dict(box=box.to(torch.int32), whole=whole,
                reach=torch.where(valid & ~whole, reach, 0.0),
                corners=torch.stack([torch.stack(px, -1), torch.stack(py, -1)], -1), spans=spans)


def cull_row_span(corners, spans, box, row, width: int):
    """The kernel's columns of one box row of a big face (csrc/rasterizer.cu:
    row_span), elementwise over N (face, row) pairs: corners (N, 3, 2) and
    spans (N,) from cull_boxes_plain, box (N, 4), row (N,) int. -> first,
    last (N,) int (empty when first > last): the pixels whose centre lies
    within CULL_SLACK of the accepting triangle's cut by the band of
    half-width CULL_SLACK about the row's centre line, within the box; the
    box's whole row where `spans` is false."""
    cx, cy = corners[..., 0], corners[..., 1]
    c = row.float() + 0.5
    band = (c - CULL_SLACK, c + CULL_SLACK)
    inf = torch.full_like(c, float("inf"))
    lo, hi = inf, -inf
    for k in range(3):
        j = (k + 1) % 3
        inside = (cy[:, k] >= band[0]) & (cy[:, k] <= band[1])
        lo = torch.minimum(lo, torch.where(inside, cx[:, k], inf))
        hi = torch.maximum(hi, torch.where(inside, cx[:, k], -inf))
        ya, yb = cy[:, k], cy[:, j]
        flat = ya == yb
        slope = torch.where(flat, 0.0, (cx[:, j] - cx[:, k])
                            / torch.where(flat, torch.ones_like(ya), yb - ya))
        for e in band:
            cross = ~flat & (e >= torch.minimum(ya, yb)) & (e <= torch.maximum(ya, yb))
            x = cx[:, k] + (e - ya) * slope
            lo = torch.minimum(lo, torch.where(cross, x, inf))
            hi = torch.maximum(hi, torch.where(cross, x, -inf))
    W = width
    first = torch.ceil(((lo - CULL_SLACK) - 0.5).clamp_min(0.0).clamp_max(float(W))).long()
    last = torch.floor(((hi + CULL_SLACK) - 0.5).clamp_min(-1.0).clamp_max(W - 1.0)).long()
    x0, x1 = box[:, 0].long(), box[:, 1].long()
    return (torch.where(spans, torch.maximum(first, x0), x0),
            torch.where(spans, torch.minimum(last, x1), x1))


def rasterize_plain(verts, faces, colors, K, T, height: int, width: int
                    ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the kernel, batched over B: the JAX scan
    over chunks of PLAIN_CHUNK faces (argmin inside a chunk, strict `<`
    across chunks), then the attribute pass."""
    B, F = faces.shape[:2]
    H, W = height, width
    dev = verts.device
    verts, colors = verts.float(), colors.float()
    K, T = K.float(), T.float()
    cam, scr = _camera(verts, K, T)
    z = cam[..., 2]
    bi = torch.arange(B, device=dev)
    fx, fy = _pixel_centres(H, W, dev)
    faces = faces.long()

    zbuf = torch.full((B, H, W), float("inf"), device=dev)
    fbuf = torch.zeros((B, H, W), dtype=torch.long, device=dev)
    for s in range(0, F, PLAIN_CHUNK):
        _, depth = inside_depth(scr, z, faces[:, s:s + PLAIN_CHUNK], H, W)
        best = torch.argmin(depth, dim=1)  # first index of the least depth
        best_depth = torch.gather(depth, 1, best[:, None])[:, 0]
        win = best_depth < zbuf
        zbuf = torch.where(win, best_depth, zbuf)
        fbuf = torch.where(win, best + s, fbuf)
    hit = torch.isfinite(zbuf)

    # attribute pass: one gather per pixel for the winning face
    idx = faces[bi[:, None, None], fbuf]  # (B, H, W, 3)
    b3 = bi[:, None, None, None]
    p = scr[b3, idx]  # (B, H, W, 3, 2)
    tz = z[b3, idx]
    x0, y0, x1, y1, x2, y2 = (p[..., k, c] for k in range(3) for c in range(2))
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    inv_area = 1.0 / torch.where(area.abs() > EPS_AREA, area, torch.ones_like(area))
    gx, gy = fx[0, 0], fy[0, 0]
    w0 = ((x1 - gx) * (y2 - gy) - (x2 - gx) * (y1 - gy)) * inv_area
    w1 = ((x2 - gx) * (y0 - gy) - (x0 - gx) * (y2 - gy)) * inv_area
    w2 = (1.0 - w0) - w1
    iz = 1.0 / tz.clamp_min(EPS_Z)
    a = [(w * iz[..., k]) * zbuf for k, w in enumerate((w0, w1, w2))]
    c = colors[b3, idx]  # (B, H, W, 3, 3)
    col = (a[0][..., None] * c[..., 0, :] + a[1][..., None] * c[..., 1, :]) \
        + a[2][..., None] * c[..., 2, :]

    cv = cam[b3, idx]  # (B, H, W, 3, 3)
    e1, e2 = cv[..., 1, :] - cv[..., 0, :], cv[..., 2, :] - cv[..., 0, :]
    nx = e1[..., 1] * e2[..., 2] - e1[..., 2] * e2[..., 1]
    ny = e1[..., 2] * e2[..., 0] - e1[..., 0] * e2[..., 2]
    nz = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    nl = torch.sqrt((nx * nx + ny * ny) + nz * nz).clamp_min(1e-20)
    nu = torch.stack([nx / nl, ny / nl, nz / nl], -1)
    nu = torch.where(nu[..., 2:3] > 0, -nu, nu)
    shade = 0.35 + 0.65 * nu[..., 2].abs()

    rgb = (col * shade[..., None]).clamp(0.0, 255.0)
    zero = torch.zeros((), device=dev)
    rgba = torch.cat([torch.where(hit[..., None], rgb, zero),
                      torch.where(hit, 255.0, 0.0)[..., None]], -1).to(torch.uint8)
    return dict(rgba=rgba, depth=torch.where(hit, zbuf, zero),
                normals=torch.where(hit[..., None], nu, zero),
                face_id=torch.where(hit, fbuf, 0).to(torch.int32))


@functools.cache
def _entry_point():
    """gp_rasterize of the built library, with its C signature declared."""
    from gigapose_tpu_torch.kernels.build import load_library

    fn = load_library("rasterizer").gp_rasterize
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 10
    return fn


# the inputs a launch may take as one mesh expanded over the batch (batch stride 0)
SHARED = ("verts", "faces", "colors")


def _launch(verts, faces, colors, K, T, height, width):
    B, V = verts.shape[:2]
    F = faces.shape[1]
    dev = verts.device
    for name, t, dtype, shape in (("verts", verts, torch.float32, (B, V, 3)),
                                  ("faces", faces, torch.int32, (B, F, 3)),
                                  ("colors", colors, torch.float32, (B, V, 3)),
                                  ("K", K, torch.float32, (B, 3, 3)),
                                  ("T", T, torch.float32, (B, 4, 4))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, verts on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not (t.is_contiguous() or (name in SHARED and t.stride(0) == 0 and t[0].is_contiguous())):
            raise ValueError(f"{name} must be contiguous" + (
                ", or one contiguous mesh expanded over the batch" if name in SHARED else ""))
    if V == 0 and F > 0:
        raise ValueError("faces without vertices")
    H, W = height, width
    check_limits(B, V, F, H, W)
    cam = torch.empty((B, V, 3), dtype=torch.float32, device=dev)
    scr = torch.empty((B, V, 2), dtype=torch.float32, device=dev)
    # scratch: the z-buffer's (depth, face) keys, the list of faces whose
    # cull box exceeds a thread's share with each one's first row, and that
    # list's length and row count
    keys = torch.empty((B, H, W), dtype=torch.int64, device=dev)
    big = torch.empty((2 * B * F,), dtype=torch.int32, device=dev)
    counter = torch.empty((1,), dtype=torch.int64, device=dev)
    out = dict(rgba=torch.empty((B, H, W, 4), dtype=torch.uint8, device=dev),
               depth=torch.empty((B, H, W), dtype=torch.float32, device=dev),
               normals=torch.empty((B, H, W, 3), dtype=torch.float32, device=dev),
               face_id=torch.empty((B, H, W), dtype=torch.int32, device=dev))
    if B == 0:
        return out
    fn = _entry_point()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rows = lambda t: t.shape[1] if t.stride(0) else 0
        err = fn(verts.data_ptr(), faces.data_ptr(), colors.data_ptr(), K.data_ptr(),
                 T.data_ptr(), B, V, F, H, W, rows(verts), rows(faces), rows(colors),
                 cam.data_ptr(), scr.data_ptr(), keys.data_ptr(),
                 big.data_ptr(), counter.data_ptr(), out["rgba"].data_ptr(),
                 out["depth"].data_ptr(), out["normals"].data_ptr(), out["face_id"].data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"rasterizer kernel launch failed: CUDA error {err}")
    rasterize.launches += 1
    return out


def check_limits(B: int, V: int, F: int, H: int, W: int) -> None:
    """The kernel's index arithmetic: raises unless B * max(H * W, V, F) <
    2^31, B * F * H < 2^32 and H + W <= 2^16."""
    if B * max(H * W, V, F) >= 2 ** 31 or B * F * H >= 2 ** 32 or H + W > 2 ** 16:
        raise ValueError(f"B * max(H * W, V, F) must stay below 2^31, B * F * H below 2^32 "
                         f"and H + W at most 2^16: B={B}, {H}x{W}, V={V}, F={F}")


def views_per_launch(faces: int, height: int, width: int, verts: int) -> int:
    """The most views of one mesh (F faces, V vertices) at H x W that one
    launch takes (check_limits); 0 when not even one view fits."""
    if height + width > 2 ** 16:
        return 0
    by_rows = (2 ** 32 - 1) // (faces * height) if faces * height else 2 ** 31
    return int(min(by_rows, (2 ** 31 - 1) // max(height * width, verts, faces, 1)))


def rasterize(verts, faces, colors, K, T, height: int, width: int) -> Dict[str, torch.Tensor]:
    """B views -> dict(rgba, depth, normals, face_id). CUDA tensors run the
    kernel; CPU tensors run rasterize_plain; anything else raises."""
    if verts.device.type == "cuda":
        return _launch(verts, faces, colors, K, T, height, width)
    if verts.device.type == "cpu":
        return rasterize_plain(verts, faces, colors, K, T, height, width)
    raise ValueError(f"the rasterizer runs on cuda or cpu tensors, not {verts.device}")


rasterize.launches = 0
