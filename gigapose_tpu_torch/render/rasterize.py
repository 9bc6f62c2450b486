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
(B, 3, 3), T (B, 4, 4) object -> camera in the units of verts. Outputs: a
dict of rgba (B, H, W, 4) uint8, depth (B, H, W) f32 (0 off the object),
normals (B, H, W, 3) f32 and face_id (B, H, W) int32 (0 off the object).

Dispatch is by device and nothing else: CUDA tensors launch the kernel (or
raise on what it does not take), CPU tensors take `rasterize_plain`.
`rasterize.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

EPS_Z = 1e-6
EPS_AREA = 1e-9
# faces per step of the plain version's scan (the JAX package's default
# chunk); the result does not depend on it
PLAIN_CHUNK = 64
# floats of one face record of the kernel's setup pass (csrc/rasterizer.cu: FaceRec)
FACE_RECORD_FLOATS = 12


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
    fx = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5)[None, None, None, :]
    fy = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5)[None, None, :, None]
    faces = faces.long()

    zbuf = torch.full((B, H, W), float("inf"), device=dev)
    fbuf = torch.zeros((B, H, W), dtype=torch.long, device=dev)
    for s in range(0, F, PLAIN_CHUNK):
        idx = faces[:, s:s + PLAIN_CHUNK]  # (B, Tc, 3)
        p = scr[bi[:, None, None], idx]  # (B, Tc, 3, 2)
        tz = z[bi[:, None, None], idx]  # (B, Tc, 3)
        x0, y0, x1, y1, x2, y2 = (p[..., k, c] for k in range(3) for c in range(2))
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        valid = (area.abs() > EPS_AREA) & (tz > EPS_Z).all(-1)
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8
    return fn


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
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if V == 0 and F > 0:
        raise ValueError("faces without vertices")
    H, W = height, width
    cam = torch.empty((B, V, 3), dtype=torch.float32, device=dev)
    scr = torch.empty((B, V, 2), dtype=torch.float32, device=dev)
    recs = torch.empty((B, F, FACE_RECORD_FLOATS), dtype=torch.float32, device=dev)
    out = dict(rgba=torch.empty((B, H, W, 4), dtype=torch.uint8, device=dev),
               depth=torch.empty((B, H, W), dtype=torch.float32, device=dev),
               normals=torch.empty((B, H, W, 3), dtype=torch.float32, device=dev),
               face_id=torch.empty((B, H, W), dtype=torch.int32, device=dev))
    if B == 0:
        return out
    fn = _entry_point()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(verts.data_ptr(), faces.data_ptr(), colors.data_ptr(), K.data_ptr(),
                 T.data_ptr(), B, V, F, H, W, cam.data_ptr(), scr.data_ptr(), recs.data_ptr(),
                 out["rgba"].data_ptr(), out["depth"].data_ptr(), out["normals"].data_ptr(),
                 out["face_id"].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rasterizer kernel launch failed: CUDA error {err}")
    rasterize.launches += 1
    return out


def rasterize(verts, faces, colors, K, T, height: int, width: int) -> Dict[str, torch.Tensor]:
    """B views -> dict(rgba, depth, normals, face_id). CUDA tensors run the
    kernel; CPU tensors run rasterize_plain; anything else raises."""
    if verts.device.type == "cuda":
        return _launch(verts, faces, colors, K, T, height, width)
    if verts.device.type == "cpu":
        return rasterize_plain(verts, faces, colors, K, T, height, width)
    raise ValueError(f"the rasterizer runs on cuda or cpu tensors, not {verts.device}")


rasterize.launches = 0
