"""Template views of a CAD model, rendered and written in the template-set
layout: the icosphere poses, the mesh unit rule, the PNG writer, and the
device renderer of a view stack (port of gigapose_tpu/render/
jax_renderer.py:402-456, `JaxRenderer.render_batch` and
`render_template_views_jax`; the host renderer's loop is
render/rasterizer.py:render_template_views).

On disk, per view v of an object (render_bop_templates' contract):

    {v:06d}.png        RGBA uint8 render
    {v:06d}_depth.png  uint16 depth in mm, np.clip(depth * unit, 0, 65535)
                       truncated, 0 off the object

Rows are written with PNG filter 0 (None): only the decoded pixels are the
contract, and the port's decoder reads filter-0 rows about 9x faster than
adaptive ones, a cost that cold onboarding pays for every view.

The device renderer runs render/rasterize.py on a device tensor stack: the
CUDA kernel on the card, its plain version on the CPU. The stack is cut into
launches that the kernel's wrapper takes (views_per_launch), and each
launch's rgba and depth are copied to the host once.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Optional

import numpy as np
import torch

from gigapose_tpu_torch.dataloader.png import save_png
from gigapose_tpu_torch.lib3d.icosphere import template_object_poses
from gigapose_tpu_torch.pipeline.templates import TEMPLATE_K
from gigapose_tpu_torch.render.mesh_io import diameter, load_mesh
from gigapose_tpu_torch.render.rasterize import PLAIN_CHUNK, rasterize, views_per_launch
from gigapose_tpu_torch.utils.device import resolve_device

PNG_FILTER = 0
# the plain version (CPU tensors) holds several (B, 64, H, W) f32 temporaries;
# on the CPU a call takes as many views as keep each near this many elements
PLAIN_ELEMENTS = 1 << 24
DEFAULT_COLOR = 200  # the grey albedo of meshes without vertex colours


def mm_per_unit(mesh_diameter: float) -> float:
    """A diameter below 5 means a mesh in metres, otherwise in mm."""
    return 1000.0 if mesh_diameter < 5.0 else 1.0


def template_poses(level: int = 1, radius_factor: float = 0.4) -> np.ndarray:
    """(V, 4, 4) f64 object poses in mm: the icosphere's object poses with
    translations scaled by radius_factor (the object at 0.4 m)."""
    poses = template_object_poses(level).copy()
    poses[:, :3, 3] *= radius_factor
    return poses


def depth_mm_u16(depth: np.ndarray, unit_to_mm: float) -> np.ndarray:
    """f32 depth in mesh units -> uint16 mm, scaled in f32, clipped, truncated."""
    return np.clip(depth * unit_to_mm, 0, 65535).astype(np.uint16)


def write_view(out_dir: str, view: int, rgba: np.ndarray, depth_mm: np.ndarray) -> None:
    for name, image in ((f"{view:06d}.png", rgba), (f"{view:06d}_depth.png", depth_mm)):
        save_png(osp.join(out_dir, name), image, PNG_FILTER)


def add_timing(timing: Optional[dict], key: str, value: float) -> None:
    """timing[key] += value, when a timing dict is given."""
    if timing is not None:
        timing[key] = timing.get(key, 0) + value


def render_view_stack(verts: np.ndarray, faces: np.ndarray, colors: np.ndarray, K: np.ndarray,
                      poses: np.ndarray, height: int, width: int, device,
                      timing: Optional[dict] = None):
    """Views of one mesh at poses (N, 4, 4) f32 in mesh units, through
    rasterize on `device`, in launches of at most views_per_launch views
    (on the CPU, as many as keep the plain version's temporaries near
    PLAIN_ELEMENTS); each launch takes the one mesh expanded over its views,
    not a copy per view -> rgba (N, H, W, 4) uint8 and depth (N, H, W) f32
    on the host. `timing`, if given, gains launches and render_s."""
    F, V = len(faces), len(verts)
    per_launch = views_per_launch(F, height, width, V)
    if torch.device(device).type == "cpu":
        per_view = max(1, min(F, PLAIN_CHUNK)) * height * width
        per_launch = min(per_launch, max(1, PLAIN_ELEMENTS // per_view))
    if per_launch < 1:
        raise ValueError(f"one {height}x{width} view of a mesh of {V} vertices and {F} faces "
                         "exceeds the rasterizer's limits")
    t0 = time.perf_counter()
    put = lambda a, dtype: torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)
    v_t, f_t, c_t = put(verts, np.float32), put(faces, np.int32), put(colors, np.float32)
    K_t, T_t = put(K, np.float32), put(poses, np.float32)
    N = len(poses)
    rgba = np.empty((N, height, width, 4), np.uint8)
    depth = np.empty((N, height, width), np.float32)
    for s in range(0, N, per_launch):
        b = min(per_launch, N - s)
        stack = lambda t: t[None].expand(b, *t.shape)
        out = rasterize(stack(v_t), stack(f_t), stack(c_t), stack(K_t).contiguous(),
                        T_t[s:s + b].contiguous(), height, width)
        rgba[s:s + b] = out["rgba"].cpu().numpy()
        depth[s:s + b] = out["depth"].cpu().numpy()
        add_timing(timing, "launches", 1)
    add_timing(timing, "render_s", time.perf_counter() - t0)
    return rgba, depth


def render_template_views_device(mesh_path: str, out_dir: str, poses: Optional[np.ndarray] = None,
                                 K: Optional[np.ndarray] = None, width: int = 640,
                                 height: int = 480, level: int = 1, radius_factor: float = 0.4,
                                 mesh_unit_to_mm: Optional[float] = None, device=None,
                                 timing: Optional[dict] = None) -> int:
    """render_template_views on the device renderer (`renderer=device`, the
    counterpart of the JAX package's `renderer=jax`): the mesh as
    load_mesh reads it (grey DEFAULT_COLOR without vertex colours), poses
    cast to f32 and then their translations divided by the mesh unit in
    f32, the whole stack rendered (render_view_stack) before the PNGs are
    written. Runs on cuda:0 unless `device` names another device. -> the
    number of views; `timing`, if given, gains launches, render_s and
    encode_s."""
    device = resolve_device(device, "the device template renderer")
    verts, faces, colors = load_mesh(mesh_path)
    if colors is None:
        colors = np.full((len(verts), 3), DEFAULT_COLOR, np.uint8)
    unit = mesh_unit_to_mm if mesh_unit_to_mm is not None else mm_per_unit(diameter(verts))
    if poses is None:
        poses = template_poses(level, radius_factor)
    poses = np.asarray(poses, np.float32).copy()
    poses[:, :3, 3] /= unit
    rgba, depth = render_view_stack(verts, faces, colors, TEMPLATE_K if K is None else K, poses,
                                    height, width, device, timing=timing)
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    for v in range(len(poses)):
        write_view(out_dir, v, rgba[v], depth_mm_u16(depth[v], unit))
    add_timing(timing, "encode_s", time.perf_counter() - t0)
    return len(poses)
