"""Device mesh pack and batched renders for the refine loop (port of
gigapose_tpu/refiner/device_render.py).

Meshes are packed once into fixed-shape tensors on the device: faces padded
to a common multiple of 64 with (0, 0, 0) rows (zero area, never win a
pixel; the JAX package's pack at its default chunk), vertices padded by
repeating each mesh's last vertex, and pre-scaled to metres
(MeshStore.unit_to_m) so the loop's metric poses apply directly.
`render_rgb` rasterizes a batch of hypotheses with render/rasterize.py: the
CUDA kernel on the card, its plain version on the CPU. Packing to the
largest face count makes small meshes pay the largest mesh's raster cost.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gigapose_tpu_torch.render.mesh_io import load_mesh
from gigapose_tpu_torch.render.rasterize import PLAIN_CHUNK, rasterize


@dataclasses.dataclass(frozen=True)
class DeviceMeshes:
    """Stacked fixed-shape mesh tensors, one row per label."""

    verts: torch.Tensor  # (L, Vmax, 3) f32, metres
    faces: torch.Tensor  # (L, Fmax, 3) i32, padded rows (0, 0, 0)
    colors: torch.Tensor  # (L, Vmax, 3) f32 albedo in [0, 255]
    label_to_row: Dict[int, int]  # host-side label -> row index

    def rows_for(self, labels: np.ndarray) -> np.ndarray:
        return np.asarray([self.label_to_row[int(l)] for l in labels], np.int64)


def decimate_vertex_clustering(verts: np.ndarray, faces: np.ndarray, colors: np.ndarray,
                               max_faces: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic grid vertex-clustering decimation to <= max_faces: the
    vertices snap to the finest uniform grid whose cluster mesh fits the
    budget (positions and colours averaged per cluster, degenerate faces
    dropped; Rossignac & Borrel '93), the JAX package's grid sequence."""
    if len(faces) <= max_faces:
        return verts, faces, colors
    lo = verts.min(0)
    extent = float((verts.max(0) - lo).max()) + 1e-12
    for cells in (512, 384, 256, 192, 128, 96, 64, 48, 32, 24, 16, 12, 8, 6, 4):
        size = extent / cells
        key = np.floor((verts - lo) / size).astype(np.int64)
        _, inv = np.unique(key, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        nf = inv[faces]
        good = (nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2]) & (nf[:, 0] != nf[:, 2])
        nf = nf[good]
        if len(nf) <= max_faces:
            n = int(inv.max()) + 1
            nv = np.zeros((n, 3), np.float64)
            nc = np.zeros((n, 3), np.float64)
            cnt = np.zeros(n, np.float64)
            np.add.at(nv, inv, verts)
            np.add.at(nc, inv, colors)
            np.add.at(cnt, inv, 1.0)
            nv /= cnt[:, None]
            nc /= cnt[:, None]
            return nv.astype(np.float32), nf.astype(np.int32), nc.astype(np.float32)
    raise ValueError(f"vertex clustering cannot reach {max_faces} faces")


def build_device_meshes(mesh_paths: Dict[int, str], unit_to_m: Dict[int, float],
                        device: torch.device, max_faces: Optional[int] = None) -> DeviceMeshes:
    """Load, decimate (max_faces), scale, pad and stack every mesh into one
    pack on `device`. The host rasterizer always renders the exact mesh."""
    loaded = {}
    for label, path in mesh_paths.items():
        verts, faces, colors = load_mesh(path)
        verts = verts.astype(np.float32) * np.float32(unit_to_m[label])
        if colors is None:
            colors = np.full((len(verts), 3), 200, np.uint8)  # grey default
        colors = colors.astype(np.float32)
        faces = faces.astype(np.int32)
        if max_faces is not None:
            verts, faces, colors = decimate_vertex_clustering(verts, faces, colors, max_faces)
        if len(faces) and (faces.min() < 0 or faces.max() >= len(verts)):
            raise ValueError(f"{path}: a face indexes a vertex outside 0..{len(verts) - 1}")
        loaded[label] = (verts, faces, colors)
    v_max = max(len(v) for v, _, _ in loaded.values())
    f_max = max(len(f) for _, f, _ in loaded.values())
    f_max += (-f_max) % PLAIN_CHUNK
    labels = sorted(loaded)
    V, F, C = [], [], []
    for label in labels:
        verts, faces, colors = loaded[label]
        vpad = v_max - len(verts)
        if vpad:
            verts = np.concatenate([verts, np.repeat(verts[-1:], vpad, 0)])
            colors = np.concatenate([colors, np.repeat(colors[-1:], vpad, 0)])
        fpad = f_max - len(faces)
        if fpad:
            faces = np.concatenate([faces, np.zeros((fpad, 3), np.int32)])
        V.append(verts)
        F.append(faces)
        C.append(colors)
    put = lambda xs: torch.from_numpy(np.stack(xs)).to(device)
    return DeviceMeshes(verts=put(V), faces=put(F), colors=put(C),
                        label_to_row={label: i for i, label in enumerate(labels)})


def as_f01(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> f32 [0, 1] on x's device, as u8 / 255 in true
    division (a 0-d device tensor divisor, filled on the device: torch
    computes `tensor / number` on the card as a product with the rounded
    reciprocal), so the host renders uploaded as uint8 equal numpy's f32
    conversion."""
    return x.to(torch.float32) / torch.full((), 255.0, device=x.device)


def render_rgb(verts: torch.Tensor, faces: torch.Tensor, colors: torch.Tensor, K: torch.Tensor,
               TCO: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """A batch of renders -> (B, 3, H, W) f32 in [0, 1]: the host path's
    uint8-quantized rgb contract (MeshStore.render_batch)."""
    H, W = size
    out = rasterize(verts, faces, colors, K.contiguous(), TCO.contiguous(), H, W)
    return as_f01(out["rgba"][..., :3].permute(0, 3, 1, 2))
