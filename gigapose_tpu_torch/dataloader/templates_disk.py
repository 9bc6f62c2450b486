"""Disk loader for pre-rendered template sets (port of
gigapose_tpu/dataloader/templates_disk.py, PNGs read by dataloader/png.py).

Layout (ref: TemplateDataset.from_config, src/custom_megapose/
template_dataset.py:225-246 and configs/data/bop.yaml):

    <dir>/<dataset>/<obj_id:06d>/<view:06d>.png        RGBA renders
    <dir>/<dataset>/<obj_id:06d>/<view:06d>_depth.png  uint16 depth (mm)
    <dir>/<dataset>/object_poses/<obj_id:06d>.npy      (V, 4, 4) object poses

Poses are multiplied by scale_factor (GSO=10, BOP=1 — the reference's
ScaleTransform TWO_init). A per-object preprocessed .npz cache mirrors
template_dataset.py:85-120.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from gigapose_tpu_torch.dataloader.png import decode_png, to_rgba
from gigapose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def save_npz_atomic(path: str, **arrays) -> None:
    """np.savez into a temporary file beside `path`, then an atomic rename:
    a reader never finds a partly written cache."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if osp.exists(tmp):
            os.remove(tmp)


def list_objects(template_dir: str) -> List[int]:
    """Object ids available under a dataset's template dir."""
    return sorted(
        int(d) for d in os.listdir(template_dir)
        if d.isdigit() and osp.isdir(osp.join(template_dir, d))
    )


def load_object_templates(
    template_dir: str,
    obj_id: int,
    num_templates: Optional[int] = None,
    scale_factor: float = 1.0,
    load_depth: bool = False,
    use_cache: bool = True,
    as_uint8: bool = False,
) -> Dict[str, np.ndarray]:
    """Load one object's templates: rgba (V, 4, H, W) in [0,1] (or raw uint8
    with as_uint8 — 4x less host->device traffic for onboarding; the device
    prep divides by 255), poses (V, 4, 4) with translations scaled by
    scale_factor, optional depth (V, H, W) mm."""
    obj_dir = osp.join(template_dir, f"{obj_id:06d}")
    cache = osp.join(template_dir, "preprocessed", f"{obj_id:06d}.npz")
    pose_path = osp.join(template_dir, "object_poses", f"{obj_id:06d}.npy")
    poses = np.load(pose_path).astype(np.float64)
    if scale_factor != 1.0:
        poses[:, :3, 3] *= scale_factor
    V = num_templates or len(poses)

    def to_dtype(rgba):
        if as_uint8 and rgba.dtype != np.uint8:
            return np.clip(rgba * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if not as_uint8 and rgba.dtype == np.uint8:
            return rgba.astype(np.float32) / 255.0
        return rgba

    if use_cache and osp.exists(cache):
        with np.load(cache) as data:
            out = {"rgba": to_dtype(data["rgba"]), "poses": poses[:V]}
            if load_depth and "depth" in data:
                out["depth"] = data["depth"]
        return out

    rgbas, depths = [], []
    for v in range(V):
        rgbas.append(to_rgba(_read_png(osp.join(obj_dir, f"{v:06d}.png"))))
        if load_depth:
            dp = osp.join(obj_dir, f"{v:06d}_depth.png")
            depths.append(np.asarray(_read_png(dp), np.float32))
    rgba = np.stack(rgbas).transpose(0, 3, 1, 2)  # (V, 4, H, W) uint8
    out = {"rgba": to_dtype(rgba), "poses": poses[:V]}
    if load_depth:
        out["depth"] = np.stack(depths)
    if use_cache:
        os.makedirs(osp.dirname(cache), exist_ok=True)
        # cache stays uint8 (4x smaller; loads re-cast per caller)
        save_npz_atomic(cache, rgba=rgba, **({"depth": out["depth"]} if load_depth else {}))
    return out
