"""The GigaPose refiner's checkpoint: what scripts/train_refiner.py saves and
refine.py's `refiner_checkpoint=` loads.

One torch.save file, <out_dir>/refiner.pt, holds both nets' state dicts
(BatchNorm running statistics included), their widths and blocks, and the
render size. `load_refiner_checkpoint` reads it with
torch.load(weights_only=True); a width, blocks or render size other than
the refiner's raises, and so does the JAX package's orbax directory
(reading it is ROADMAP A12).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict

import torch

CKPT_NAME = "refiner.pt"
FORMAT = "gigapose_tpu_torch.refiner/1"


def _shape_of(refiner) -> Dict:
    rb, sb = refiner.refiner_net.backbone, refiner.scorer_net.backbone
    return {"refiner_width": rb.width, "refiner_blocks": list(rb.blocks),
            "scorer_width": sb.width, "scorer_blocks": list(sb.blocks),
            "render_size": list(refiner.config.render_size)}


def save_refiner_checkpoint(out_dir: str, refiner) -> str:
    """Write <out_dir>/refiner.pt (both nets' state dicts on the CPU, their
    widths and blocks, the render size) -> its path."""
    os.makedirs(out_dir, exist_ok=True)
    path = osp.join(osp.abspath(out_dir), CKPT_NAME)
    cpu = lambda net: {k: v.detach().cpu() for k, v in net.state_dict().items()}
    torch.save({"format": FORMAT, **_shape_of(refiner), "refiner": cpu(refiner.refiner_net),
                "scorer": cpu(refiner.scorer_net)}, path)
    return path


def _is_orbax(path: str) -> bool:
    """An orbax checkpoint directory, as the JAX package's trainer writes
    (<out_dir>/refiner/ with orbax's metadata files)."""
    if osp.isdir(osp.join(path, "refiner")):
        return True
    return osp.isdir(path) and any(f.startswith(("_METADATA", "_CHECKPOINT_METADATA", "manifest"))
                                   or f in ("checkpoint", "_sharding") for f in os.listdir(path))


def load_refiner_checkpoint(path: str, refiner):
    """Load save_refiner_checkpoint's file (or the directory that holds it)
    into `refiner`'s nets, on their device -> the refiner. A JAX orbax
    directory, or a checkpoint whose widths, blocks or render size differ
    from the refiner's, raises and says why."""
    if osp.isdir(path):
        if osp.isfile(osp.join(path, CKPT_NAME)):
            path = osp.join(path, CKPT_NAME)
        elif _is_orbax(path):
            raise NotImplementedError(
                f"{path} is an orbax checkpoint of the JAX package's trainer: reading it "
                f"is ROADMAP A12; train with gigapose_tpu_torch.scripts.train_refiner")
        else:
            raise FileNotFoundError(f"no {CKPT_NAME} in {path}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or ckpt.get("format") != FORMAT:
        raise ValueError(f"{path} is not a refiner checkpoint of this package ({FORMAT})")
    diff = {k: (ckpt.get(k), v) for k, v in _shape_of(refiner).items() if ckpt.get(k) != v}
    if diff:
        raise ValueError(f"{path} was trained with other nets than this refiner's "
                         f"(checkpoint, refiner): {diff}")
    refiner.refiner_net.load_state_dict(ckpt["refiner"], strict=True)
    refiner.scorer_net.load_state_dict(ckpt["scorer"], strict=True)
    return refiner
