"""The GigaPose refiner's checkpoint: what scripts/train_refiner.py saves and
refine.py's `refiner_checkpoint=` loads.

One torch.save file, <out_dir>/refiner.pt, holds both nets' state dicts
(BatchNorm running statistics included), their widths and blocks, and the
render size. `load_refiner_checkpoint` reads it with
torch.load(weights_only=True); a width, blocks or render size other than
the refiner's raises.

It also reads the JAX package's checkpoint (gigapose_tpu/scripts/
train_refiner.py: <out_dir>/refiner/, an orbax directory of
{"refiner_vars", "scorer_vars"}, each {"params", "batch_stats"}) without
orbax (utils/orbax.py), through models/convert.py's refiner_flax_to_torch.
That directory holds no widths or render size: a net whose parameter
shapes differ from the refiner's raises ValueError naming them, and the
render size is the refiner's own.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict

import torch

from gigapose_tpu_torch.models.convert import refiner_flax_to_torch
from gigapose_tpu_torch.utils import orbax

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


def _orbax_dir(path: str):
    """The JAX trainer's orbax directory at `path` or at <path>/refiner, if any."""
    for p in (path, osp.join(path, "refiner")):
        if orbax.is_checkpoint(p):
            return p
    return None


def _load_jax(path: str, refiner) -> None:
    tree = orbax.read_tree(path)
    if set(tree) != {"refiner_vars", "scorer_vars"}:
        raise ValueError(f"{path} is not a refiner checkpoint of the JAX trainer (its keys: "
                         f"{sorted(tree)})")
    for name, net in (("refiner_vars", refiner.refiner_net), ("scorer_vars", refiner.scorer_net)):
        sd, mine = refiner_flax_to_torch(tree[name]), net.state_dict()
        diff = {k: (tuple(sd[k].shape) if k in sd else None,
                    tuple(mine[k].shape) if k in mine else None)
                for k in set(sd) | set(mine)
                if k not in sd or k not in mine or sd[k].shape != mine[k].shape}
        if diff:
            shown = dict(sorted(diff.items())[:6])
            raise ValueError(f"{path}: {name} was trained with other nets than this refiner's "
                             f"(width or blocks; checkpoint, refiner shapes of {len(diff)} "
                             f"tensors): {shown}")
        net.load_state_dict({k: v.to(mine[k].dtype) for k, v in sd.items()}, strict=True)


def load_refiner_checkpoint(path: str, refiner):
    """Load save_refiner_checkpoint's file (or the directory that holds it),
    or the JAX trainer's orbax checkpoint (its out_dir or <out_dir>/refiner),
    into `refiner`'s nets, on their device -> the refiner. A checkpoint whose
    widths, blocks or (for this module's file) render size differ from the
    refiner's raises ValueError and says why."""
    if osp.isdir(path):
        jax_dir = _orbax_dir(path)
        if osp.isfile(osp.join(path, CKPT_NAME)):
            path = osp.join(path, CKPT_NAME)
        elif jax_dir:
            _load_jax(jax_dir, refiner)
            return refiner
        else:
            raise FileNotFoundError(f"no {CKPT_NAME} and no orbax checkpoint in {path}")
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
