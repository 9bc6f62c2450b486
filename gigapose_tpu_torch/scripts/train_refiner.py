"""Refiner training CLI: CAD models -> trained refiner and scorer weights
(port of gigapose_tpu/scripts/train_refiner.py).

Render-and-perturb training (refiner/training.py) over the meshes of a
models directory, saved as one torch.save file that the refine CLI loads
with `refiner_checkpoint=<file or its directory>`.

Usage:
    python -m gigapose_tpu_torch.scripts.train_refiner cad_dir=<models> \\
        out_dir=<dir> [steps=2000] [batch_size=8] [lr=3e-4] [render=160] \\
        [width=64] [scorer_width=32] [curriculum=true] [rot_deg=10] [device=cpu]

It trains on cuda:0 unless `device=` names another device; with no card and
no device it raises. curriculum=true (the default) anneals the perturbation
range from 1x to 0.25x over the steps; curriculum=false keeps the full range.
An unknown key raises.

The checkpoint is refiner/checkpoint.py's <out_dir>/refiner.pt: both nets'
state dicts (BatchNorm running statistics included), their widths and
blocks, and the render size.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from gigapose_tpu_torch.pipeline.templates import TEMPLATE_K
from gigapose_tpu_torch.refine import mesh_paths_of
from gigapose_tpu_torch.refiner.checkpoint import save_refiner_checkpoint
from gigapose_tpu_torch.refiner.refiner import RefinerConfig, RenderCompareRefiner
from gigapose_tpu_torch.refiner.training import PerturbConfig, train_refiner

KEYS = ("cad_dir", "out_dir", "steps", "batch_size", "lr", "render", "width", "scorer_width",
        "curriculum", "rot_deg", "device")


def main(argv=None, timing: Optional[dict] = None):
    """Train on `argv`'s key=value pairs (default sys.argv[1:]) and save ->
    the refiner. `timing`, a dict, is train_refiner's (its host split and
    each step's seconds)."""
    args = list(argv if argv is not None else sys.argv[1:])
    kv = dict(a.split("=", 1) for a in args)
    unknown = sorted(set(kv) - set(KEYS))
    if unknown:
        raise ValueError(f"unknown keys {unknown}; the keys are {', '.join(KEYS)}")
    render = int(kv.get("render", 160))
    device: Optional[str] = kv.get("device")
    refiner = RenderCompareRefiner.create(
        mesh_paths_of(kv["cad_dir"]), config=RefinerConfig(render_size=(render, render)),
        refiner_width=int(kv.get("width", 64)), scorer_width=int(kv.get("scorer_width", 32)),
        device=device)
    base = PerturbConfig(rot_deg=float(kv.get("rot_deg", 10.0)))
    final = PerturbConfig(rot_deg=base.rot_deg / 4, trans_xy=base.trans_xy / 4,
                          trans_z=base.trans_z / 4)
    try:
        train_refiner(refiner, np.asarray(TEMPLATE_K), steps=int(kv.get("steps", 2000)),
                      batch_size=int(kv.get("batch_size", 8)), lr=float(kv.get("lr", 3e-4)),
                      perturb=base,
                      final_perturb=final if kv.get("curriculum", "true").lower() == "true"
                      else None, timing=timing)
    finally:
        refiner.meshes.close()
    path = save_refiner_checkpoint(kv["out_dir"], refiner)
    print(f"saved refiner checkpoint to {path}")
    return refiner


if __name__ == "__main__":
    main()
