"""Template-rendering CLI of the port: CAD models -> icosphere template sets
on disk (port of gigapose_tpu/scripts/render_templates.py, same overrides).

Usage:
    python -m gigapose_tpu_torch.scripts.render_templates \
        cad_dir=<models dir> out_dir=<templates/ds> [level=1] [radius_factor=0.4] \
        [num_workers=1] [renderer=native|device] [device=cpu]

Writes, for every .ply / .obj of cad_dir (the object id is the digits of
the file name):

    <out>/<obj:06d>/{view:06d}.png + {view:06d}_depth.png   (RGBA, uint16 mm)
    <out>/object_poses/<obj:06d>.npy                         ((V, 4, 4), mm)

and checks that each object's directory holds 2 x V PNGs.

`renderer=native` (the default) renders on the host C++ rasterizer
(render/rasterizer.py); with num_workers > 1 the objects go to a pool of
`spawn` processes, which never inherit a CUDA context the caller may hold.
`renderer=device` renders each object's whole view stack through the
rasterizer kernel (render/templates.py), on cuda:0 unless `device=` names
another device; it renders in this process, one object after another,
whatever num_workers is: a forked worker cannot use the parent's CUDA
context, and each object's stack already fills the card in one or a few
launches. `renderer=jax` (the JAX package's device renderer) raises and
names `device`.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import os.path as osp
import sys
from typing import Dict, List, Optional

import numpy as np

KEYS = ("cad_dir", "out_dir", "level", "radius_factor", "num_workers", "renderer", "device")


def render_one(args):
    """One object: (cad_path, out_dir, level, radius_factor, renderer,
    device) -> (its directory's name, its number of views)."""
    cad_path, out_dir, level, radius_factor, renderer, device = args
    if renderer == "device":
        from gigapose_tpu_torch.render.templates import render_template_views_device

        n = render_template_views_device(cad_path, out_dir, level=level,
                                         radius_factor=radius_factor, device=device)
    else:
        from gigapose_tpu_torch.render.rasterizer import render_template_views

        n = render_template_views(cad_path, out_dir, level=level, radius_factor=radius_factor)
    n_png = len([f for f in os.listdir(out_dir) if f.endswith(".png")])
    if n_png != 2 * n:
        raise RuntimeError(f"{out_dir}: expected {2 * n} files, found {n_png}")
    return osp.basename(out_dir), n


def main(argv: Optional[List[str]] = None) -> Dict[str, int]:
    """Render every mesh of cad_dir -> {object directory: views}."""
    from gigapose_tpu_torch.render.templates import template_poses

    overrides = dict(o.split("=", 1) for o in (argv if argv is not None else sys.argv[1:]))
    unknown = sorted(set(overrides) - set(KEYS))
    if unknown:
        raise ValueError(f"render_templates reads no option {', '.join(unknown)}")
    cad_dir, out_dir = overrides["cad_dir"], overrides["out_dir"]
    level = int(overrides.get("level", 1))
    radius_factor = float(overrides.get("radius_factor", 0.4))
    num_workers = int(overrides.get("num_workers", 1))
    renderer = overrides.get("renderer", "native")
    if renderer == "jax":
        raise ValueError("renderer=jax is the JAX package's renderer; the port renders on the card "
                         "with renderer=device")
    if renderer not in ("native", "device"):
        raise ValueError(f"renderer must be native or device, not {renderer!r}")
    device = overrides.get("device")
    if renderer == "device":
        from gigapose_tpu_torch.utils.device import resolve_device

        device = str(resolve_device(device, "renderer=device", "device=cpu"))

    meshes = sorted(f for f in os.listdir(cad_dir) if f.endswith((".ply", ".obj")))
    os.makedirs(osp.join(out_dir, "object_poses"), exist_ok=True)
    poses = template_poses(level, radius_factor)
    jobs = []
    for mesh in meshes:
        stem = osp.splitext(mesh)[0]  # e.g. obj_000001
        obj_id = int("".join(c for c in stem if c.isdigit()) or 0)
        np.save(osp.join(out_dir, "object_poses", f"{obj_id:06d}.npy"), poses)
        jobs.append((osp.join(cad_dir, mesh), osp.join(out_dir, f"{obj_id:06d}"), level,
                     radius_factor, renderer, device))

    done = {}
    if renderer == "native" and num_workers > 1:
        from gigapose_tpu_torch.render.rasterizer import _library

        _library()  # built once here, loaded by the workers
        with mp.get_context("spawn").Pool(num_workers) as pool:
            for name, n in pool.imap_unordered(render_one, jobs):
                done[name] = n
                print(f"rendered {name}: {n} views")
    else:
        if renderer == "device" and num_workers > 1:
            print("renderer=device renders in this process; num_workers is not used")
        for job in jobs:
            name, n = render_one(job)
            done[name] = n
            print(f"rendered {name}: {n} views")
    print(f"done: {len(jobs)} objects -> {out_dir}")
    return done


if __name__ == "__main__":
    main()
