"""Refinement CLI of the port (port of refine.py; same override surface).

Usage:
    python -m gigapose_tpu_torch.refine test_dataset_name=lmo run_id=0 \
        [use_multiple=true] [refine_renderer=host|device] [device=cpu] ...
    python -m gigapose_tpu_torch.refine ... refiner_type=megapose \
        [megapose_refiner_ckpt=...] [megapose_coarse_ckpt=...] [n_rendered_views=1]
    python -m gigapose_tpu_torch.refine ... coarse_mode=so3grid [so3_grid_size=576]

With the default coarse_mode=csv it finds the coarse csv written by the
coarse CLI (the MultiHypothesis csv with use_multiple, else the top-1 csv;
or init_loc_path) and refines and scores every hypothesis; with
coarse_mode=so3grid it starts from the dataset's CNOS detections, scores
every rotation of the SO(3) grid per detection with MegaPose's coarse model
and refines the best. The CAD models are read from
<root>/datasets/<ds>/models (models_cad for tless); the refined csv goes
under <save_dir>/predictions_refined/.

The refiner: RenderCompareRefiner (the GigaPose nets), or MegaposeRefiner
(the released MegaPose checkpoints' architecture: WideResNet-34, 240x320
renders with normals, 500 points) when refiner_type=megapose,
coarse_mode=so3grid or a megapose_*_ckpt is given; a missing checkpoint
leaves its net seeded random.

It runs on cuda:0 unless `device=` names another device (the tests pass
`device=cpu`); with no card and no device it raises. Options beside the
`test` config: n_refine_iterations (5), refine_renderer (GigaPose refiner
only; host: the C++ raster on the host; device: the CUDA rasterizer, the
loop on the card; the MegaPose refiner renders on the host and refuses
device), refine_pipeline_chunks (1, as refine.py: the host loop refines the
whole batch in one chunk), min_score (0.25, csv mode), init_loc_path,
max_images, n_rendered_views (1), so3_grid_size (576). Without a
checkpoint the nets are seeded random with the pose head the identity
update (as JAX initialises the GigaPose head; its MegaPose head is drawn
random), so an untrained refiner returns its init poses.
`GIGAPOSE_TINY=1` builds refine.py's tiny nets: GigaPose widths 8 / 8, 64x64
renders, 8 crop points; MegaPose width 0.125, 60x80 renders, 8 points.

refiner_checkpoint= loads the GigaPose refiner's and scorer's weights from
the file (or its directory) that `python -m
gigapose_tpu_torch.scripts.train_refiner` saves; its widths and render size
must be those of the refiner built here (full width, or GIGAPOSE_TINY's),
and with the MegaPose refiner it raises (that refiner reads
megapose_*_ckpt). Refused, with the ROADMAP item to look up: a JAX orbax
refiner checkpoint (A12); refine_pipeline_chunks above 1, the pipelined host
loop (A13c).

Several processes (parallel/multihost.py's launch contract, as the coarse
CLI) split the images round-robin, one card each; process 0 writes the csv
and the others return no path.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Tuple

from gigapose_tpu_torch.cli import device_of, load_cli_config
from gigapose_tpu_torch.dataloader.scene import DirSceneSource, TarSceneSource
from gigapose_tpu_torch.parallel import multihost
from gigapose_tpu_torch.refiner.checkpoint import load_refiner_checkpoint
from gigapose_tpu_torch.refiner.megapose_refiner import MegaposeRefiner, MegaposeRefinerConfig
from gigapose_tpu_torch.refiner.refiner import RefinerConfig, RenderCompareRefiner
from gigapose_tpu_torch.refiner.runner import (
    find_init_pose_path,
    run_refinement,
    run_so3_coarse_refinement,
)
from gigapose_tpu_torch.utils.config import Config

OPTIONAL_KEYS = ("device", "max_images", "n_refine_iterations", "refine_renderer",
                 "refine_pipeline_chunks", "min_score", "init_loc_path", "refiner_checkpoint",
                 "megapose_refiner_ckpt", "megapose_coarse_ckpt", "refiner_type", "coarse_mode",
                 "n_rendered_views", "so3_grid_size")


def mesh_paths_of(cad_dir: str) -> Dict[int, str]:
    """{obj_id: path} of the .ply / .obj files of a BOP models directory;
    the id is the digits of the file name."""
    paths = {}
    for f in sorted(os.listdir(cad_dir)):
        if f.endswith((".ply", ".obj")):
            obj_id = int("".join(c for c in osp.splitext(f)[0] if c.isdigit()) or 0)
            paths[obj_id] = osp.join(cad_dir, f)
    return paths


def build_refiner(cfg: Config, mesh_paths: Dict[int, str], tiny: bool = False
                  ) -> RenderCompareRefiner:
    """The refiner refine.py builds: full width (RefinerNet 64, scorer 32,
    160x160, 500 points) or with `tiny` its smoke size; seeded random nets."""
    rcfg = RefinerConfig(
        n_iterations=int(cfg.get("n_refine_iterations") or 5),
        render_size=(64, 64) if tiny else (160, 160),
        n_sample_points=8 if tiny else 500,
        renderer=str(cfg.get("refine_renderer") or "host"),
    )
    return RenderCompareRefiner.create(mesh_paths, config=rcfg,
                                       refiner_width=8 if tiny else 64,
                                       scorer_width=8 if tiny else 32, device=device_of(cfg))


def build_megapose_refiner(cfg: Config, mesh_paths: Dict[int, str], tiny: bool = False
                           ) -> MegaposeRefiner:
    """The MegaPose refiner refine.py builds: the released architecture
    (WideResNet-34 width 1.0, 240x320, 500 points) or with `tiny` its smoke
    size (width 0.125, 60x80, 8 points), from megapose_refiner_ckpt /
    megapose_coarse_ckpt where given, else seeded random."""
    mcfg = MegaposeRefinerConfig(
        n_iterations=int(cfg.get("n_refine_iterations") or 5),
        render_size=(60, 80) if tiny else (240, 320),
        n_sample_points=8 if tiny else 500,
        n_rendered_views=int(cfg.get("n_rendered_views") or 1),
    )
    ckpt = lambda key: str(cfg.get(key)) if cfg.get(key) else None
    return MegaposeRefiner.from_checkpoints(
        ckpt("megapose_refiner_ckpt"), ckpt("megapose_coarse_ckpt"), mesh_paths, config=mcfg,
        width=0.125 if tiny else 1.0, device=device_of(cfg))


def main(argv=None) -> Tuple[List[str], Dict]:
    """Run the CLI on `argv` (default sys.argv[1:]) -> (the refined csv
    paths, the run's timing: images, hypotheses (csv mode) or detections
    (so3grid), seconds per image, run seconds; this process's)."""
    multihost.maybe_initialize()  # before any CUDA call
    cfg = load_cli_config(argv, OPTIONAL_KEYS)
    ds = cfg.test_dataset_name
    if not ds:
        raise ValueError("test_dataset_name=... is required")
    coarse_mode = str(cfg.get("coarse_mode") or "csv")
    if coarse_mode not in ("csv", "so3grid"):
        raise ValueError(f"coarse_mode must be csv or so3grid, not {coarse_mode!r}")
    if int(cfg.get("refine_pipeline_chunks") or 1) > 1:
        raise NotImplementedError("refine_pipeline_chunks > 1: the pipelined host loop is "
                                  "ROADMAP A13c")
    megapose = bool(cfg.get("megapose_refiner_ckpt") or cfg.get("megapose_coarse_ckpt")
                    or cfg.get("refiner_type") == "megapose" or coarse_mode == "so3grid")
    if megapose and str(cfg.get("refine_renderer") or "host") != "host":
        raise ValueError("refine_renderer: the MegaPose refiner renders on the host only")
    if megapose and cfg.get("refiner_checkpoint"):
        raise ValueError("refiner_checkpoint holds the GigaPose refiner's weights; the MegaPose "
                         "refiner reads megapose_refiner_ckpt / megapose_coarse_ckpt")

    root = osp.join(cfg.machine.root_dir, "datasets")
    save_dir = cfg.get("save_dir") or osp.join(
        cfg.machine.root_dir, "results", f"{cfg.model.model_name}_{cfg.run_id}")
    init_path = None
    if coarse_mode == "csv":
        init_path = cfg.get("init_loc_path") or find_init_pose_path(
            osp.join(save_dir, "predictions"), ds, cfg.model.model_name, cfg.run_id,
            use_multiple=bool(cfg.use_multiple))
    cad_dir = osp.join(root, ds, "models_cad" if ds == "tless" else "models")
    tiny = bool(int(os.environ.get("GIGAPOSE_TINY", "0")))
    build = build_megapose_refiner if megapose else build_refiner
    refiner = build(cfg, mesh_paths_of(cad_dir), tiny=tiny)

    split_dir = osp.join(root, ds, "test")
    has_tar = osp.isdir(split_dir) and any(f.endswith(".tar") for f in os.listdir(split_dir))
    source = (TarSceneSource(split_dir, depth_scale=cfg.data.depth_scale, load_depth=False)
              if has_tar else DirSceneSource(split_dir, load_depth=False, load_masks=False))
    timing: Dict = {}
    common = dict(save_dir=save_dir, dataset_name=ds, model_name=cfg.model.model_name,
                  run_id=cfg.run_id, max_images=cfg.get("max_images"), timing=timing)
    try:
        if cfg.get("refiner_checkpoint"):
            load_refiner_checkpoint(str(cfg.refiner_checkpoint), refiner)
        if coarse_mode == "so3grid":
            paths = run_so3_coarse_refinement(
                refiner, source, root_dir=root, grid_size=int(cfg.get("so3_grid_size") or 576),
                **common)
        else:
            paths = run_refinement(
                refiner, source, init_path,
                min_score=cfg["min_score"] if "min_score" in cfg else 0.25, **common)
    finally:
        refiner.meshes.close()
    if paths:  # process 0 merges
        print("Wrote:", *paths, sep="\n  ")
    return paths, timing


if __name__ == "__main__":
    main()
