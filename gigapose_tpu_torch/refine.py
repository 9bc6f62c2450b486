"""Refinement CLI of the port (port of refine.py, the render-and-compare
branch; same override surface).

Usage:
    python -m gigapose_tpu_torch.refine test_dataset_name=lmo run_id=0 \
        [use_multiple=true] [refine_renderer=host|device] [device=cpu] ...

Finds the coarse csv written by the coarse CLI (the MultiHypothesis csv with
use_multiple, else the top-1 csv; or init_loc_path), loads the CAD models of
<root>/datasets/<ds>/models (models_cad for tless), refines and scores every
hypothesis with RenderCompareRefiner, and writes the refined csv under
<save_dir>/predictions_refined/.

It runs on cuda:0 unless `device=` names another device (the tests pass
`device=cpu`); with no card and no device it raises. Options beside the
`test` config: n_refine_iterations (5), refine_renderer (host: the C++
raster on the host; device: the CUDA rasterizer, the loop on the card),
refine_pipeline_chunks (1, as refine.py: the host loop refines the whole
batch in one chunk), min_score (0.25), init_loc_path, max_images. Without
a checkpoint the nets are seeded random with the pose head as JAX
initialises it (the identity update).
`GIGAPOSE_TINY=1` builds refine.py's tiny nets: widths 8 / 8, 64x64 renders,
8 crop points.

Refused, with the ROADMAP item to look up: refiner_checkpoint (orbax, A12);
megapose_refiner_ckpt, megapose_coarse_ckpt, refiner_type=megapose and
coarse_mode=so3grid (A13b); refine_pipeline_chunks above 1, the pipelined
host loop (A13c); multi-process runs (A14).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Tuple

from gigapose_tpu_torch.cli import device_of, load_cli_config
from gigapose_tpu_torch.dataloader.scene import DirSceneSource, TarSceneSource
from gigapose_tpu_torch.refiner.refiner import RefinerConfig, RenderCompareRefiner
from gigapose_tpu_torch.refiner.runner import find_init_pose_path, run_refinement
from gigapose_tpu_torch.utils.config import Config

OPTIONAL_KEYS = ("device", "max_images", "n_refine_iterations", "refine_renderer",
                 "refine_pipeline_chunks", "min_score", "init_loc_path", "refiner_checkpoint",
                 "megapose_refiner_ckpt", "megapose_coarse_ckpt", "refiner_type", "coarse_mode")


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


def main(argv=None) -> Tuple[List[str], Dict]:
    """Run the CLI on `argv` (default sys.argv[1:]) -> (the refined csv
    paths, the run's timing: images, hypotheses, seconds per image, run
    seconds)."""
    cfg = load_cli_config(argv, OPTIONAL_KEYS)
    ds = cfg.test_dataset_name
    if not ds:
        raise ValueError("test_dataset_name=... is required")
    if cfg.get("refiner_checkpoint"):
        raise NotImplementedError("refiner_checkpoint: loading an orbax refiner checkpoint "
                                  "is ROADMAP A12")
    coarse_mode = str(cfg.get("coarse_mode") or "csv")
    if (cfg.get("megapose_refiner_ckpt") or cfg.get("megapose_coarse_ckpt")
            or cfg.get("refiner_type") == "megapose" or coarse_mode == "so3grid"):
        raise NotImplementedError("the megapose refiner and coarse_mode=so3grid are ROADMAP A13b")
    if coarse_mode != "csv":
        raise ValueError(f"coarse_mode must be csv or so3grid, not {coarse_mode!r}")
    if int(cfg.get("refine_pipeline_chunks") or 1) > 1:
        raise NotImplementedError("refine_pipeline_chunks > 1: the pipelined host loop is "
                                  "ROADMAP A13c")

    root = osp.join(cfg.machine.root_dir, "datasets")
    save_dir = cfg.get("save_dir") or osp.join(
        cfg.machine.root_dir, "results", f"{cfg.model.model_name}_{cfg.run_id}")
    init_path = cfg.get("init_loc_path") or find_init_pose_path(
        osp.join(save_dir, "predictions"), ds, cfg.model.model_name, cfg.run_id,
        use_multiple=bool(cfg.use_multiple))
    cad_dir = osp.join(root, ds, "models_cad" if ds == "tless" else "models")
    refiner = build_refiner(cfg, mesh_paths_of(cad_dir),
                            tiny=bool(int(os.environ.get("GIGAPOSE_TINY", "0"))))

    split_dir = osp.join(root, ds, "test")
    has_tar = osp.isdir(split_dir) and any(f.endswith(".tar") for f in os.listdir(split_dir))
    source = (TarSceneSource(split_dir, depth_scale=cfg.data.depth_scale, load_depth=False)
              if has_tar else DirSceneSource(split_dir, load_depth=False, load_masks=False))
    timing: Dict = {}
    try:
        paths = run_refinement(
            refiner, source, init_path, save_dir=save_dir, dataset_name=ds,
            model_name=cfg.model.model_name, run_id=cfg.run_id,
            max_images=cfg.get("max_images"),
            min_score=cfg["min_score"] if "min_score" in cfg else 0.25, timing=timing)
    finally:
        refiner.meshes.close()
    print("Wrote:", *paths, sep="\n  ")
    return paths, timing


if __name__ == "__main__":
    main()
