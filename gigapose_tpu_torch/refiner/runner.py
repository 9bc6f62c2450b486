"""Refinement runners -> refined BOP csv (port of gigapose_tpu/refiner/runner.py).

- run_refinement: per image, the coarse hypotheses (top-1 csv or the top-k
  MultiHypothesis csv), refined in chunks of `chunk_size` by any refiner
  with refine_batch(images, K, labels, TCO) -> (TCO, scores)
  (RenderCompareRefiner or MegaposeRefiner), the best hypothesis kept per
  instance with score = (coarse score + pose score) / 2 (the reference's
  refiner.py:124-131);
- run_so3_coarse_refinement: from CNOS detections alone, MegaposeRefiner's
  SO(3)-grid classification (the best grid rotation per detection), then
  its refinement; score = the pose score.

One npz per image, merged into the refined csv. In a multi-process run
(parallel/multihost.py) the images go round-robin to the processes (image
i to process i mod count, counting the images the source yields), process 0
clears the old npz files before anyone writes and merges everyone's after
all are done; the other processes return no path. max_images counts the
images of every process.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from gigapose_tpu_torch.dataloader import bop_io
from gigapose_tpu_torch.parallel import multihost
from gigapose_tpu_torch.utils.logging import get_logger
from gigapose_tpu_torch.utils.timer import Timer

logger = get_logger(__name__)


def find_init_pose_path(pred_dir: str, dataset_name: str, model_name: str, run_id,
                        use_multiple: bool = True) -> str:
    """The coarse csv of a run (ref: refiner_utils.find_init_pose_path)."""
    name = f"{model_name}-pbrreal-rgb-mmodel_{dataset_name}-test_{run_id}"
    path = osp.join(pred_dir, f"{name}{'MultiHypothesis.csv' if use_multiple else '.csv'}")
    if not osp.exists(path):
        raise FileNotFoundError(path)
    return path


def load_hypotheses(init_loc_path: str, min_score: float) -> Dict[str, List[Dict]]:
    """The coarse csv's rows per image key; `instance_id` from its extra
    column, else the row index. Instances whose best hypothesis scores below
    min_score are dropped whole."""
    try:
        locs = bop_io.load_bop_csv(init_loc_path, extra_column="instance_id")
    except ValueError:  # a top-1 csv: 7 columns
        locs = bop_io.load_bop_csv(init_loc_path)
        for i, r in enumerate(locs):
            r["instance_id"] = i
    per_image = bop_io.group_by_image(locs, image_key="im_id")
    for key, rows in per_image.items():
        best: Dict[int, float] = {}
        for r in rows:
            iid = int(r["instance_id"])
            best[iid] = max(best.get(iid, -1e9), r["score"])
        per_image[key] = [r for r in rows if best[int(r["instance_id"])] >= min_score]
    return per_image


def _clear_npz(pred_dir: str) -> None:
    """Stale batches of earlier runs go (the merge globs *.npz): on process 0,
    before any process writes."""
    os.makedirs(pred_dir, exist_ok=True)
    if multihost.is_primary():
        for f in os.listdir(pred_dir):
            if f.endswith(".npz"):
                os.remove(osp.join(pred_dir, f))
    multihost.barrier()


def _merge(pred_dir: str, dataset_name: str, model_name: str, run_id) -> List[str]:
    """The refined csv, merged by process 0 once every process has written
    its npz files; [] on the others."""
    multihost.barrier()
    if not multihost.is_primary():
        return []
    return bop_io.merge_batched_predictions(pred_dir, dataset_name, model_name, run_id,
                                            is_refined=True)


def _mine(batch_id: int) -> bool:
    return batch_id % multihost.process_count() == multihost.process_index()


def _observations(scene_source, keys):
    """The observations of `keys` by random access where the source has an
    index holding every key (only those images are decoded), else the whole
    source in order."""
    index = getattr(scene_source, "key_index", None)
    if hasattr(scene_source, "lookup") and index and all(k in index for k in keys):
        logger.info(f"Random-access refinement over {len(keys)} keys")
        for k in sorted(keys):
            obs = scene_source.lookup(k)
            if obs is not None:
                yield obs
        return
    yield from scene_source


def _refine_chunks(refiner, images, K, labels, TCO, chunk_size: int):
    """refine_batch over chunks of `chunk_size` hypotheses -> (TCO, scores)."""
    refined = np.zeros_like(TCO)
    scores = np.zeros(len(labels), np.float32)
    for s in range(0, len(labels), chunk_size):
        e = min(s + chunk_size, len(labels))
        refined[s:e], scores[s:e] = refiner.refine_batch(images[s:e], K[s:e], labels[s:e],
                                                         TCO[s:e])
    return refined, scores


def run_refinement(refiner, scene_source, init_loc_path: str,
                   save_dir: str, dataset_name: str, model_name: str = "large", run_id="0",
                   chunk_size: int = 8, max_images: Optional[int] = None,
                   min_score: float = 0.25, timing: Optional[Dict] = None) -> List[str]:
    """Refine every image's hypotheses and merge the refined csv; returns
    its paths. A hypothesis whose obj_id has no mesh raises ValueError
    before any image is refined. `timing`, when given, receives the images,
    the hypotheses, the per-image seconds and the run's seconds."""
    locs_per_image = load_hypotheses(init_loc_path, min_score)
    meshes = refiner.meshes.rasterizers
    missing = sorted({int(r["obj_id"]) for rows in locs_per_image.values() for r in rows}
                     - set(meshes))
    if missing:
        dirs = sorted({osp.dirname(r.mesh_path) for r in meshes.values()})
        raise ValueError(f"obj_id {missing[0]} of {init_loc_path} has no mesh in {dirs} "
                         f"(meshes of objects {sorted(meshes)})")

    pred_dir = osp.join(save_dir, "predictions_refined")
    _clear_npz(pred_dir)
    stats = dict(images=0, hypotheses=0, image_s=[])
    timer, run_timer = Timer(), Timer().tic()
    seen = 0  # images with rows, of every process
    for batch_id, obs in enumerate(_observations(scene_source, locs_per_image)):
        rows = locs_per_image.get(obs.key, [])
        if not rows:
            continue
        if max_images is not None and seen >= max_images:
            break
        seen += 1
        if not _mine(batch_id):
            continue
        timer.tic()
        img = obs.rgb.astype(np.float32).transpose(2, 0, 1)[None] / 255.0
        B = len(rows)
        images = np.repeat(img, B, axis=0)
        K = np.tile(obs.K[None], (B, 1, 1)).astype(np.float32)
        labels = np.array([r["obj_id"] for r in rows], np.int32)
        TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        for i, r in enumerate(rows):
            TCO[i, :3, :3] = r["R"]
            TCO[i, :3, 3] = np.asarray(r["t"]).reshape(3) / 1000.0  # mm -> m
        refined, pose_scores = _refine_chunks(refiner, images, K, labels, TCO, chunk_size)
        elapsed = timer.toc()  # refine_batch returns host arrays: the work is done
        stats["images"] += 1
        stats["hypotheses"] += B
        stats["image_s"].append(elapsed)

        # the best hypothesis per instance; score = mean of the coarse
        # matching score and the pose score (refiner.py:124-131)
        by_instance: Dict[int, List[int]] = {}
        for i, r in enumerate(rows):
            by_instance.setdefault(int(r["instance_id"]), []).append(i)
        sel, scores = [], []
        for idxs in by_instance.values():
            best = max(idxs, key=lambda i: float(pose_scores[i]))
            sel.append(best)
            scores.append((rows[best]["score"] + float(pose_scores[best])) / 2)
        sel = np.asarray(sel)
        poses_mm = refined[sel].copy()
        poses_mm[:, :3, 3] *= 1000.0  # m -> mm for the BOP csv
        np.savez(
            osp.join(pred_dir, f"{batch_id:06d}.npz"),
            scene_id=np.full(len(sel), obs.scene_id, np.int32),
            im_id=np.full(len(sel), obs.im_id, np.int32),
            object_id=labels[sel],
            poses=poses_mm,
            scores=np.asarray(scores),
            time=np.array([rows[i]["time"] for i in sel]),
            refinement_time=np.full(len(sel), elapsed),
        )
    stats["run_s"] = run_timer.toc()
    if timing is not None:
        timing.update(stats)
    logger.info(f"Refined {stats['images']} images")
    return _merge(pred_dir, dataset_name, model_name, run_id)


def run_so3_coarse_refinement(refiner, scene_source, root_dir: str, save_dir: str,
                              dataset_name: str, model_name: str = "large", run_id="0",
                              grid_size: int = 576, chunk_size: int = 8,
                              max_images: Optional[int] = None, max_dets_per_image: int = 16,
                              timing: Optional[Dict] = None) -> List[str]:
    """The detections-only pipeline (the reference's forward_coarse_model
    path): per image its CNOS detections (the `max_dets_per_image` best),
    every rotation of the `grid_size`-point SO(3) grid scored per detection
    by `refiner.classify_coarse` (a MegaposeRefiner), the best one refined;
    one row per detection with the pose score. `timing`, when given,
    receives the images, the detections, the per-image seconds and the
    run's seconds."""
    _, dets_per_image = bop_io.load_cnos_detections(root_dir, dataset_name,
                                                    test_setting="detection")
    pred_dir = osp.join(save_dir, "predictions_refined")
    _clear_npz(pred_dir)
    stats = dict(images=0, detections=0, image_s=[])
    timer, run_timer = Timer(), Timer().tic()
    seen = 0  # images with detections, of every process
    for batch_id, obs in enumerate(_observations(scene_source, dets_per_image)):
        dets = dets_per_image.get(obs.key, [])
        if not dets:
            continue
        if max_images is not None and seen >= max_images:
            break
        seen += 1
        if not _mine(batch_id):
            continue
        dets = sorted(dets, key=lambda d: -d.get("score", 0.0))[:max_dets_per_image]
        timer.tic()
        img = obs.rgb.astype(np.float32).transpose(2, 0, 1)[None] / 255.0
        B = len(dets)
        images = np.repeat(img, B, axis=0)
        K = np.tile(obs.K[None], (B, 1, 1)).astype(np.float32)
        labels = np.array([int(d.get("category_id", d.get("obj_id"))) for d in dets], np.int32)
        boxes = np.zeros((B, 4), np.float32)  # COCO xywh -> xyxy
        for i, d in enumerate(dets):
            x, y, w, h = d["bbox"]
            boxes[i] = (x, y, x + w, y + h)
        TCO_init, _ = refiner.classify_coarse(images, K, labels, boxes, top_k=1,
                                              grid_size=grid_size)
        refined, pose_scores = _refine_chunks(refiner, images, K, labels, TCO_init[:, 0],
                                              chunk_size)
        elapsed = timer.toc()
        stats["images"] += 1
        stats["detections"] += B
        stats["image_s"].append(elapsed)
        poses_mm = refined.copy()
        poses_mm[:, :3, 3] *= 1000.0
        np.savez(
            osp.join(pred_dir, f"{batch_id:06d}.npz"),
            scene_id=np.full(B, obs.scene_id, np.int32),
            im_id=np.full(B, obs.im_id, np.int32),
            object_id=labels,
            poses=poses_mm,
            scores=pose_scores,
            time=np.full(B, float(dets[0].get("time", 0.0))),
            refinement_time=np.full(B, elapsed),
        )
    stats["run_s"] = run_timer.toc()
    if timing is not None:
        timing.update(stats)
    logger.info(f"SO(3)-grid ({grid_size}) classified and refined {stats['images']} images")
    return _merge(pred_dir, dataset_name, model_name, run_id)
