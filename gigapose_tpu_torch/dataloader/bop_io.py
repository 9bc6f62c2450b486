"""BOP-protocol I/O: detections, test targets, result csvs, runtime accounting
(port of gigapose_tpu/dataloader/bop_io.py; numpy and the standard library
only, no bop_toolkit or pycocotools):

- COCO RLE mask codec (CNOS detections ship compressed RLE segmentations)
- CNOS detection loading for both test settings (localization with the
  MegaPose fallback-when-object-missing trick + per-object caps, and
  detection mode with a generated target list) — inout.py:370-493
- LM-O object-id remapping (dataset.py:18-19)
- BOP result csv write/read incl. the MultiHypothesis instance_id column —
  inout.py:126-194
- the BOP runtime protocol: per-image time = detection_time + sum of unique
  batch times (+ refinement times when refined), de-duped by batch_id —
  inout.py:217-270
- batched .npz prediction files -> merged csv(s) — inout.py:273-367
"""

from __future__ import annotations

import copy
import json
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence

import numpy as np

from gigapose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# CNOS default detection files per dataset (ref: src/utils/dataset.py:5-15)
CNOS_DETECTIONS = {
    "itodd": "cnos-fastsam_itodd-test_df32d45b-301c-4fc9-8769-797904dd9325.json",
    "hb": "cnos-fastsam_hb-test_db836947-020a-45bd-8ec5-c95560b68011.json",
    "icbin": "cnos-fastsam_icbin-test_f21a9faf-7ef2-4325-885f-f4b6460f4432.json",
    "lmo": "cnos-fastsam_lmo-test_3cb298ea-e2eb-4713-ae9e-5a7134c5da0f.json",
    "tless": "cnos-fastsam_tless-test_8ca61cb0-4472-4f11-bce7-1362a12d396f.json",
    "ycbv": "cnos-fastsam_ycbv-test_f4f2127c-6f59-447c-95b3-28e1e591f1a1.json",
    "tudl": "cnos-fastsam_tudl-test_c48a2a95-1b41-4a51-9920-a667cb3d7149.json",
}

# occlusion-LINEMOD's object ids are a sparse subset (ref: dataset.py:18-19)
LMO_INDEX_TO_ID = [1, 5, 6, 8, 9, 10, 11, 12]
LMO_ID_TO_INDEX = {obj_id: idx + 1 for idx, obj_id in enumerate(LMO_INDEX_TO_ID)}

BOP23_CORE = ["lmo", "tless", "tudl", "icbin", "itodd", "hb", "ycbv"]


# --------------------------------------------------------------------------- #
# COCO RLE codec (replaces pycocotools for CNOS segmentations)
# --------------------------------------------------------------------------- #

def rle_decode(rle: Dict) -> np.ndarray:
    """COCO RLE -> (H, W) uint8 mask. Accepts compressed (string counts) and
    uncompressed (list counts) encodings. Column-major, starts with zeros."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _rle_uncompress(counts.encode("ascii"))
    # runs alternate 0, 1, 0, ...; runs past h * w are cut, a short total
    # leaves the tail 0
    runs = np.repeat((np.arange(len(counts)) & 1).astype(np.uint8), counts)[: h * w]
    mask = np.zeros(h * w, dtype=np.uint8)
    mask[: len(runs)] = runs
    return mask.reshape((w, h)).T  # column-major


def rle_encode(mask: np.ndarray) -> Dict:
    """(H, W) {0,1} mask -> compressed COCO RLE dict."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)  # column-major
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [len(flat)]])
    counts = np.diff(idx).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": _rle_compress(counts).decode("ascii")}


def _rle_uncompress(s: bytes) -> List[int]:
    """LEB128-style COCO string -> counts (pycocotools rleFrString algorithm,
    public format)."""
    counts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _rle_compress(counts: Sequence[int]) -> bytes:
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


# --------------------------------------------------------------------------- #
# json helpers / grouping
# --------------------------------------------------------------------------- #

def load_json(path):
    with open(path) as f:
        return json.load(f)


def save_json(path, data):
    with open(path, "w") as f:
        json.dump(data, f)


def group_by_image(items: Sequence[Dict], image_key: str = "image_id") -> Dict:
    """Group detection/target dicts by '{scene:06d}_{im:06d}' keys (ref:
    group_by_image_level, inout.py:109-123). Accepts nested lists too."""
    grouped: Dict[str, List[Dict]] = {}
    def add(d):
        scene_id = int(d["scene_id"])
        im_id = int(d[image_key] if image_key in d else d["im_id"])
        key = f"{scene_id:06d}_{im_id:06d}"
        grouped.setdefault(key, []).append(d)

    for it in items:
        if isinstance(it, list):
            for d in it:
                add(d)
        else:
            add(it)
    return grouped


# --------------------------------------------------------------------------- #
# detections + test lists
# --------------------------------------------------------------------------- #

def generate_test_list(dets_per_image: Dict) -> Dict:
    """Detection-setting target list: per image, count instances per object id
    (ref: generate_test_list, inout.py:370-400)."""
    out = {}
    for key, dets in dets_per_image.items():
        scene_id, im_id = (int(x) for x in key.split("_"))
        counts: Dict[int, int] = {}
        for det in dets:
            obj_id = int(det.get("category_id", det.get("obj_id")))
            counts[obj_id] = counts.get(obj_id, 0) + 1
        out[key] = [
            {"scene_id": scene_id, "im_id": im_id, "obj_id": o, "inst_count": c}
            for o, c in counts.items()
        ]
    return out


def load_cnos_detections(
    root_dir: str,
    dataset_name: str,
    test_setting: str = "localization",
    max_det_per_object_id: Optional[int] = None,
):
    """Returns (test_list_per_image, detections_per_image).

    Mirrors load_test_list_and_cnos_detections (inout.py:403-493): BOP'19
    datasets use cnos-fastsam, hope uses BOP'24 cnos-sam; in localization mode
    missing-object images borrow all image detections relabeled to the target
    object (the MegaPose trick), detections are score-sorted and capped.
    """
    if dataset_name in BOP23_CORE:
        year, det_model = "19", "cnos-fastsam"
    elif dataset_name in ["hope", "hopev2", "handal"]:
        year, det_model = "24", "cnos-sam"
    else:
        raise NotImplementedError(f"No default detections for {dataset_name}")
    det_dir = osp.join(
        root_dir, "default_detections", f"core{year}_model_based_unseen", det_model
    )
    candidates = [f for f in os.listdir(det_dir) if dataset_name in f]
    all_dets = load_json(osp.join(det_dir, candidates[0]))
    dets_per_image = group_by_image(all_dets, image_key="image_id")

    if test_setting == "detection":
        return generate_test_list(dets_per_image), dets_per_image
    if test_setting != "localization":
        raise NotImplementedError(test_setting)

    targets = load_json(
        osp.join(root_dir, dataset_name, f"test_targets_bop{year}.json")
    )
    selected: List[List[Dict]] = []
    for t in targets:
        key = f"{int(t['scene_id']):06d}_{int(t['im_id']):06d}"
        if key not in dets_per_image:
            logger.info(f"No detection for {key}")
            continue
        dets = [
            d for d in dets_per_image[key] if d["category_id"] == t["obj_id"]
        ]
        if not dets:  # megapose fallback: relabel all detections of the image
            dets = copy.deepcopy(dets_per_image[key])
            for d in dets:
                d["category_id"] = t["obj_id"]
        dets = sorted(dets, key=lambda d: d["score"], reverse=True)
        cap = max_det_per_object_id if max_det_per_object_id else t["inst_count"]
        selected.append(dets[:cap])
    return group_by_image(targets, image_key="im_id"), group_by_image(
        selected, image_key="image_id"
    )


# --------------------------------------------------------------------------- #
# BOP result csv
# --------------------------------------------------------------------------- #

def save_bop_csv(path: str, results: Sequence[Dict], extra_column: Optional[str] = None):
    """Write the BOP'19 csv (ref: save_bop_results, inout.py:126-152)."""
    header = "scene_id,im_id,obj_id,score,R,t,time"
    if extra_column:
        header += f",{extra_column}"
    lines = [header]
    for r in results:
        line = (
            f"{r['scene_id']},{r['im_id']},{r['obj_id']},{r['score']},"
            f"{' '.join(str(v) for v in np.asarray(r['R']).flatten().tolist())},"
            f"{' '.join(str(v) for v in np.asarray(r['t']).flatten().tolist())},"
            f"{r.get('time', -1)}"
        )
        if extra_column:
            line += f",{r[extra_column]}"
        lines.append(line)
    with open(path, "w") as f:
        f.write("\n".join(lines))


def load_bop_csv(path: str, extra_column: Optional[str] = None) -> List[Dict]:
    """Read a BOP'19 csv (ref: load_bop_results, inout.py:154-194)."""
    results = []
    n_cols = 8 if extra_column else 7
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line or (i == 0 and line.startswith("scene_id")):
                continue
            elems = line.split(",")
            if len(elems) != n_cols:
                raise ValueError(f"Expected {n_cols} columns: {line}")
            r = {
                "scene_id": int(elems[0]),
                "im_id": int(elems[1]),
                "obj_id": int(elems[2]),
                "score": float(elems[3]),
                "R": np.array(elems[4].split(), np.float64).reshape(3, 3),
                "t": np.array(elems[5].split(), np.float64).reshape(3, 1),
                "time": float(elems[6]),
            }
            if extra_column:
                r[extra_column] = float(elems[7])
            results.append(r)
    return results


def apply_runtime_protocol(results: List[Dict], is_refined: bool) -> List[Dict]:
    """BOP per-image runtime (ref: calculate_runtime_per_image, inout.py:217-270):
    coarse: time = detection_time + sum of unique batch times;
    refined: time = sum of batch times + sum of refinement times.
    Consumes and removes the bookkeeping keys additional_time / batch_id."""
    per_image: Dict[str, Dict] = {}
    for r in results:
        key = f"{r['scene_id']:06d}_{r['im_id']:06d}"
        slot = per_image.setdefault(
            key, {"batch_ids": [], "times": [], "extra": []}
        )
        if r["batch_id"] not in slot["batch_ids"]:
            slot["batch_ids"].append(r["batch_id"])
            slot["times"].append(r["time"])
            slot["extra"].append(r["additional_time"])
    totals = {}
    for key, slot in per_image.items():
        if is_refined:
            totals[key] = float(np.sum(slot["extra"]) + np.sum(slot["times"]))
        else:
            # detection time counted once
            totals[key] = float(slot["extra"][0] + np.sum(slot["times"]))
    for r in results:
        key = f"{r['scene_id']:06d}_{r['im_id']:06d}"
        r["time"] = totals[key]
        r.pop("additional_time", None)
        r.pop("batch_id", None)
    return results


def merge_batched_predictions(
    prediction_dir: str,
    dataset_name: str,
    model_name: str,
    run_id,
    is_refined: bool = False,
) -> List[str]:
    """Merge per-batch .npz prediction files into the final BOP csv(s)
    (ref: save_predictions_from_batched_predictions, inout.py:273-367).

    npz contract per batch: scene_id, im_id, object_id (internal 1-based
    label), poses (B, 4, 4) or (B, k, 4, 4) in mm, scores (B[, k]), time,
    detection_time (coarse) or refinement_time (refined).
    Returns the written csv path(s).
    """
    files = sorted(f for f in os.listdir(prediction_dir) if f.endswith(".npz"))
    extra_key = "refinement_time" if is_refined else "detection_time"
    top1, topk = [], []
    instance_id = 0
    multi = False
    for batch_id, fname in enumerate(files):
        data = np.load(osp.join(prediction_dir, fname))
        poses = data["poses"]
        multi = poses.ndim == 4
        for i in range(len(data["im_id"])):
            obj_id = int(data["object_id"][i])
            if not is_refined and "lmo" in dataset_name:
                obj_id = LMO_INDEX_TO_ID[obj_id - 1]
            hyps = poses[i] if multi else poses[i][None]
            scores = data["scores"][i] if multi else [data["scores"][i]]
            base = dict(
                scene_id=int(data["scene_id"][i]),
                im_id=int(data["im_id"][i]),
                obj_id=obj_id,
                time=float(data["time"][i]),
                additional_time=float(data[extra_key][i]),
                batch_id=batch_id,
            )
            first = dict(
                base, score=float(scores[0]), R=hyps[0][:3, :3].reshape(-1),
                t=hyps[0][:3, 3].reshape(-1),
            )
            top1.append(dict(first))
            first["instance_id"] = instance_id
            topk.append(dict(first))
            for j in range(1, len(hyps)):
                topk.append(
                    dict(
                        base,
                        score=float(scores[j]),
                        R=hyps[j][:3, :3].reshape(-1),
                        t=hyps[j][:3, 3].reshape(-1),
                        instance_id=instance_id,
                    )
                )
            instance_id += 1

    name = f"{model_name}-pbrreal-rgb-mmodel_{dataset_name}-test_{run_id}"
    paths = []
    path1 = osp.join(prediction_dir, f"{name}.csv")
    apply_runtime_protocol(top1, is_refined)
    save_bop_csv(path1, top1)
    paths.append(path1)
    if multi:
        pathk = osp.join(prediction_dir, f"{name}MultiHypothesis.csv")
        apply_runtime_protocol(topk, is_refined)
        save_bop_csv(pathk, topk, extra_column="instance_id")
        paths.append(pathk)
    logger.info(f"Merged {len(files)} batches -> {paths}")
    return paths


def load_init_locs(root_dir: str, dataset_name: str, init_loc_path: str,
                   test_setting: str = "localization"):
    """Load coarse csv hypotheses for refinement (ref: load_test_list_and_init_locs,
    inout.py:495-521). Returns (test_list, init_locs_per_image, num_hypotheses)."""
    try:
        locs = load_bop_csv(init_loc_path, extra_column="instance_id")
        n_inst = len(np.unique([r["instance_id"] for r in locs]))
        assert len(locs) % n_inst == 0
        num_hyp = len(locs) // n_inst
    except Exception:
        locs = load_bop_csv(init_loc_path)
        num_hyp = 1
    locs_per_image = group_by_image(locs, image_key="im_id")
    if test_setting == "detection":
        return generate_test_list(locs_per_image), locs_per_image, num_hyp
    targets = load_json(osp.join(root_dir, dataset_name, "test_targets_bop19.json"))
    return group_by_image(targets, image_key="im_id"), locs_per_image, num_hyp
