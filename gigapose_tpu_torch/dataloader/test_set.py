"""Inference dataset: per test image, the CNOS detections as numpy arrays
ready for device cropping (port of gigapose_tpu/dataloader/test_set.py).

GigaPoseTestSet's detection path (src/dataloader/test.py:47-318):
- localization: per-object detection caps (icbin 32, else 16), test-target
  list attached per image; detection: all detections, generated target list
- per detection: RLE -> mask, xywh -> xyxy box, masked RGBA for cropping
- LM-O: dataset object ids remapped to contiguous internal labels 1..8

Batch assembly (crop warp + normalization) happens on device in the runner;
this module only decodes and indexes host data.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np

from gigapose_tpu_torch.dataloader import bop_io
from gigapose_tpu_torch.dataloader.scene import DirSceneSource, TarSceneSource
from gigapose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class ImageDetections:
    """All detections of one test image, host-side."""

    scene_id: int
    im_id: int
    rgb: np.ndarray  # (H, W, 3) uint8
    K: np.ndarray  # (3, 3)
    labels: np.ndarray  # (N,) internal 1-based labels
    obj_ids: np.ndarray  # (N,) dataset object ids
    boxes_xyxy: np.ndarray  # (N, 4) int
    masks: np.ndarray  # (N, H, W) uint8
    scores: np.ndarray  # (N,) detection scores
    detection_time: float
    test_list: List[Dict]  # target entries for this image (obj_id, inst_count)

    @property
    def key(self):
        return f"{self.scene_id:06d}_{self.im_id:06d}"


def object_id_to_label(dataset_name: str, obj_id: int) -> int:
    if "lmo" in dataset_name:
        return bop_io.LMO_ID_TO_INDEX[int(obj_id)]
    return int(obj_id)


class InferenceDataset:
    """Iterates ImageDetections over a BOP test split + CNOS detections."""

    def __init__(
        self,
        root_dir: str,
        dataset_name: str,
        test_setting: str = "localization",
        source: str = "auto",  # "tar" | "dir" | "auto"
        depth_scale: float = 10.0,
        load_depth: bool = False,
    ):
        import os.path as osp

        self.dataset_name = dataset_name
        split = "test"
        cap = None
        if test_setting == "localization":
            cap = 32 if dataset_name == "icbin" else 16
        self.test_list, self.detections = bop_io.load_cnos_detections(
            root_dir, dataset_name, test_setting, max_det_per_object_id=cap
        )
        split_dir = osp.join(root_dir, dataset_name, split)
        if source == "auto":
            import os

            has_tar = osp.isdir(split_dir) and any(
                f.endswith(".tar") for f in os.listdir(split_dir)
            )
            source = "tar" if has_tar else "dir"
        if source == "tar":
            self.scenes = TarSceneSource(
                split_dir, depth_scale=depth_scale, load_depth=load_depth
            )
        else:
            self.scenes = DirSceneSource(split_dir, load_depth=load_depth,
                                         load_masks=False)

    def __iter__(self) -> Iterator[ImageDetections]:
        for obs in self.scenes:
            key = obs.key
            if key not in self.detections:
                continue
            dets = self.detections[key]
            H, W = obs.rgb.shape[:2]
            labels, obj_ids, boxes, masks, scores = [], [], [], [], []
            for det in dets:
                obj_id = int(det["category_id"])
                mask = bop_io.rle_decode(det["segmentation"])
                x, y, w, h = det["bbox"]
                box = np.array(
                    [max(int(x), 0), max(int(y), 0),
                     min(int(x + w), W), min(int(y + h), H)], np.int32
                )
                if box[2] <= box[0] or box[3] <= box[1]:
                    continue
                labels.append(object_id_to_label(self.dataset_name, obj_id))
                obj_ids.append(obj_id)
                boxes.append(box)
                masks.append(mask)
                scores.append(det.get("score", 1.0))
            if not labels:
                continue
            det_time = dets[0].get("time", 0.0)
            yield ImageDetections(
                scene_id=obs.scene_id,
                im_id=obs.im_id,
                rgb=obs.rgb,
                K=obs.K,
                labels=np.asarray(labels, np.int32),
                obj_ids=np.asarray(obj_ids, np.int32),
                boxes_xyxy=np.stack(boxes),
                masks=np.stack(masks).astype(np.uint8),
                scores=np.asarray(scores, np.float32),
                detection_time=float(det_time),
                test_list=self.test_list.get(key, []),
            )
