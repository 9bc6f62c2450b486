"""Instance detector wrapper producing BOP-format detections (port of
gigapose_tpu/detector.py; ref: src/megapose/inference/detector.py
Detector.get_detections, filter_detections / add_instance_id of
src/megapose/inference/utils.py:153-196).

The model is any callable from a list of (H, W, 3) uint8 images to one dict
per image of boxes (N, 4) xyxy, scores (N,), labels (N,) and optionally
masks (N, H, W) in [0, 1]. The post-processing (score threshold, mask
binarization, one instance per class, instance ids, the BOP json) is
numpy. A torchvision MaskRCNN constructor is optional, as in the reference
(GigaPose itself reads CNOS detections from json and never runs it).

The dicts follow the BOP detection json that dataloader/bop_io.py:
load_cnos_detections reads: {scene_id, image_id, category_id, bbox [x, y,
w, h], score, time, segmentation (compressed RLE)}, so a run saved with
`save_detections_json` serves like a CNOS detection file.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from gigapose_tpu_torch.dataloader.bop_io import rle_encode


def postprocess_image_detections(
    output: Dict[str, np.ndarray],
    scene_id: int,
    im_id: int,
    detection_th: Optional[float] = None,
    mask_th: float = 0.8,
    detection_time: float = -1.0,
    category_id_map: Optional[Dict[int, int]] = None,
) -> List[Dict]:
    """One image's model output -> BOP-format detection dicts: detections
    scoring at most `detection_th` dropped, soft masks binarized above
    `mask_th` (the reference's 0.8), labels mapped by `category_id_map`."""
    boxes = np.asarray(output["boxes"], np.float64).reshape(-1, 4)
    scores = np.asarray(output["scores"], np.float64).reshape(-1)
    labels = np.asarray(output["labels"]).reshape(-1)
    masks = output.get("masks")
    dets: List[Dict] = []
    for i in range(len(boxes)):
        if detection_th is not None and scores[i] <= detection_th:
            continue
        cat = int(labels[i])
        if category_id_map is not None:
            cat = int(category_id_map[cat])
        x0, y0, x1, y1 = boxes[i]
        det = {
            "scene_id": int(scene_id),
            "image_id": int(im_id),
            "category_id": cat,
            "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
            "score": float(scores[i]),
            "time": float(detection_time),
        }
        if masks is not None:
            det["segmentation"] = rle_encode(np.asarray(masks[i]) > mask_th)
        dets.append(det)
    return dets


def filter_one_instance_per_class(dets: List[Dict]) -> List[Dict]:
    """The highest-scoring detection per (scene, image, category), in their
    original order (the reference's one_instance_per_class)."""
    best: Dict[tuple, Dict] = {}
    for d in dets:
        key = (d["scene_id"], d["image_id"], d["category_id"])
        if key not in best or d["score"] > best[key]["score"]:
            best[key] = d
    winners = set(map(id, best.values()))
    return [d for d in dets if id(d) in winners]


def add_instance_ids(dets: List[Dict]) -> List[Dict]:
    """Number the instances of one object in one image 0..n-1 in order of
    appearance, in place; detections that have an instance_id keep it."""
    counters: Dict[tuple, int] = {}
    for d in dets:
        if "instance_id" in d:
            continue
        key = (d["scene_id"], d["image_id"], d["category_id"])
        d["instance_id"] = counters.get(key, 0)
        counters[key] = d["instance_id"] + 1
    return dets


def save_detections_json(dets: List[Dict], path: str) -> None:
    """The BOP detection json that load_cnos_detections reads."""
    with open(path, "w") as f:
        json.dump(dets, f)


@dataclass
class Detector:
    """Any per-image detection model behind the BOP detection format
    (`model_fn`: the torchvision MaskRCNN contract, detector.py:95-110 of
    the reference)."""

    model_fn: Callable[[Sequence[np.ndarray]], List[Dict[str, np.ndarray]]]
    detection_th: Optional[float] = None
    mask_th: float = 0.8
    one_instance_per_class: bool = False
    category_id_map: Optional[Dict[int, int]] = None

    def get_detections(
        self,
        rgbs: Sequence[np.ndarray],
        scene_ids: Sequence[int],
        im_ids: Sequence[int],
        detection_time: float = -1.0,
    ) -> List[Dict]:
        outputs = self.model_fn(list(rgbs))
        dets: List[Dict] = []
        for out, sid, iid in zip(outputs, scene_ids, im_ids):
            dets += postprocess_image_detections(
                out, sid, iid, detection_th=self.detection_th, mask_th=self.mask_th,
                detection_time=detection_time, category_id_map=self.category_id_map)
        if self.one_instance_per_class:
            dets = filter_one_instance_per_class(dets)
        return add_instance_ids(dets)

    __call__ = get_detections

    @classmethod
    def from_torchvision_maskrcnn(cls, n_classes: int, checkpoint_path: Optional[str] = None,
                                  device=None, **kwargs) -> "Detector":
        """A MaskRCNN-backed detector (the reference's DetectorMaskRCNN,
        src/megapose/models/mask_rcnn.py) on `device` (cuda:0 unless given).
        torchvision is an optional dependency: without it this raises
        ImportError."""
        try:
            import torchvision
        except ImportError as e:
            raise ImportError(
                "Detector.from_torchvision_maskrcnn needs torchvision, which is not "
                "installed; give Detector any model_fn with the boxes / scores / labels / "
                "masks contract instead") from e
        import torch

        from gigapose_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device, "Detector.from_torchvision_maskrcnn")
        model = torchvision.models.detection.maskrcnn_resnet50_fpn(num_classes=n_classes,
                                                                   weights=None)
        if checkpoint_path:
            sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
            model.load_state_dict(sd.get("state_dict", sd))
        model.to(dev).eval()

        def model_fn(rgbs: Sequence[np.ndarray]) -> List[Dict[str, np.ndarray]]:
            with torch.inference_mode():
                outs = model([torch.as_tensor(r).to(dev).float().permute(2, 0, 1) / 255.0
                              for r in rgbs])
            return [{k: (v[:, 0] if k == "masks" else v).cpu().numpy() for k, v in o.items()
                     if k in ("boxes", "scores", "labels", "masks")} for o in outs]

        return cls(model_fn=model_fn, **kwargs)
