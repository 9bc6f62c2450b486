"""Coarse inference runner: BOP dataset -> npz prediction batches -> BOP csv
(port of gigapose_tpu/pipeline/runner.py).

1. onboard the dataset's objects into a TemplateStore (once; with a cache
   tag, from / to `<template_dir>/onboarded_<tag>.npz`),
2. per test image: decode (host, dataloader/), crop + normalize (device,
   `prepare_batch`, padded to a shape bucket), the estimator on chunks of at
   most `max_dets_per_forward` detections,
3. filter per the localization protocol (top inst_count per target object by
   score, gigaPose.py:400-449),
4. write per-image npz with the BOP timing fields and merge them into csv.

Not ported yet: a sharded store or a device mesh and multi-process runs
(ROADMAP A14); the CLI refuses them.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
import time
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from gigapose_tpu_torch.dataloader import bop_io
from gigapose_tpu_torch.dataloader.templates_disk import (
    list_objects,
    load_object_templates,
    save_npz_atomic,
)
from gigapose_tpu_torch.dataloader.test_set import ImageDetections
from gigapose_tpu_torch.ops.crop import crop_resize_pad
from gigapose_tpu_torch.ops.matching import downsample_mask
from gigapose_tpu_torch.pipeline.estimator import DetectionBatch, GigaPoseEstimator
from gigapose_tpu_torch.pipeline.templates import (
    TemplateStore,
    normalize_rgb,
    onboard_templates,
)
from gigapose_tpu_torch.utils.logging import get_logger
from gigapose_tpu_torch.utils.timer import Timer

logger = get_logger(__name__)

PAD_BUCKETS = (4, 8, 16, 32, 64, 128)


def pad_bucket(n: int) -> int:
    for b in PAD_BUCKETS:
        if n <= b:
            return b
    return ((n + PAD_BUCKETS[-1] - 1) // PAD_BUCKETS[-1]) * PAD_BUCKETS[-1]


def prepare_batch(
    rgb: np.ndarray,  # (H, W, 3) uint8
    masks: np.ndarray,  # (N, H, W) modal masks, {0, 1}
    boxes_xyxy: np.ndarray,  # (N, 4) integer pixel boxes
    labels: np.ndarray,  # (N,) 1-based object labels
    K: np.ndarray,  # (3, 3) intrinsics
    device: torch.device,
    target_size: int = 224,
    num_patches: int = 16,
) -> DetectionBatch:
    """One image's detections -> a DetectionBatch padded to pad_bucket(N)."""
    N = len(labels)
    pad = pad_bucket(N) - N
    img = torch.as_tensor(np.asarray(rgb)).to(device, torch.float32) / 255.0  # (H, W, 3)
    m = torch.as_tensor(np.asarray(masks)).to(device, torch.float32)  # (N, H, W)
    rgba = torch.cat([img.permute(2, 0, 1)[None] * m[:, None], m[:, None]], dim=1)
    boxes = torch.as_tensor(np.asarray(boxes_xyxy)).to(device, torch.float32)
    crops, Ms = crop_resize_pad(rgba, boxes, target_size)
    crop_rgb = normalize_rgb(crops[:, :3])
    crop_mask = downsample_mask(crops[:, 3], num_patches)

    z = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    # K / M padding rows are identity, not zeros: the recovery inverts them
    eye_pad = lambda a: torch.cat([a, torch.eye(3, dtype=a.dtype, device=device).expand(pad, 3, 3)])
    Ks = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device).expand(N, 3, 3)
    lab = torch.as_tensor(np.asarray(labels).astype(np.int64) - 1).to(device, torch.int32)
    return DetectionBatch(
        crops=z(crop_rgb),
        masks=z(crop_mask),
        labels=z(lab),  # 0-based store index
        Ks=eye_pad(Ks),
        Ms=eye_pad(Ms),
        valid=torch.cat([torch.ones(N, dtype=torch.bool, device=device),
                         torch.zeros(pad, dtype=torch.bool, device=device)]),
    )


def _timed(items: Iterable, timing: Dict[str, float]) -> Iterator:
    """`items`, adding the time each next() takes (the dataset's decoding)
    to timing["decode_s"]."""
    it = iter(items)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            timing["decode_s"] += time.perf_counter() - t0
        yield item


@dataclasses.dataclass
class CoarseRunner:
    estimator: GigaPoseEstimator
    store: TemplateStore
    save_dir: str
    dataset_name: str
    num_patches: int = 16
    target_size: int = 224
    # at most this many detections per forward (ref: max_num_dets_per_forward,
    # configs/test.yaml:23, gigaPose.py:500-536)
    max_dets_per_forward: Optional[int] = None
    # host-clock seconds and counts of onboarding and of the last run()
    timing: Dict[str, float] = dataclasses.field(default_factory=dict)

    @classmethod
    def onboard(
        cls,
        estimator: GigaPoseEstimator,
        template_dir: str,
        save_dir: str,
        dataset_name: str,
        num_templates: Optional[int] = None,
        scale_factor: float = 1.0,
        feature_dtype: Optional[torch.dtype] = None,  # None: f32 store
        cache_tag: Optional[str] = None,  # persist the onboarded store on disk
        **kwargs,
    ) -> "CoarseRunner":
        """Build the TemplateStore from a rendered template directory (ref:
        set_template_data, gigaPose.py:357-398). With cache_tag, the store is
        read from / written to <template_dir>/onboarded_<tag>.npz, features as
        f32 (npz has no bf16), re-cast to feature_dtype on load; the file is
        written under another name and renamed, so that a reader never
        finds a partial cache."""
        timer = Timer().tic()
        device = estimator.device
        cache_path = osp.join(template_dir, f"onboarded_{cache_tag}.npz") if cache_tag else None
        make = lambda store, cached: cls(
            estimator=estimator, store=store, save_dir=save_dir, dataset_name=dataset_name,
            timing=dict(onboard_s=timer.toc(block_on=store.ae_features),
                        onboard_cached=cached, objects=int(store.K.shape[0])),
            **kwargs,
        )
        if cache_path and osp.exists(cache_path):
            with np.load(cache_path) as data:
                fields = {k: torch.as_tensor(data[k]).to(device) for k in data.files}
            if feature_dtype is not None:
                for k in ("ae_features", "ist_features"):
                    fields[k] = fields[k].to(feature_dtype)
            runner = make(TemplateStore(**fields), True)
            logger.info(f"Loaded onboarded store from {cache_path}")
            return runner
        obj_ids = list_objects(template_dir)
        rgbas, poses = [], []
        for obj_id in obj_ids:
            data = load_object_templates(template_dir, obj_id, num_templates, scale_factor,
                                         as_uint8=True)  # 4x less host -> device traffic
            rgbas.append(data["rgba"])
            poses.append(data["poses"])
        store = onboard_templates(estimator.ae_apply, estimator.ist_apply, rgbas, poses, device,
                                  feature_dtype=feature_dtype or torch.float32)
        runner = make(store, False)
        dt = runner.timing["onboard_s"]
        logger.info(f"Onboarded {len(obj_ids)} objects in {dt:.1f}s "
                    f"({dt / max(len(obj_ids), 1):.2f} s/object)")
        if cache_path:
            save_npz_atomic(cache_path, **{
                f.name: getattr(store, f.name).to(
                    torch.float32 if "features" in f.name else getattr(store, f.name).dtype
                ).cpu().numpy()
                for f in dataclasses.fields(store)})
            logger.info(f"Saved onboarded store to {cache_path}")
        return runner

    def prepare_batch(self, image: ImageDetections, sel=None) -> DetectionBatch:
        """Host arrays -> device crops, padded to a shape bucket. `sel`
        restricts to a subset of the image's detections (chunking)."""
        sel = slice(None) if sel is None else sel
        return prepare_batch(image.rgb, image.masks[sel], image.boxes_xyxy[sel],
                             image.labels[sel], image.K, self.estimator.device,
                             self.target_size, self.num_patches)

    def filter_localization(
        self, image: ImageDetections, scores: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Keep top inst_count detections per target object by top-1 score
        (ref: filter_and_save, gigaPose.py:400-449). Returns (selected indices,
        per-selection detection_time)."""
        sel: List[int] = []
        det_times: List[float] = []
        labels = image.obj_ids
        for target in image.test_list:
            obj_id = target["obj_id"]
            inst = int(target.get("inst_count", 1))
            idx = np.where(labels == obj_id)[0]
            order = idx[np.argsort(-scores[idx])][:inst]
            sel.extend(order.tolist())
            det_times.extend([image.detection_time] * len(order))
        return np.asarray(sel, np.int64), np.asarray(det_times)

    def run(
        self,
        dataset: Iterable[ImageDetections],
        test_setting: str = "localization",
        model_name: str = "large",
        run_id="0",
        max_images: Optional[int] = None,
    ) -> List[str]:
        """Every image of `dataset` through the estimator; returns the csv
        paths. Per image the npz holds the JAX runner's fields (scene_id,
        im_id, object_id, poses (n, k, 4, 4), scores (n, k), time,
        detection_time) and view_ids (n, k). Adds images, detections,
        forwards, decode_s (host time inside the dataset's iterator) and
        run_s to `timing`."""
        pred_dir = osp.join(self.save_dir, "predictions")
        os.makedirs(pred_dir, exist_ok=True)
        # drop stale batches of earlier runs: the merge globs *.npz
        for f in os.listdir(pred_dir):
            if f.endswith(".npz"):
                os.remove(osp.join(pred_dir, f))
        stats = dict(images=0, detections=0, forwards=0, decode_s=0.0)
        t_run = time.perf_counter()
        timer = Timer()
        for idx_batch, image in enumerate(_timed(dataset, stats)):
            if max_images is not None and idx_batch >= max_images:
                break
            timer.tic()
            N = len(image.labels)
            chunk = self.max_dets_per_forward or N
            outs = {"poses": [], "scores": [], "view_ids": []}
            for s in range(0, N, chunk):
                sel = np.arange(s, min(s + chunk, N))
                pred = self.estimator(self.store, self.prepare_batch(image, sel))
                for name, out in outs.items():
                    t = getattr(pred, name)[: len(sel)]  # scores are bf16 on a bf16 store
                    out.append((t.float() if t.is_floating_point() else t).cpu().numpy())
                stats["forwards"] += 1
            elapsed = timer.toc(block_on=pred.poses)
            poses = np.concatenate(outs["poses"]).astype(np.float64)
            scores = np.concatenate(outs["scores"]).astype(np.float64)
            view_ids = np.concatenate(outs["view_ids"]).astype(np.int32)
            stats["images"] += 1
            stats["detections"] += N
            if test_setting == "localization" and image.test_list:
                sel, det_times = self.filter_localization(image, scores[:, 0])
            else:
                sel = np.arange(N)
                det_times = np.full(N, image.detection_time)
            if len(sel) == 0:
                continue
            np.savez(
                osp.join(pred_dir, f"{idx_batch:06d}.npz"),
                scene_id=np.full(len(sel), image.scene_id, np.int32),
                im_id=np.full(len(sel), image.im_id, np.int32),
                object_id=image.labels[sel].astype(np.int32),
                poses=poses[sel],
                scores=scores[sel],
                view_ids=view_ids[sel],
                time=np.full(len(sel), elapsed),
                detection_time=det_times,
            )
        stats["run_s"] = time.perf_counter() - t_run
        self.timing.update(stats)
        logger.info(f"Ran coarse inference on {stats['images']} images")
        return bop_io.merge_batched_predictions(
            pred_dir, self.dataset_name, model_name, run_id, is_refined=False
        )
