"""Training data: BOP scenes and templates -> TrainBatch (port of
gigapose_tpu/dataloader/train_set.py).

HOST (`TrainLoader`): scenes from tar shards or directories, the RGB
augmentation, instance sampling, the nearest template view with a random
in-plane rotation, the template PNGs (dataloader/png.py, no PIL) - the
per-observation work, optionally on a window of worker threads.

DEVICE (`prepare_train_batch`, on the trainer's device): the masked RGBA
crops of both views, CLIP normalization, the ground-truth patch
correspondences (dataloader/keypoints.py), relative scale and in-plane
angle.

Units are meters on the training path (scene poses are converted by
scene.py; template poses and depth are scaled by the loader's unit_scale).
"""

from __future__ import annotations

import collections
import dataclasses
import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np
import torch

from gigapose_tpu_torch.dataloader.augment import augment_rgb, rotate, rotate_rgba
from gigapose_tpu_torch.dataloader.keypoints import KeypointView, sample_keypoints
from gigapose_tpu_torch.dataloader.png import decode_png, to_rgba
from gigapose_tpu_torch.dataloader.scene import SceneObservation
from gigapose_tpu_torch.lib3d.geometry import relative_inplane, relative_scale
from gigapose_tpu_torch.ops.crop import crop_resize_pad
from gigapose_tpu_torch.ops.matching import downsample_mask
from gigapose_tpu_torch.pipeline.templates import TEMPLATE_K, normalize_rgb
from gigapose_tpu_torch.training.state import TrainBatch


def nearest_view_index(R_query: np.ndarray, view_poses: np.ndarray) -> int:
    """Nearest out-of-plane template view by the distance of the rotations'
    third rows (invariant to the OpenGL flip)."""
    d = np.linalg.norm(view_poses[:, 2, :3] - R_query[2, :3], axis=1)
    return int(np.argmin(d))


@dataclasses.dataclass
class HostTrainRecords:
    """The numpy batch the host loader yields (all float32)."""

    q_rgb: np.ndarray  # (B, 3, H, W) [0, 1], augmented
    q_depth: np.ndarray  # (B, H, W) meters
    q_mask: np.ndarray  # (B, H, W)
    q_K: np.ndarray  # (B, 3, 3)
    q_pose: np.ndarray  # (B, 4, 4) meters
    q_box: np.ndarray  # (B, 4) xyxy
    t_rgba: np.ndarray  # (B, 4, Ht, Wt) [0, 1]
    t_depth: np.ndarray  # (B, Ht, Wt) meters
    t_K: np.ndarray  # (B, 3, 3)
    t_pose: np.ndarray  # (B, 4, 4) meters, in-plane rotation composed
    t_box: np.ndarray  # (B, 4) xyxy


def _read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


class TrainLoader:
    """Iterates HostTrainRecords of a fixed batch size over BOP scenes.

    Each observation gets a child seed drawn in order from the master
    stream, so the batches do not depend on `num_workers` (worker threads
    in an order-keeping window of 2 x num_workers observations)."""

    def __init__(self, scene_source, template_dir: str, batch_size: int = 12,
                 inplane_augmentation: bool = True, rgb_augmentation: bool = True,
                 unit_scale: float = 1e-3, template_scale_factor: float = 1.0,
                 seed: int = 2023, min_box_size: float = 10.0, num_workers: int = 1):
        self.scenes = scene_source
        self.template_dir = template_dir
        self.batch_size = batch_size
        self.inplane_aug = inplane_augmentation
        self.rgb_aug = rgb_augmentation
        self.unit_scale = unit_scale  # template pose / depth (mm) -> meters
        self.scale_factor = template_scale_factor
        self.rng = np.random.default_rng(seed)
        self.min_box_size = min_box_size
        self.num_workers = num_workers
        self._pose_cache: Dict[int, np.ndarray] = {}

    def _view_poses(self, obj_id: int) -> np.ndarray:
        if obj_id not in self._pose_cache:
            path = osp.join(self.template_dir, "object_poses", f"{obj_id:06d}.npy")
            poses = np.load(path).astype(np.float64)
            poses[:, :3, 3] *= self.scale_factor
            self._pose_cache[obj_id] = poses
        return self._pose_cache[obj_id]

    def _load_template_view(self, obj_id: int, view: int, inplane_deg: float):
        obj_dir = osp.join(self.template_dir, f"{obj_id:06d}")
        rgba = to_rgba(_read_png(osp.join(obj_dir, f"{view:06d}.png"))).astype(np.float32) / 255.0
        depth = _read_png(osp.join(obj_dir, f"{view:06d}_depth.png")).astype(np.float32)
        if inplane_deg:
            rgba = rotate_rgba(rgba, inplane_deg)
            depth = rotate(depth, inplane_deg)
        return rgba.transpose(2, 0, 1), depth * self.unit_scale

    def _instances(self, obs: SceneObservation, rng) -> List[int]:
        ok = [i for i in range(len(obs.object_ids))
              if min(obs.bboxes_xywh[i][2], obs.bboxes_xywh[i][3]) >= self.min_box_size]
        if len(ok) > self.batch_size:
            ok = list(rng.choice(ok, self.batch_size, replace=False))
        return ok

    def _obs_records(self, obs: SceneObservation, rng) -> List[Dict]:
        """The per-observation host work (RGB augmentation, template decode,
        in-plane rotation): the unit the worker threads take."""
        rgb = augment_rgb(obs.rgb, rng) if self.rgb_aug else obs.rgb
        rgb = rgb.astype(np.float32).transpose(2, 0, 1) / 255.0
        records: List[Dict] = []
        for i in self._instances(obs, rng):
            obj_id = obs.object_ids[i]
            try:
                view_poses = self._view_poses(obj_id)
            except FileNotFoundError:
                continue
            v = nearest_view_index(obs.poses[i][:3, :3], view_poses)
            inplane = float(rng.integers(0, 360)) if self.inplane_aug else 0.0
            try:
                t_rgba, t_depth = self._load_template_view(obj_id, v, inplane)
            except FileNotFoundError:
                continue
            t_pose = view_poses[v].copy()
            t_pose[:3, 3] *= self.unit_scale
            if inplane:
                a = np.deg2rad(-inplane)
                T = np.eye(4)
                T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]]
                t_pose = T @ t_pose
            ys, xs = np.nonzero(t_rgba[3] > 0)
            if len(ys) == 0:
                continue
            x, y, w, h = obs.bboxes_xywh[i]
            records.append(dict(
                q_rgb=rgb, q_depth=obs.depth, q_mask=obs.masks[i], q_K=obs.K,
                q_pose=obs.poses[i], q_box=np.array([x, y, x + w, y + h]),
                t_rgba=t_rgba, t_depth=t_depth, t_K=TEMPLATE_K, t_pose=t_pose,
                t_box=np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]),
            ))
        return records

    def _record_lists(self) -> Iterator[List[Dict]]:
        """Per-observation record lists, in order, sequentially or through
        the worker window."""
        def seeded():
            for obs in self.scenes:
                if obs.depth is None or obs.masks is None:
                    continue
                yield obs, int(self.rng.integers(2**31))

        if self.num_workers <= 1:
            for obs, seed in seeded():
                yield self._obs_records(obs, np.random.default_rng(seed))
            return
        with ThreadPoolExecutor(self.num_workers) as ex:
            futs: collections.deque = collections.deque()
            it = seeded()
            exhausted = False
            while True:
                while not exhausted and len(futs) < 2 * self.num_workers:
                    nxt = next(it, None)
                    if nxt is None:
                        exhausted = True
                        break
                    futs.append(ex.submit(self._obs_records, nxt[0], np.random.default_rng(nxt[1])))
                if not futs:
                    return
                yield futs.popleft().result()

    def __iter__(self) -> Iterator[HostTrainRecords]:
        pending: List[Dict] = []
        for records in self._record_lists():
            for rec in records:
                pending.append(rec)
                if len(pending) == self.batch_size:
                    yield self._stack(pending)
                    pending = []

    @staticmethod
    def _stack(recs: List[Dict]) -> HostTrainRecords:
        return HostTrainRecords(**{k: np.stack([np.asarray(r[k], np.float32) for r in recs])
                                   for k in recs[0]})


def prepare_train_batch(rec: HostTrainRecords, device, target_size: int = 224,
                        patch_size: int = 14) -> TrainBatch:
    """HostTrainRecords -> TrainBatch on `device`: crops, normalization,
    ground-truth correspondences, relative scale and in-plane angle."""
    t = {f.name: torch.as_tensor(getattr(rec, f.name), device=device)
         for f in dataclasses.fields(rec)}
    q_mask = t["q_mask"][:, None]
    q_rgba = torch.cat([t["q_rgb"] * q_mask, q_mask], dim=1)  # masked RGBA query
    q_crops, q_M = crop_resize_pad(q_rgba, t["q_box"], target_size)
    t_crops, t_M = crop_resize_pad(t["t_rgba"], t["t_box"], target_size)
    T_real2temp = t["t_pose"] @ torch.linalg.inv(t["q_pose"])
    # for each query (real) patch its place in the template crop: the
    # sampler's (src, tar) are (real, template)
    kp = sample_keypoints(
        T_real2temp,
        src=KeypointView(K=t["q_K"], depth=t["q_depth"], mask=q_crops[:, 3], M=q_M),
        tar=KeypointView(K=t["t_K"], depth=t["t_depth"], mask=t_crops[:, 3], M=t_M),
        tar_size=target_size, patch_size=patch_size,
    )
    n_pat = target_size // patch_size
    return TrainBatch(
        src_img=normalize_rgb(t_crops[:, :3]),
        tar_img=normalize_rgb(q_crops[:, :3]),
        src_pts=kp["src_pts"],
        tar_pts=kp["tar_pts"],
        rel_scale=relative_scale(t["t_K"], t["q_K"], t["t_pose"], t["q_pose"], t_M, q_M),
        rel_inplane=relative_inplane(t["t_pose"], t["q_pose"]),
        src_mask=downsample_mask(t_crops[:, 3], n_pat),
        tar_mask=downsample_mask(q_crops[:, 3], n_pat),
    )
