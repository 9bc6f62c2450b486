"""BOP scene reading: directory layout and tar shards, host-side (port of
gigapose_tpu/dataloader/scene.py, with the numpy PNG codec in place of PIL).

The sample contract:

    {scene_id:06d}_{im_id:06d}.rgb.(png|jpg) | .gray.tif
    .depth.png (uint16, depth_scale)
    .camera.json  {"cam_K": 9 floats, "depth_scale": s}
    .gt.json      [{"obj_id", "cam_R_m2c", "cam_t_m2c"}]
    .gt_info.json [{"bbox_visib": xywh, "visib_fract": f}]
    .mask_visib.json [RLE per instance]

Two sources:
- ``TarSceneSource``: webdataset-style .tar shards (sequential members,
  key_to_shard.json index honored when present, broken-shard blacklist).
- ``DirSceneSource``: classic BOP directory layout
  (split/{scene:06d}/rgb/{im:06d}.png + scene_camera.json + scene_gt.json ...).

Samples with visib_fract <= 0.1 are filtered like the reference
(web_scene_dataset.py:92-99).

Images are decoded by dataloader/png.py: a `.jpg` rgb image or a `.gray.tif`
raises NotImplementedError (their decoders are ROADMAP A1), and a palette
PNG comes back as RGB where PIL's np.asarray gives its indices.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import tarfile
from typing import Dict, Iterator, List, Optional

import numpy as np
from gigapose_tpu_torch.dataloader.bop_io import rle_decode, rle_encode
from gigapose_tpu_torch.dataloader.png import SIGNATURE, decode_png
from gigapose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

MIN_VISIB_FRACT = 0.1


@dataclasses.dataclass
class SceneObservation:
    """One image with its GT annotations (ref: SceneObservation,
    src/megapose/datasets/scene_dataset.py:198)."""

    scene_id: int
    im_id: int
    rgb: np.ndarray  # (H, W, 3) uint8
    depth: Optional[np.ndarray]  # (H, W) float, meters
    K: np.ndarray  # (3, 3)
    object_ids: List[int]
    poses: np.ndarray  # (N, 4, 4) world->cam object poses (meters)
    bboxes_xywh: np.ndarray  # (N, 4) visible boxes
    masks: Optional[np.ndarray]  # (N, H, W) uint8 visible masks
    visib_fract: np.ndarray  # (N,)

    @property
    def key(self) -> str:
        return f"{self.scene_id:06d}_{self.im_id:06d}"


def _decode_image(data: bytes, name: str = "image") -> np.ndarray:
    if name.endswith(".tif") or data[:8] != SIGNATURE:
        raise NotImplementedError(
            f"{name} is not a PNG: the port decodes PNG only (JPEG and TIFF are ROADMAP A1)"
        )
    return decode_png(data)


def _to_rgb(img: np.ndarray) -> np.ndarray:
    """A decoded image as (H, W, 3), as PIL's convert("RGB"): gray and
    gray + alpha widen to gray x 3, RGBA (also a palette PNG with a tRNS
    chunk) drops its alpha."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _parse_gt(gt: List[Dict], mm_to_m: float = 1e-3) -> np.ndarray:
    poses = np.zeros((len(gt), 4, 4))
    for i, g in enumerate(gt):
        poses[i, :3, :3] = np.asarray(g["cam_R_m2c"], np.float64).reshape(3, 3)
        poses[i, :3, 3] = np.asarray(g["cam_t_m2c"], np.float64).reshape(3) * mm_to_m
        poses[i, 3, 3] = 1.0
    return poses


def _build_obs(key: str, parts: Dict[str, bytes], depth_scale: float = 1.0,
               load_depth: bool = True) -> Optional[SceneObservation]:
    scene_id, im_id = (int(x) for x in key.split("_"))
    rgb = None
    for name in ("rgb.png", "rgb.jpg", "gray.tif"):
        if name in parts:
            rgb = _decode_image(parts[name], name)
            break
    if rgb is None:
        return None
    rgb = _to_rgb(rgb)

    cam = json.loads(parts["camera.json"])
    K = np.asarray(cam["cam_K"], np.float64).reshape(3, 3)

    depth = None
    if load_depth and "depth.png" in parts:
        d = _decode_image(parts["depth.png"], "depth.png").astype(np.float32)
        depth = d * cam.get("depth_scale", depth_scale) / 1000.0  # -> meters

    gt = json.loads(parts.get("gt.json", b"[]"))
    gt_info = json.loads(parts.get("gt_info.json", b"[]"))
    masks_rle = json.loads(parts["mask_visib.json"]) if "mask_visib.json" in parts else None

    keep = [
        i for i in range(len(gt))
        if not gt_info or gt_info[i].get("visib_fract", 1.0) > MIN_VISIB_FRACT
    ]
    object_ids = [int(gt[i]["obj_id"]) for i in keep]
    poses = _parse_gt([gt[i] for i in keep])
    bboxes = np.asarray(
        [gt_info[i]["bbox_visib"] for i in keep] if gt_info else np.zeros((len(keep), 4)),
        np.float64,
    ).reshape(len(keep), 4)
    masks = None
    if masks_rle is not None:
        masks = np.stack(
            [rle_decode(masks_rle[i] if isinstance(masks_rle, list) else masks_rle[str(i)]) for i in keep]
        ) if keep else np.zeros((0,) + rgb.shape[:2], np.uint8)
    visib = np.asarray(
        [gt_info[i].get("visib_fract", 1.0) for i in keep] if gt_info else [1.0] * len(keep)
    )
    return SceneObservation(
        scene_id=scene_id, im_id=im_id, rgb=rgb, depth=depth, K=K,
        object_ids=object_ids, poses=poses, bboxes_xywh=bboxes, masks=masks,
        visib_fract=visib,
    )


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _read_json(path: str, default):
    """The parsed file; `default` when it is absent (None: it must exist)."""
    if default is not None and not osp.exists(path):
        return default
    with open(path) as f:
        return json.load(f)


class TarSceneSource:
    """Iterate SceneObservations out of webdataset-style tar shards."""

    def __init__(self, shard_dir: str, depth_scale: float = 1.0,
                 load_depth: bool = True, blacklist: Optional[List[str]] = None):
        self.shard_dir = shard_dir
        self.depth_scale = depth_scale
        self.load_depth = load_depth
        names = sorted(f for f in os.listdir(shard_dir) if f.endswith(".tar"))
        blacklist = set(blacklist or [])
        self.shards = [osp.join(shard_dir, n) for n in names if n not in blacklist]
        index_path = osp.join(shard_dir, "key_to_shard.json")
        self.key_index = None
        if osp.exists(index_path):
            with open(index_path) as f:
                self.key_index = json.load(f)

    def lookup(self, key: str) -> Optional["SceneObservation"]:
        """Random access by sample key through key_to_shard.json
        ({key: shard_id}, the reference's index contract —
        convert_imagewise_to_webdataset.py:98-108). Returns None when the
        index, the shard, or the key is absent."""
        if self.key_index is None or key not in self.key_index:
            return None
        path = osp.join(self.shard_dir, f"shard-{int(self.key_index[key]):06d}.tar")
        # Honor the constructor's blacklist: self.shards is the already
        # blacklist-filtered set, so a resolved shard outside it must not be
        # served through random access either (matches __iter__ semantics).
        if path not in self.shards or not osp.exists(path):
            return None
        parts = {}
        with tarfile.open(path) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                base = osp.basename(member.name)
                k, _, suffix = base.partition(".")
                if k == key:
                    parts[suffix] = tf.extractfile(member).read()
        if not parts:
            return None
        return _build_obs(key, parts, self.depth_scale, self.load_depth)

    def __iter__(self) -> Iterator[SceneObservation]:
        for shard in self.shards:
            with tarfile.open(shard) as tf:
                current_key, parts = None, {}
                for member in tf:
                    if not member.isfile():
                        continue
                    base = osp.basename(member.name)
                    key, _, suffix = base.partition(".")
                    if current_key is not None and key != current_key:
                        obs = _build_obs(current_key, parts, self.depth_scale,
                                         self.load_depth)
                        if obs is not None:
                            yield obs
                        parts = {}
                    current_key = key
                    parts[suffix] = tf.extractfile(member).read()
                if current_key is not None and parts:
                    obs = _build_obs(current_key, parts, self.depth_scale,
                                     self.load_depth)
                    if obs is not None:
                        yield obs


class DirSceneSource:
    """Iterate SceneObservations from the classic BOP directory layout."""

    def __init__(self, split_dir: str, load_depth: bool = True,
                 load_masks: bool = True):
        self.split_dir = split_dir
        self.load_depth = load_depth
        self.load_masks = load_masks
        self.scenes = sorted(
            d for d in os.listdir(split_dir)
            if osp.isdir(osp.join(split_dir, d)) and d.isdigit()
        )

    def __iter__(self) -> Iterator[SceneObservation]:
        for scene in self.scenes:
            sdir = osp.join(self.split_dir, scene)
            cams = _read_json(osp.join(sdir, "scene_camera.json"), None)
            gts = _read_json(osp.join(sdir, "scene_gt.json"), {})
            gt_infos = _read_json(osp.join(sdir, "scene_gt_info.json"), {})
            for im_id_s, cam in sorted(cams.items(), key=lambda kv: int(kv[0])):
                im_id = int(im_id_s)
                parts: Dict[str, bytes] = {
                    "camera.json": json.dumps(cam).encode()
                }
                for ext in ("png", "jpg", "tif"):
                    p = osp.join(sdir, "rgb", f"{im_id:06d}.{ext}")
                    if osp.exists(p):
                        parts["rgb.png" if ext != "tif" else "gray.tif"] = _read_bytes(p)
                        break
                dp = osp.join(sdir, "depth", f"{im_id:06d}.png")
                if self.load_depth and osp.exists(dp):
                    parts["depth.png"] = _read_bytes(dp)
                if im_id_s in gts:
                    parts["gt.json"] = json.dumps(gts[im_id_s]).encode()
                if im_id_s in gt_infos:
                    parts["gt_info.json"] = json.dumps(gt_infos[im_id_s]).encode()
                if self.load_masks and im_id_s in gts:
                    rles = []
                    ok = True
                    for i in range(len(gts[im_id_s])):
                        mp = osp.join(sdir, "mask_visib", f"{im_id:06d}_{i:06d}.png")
                        if not osp.exists(mp):
                            ok = False
                            break
                        m = decode_png(_read_bytes(mp)) > 0
                        rles.append(rle_encode(m.astype(np.uint8)))
                    if ok and rles:
                        parts["mask_visib.json"] = json.dumps(rles).encode()
                obs = _build_obs(f"{int(scene):06d}_{im_id:06d}", parts,
                                 load_depth=self.load_depth)
                if obs is not None:
                    yield obs
