"""Convert a BOP split in the scenewise directory layout into webdataset-style
tar shards (port of gigapose_tpu/scripts/convert_to_shards.py, same
arguments, byte-equal output).

Each image's files become members
{scene:06d}_{im:06d}.{rgb.png|rgb.jpg, depth.png, camera.json, gt.json,
gt_info.json, mask_visib.json} of fixed-size .tar shards, plus
key_to_shard.json: the contract TarSceneSource (dataloader/scene.py) reads
back. The rgb and depth files are copied as they are (a train_pbr split's
JPEGs stay JPEGs); the visible masks are decoded (dataloader/png.py) and
stored run-length encoded. Members carry mtime 0, so the same split gives
the same bytes.

Usage:
    python -m gigapose_tpu_torch.scripts.convert_to_shards \
        split_dir=<bop split dir> out_dir=<shards dir> [shard_size=1000]
"""

from __future__ import annotations

import io
import json
import os
import os.path as osp
import sys
import tarfile

import numpy as np

from gigapose_tpu_torch.dataloader.bop_io import rle_encode
from gigapose_tpu_torch.dataloader.png import decode_png

KEYS = ("split_dir", "out_dir", "shard_size")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _load_json(path: str, default=None):
    if default is not None and not osp.exists(path):
        return default
    with open(path) as f:
        return json.load(f)


def _add_bytes(tar: tarfile.TarFile, name: str, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def _masks_json(sdir: str, im_id: int, n: int):
    """The image's n visible masks as RLE json bytes; None when one is missing."""
    rles = []
    for i in range(n):
        path = osp.join(sdir, "mask_visib", f"{im_id:06d}_{i:06d}.png")
        if not osp.exists(path):
            return None
        rles.append(rle_encode((decode_png(_read(path)) > 0).astype(np.uint8)))
    return json.dumps(rles).encode() if rles else None


def convert(split_dir: str, out_dir: str, shard_size: int = 1000) -> int:
    """Write the shards and key_to_shard.json; returns the number of images."""
    os.makedirs(out_dir, exist_ok=True)
    scenes = sorted(d for d in os.listdir(split_dir)
                    if d.isdigit() and osp.isdir(osp.join(split_dir, d)))
    key_to_shard = {}
    shard_idx, n_in_shard = 0, 0
    tar = tarfile.open(osp.join(out_dir, f"shard-{shard_idx:06d}.tar"), "w")
    for scene in scenes:
        sdir = osp.join(split_dir, scene)
        cams = _load_json(osp.join(sdir, "scene_camera.json"))
        gts = _load_json(osp.join(sdir, "scene_gt.json"), {})
        gt_infos = _load_json(osp.join(sdir, "scene_gt_info.json"), {})
        for im_id_s, cam in sorted(cams.items(), key=lambda kv: int(kv[0])):
            im_id = int(im_id_s)
            key = f"{int(scene):06d}_{im_id:06d}"
            if n_in_shard >= shard_size:
                tar.close()
                shard_idx += 1
                n_in_shard = 0
                tar = tarfile.open(osp.join(out_dir, f"shard-{shard_idx:06d}.tar"), "w")
            for ext in ("png", "jpg"):
                path = osp.join(sdir, "rgb", f"{im_id:06d}.{ext}")
                if osp.exists(path):
                    _add_bytes(tar, f"{key}.rgb.{ext}", _read(path))
                    break
            path = osp.join(sdir, "depth", f"{im_id:06d}.png")
            if osp.exists(path):
                _add_bytes(tar, f"{key}.depth.png", _read(path))
            _add_bytes(tar, f"{key}.camera.json", json.dumps(cam).encode())
            if im_id_s in gts:
                _add_bytes(tar, f"{key}.gt.json", json.dumps(gts[im_id_s]).encode())
            if im_id_s in gt_infos:
                _add_bytes(tar, f"{key}.gt_info.json", json.dumps(gt_infos[im_id_s]).encode())
            if im_id_s in gts:
                masks = _masks_json(sdir, im_id, len(gts[im_id_s]))
                if masks is not None:
                    _add_bytes(tar, f"{key}.mask_visib.json", masks)
            key_to_shard[key] = shard_idx
            n_in_shard += 1
    tar.close()
    with open(osp.join(out_dir, "key_to_shard.json"), "w") as f:
        json.dump(key_to_shard, f)
    return len(key_to_shard)


def main(argv=None):
    kv = dict(a.split("=", 1) for a in (argv if argv is not None else sys.argv[1:]))
    unknown = sorted(set(kv) - set(KEYS))
    if unknown:
        raise ValueError(f"unknown arguments {unknown}; convert_to_shards takes {list(KEYS)}")
    n = convert(kv["split_dir"], kv["out_dir"], int(kv.get("shard_size", 1000)))
    print(f"converted {n} images -> {kv['out_dir']}")
    return n


if __name__ == "__main__":
    main()
