"""Synthetic BOP-format datasets for the port's self-checks (port of the JAX
package's tests/synthetic_bop.py, PIL-free).

- `build`: a textured-square object pasted into the images (templates, one
  test scene, CNOS-style detections, targets, a small train_pbr split, cube
  meshes for the refiner): the whole disk contract of the inference
  pipeline without real BOP data.
- `build_rendered`: one vertex-coloured cube rendered by the host
  rasterizer (render/rasterizer.py) into the templates, the train_pbr scenes
  and a held-out test scene, so viewpoint, scale and in-plane rotation are
  real 3D geometry; returns the test scene's ground-truth pose.

Both draw the same random numbers in the same order as the JAX package's
builders, so one seed gives the same files: the JSON and npy files equal,
the PNGs equal once decoded (they are written by dataloader/png.py's
encode_png with filter-0 rows, not by PIL, so their bytes differ).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Optional, Tuple

import numpy as np

from gigapose_tpu_torch.dataloader import bop_io
from gigapose_tpu_torch.dataloader.png import encode_png, save_png

DS = "tudl"  # a core-19 dataset name, so the detection registry resolves
OBJ_ID = 1
NUM_OBJECTS = 2  # a second object exercises multi-object label indexing
K_LIST = [572.4114, 0.0, 320.0, 0.0, 573.57043, 240.0, 0.0, 0.0, 1.0]
DETECTIONS = ("default_detections", "core19_model_based_unseen", "cnos-fastsam")


def write_cube_ply(path: str, size: float = 0.05, colors: bool = True) -> np.ndarray:
    """An axis-aligned ASCII PLY cube centred at the origin, side `size`,
    with sign-asymmetric vertex colours (every orientation looks different);
    -> its (8, 3) f32 vertices."""
    s = size / 2
    verts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)], np.float32)
    cols = (verts / s * 100 + 128).astype(np.uint8)
    faces = [
        (0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),  # x faces
        (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),  # y faces
        (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3),  # z faces
    ]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v, c in zip(verts, cols):
            line = f"{v[0]} {v[1]} {v[2]}"
            if colors:
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
        for fc in faces:
            f.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n")
    return verts


def _dump(path: str, data) -> None:
    with open(path, "w") as f:
        json.dump(data, f)


def _write_detections(datasets: str, dets: list, targets: list) -> None:
    det_dir = osp.join(datasets, *DETECTIONS)
    os.makedirs(det_dir, exist_ok=True)
    _dump(osp.join(det_dir, f"cnos-fastsam_{DS}-test_fixture.json"), dets)
    _dump(osp.join(datasets, DS, "test_targets_bop19.json"), targets)


def _bbox(mask: np.ndarray) -> list:
    ys, xs = np.nonzero(mask)
    return [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
            int(ys.max() - ys.min() + 1)]


def build(root: str, num_templates: int = 8, img_hw=(480, 640), obj_px: int = 120,
          n_test_images: int = 1, insts_per_image: Optional[int] = None) -> str:
    """The pasted-texture fixture under `root`; -> root. n_test_images and
    insts_per_image (up to 8 grid slots) scale the test split."""
    rng = np.random.default_rng(0)
    datasets = osp.join(root, "datasets")
    H, W = img_hw

    # per-object textures, the same in every view
    textures = [(rng.uniform(0.2, 1.0, size=(obj_px, obj_px, 3)) * 255).astype(np.uint8)
                for _ in range(NUM_OBJECTS)]

    # templates: RGBA with the texture centred, all at 400 mm
    pose_dir = osp.join(datasets, "templates", DS, "object_poses")
    os.makedirs(pose_dir, exist_ok=True)
    y0, x0 = (H - obj_px) // 2, (W - obj_px) // 2
    poses = np.tile(np.eye(4), (num_templates, 1, 1))
    poses[:, 2, 3] = 400.0  # mm
    for obj_id in range(1, NUM_OBJECTS + 1):
        tdir = osp.join(datasets, "templates", DS, f"{obj_id:06d}")
        os.makedirs(tdir, exist_ok=True)
        rgba = np.zeros((H, W, 4), np.uint8)
        rgba[y0:y0 + obj_px, x0:x0 + obj_px, :3] = textures[obj_id - 1]
        rgba[y0:y0 + obj_px, x0:x0 + obj_px, 3] = 255
        depth = np.zeros((H, W), np.uint16)
        depth[y0:y0 + obj_px, x0:x0 + obj_px] = 400
        rgba_png, depth_png = encode_png(rgba), encode_png(depth)
        for v in range(num_templates):
            for name, data in ((f"{v:06d}.png", rgba_png), (f"{v:06d}_depth.png", depth_png)):
                with open(osp.join(tdir, name), "wb") as f:
                    f.write(data)
        np.save(osp.join(pose_dir, f"{obj_id:06d}.npy"), poses)

    # test scene(s): the objects pasted at non-overlapping grid slots
    scene_dir = osp.join(datasets, DS, "test", "000001")
    os.makedirs(osp.join(scene_dir, "rgb"), exist_ok=True)
    slots = [(100, 380), (280, 80)]  # object 1 top-right, object 2 bottom-left
    n_inst = insts_per_image or NUM_OBJECTS
    if n_inst > 2:
        slots = [(y, x) for y in (60, 280) for x in (20, 180, 340, 500)]
    if n_inst > len(slots):
        raise ValueError(f"insts_per_image={n_inst}: at most {len(slots)} slots")
    cams, dets, targets = {}, [], []
    for im in range(n_test_images):
        img = (rng.uniform(0, 0.15, size=(H, W, 3)) * 255).astype(np.uint8)
        placed = []
        for j in range(n_inst):
            obj_id = 1 + j % NUM_OBJECTS
            qy, qx = slots[j]
            img[qy:qy + obj_px, qx:qx + obj_px] = textures[obj_id - 1]
            placed.append((obj_id, qy, qx))
        save_png(osp.join(scene_dir, "rgb", f"{im:06d}.png"), img)
        cams[str(im)] = {"cam_K": K_LIST, "depth_scale": 1.0}
        counts = {}
        for obj_id, qy, qx in placed:
            mask = np.zeros((H, W), np.uint8)
            mask[qy:qy + obj_px, qx:qx + obj_px] = 1
            dets.append({"scene_id": 1, "image_id": im, "category_id": obj_id, "score": 0.95,
                         "bbox": [qx, qy, obj_px, obj_px],
                         "segmentation": bop_io.rle_encode(mask), "time": 0.12})
            counts[obj_id] = counts.get(obj_id, 0) + 1
        for obj_id, cnt in sorted(counts.items()):
            targets.append({"scene_id": 1, "im_id": im, "obj_id": obj_id, "inst_count": cnt})
    _dump(osp.join(scene_dir, "scene_camera.json"), cams)
    _write_detections(datasets, dets, targets)

    # a small training split (directory layout with depth, masks and gt)
    tr = osp.join(datasets, DS, "train_pbr", "000001")
    for sub in ("rgb", "depth", "mask_visib"):
        os.makedirs(osp.join(tr, sub), exist_ok=True)
    cams, gts, infos = {}, {}, {}
    for im in range(3):
        img = (rng.uniform(0, 0.15, size=(H, W, 3)) * 255).astype(np.uint8)
        img[y0:y0 + obj_px, x0:x0 + obj_px] = textures[0]
        save_png(osp.join(tr, "rgb", f"{im:06d}.png"), img)
        depth = np.zeros((H, W), np.uint16)
        depth[y0:y0 + obj_px, x0:x0 + obj_px] = 400  # mm
        save_png(osp.join(tr, "depth", f"{im:06d}.png"), depth)
        m = np.zeros((H, W), np.uint8)
        m[y0:y0 + obj_px, x0:x0 + obj_px] = 255
        save_png(osp.join(tr, "mask_visib", f"{im:06d}_000000.png"), m)
        cams[str(im)] = {"cam_K": K_LIST, "depth_scale": 1.0}
        gts[str(im)] = [{"obj_id": OBJ_ID, "cam_R_m2c": np.eye(3).reshape(-1).tolist(),
                         "cam_t_m2c": [0.0, 0.0, 400.0]}]
        infos[str(im)] = [{"bbox_visib": [x0, y0, obj_px, obj_px], "visib_fract": 1.0}]
    for name, data in (("scene_camera", cams), ("scene_gt", gts), ("scene_gt_info", infos)):
        _dump(osp.join(tr, f"{name}.json"), data)

    # CAD models for the refiner: small cubes, in metres
    models = osp.join(datasets, DS, "models")
    os.makedirs(models, exist_ok=True)
    for obj_id in range(1, NUM_OBJECTS + 1):
        write_cube_ply(osp.join(models, f"obj_{obj_id:06d}.ply"), size=0.08)
    return root


def build_rendered(root: str, n_train: int = 40, level: int = 0, seed: int = 0,
                   obj_size_mm: float = 80.0) -> Tuple[str, np.ndarray]:
    """The rendered fixture under `root`, in mm (BOP's unit): one coloured
    cube; its icosphere templates of `level`, `n_train` train_pbr scenes at
    random poses and one test scene with a CNOS-style detection, all from
    the host rasterizer. -> (root, the test scene's pose (4, 4) in mm)."""
    from scipy.spatial.transform import Rotation

    from gigapose_tpu_torch.render import templates as TP
    from gigapose_tpu_torch.render.rasterizer import Rasterizer, render_template_views

    rng = np.random.default_rng(seed)
    datasets = osp.join(root, "datasets")
    K = np.array(K_LIST).reshape(3, 3)

    # the mesh, in mm, vertex-coloured so that viewpoints differ
    models = osp.join(datasets, DS, "models")
    os.makedirs(models, exist_ok=True)
    mesh_path = osp.join(models, f"obj_{OBJ_ID:06d}.ply")
    write_cube_ply(mesh_path, size=obj_size_mm, colors=True)

    # rendered templates and their poses (the object at 400 mm)
    render_template_views(mesh_path, osp.join(datasets, "templates", DS, f"{OBJ_ID:06d}"),
                          level=level)
    pose_dir = osp.join(datasets, "templates", DS, "object_poses")
    os.makedirs(pose_dir, exist_ok=True)
    np.save(osp.join(pose_dir, f"{OBJ_ID:06d}.npy"), TP.template_poses(level, 0.4))

    r = Rasterizer(mesh_path)

    def sample_pose(rs) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = Rotation.random(random_state=rs).as_matrix()
        T[0, 3] = rng.uniform(-40, 40)
        T[1, 3] = rng.uniform(-30, 30)
        T[2, 3] = rng.uniform(350, 550)
        return T

    def write_scene(split: str, image_poses) -> None:
        sdir = osp.join(datasets, DS, split, "000001")
        for sub in ("rgb", "depth", "mask_visib"):
            os.makedirs(osp.join(sdir, sub), exist_ok=True)
        cams, gts, infos = {}, {}, {}
        for im, T in enumerate(image_poses):
            rgba, depth = r.render(K, T.astype(np.float32), 640, 480)
            rgb = rgba[..., :3].copy()
            bg = rgba[..., 3] == 0
            rgb[bg] = (rng.uniform(0, 0.1, (int(bg.sum()), 3)) * 255).astype(np.uint8)
            save_png(osp.join(sdir, "rgb", f"{im:06d}.png"), rgb)
            save_png(osp.join(sdir, "depth", f"{im:06d}.png"),
                     np.clip(depth, 0, 65535).astype(np.uint16))
            mask = ((rgba[..., 3] > 0) * 255).astype(np.uint8)
            save_png(osp.join(sdir, "mask_visib", f"{im:06d}_000000.png"), mask)
            cams[str(im)] = {"cam_K": K_LIST, "depth_scale": 1.0}
            gts[str(im)] = [{"obj_id": OBJ_ID, "cam_R_m2c": T[:3, :3].reshape(-1).tolist(),
                             "cam_t_m2c": T[:3, 3].tolist()}]
            infos[str(im)] = [{"bbox_visib": _bbox(mask), "visib_fract": 1.0}]
        for name, data in (("scene_camera", cams), ("scene_gt", gts), ("scene_gt_info", infos)):
            _dump(osp.join(sdir, f"{name}.json"), data)

    write_scene("train_pbr", [sample_pose(rng.integers(1 << 30)) for _ in range(n_train)])

    # the test scene: one held-out pose and its CNOS-style detection
    gt_test = sample_pose(12345)
    write_scene("test", [gt_test])
    rgba, _ = r.render(K, gt_test.astype(np.float32), 640, 480)
    mask = (rgba[..., 3] > 0).astype(np.uint8)
    det = {"scene_id": 1, "image_id": 0, "category_id": OBJ_ID, "score": 0.95,
           "bbox": _bbox(mask), "segmentation": bop_io.rle_encode(mask), "time": 0.1}
    _write_detections(datasets, [det],
                      [{"scene_id": 1, "im_id": 0, "obj_id": OBJ_ID, "inst_count": 1}])
    return root, gt_test
