"""BOP19 pose scoring: csv + dataset -> average recall (port of
gigapose_tpu/eval/scorer.py).

Recomputes the BOP19 protocol without bop_toolkit: VSD on depth rendered by
the port's host C++ rasterizer (render/rasterizer.py), MSSD / MSPD as f32
torch functions on the scorer's device (eval/errors.py), and the greedy
score-ordered matching and threshold-grid recall of bop_toolkit's
eval_bop19_pose. It replicates bop_toolkit's symmetry discretization
(misc.get_symmetry_transformations: ceil(pi / 0.01) steps, cont∘disc, no
pure identity beside a continuous symmetry) and its distance images
(misc.depth_im_to_dist_im_fast). scripts/eval_bop.py scores with it when
bop_toolkit is not installed.

Depth PNGs are read with the port's decoder (dataloader/png.py), not PIL.
"""

from __future__ import annotations

import glob
import json
import os.path as osp
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gigapose_tpu_torch.dataloader import bop_io
from gigapose_tpu_torch.dataloader.png import decode_png
from gigapose_tpu_torch.eval import errors as E
from gigapose_tpu_torch.render.mesh_io import diameter as _diameter
from gigapose_tpu_torch.render.mesh_io import load_vertices
from gigapose_tpu_torch.utils.device import resolve_device

# BOP19 threshold grids (eval_bop19_pose defaults)
VSD_DELTA = 15.0  # mm; taus are 0.05..0.5 of the object diameter
REC_THRESH_VSD = np.arange(0.05, 0.51, 0.05)  # error in [0,1]
REC_THRESH_MSSD = np.arange(0.05, 0.51, 0.05)  # fractions of diameter
REC_THRESH_MSPD = np.arange(5, 51, 5)  # px at 640-wide images
VISIB_GT_MIN = 0.1


def load_models_info(models_dir: str) -> Dict[int, dict]:
    """models_info.json when present (BOP ships it); else diameters computed
    from the meshes and no symmetries."""
    path = osp.join(models_dir, "models_info.json")
    if osp.exists(path):
        with open(path) as f:
            raw = json.load(f)
        return {int(k): v for k, v in raw.items()}
    info = {}
    for mesh in sorted(glob.glob(osp.join(models_dir, "obj_*.ply")) +
                       glob.glob(osp.join(models_dir, "obj_*.obj"))):
        obj_id = int(osp.basename(mesh).split("_")[1].split(".")[0])
        verts, _ = _load_vertices_mm(mesh)
        info[obj_id] = {"diameter": _diameter(verts)}
    return info


def _load_vertices_mm(mesh_path: str) -> Tuple[np.ndarray, float]:
    """Vertices in mm (f64) and the mesh-unit -> mm scale (a diameter below
    5 means metres)."""
    verts = load_vertices(mesh_path)
    scale = 1000.0 if _diameter(verts) < 5.0 else 1.0
    return verts * scale, scale


def symmetry_set(info: dict, verts_mm: Optional[np.ndarray] = None,
                 max_disc_step: float = 0.01) -> Tuple[np.ndarray, np.ndarray]:
    """(S,3,3),(S,3) f32 symmetry transforms, as bop_toolkit's
    misc.get_symmetry_transformations gives them:

    - each continuous symmetry is discretized into ceil(pi / max_disc_step)
      steps (315 at BOP19's 0.01), whatever the mesh, of which steps
      1..n-1 are kept (no identity);
    - with a continuous symmetry the set holds only cont∘disc compositions,
      R = R_cont @ R_disc, t = R_cont @ t_disc + t_cont; without one it is
      the discrete set with the identity first.

    verts_mm is not used (the toolkit's count does not depend on the mesh)."""
    del verts_mm
    disc_R = [np.eye(3)]
    disc_t = [np.zeros(3)]
    for m in info.get("symmetries_discrete", []):
        T = np.asarray(m, np.float64).reshape(4, 4)
        disc_R.append(T[:3, :3])
        disc_t.append(T[:3, 3])
    cont_R: List[np.ndarray] = []
    cont_t: List[np.ndarray] = []
    for sym in info.get("symmetries_continuous", []):
        axis = np.asarray(sym["axis"], np.float64)
        axis = axis / np.linalg.norm(axis)
        offset = np.asarray(sym.get("offset", [0, 0, 0]), np.float64)
        n = int(np.ceil(np.pi / max_disc_step))
        for k in range(1, n):
            R = _axis_angle(axis, 2.0 * np.pi * k / n)
            cont_R.append(R)
            cont_t.append(offset - R @ offset)
    R, t = [], []
    for dR, dt in zip(disc_R, disc_t):
        if cont_R:
            for cR, ct in zip(cont_R, cont_t):
                R.append(cR @ dR)
                t.append(cR @ dt + ct)
        else:
            R.append(dR)
            t.append(dt)
    return np.stack(R).astype(np.float32), np.stack(t).astype(np.float32)


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _greedy_recall(err_mats: List[np.ndarray], scores: List[np.ndarray], n_gt_total: int,
                   thresh: float) -> float:
    """bop_toolkit matching: per image-group, estimates in score order each
    claim the lowest-error unmatched gt with error < thresh."""
    matched = 0
    for errs, sc in zip(err_mats, scores):
        if errs.size == 0:
            continue
        taken = np.zeros(errs.shape[1], bool)
        for i in np.argsort(-sc):
            ok = np.where(~taken & (errs[i] < thresh))[0]
            if ok.size:
                j = ok[np.argmin(errs[i][ok])]
                taken[j] = True
                matched += 1
    return matched / max(n_gt_total, 1)


class _SceneGT:
    """Lazy per-scene gt / camera / depth access in the BOP dir layout."""

    def __init__(self, split_dir: str):
        self.split_dir = split_dir
        self._cache: Dict[int, tuple] = {}

    def get(self, scene_id: int):
        if scene_id not in self._cache:
            sdir = osp.join(self.split_dir, f"{scene_id:06d}")
            with open(osp.join(sdir, "scene_gt.json")) as f:
                gt = json.load(f)
            with open(osp.join(sdir, "scene_camera.json")) as f:
                cam = json.load(f)
            info_path = osp.join(sdir, "scene_gt_info.json")
            info = {}
            if osp.exists(info_path):
                with open(info_path) as f:
                    info = json.load(f)
            self._cache[scene_id] = (sdir, gt, cam, info)
        return self._cache[scene_id]

    def depth(self, scene_id: int, im_id: int) -> Optional[np.ndarray]:
        sdir, _, cam, _ = self.get(scene_id)
        path = osp.join(sdir, "depth", f"{im_id:06d}.png")
        if not osp.exists(path):
            return None
        with open(path, "rb") as f:
            d = np.asarray(decode_png(f.read()), np.float64)
        return d * float(cam[str(im_id)].get("depth_scale", 1.0))


def score_bop(csv_path: str, root_dir: str, dataset_name: str, split: str = "test",
              error_types: Sequence[str] = ("vsd", "mssd", "mspd"), max_points: int = 2000,
              device=None, timing: Optional[dict] = None) -> dict:
    """Score a BOP19 csv against the dataset's ground truth -> {
    bop19_average_recall, bop19_average_recall_{vsd,mssd,mspd}, n_targets,
    scorer}. MSSD and MSPD run on `device` (cuda:0 unless given); VSD
    renders on the host. `timing`, if given, gains images and seconds."""
    from gigapose_tpu_torch.render.rasterizer import Rasterizer

    t_start = time.perf_counter()
    dev = resolve_device(device, "score_bop")
    ds_dir = osp.join(root_dir, "datasets", dataset_name)
    models_dir = osp.join(ds_dir, "models")
    split_dir = osp.join(ds_dir, split)
    results = bop_io.load_bop_csv(csv_path)
    with open(osp.join(ds_dir, "test_targets_bop19.json")) as f:
        targets = json.load(f)

    models_info = load_models_info(models_dir)
    scene_gt = _SceneGT(split_dir)

    # per-object geometry (vertices in mm on the device, symmetry set, rasterizer)
    geo: Dict[int, dict] = {}

    def get_geo(obj_id: int) -> dict:
        if obj_id not in geo:
            mesh = osp.join(models_dir, f"obj_{obj_id:06d}.ply")
            if not osp.exists(mesh):
                mesh = osp.join(models_dir, f"obj_{obj_id:06d}.obj")
            verts, scale = _load_vertices_mm(mesh)
            if len(verts) > max_points:
                verts = verts[np.linspace(0, len(verts) - 1, max_points).astype(int)]
            info = models_info.get(obj_id, {"diameter": _diameter(verts)})
            sym_R, sym_t = symmetry_set(info, verts)
            geo[obj_id] = {
                "verts": E.as_f32(verts, dev),
                "diameter": float(info["diameter"]),
                "sym": (E.as_f32(sym_R, dev), E.as_f32(sym_t, dev)),
                "raster": Rasterizer(mesh) if "vsd" in error_types else None,
                "unit_to_mm": scale,
            }
        return geo[obj_id]

    # group estimates by (scene, im, obj); keep top inst_count by score
    est_by_group: Dict[tuple, List[dict]] = {}
    for r in results:
        est_by_group.setdefault((r["scene_id"], r["im_id"], r["obj_id"]), []).append(r)

    mats: Dict[str, List] = {e: [] for e in error_types}
    scores: List[np.ndarray] = []
    diam_per_group: List[float] = []
    imw_per_group: List[float] = []
    n_gt_total = 0
    n_taus = 10
    images = set()

    for tgt in targets:
        sid, iid, oid = tgt["scene_id"], tgt["im_id"], tgt["obj_id"]
        inst = int(tgt.get("inst_count", 1))
        sdir, gt_all, cam_all, info_all = scene_gt.get(sid)
        cam = cam_all[str(iid)]
        K = np.asarray(cam["cam_K"], np.float64).reshape(3, 3)
        gts = [(k, g) for k, g in enumerate(gt_all.get(str(iid), [])) if g["obj_id"] == oid]
        # bop19 validity: visib_fract >= 0.1 when gt_info exists
        im_info = info_all.get(str(iid), [])
        gts = [(k, g) for k, g in gts
               if not im_info or im_info[k].get("visib_fract", 1.0) >= VISIB_GT_MIN]
        if not gts:
            continue
        images.add((sid, iid))
        n_gt_total += min(inst, len(gts))
        g = get_geo(oid)
        ests = sorted(est_by_group.get((sid, iid, oid), []), key=lambda r: -r["score"])[:inst]
        sc = np.asarray([r["score"] for r in ests])
        scores.append(sc)
        diam_per_group.append(g["diameter"])

        depth_test = scene_gt.depth(sid, iid) if "vsd" in error_types else None
        if depth_test is not None:
            H, W = depth_test.shape
            # bop_toolkit compares distance images; the scene's once per group
            dist_test = E.depth_im_to_dist_im(depth_test, K)
        else:
            W = 640  # MSPD's thresholds are for 640-wide images
        imw_per_group.append(float(W))

        m = {e: np.zeros((len(ests), len(gts))) for e in error_types if e != "vsd"}
        if "vsd" in error_types:
            m["vsd"] = np.zeros((len(ests), len(gts), n_taus))
        gt_depth_cache = {}
        for j, (_, gt) in enumerate(gts):
            R_g = np.asarray(gt["cam_R_m2c"], np.float64).reshape(3, 3)
            t_g = np.asarray(gt["cam_t_m2c"], np.float64).reshape(3)
            for i, r in enumerate(ests):
                R_e, t_e = r["R"], r["t"].reshape(3)
                if "mssd" in error_types:
                    m["mssd"][i, j] = E.mssd_error(R_e, t_e, R_g, t_g, g["verts"], *g["sym"],
                                                   device=dev)
                if "mspd" in error_types:
                    m["mspd"][i, j] = E.mspd_error(R_e, t_e, R_g, t_g, g["verts"], K, *g["sym"],
                                                   device=dev)
                if "vsd" in error_types and depth_test is not None:
                    if j not in gt_depth_cache:
                        gt_depth_cache[j] = E.depth_im_to_dist_im(
                            _render_depth_mm(g, K, R_g, t_g, W, H), K)
                    d_est = E.depth_im_to_dist_im(_render_depth_mm(g, K, R_e, t_e, W, H), K)
                    taus = np.arange(0.05, 0.51, 0.05) * g["diameter"]
                    # all three inputs are distance images already -> K=None
                    m["vsd"][i, j] = E.vsd_error(d_est, gt_depth_cache[j], dist_test, VSD_DELTA,
                                                 taus)
                elif "vsd" in error_types:
                    m["vsd"][i, j] = 1.0  # no depth -> VSD undefined/failed
        for e in error_types:
            mats[e].append(m[e])

    out = {}
    recalls_all = []
    if "vsd" in error_types:
        recs = []
        for ti in range(n_taus):
            tau_mats = [m[:, :, ti] for m in mats["vsd"]]
            for th in REC_THRESH_VSD:
                recs.append(_greedy_recall(tau_mats, scores, n_gt_total, th))
        out["bop19_average_recall_vsd"] = float(np.mean(recs)) if recs else 0.0
        recalls_all.append(out["bop19_average_recall_vsd"])
    if "mssd" in error_types:
        recs = []
        for th in REC_THRESH_MSSD:
            dmats = [m / d for m, d in zip(mats["mssd"], diam_per_group)]
            recs.append(_greedy_recall(dmats, scores, n_gt_total, th))
        out["bop19_average_recall_mssd"] = float(np.mean(recs)) if recs else 0.0
        recalls_all.append(out["bop19_average_recall_mssd"])
    if "mspd" in error_types:
        recs = []
        for th in REC_THRESH_MSPD:
            # thresholds scale with im_width/640 (BOP19)
            nmats = [m * (640.0 / w) for m, w in zip(mats["mspd"], imw_per_group)]
            recs.append(_greedy_recall(nmats, scores, n_gt_total, th))
        out["bop19_average_recall_mspd"] = float(np.mean(recs)) if recs else 0.0
        recalls_all.append(out["bop19_average_recall_mspd"])
    out["bop19_average_recall"] = float(np.mean(recalls_all)) if recalls_all else 0.0
    out["n_targets"] = n_gt_total
    out["scorer"] = "native"
    if timing is not None:
        timing.update(images=len(images), seconds=time.perf_counter() - t_start)
    return out


def _render_depth_mm(g: dict, K, R, t, W, H) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t, np.float64) / g["unit_to_mm"]  # mm -> mesh units
    _, depth = g["raster"].render(np.asarray(K, np.float32), T.astype(np.float32), W, H)
    return depth * g["unit_to_mm"]


class ModelNetMeter:
    """ModelNetErrorMeter's summary: add0.1d / 5deg_5cm / proj2d_5px over
    accumulated (pred, gt) pose pairs. Units: mm poses and mm points
    (converted to the meter thresholds). ADD runs on `device` (cuda:0
    unless given)."""

    def __init__(self, points_mm: np.ndarray, device=None):
        self.pts = np.asarray(points_mm, np.float32)
        self.device = resolve_device(device, "ModelNetMeter")
        extent = self.pts.max(0) - self.pts.min(0)
        self.diameter = float(np.linalg.norm(extent))
        self.rows: List[dict] = []

    def add(self, T_pred_mm: np.ndarray, T_gt_mm: np.ndarray, K: np.ndarray):
        Rp, tp = T_pred_mm[:3, :3], T_pred_mm[:3, 3]
        Rg, tg = T_gt_mm[:3, :3], T_gt_mm[:3, 3]
        self.rows.append({
            "add": E.add_error(Rp, tp, Rg, tg, self.pts, device=self.device),
            "trans_dist_m": float(np.linalg.norm(tp - tg)) / 1000.0,
            "angular_deg": E.angular_error_deg(Rp, Rg),
            "proj_px": self._proj_err(Rp, tp, Rg, tg, K),
        })

    def _proj_err(self, Rp, tp, Rg, tg, K) -> float:
        def proj(R, t):
            p = self.pts @ R.T + t
            uv = p @ np.asarray(K).T
            return uv[:, :2] / uv[:, 2:3]

        return float(np.linalg.norm(proj(Rp, tp) - proj(Rg, tg), axis=1).mean())

    def summary(self) -> dict:
        add = np.array([r["add"] for r in self.rows])
        td = np.array([r["trans_dist_m"] for r in self.rows])
        ang = np.array([r["angular_deg"] for r in self.rows])
        proj = np.array([r["proj_px"] for r in self.rows])
        return {
            "add0.1d": float((add < 0.1 * self.diameter).mean()),
            "5deg_5cm": float(((td < 0.05) & (ang < 5)).mean()),
            "proj2d_5px": float((proj < 5).mean()),
            "auc_add_m": E.auc_posecnn(add / 1000.0),
        }


def convert_results_to_coco(csv_path: str, out_json: str, root_dir: str,
                            dataset_name: str) -> int:
    """Pose csv -> COCO detection json: each box is the projection of the
    model's vertices under the estimated pose with the scene camera."""
    results = bop_io.load_bop_csv(csv_path)
    models_dir = osp.join(root_dir, "datasets", dataset_name, "models")
    verts_cache: Dict[int, np.ndarray] = {}
    anns = []
    for r in results:
        oid = r["obj_id"]
        if oid not in verts_cache:
            mesh = osp.join(models_dir, f"obj_{oid:06d}.ply")
            verts_cache[oid], _ = _load_vertices_mm(mesh)
        p = verts_cache[oid] @ r["R"].T + r["t"].reshape(3)
        sdir = osp.join(root_dir, "datasets", dataset_name, "test", f"{r['scene_id']:06d}")
        with open(osp.join(sdir, "scene_camera.json")) as f:
            K = np.asarray(json.load(f)[str(r["im_id"])]["cam_K"], np.float64).reshape(3, 3)
        uv = p @ K.T
        uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)
        x0, y0 = uv.min(0)
        x1, y1 = uv.max(0)
        anns.append({
            "scene_id": r["scene_id"],
            "image_id": r["im_id"],
            "category_id": oid,
            "score": r["score"],
            "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
        })
    with open(out_json, "w") as f:
        json.dump(anns, f)
    return len(anns)


def main(argv=None):
    """python -m gigapose_tpu_torch.eval.scorer csv=<csv> dataset=<ds> [root=.]
    [split=test] [errors=vsd,mssd,mspd] [device=cpu]"""
    args = dict(a.split("=", 1) for a in (argv if argv is not None else sys.argv[1:]))
    out = score_bop(args["csv"], args.get("root", "."), args["dataset"],
                    split=args.get("split", "test"),
                    error_types=tuple(args.get("errors", "vsd,mssd,mspd").split(",")),
                    device=args.get("device"))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
