"""Whole-system self-check on rendered 3D data: coarse training -> coarse
estimation -> the int8 serving A/B -> refiner training -> refinement, all
against analytic ground truth (port of gigapose_tpu/scripts/selfcheck_full.py).

The fixture is scripts/synthetic_bop.py:build_rendered: a vertex-coloured
cube with real viewpoint, in-plane and scale variation over the icosphere
templates of `level` (42 views at 0, 162 at 1) and random-pose training
scenes, so retrieval, the scale / in-plane regression, RANSAC, the recovery
and render-and-compare refinement all run on true 3D geometry. Legs:

1. coarse training (training/loop.py:fit) of the tiny nets;
2. coarse estimation of the held-out test image through CoarseRunner (a bf16
   store, the fused matching kernel: match_bf16_kernel on the card, its
   plain version on the CPU) and the BOP19 AR of its csv (eval/scorer.py);
3. (quant_ab=true) the int8 A/B on the trained weights:
   GigaPoseEstimator.quantize_serving() (ops/qmm.py: the csrc/qmm.cu kernels
   on the card, their plain versions on the CPU), its own store, its
   retrieval against the float AE's, its pose and AR; and the per-block
   activation absmax of the float AE on the query crops (forward hooks on
   every module);
4. refiner training (refiner/training.py:train_refiner) with a global-norm
   gradient clip, the perturbation ranges refiner_rot / refiner_xy /
   refiner_z and, with curriculum=true, their anneal to a quarter;
5. refinement of the coarse MultiHypothesis csv (refiner/runner.py:
   run_refinement) and the refined csv's AR.

Usage:
    python -m gigapose_tpu_torch.scripts.selfcheck_full [steps=400] [refiner_steps=400] \\
        [level=0] [seed=0] [root=<dir>] [ae_model=vit_tiny_test] [quant_ab=true] \\
        [curriculum=false] [refiner_rot=30] [refiner_xy=0.02] [refiner_z=0.04] \\
        [refiner_grad_clip=1.0] [n_train=40] [device=cpu]

It runs on cuda:0 unless `device=` names another device; with no card and no
device it raises. An unknown key raises. The int8 attention kernel takes
head width 64 only, so on the card the int8 leg needs an AE such as
ae_model=vit_deep_test (dim 256, 4 heads, 6 blocks); vit_tiny_test (head
width 32) with quant_ab=true raises there before any work. Prints one JSON
line: the JAX script's keys plus device, ae_model and the seconds of each
leg.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Dict

import numpy as np
import torch

from gigapose_tpu_torch.scripts.selfcheck_e2e import (
    Laps,
    check_int8_head_width,
    estimator,
    fresh_root,
    parse_args,
    tiny_nets,
)

KEYS = ("steps", "refiner_steps", "level", "root", "seed", "ae_model", "quant_ab",
        "curriculum", "refiner_rot", "refiner_xy", "refiner_z", "refiner_grad_clip", "n_train",
        "device")


def pose_errors(T_pred_mm: np.ndarray, T_gt_mm: np.ndarray):
    t_err = float(np.linalg.norm(T_pred_mm[:3, 3] - T_gt_mm[:3, 3]))
    tr = np.trace(T_pred_mm[:3, :3] @ T_gt_mm[:3, :3].T)
    rot_err = float(np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1))))
    return t_err, rot_err


def pose_of(row: Dict) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = row["R"]
    T[:3, 3] = row["t"].reshape(3)
    return T


def activation_absmax(ae_net: torch.nn.Module, crops: torch.Tensor) -> Dict[str, float]:
    """max |x| of every module's output in one forward of `ae_net` on
    `crops`, by module name ("out" for the net's own), as flax's
    capture_intermediates records every module's __call__."""
    absmax: Dict[str, float] = {}

    def hook(name):
        def record(module, inputs, output):
            for t in output if isinstance(output, (tuple, list)) else (output,):
                if torch.is_tensor(t) and t.is_floating_point():
                    absmax[name] = max(absmax.get(name, 0.0), float(t.detach().abs().max()))
        return record

    handles = [m.register_forward_hook(hook(name or "out"))
               for name, m in ae_net.named_modules()]
    try:
        with torch.inference_mode():
            ae_net(crops)
    finally:
        for h in handles:
            h.remove()
    return absmax


def main(argv=None) -> dict:
    kv = parse_args(argv, KEYS)
    from gigapose_tpu_torch.dataloader import bop_io
    from gigapose_tpu_torch.dataloader.scene import DirSceneSource
    from gigapose_tpu_torch.dataloader.test_set import InferenceDataset
    from gigapose_tpu_torch.dataloader.train_set import TrainLoader
    from gigapose_tpu_torch.eval.scorer import score_bop
    from gigapose_tpu_torch.pipeline.estimator import GigaPoseEstimator, set_f32_matmul_precision
    from gigapose_tpu_torch.pipeline.runner import CoarseRunner
    from gigapose_tpu_torch.pipeline.templates import TEMPLATE_K
    from gigapose_tpu_torch.refiner.refiner import RefinerConfig, RenderCompareRefiner
    from gigapose_tpu_torch.refiner.runner import find_init_pose_path, run_refinement
    from gigapose_tpu_torch.refiner.training import PerturbConfig, train_refiner
    from gigapose_tpu_torch.scripts import synthetic_bop
    from gigapose_tpu_torch.training.loop import FitConfig, fit
    from gigapose_tpu_torch.training.state import OptimConfig
    from gigapose_tpu_torch.utils.device import resolve_device

    steps = int(kv.get("steps", 400))
    refiner_steps = int(kv.get("refiner_steps", 400))
    level = int(kv.get("level", 0))
    seed = int(kv.get("seed", 0))
    ae_model = kv.get("ae_model", "vit_tiny_test")
    quant_ab = kv.get("quant_ab", "true").lower() == "true"
    device = resolve_device(kv.get("device"), "selfcheck_full", "device=cpu")
    if quant_ab:
        check_int8_head_width(ae_model, device)
    set_f32_matmul_precision()
    laps = Laps()
    root = fresh_root(kv, "gigapose_torch_selfcheck_full")
    _, gt_test = synthetic_bop.build_rendered(root, n_train=int(kv.get("n_train", 40)),
                                              level=level, seed=seed)
    datasets = osp.join(root, "datasets")
    tdir = osp.join(datasets, "templates", "tudl")
    laps("fixture")

    # ---- 1. coarse training on the rendered scenes
    ae, ist = tiny_nets(ae_model)
    loader = TrainLoader(scene_source=DirSceneSource(osp.join(datasets, "tudl", "train_pbr")),
                         template_dir=tdir, batch_size=4, seed=seed)
    state = fit(ae, ist, loader, device,
                optim_cfg=OptimConfig(ae_lr=3e-4, ist_lr=1e-3, warm_up_steps=20),
                fit_cfg=FitConfig(max_steps=steps, log_every=max(steps // 5, 1),
                                  checkpoint_every=10**9))
    laps("coarse_train")

    # ---- 2. coarse estimation of the held-out test image, and its AR
    est = estimator(state.ae_net, state.ist_net)
    save_dir = osp.join(root, "results", "selfcheck_full")
    runner = CoarseRunner.onboard(est, template_dir=tdir, save_dir=save_dir,
                                  dataset_name="tudl", feature_dtype=torch.bfloat16)
    dataset = InferenceDataset(root_dir=datasets, dataset_name="tudl")
    paths = runner.run(dataset, model_name="selfcheck", run_id="0")
    T_coarse = pose_of(bop_io.load_bop_csv(paths[0])[0])
    t_err_c, r_err_c = pose_errors(T_coarse, gt_test)
    coarse_ar = score_bop(paths[0], root, "tudl", device=device)["bop19_average_recall"]
    laps("coarse")

    # ---- 3. the int8 A/B on the trained weights
    int8_metrics = {}
    if quant_ab:
        image = next(iter(dataset))
        batch = runner.prepare_batch(image)
        pred_f = est(runner.store, batch)
        est_q = GigaPoseEstimator(est.ae_net, est.ist_net, est.config).quantize_serving()
        runner_q = CoarseRunner.onboard(est_q, template_dir=tdir,
                                        save_dir=osp.join(root, "results", "selfcheck_full_int8"),
                                        dataset_name="tudl", feature_dtype=torch.bfloat16)
        pred_q = est_q(runner_q.store, batch)
        n = len(image.labels)
        ids_f = pred_f.view_ids[:n, 0].cpu().numpy()
        ids_q = pred_q.view_ids[:n, 0].cpu().numpy()
        paths_q = runner_q.run(dataset, model_name="selfcheckq", run_id="0")
        int8_ar = score_bop(paths_q[0], root, "tudl", device=device)["bop19_average_recall"]
        t_err_q, r_err_q = pose_errors(pose_of(bop_io.load_bop_csv(paths_q[0])[0]), gt_test)
        # the trained float AE's activation outliers, which int8 serving must carry
        absmax = activation_absmax(est.ae_net, batch.crops)
        int8_metrics = {
            "int8_retrieval_agreement": float((ids_f == ids_q).mean()),
            "int8_t_err_mm": round(t_err_q, 2),
            "int8_rot_err_deg": round(r_err_q, 2),
            "int8_ar": round(int8_ar, 4),
            "act_absmax_global": round(max(absmax.values()), 2),
            "act_absmax_blocks": {k: round(v, 2) for k, v in absmax.items() if "block" in k},
        }
        laps("int8")

    # ---- 4. refiner training; 5. refinement of the coarse csv
    refiner = RenderCompareRefiner.create(
        {1: osp.join(datasets, "tudl", "models", "obj_000001.ply")},
        config=RefinerConfig(n_iterations=3, render_size=(96, 96), n_sample_points=32),
        refiner_width=16, scorer_width=8, device=device)
    # the perturbation range covers the coarse stage's errors; the curriculum
    # anneals it to a quarter over training
    rot = float(kv.get("refiner_rot", 30.0))
    txy = float(kv.get("refiner_xy", 0.02))
    tz = float(kv.get("refiner_z", 0.04))
    curriculum = kv.get("curriculum", "false").lower() == "true"
    train_refiner(
        refiner, np.asarray(TEMPLATE_K), steps=refiner_steps, batch_size=4, lr=1e-3,
        log_every=max(refiner_steps // 4, 1), seed=seed,
        perturb=PerturbConfig(rot_deg=rot, trans_xy=txy, trans_z=tz),
        final_perturb=(PerturbConfig(rot_deg=rot / 4, trans_xy=txy / 4, trans_z=tz / 4)
                       if curriculum else None),
        # bounds each step's parameter motion, so that reduction-order noise
        # cannot tip the toy recipe into its runaway basin
        grad_clip=float(kv.get("refiner_grad_clip", 1.0)))
    laps("refiner_train")
    init_path = find_init_pose_path(osp.join(save_dir, "predictions"), "tudl", "selfcheck", "0",
                                    use_multiple=True)
    ref_paths = run_refinement(
        refiner, DirSceneSource(osp.join(datasets, "tudl", "test"), load_depth=False,
                                load_masks=False),
        init_path, save_dir=save_dir, dataset_name="tudl", model_name="selfcheck", run_id="0",
        min_score=0.0)
    T_ref = pose_of(bop_io.load_bop_csv(ref_paths[0])[0])
    t_err_r, r_err_r = pose_errors(T_ref, gt_test)
    refined_ar = score_bop(ref_paths[0], root, "tudl", device=device)["bop19_average_recall"]
    laps("refine")

    result = {
        "coarse_ar": round(coarse_ar, 4),
        "refined_ar": round(refined_ar, 4),
        **int8_metrics,
        "level": level,
        "seed": seed,
        "curriculum": curriculum,
        "coarse_steps": steps,
        "refiner_steps": refiner_steps,
        "coarse_t_err_mm": round(t_err_c, 2),
        "coarse_rot_err_deg": round(r_err_c, 2),
        "refined_t_err_mm": round(t_err_r, 2),
        "refined_rot_err_deg": round(r_err_r, 2),
        "gt_t": gt_test[:3, 3].round(1).tolist(),
        "coarse_t": T_coarse[:3, 3].round(1).tolist(),
        "refined_t": T_ref[:3, 3].round(1).tolist(),
        "device": str(device),
        "ae_model": ae_model,
        "seconds": laps.total(),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
