"""Self-check: train tiny nets on the pasted-texture fixture, then check that
the coarse pipeline recovers the test image's 6D pose (port of
gigapose_tpu/scripts/selfcheck_e2e.py).

Training (InfoNCE + scale / in-plane regression, training/loop.py:fit) must
make retrieval, regression, RANSAC and recovery give a metrically correct
pose on the fixture's test image (scripts/synthetic_bop.py:build), whose
ground truth is known analytically. The coarse chain is the CLI's:
CoarseRunner onboarding into a bf16 store, retrieval through the fused
matching kernel (ops/fused_matching: match_bf16_kernel on the card, its
plain version on the CPU), InferenceDataset and the BOP csv.

Usage:
    python -m gigapose_tpu_torch.scripts.selfcheck_e2e [steps=150] [root=<dir>] \\
        [seed=0] [rgb_aug=false] [ae_lr=3e-4] [ist_lr=1e-3] [warm_up=10] \\
        [grad_clip=1.0] [tau_start=0.5] [tau_warmup=50] [device=cpu]

It runs on cuda:0 unless `device=` names another device; with no card and no
device it raises. An unknown key raises. The nets start from seeded random
weights (flax's init scheme, seed 2023 as the JAX trainer's); `seed` moves
the loader. Prints one JSON line: the JAX script's keys (steps, t_err_mm,
rot_err_deg, score, gt_t, pred_t) plus device and the seconds of each leg.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import sys
import tempfile
import time
from typing import Dict, Sequence

import numpy as np
import torch

INIT_SEED = 2023  # the JAX trainer's init key (training/loop.py:fit)
KEYS = ("steps", "root", "seed", "rgb_aug", "ae_lr", "ist_lr", "warm_up", "grad_clip",
        "tau_start", "tau_warmup", "device")
# the test image's analytic ground truth (synthetic_bop.build): the texture
# pasted at (qy, qx) = (100, 380), 120 px, at 400 mm
FIXTURE_K = np.array([[572.4114, 0, 320], [0, 573.57043, 240], [0, 0, 1.0]])


def parse_args(argv, keys: Sequence[str]) -> Dict[str, str]:
    """key=value arguments (default sys.argv[1:]); an unknown key raises."""
    kv = dict(a.split("=", 1) for a in (argv if argv is not None else sys.argv[1:]))
    unknown = sorted(set(kv) - set(keys))
    if unknown:
        raise ValueError(f"unknown key(s) {', '.join(unknown)}; expected some of {', '.join(keys)}")
    return kv


def fresh_root(kv: Dict[str, str], name: str) -> str:
    root = kv.get("root") or osp.join(tempfile.gettempdir(), name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    return root


def tiny_nets(ae_model: str = "vit_tiny_test"):
    """The selfchecks' AE and IST (the JAX scripts' widths) with seeded
    random weights, on the CPU."""
    from gigapose_tpu_torch.models.ae_net import AENet
    from gigapose_tpu_torch.models.ist_net import ISTBackbone, ISTNet, Regressor
    from gigapose_tpu_torch.pipeline.estimator import init_random_

    gen = torch.Generator().manual_seed(INIT_SEED)
    ae = init_random_(AENet(ae_model), gen)
    ist = init_random_(ISTNet(
        ISTBackbone(initial_dim=16, block_dims=(16, 16, 24, 32), descriptor_size=32,
                    input_size=256),
        Regressor(64, hidden_dim=32)), gen)
    return ae, ist


def estimator(ae_net, ist_net):
    """Trained nets as a GigaPoseEstimator in eval mode, retrieval on the
    fused matching kernel (with a bf16 store: match_bf16_kernel)."""
    from gigapose_tpu_torch.pipeline.estimator import EstimatorConfig, GigaPoseEstimator

    return GigaPoseEstimator(ae_net.eval(), ist_net.eval(),
                             EstimatorConfig(use_pallas_matching=True))


def check_int8_head_width(ae_model: str, device: torch.device) -> None:
    """The int8 attention kernel takes head width 64 only: on the card an
    AE of another head width raises before any work."""
    from gigapose_tpu_torch.models.vit import VIT_CONFIGS
    from gigapose_tpu_torch.ops.qmm import HEAD_DIM

    vit = VIT_CONFIGS[ae_model]
    if device.type == "cuda" and vit.embed_dim // vit.num_heads != HEAD_DIM:
        raise ValueError(
            f"ae_model={ae_model} has head width {vit.embed_dim // vit.num_heads}; the int8 "
            f"attention kernel takes {HEAD_DIM}: pass ae_model=vit_deep_test on the card")


class Laps:
    """Seconds per leg, on the host clock (each leg ends in a host fetch)."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.t0 = self.t = time.perf_counter()

    def __call__(self, leg: str) -> None:
        now = time.perf_counter()
        self.seconds[leg] = round(now - self.t, 2)
        self.t = now

    def total(self) -> Dict[str, float]:
        return {**self.seconds, "total": round(time.perf_counter() - self.t0, 2)}


def train(kv: Dict[str, str], device: torch.device, root: str, metrics_hook=None):
    """The pasted-texture fixture under `root`, then the tiny nets trained
    on it with the selfcheck recipe (fit's metrics_hook as given); -> the
    TrainState."""
    from gigapose_tpu_torch.dataloader.scene import DirSceneSource
    from gigapose_tpu_torch.dataloader.train_set import TrainLoader
    from gigapose_tpu_torch.scripts import synthetic_bop
    from gigapose_tpu_torch.training.loop import FitConfig, fit
    from gigapose_tpu_torch.training.state import OptimConfig

    steps = int(kv.get("steps", 150))
    # the photometric augmentations are off by default, as in the JAX script:
    # their ranges are set for terabytes of scenes, not for this 3-image split
    rgb_aug = kv.get("rgb_aug", "false").lower() == "true"
    synthetic_bop.build(root)
    datasets = osp.join(root, "datasets")
    ae, ist = tiny_nets()
    loader = TrainLoader(scene_source=DirSceneSource(osp.join(datasets, "tudl", "train_pbr")),
                         template_dir=osp.join(datasets, "templates", "tudl"), batch_size=3,
                         rgb_augmentation=rgb_aug, inplane_augmentation=True,
                         seed=int(kv.get("seed", 0)))
    return fit(
        ae, ist, loader, device,
        optim_cfg=OptimConfig(
            ae_lr=float(kv.get("ae_lr", 3e-4)), ist_lr=float(kv.get("ist_lr", 1e-3)),
            warm_up_steps=int(kv.get("warm_up", 10)),
            # the short-budget InfoNCE stabilizers: gradient clipping and a
            # temperature warm-up
            grad_clip=float(kv.get("grad_clip", 1.0)),
            tau_start=float(kv.get("tau_start", 0.5)),
            tau_warmup_steps=int(kv.get("tau_warmup", 50))),
        fit_cfg=FitConfig(max_steps=steps, log_every=max(steps // 5, 1),
                          checkpoint_every=10**9),
        metrics_hook=metrics_hook)


def estimate(ae_net, ist_net, root: str, run_id: str = "0") -> dict:
    """The coarse chain (onboarding into a bf16 store, the test split, the
    csv) with the nets as given, on their device; -> the test image's
    top-1 row, with its retrieved view id under "view_id"."""
    from gigapose_tpu_torch.dataloader import bop_io
    from gigapose_tpu_torch.dataloader.test_set import InferenceDataset
    from gigapose_tpu_torch.pipeline.runner import CoarseRunner

    datasets = osp.join(root, "datasets")
    est = estimator(ae_net, ist_net)
    save_dir = osp.join(root, "results", f"selfcheck_{run_id}")
    runner = CoarseRunner.onboard(est, template_dir=osp.join(datasets, "templates", "tudl"),
                                  save_dir=save_dir, dataset_name="tudl", num_templates=8,
                                  feature_dtype=torch.bfloat16)
    paths = runner.run(InferenceDataset(root_dir=datasets, dataset_name="tudl"),
                       model_name="selfcheck", run_id=run_id)
    top1 = bop_io.load_bop_csv(paths[0])[0]
    with np.load(osp.join(save_dir, "predictions", "000000.npz")) as batch:
        top1["view_id"] = int(batch["view_ids"][0, 0])
    return top1


def main(argv=None) -> dict:
    kv = parse_args(argv, KEYS)
    from gigapose_tpu_torch.pipeline.estimator import set_f32_matmul_precision
    from gigapose_tpu_torch.utils.device import resolve_device

    steps = int(kv.get("steps", 150))
    device = resolve_device(kv.get("device"), "selfcheck_e2e", "device=cpu")
    set_f32_matmul_precision()
    laps = Laps()
    root = fresh_root(kv, "gigapose_torch_selfcheck")
    state = train(kv, device, root)
    laps("train")
    top1 = estimate(state.ae_net, state.ist_net, root)
    laps("coarse")

    cx_px, cy_px, z = 380 + 60, 100 + 60, 400.0
    K = FIXTURE_K
    gt_t = np.array([(cx_px - K[0, 2]) * z / K[0, 0], (cy_px - K[1, 2]) * z / K[1, 1], z])
    t_err = float(np.linalg.norm(top1["t"].reshape(3) - gt_t))
    R = top1["R"]
    ang_err = float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))
    result = {
        "steps": steps,
        "t_err_mm": round(t_err, 2),
        "rot_err_deg": round(ang_err, 2),
        "score": top1["score"],
        "gt_t": gt_t.round(1).tolist(),
        "pred_t": np.asarray(top1["t"]).reshape(3).round(1).tolist(),
        "device": str(device),
        "seconds": laps.total(),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
