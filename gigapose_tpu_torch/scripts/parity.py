"""One-command accuracy-parity runbook (port of gigapose_tpu/scripts/parity.py).

With the released weights and BOP data under root_dir, one command runs
the coarse CLI (the int8 AE and the float AE), the refine CLI (MegaPose's
refiner, top-1 and top-5 hypotheses) and the port's BOP19 scorer:

    python -m gigapose_tpu_torch.scripts.parity mode=real root_dir=<root> dataset=lmo

mode=real reads, and never downloads, these files under root_dir:
pretrained/gigaPose_v1.ckpt, the MegaPose coarse and refiner checkpoints
(pretrained/{coarse-rgb-906902141,refiner-rgb-653307694}/checkpoint.pth.tar)
and the dataset's test split, CAD models, test targets and CNOS detections
(datasets/...). One FileNotFoundError names every file that is missing.

mode=dryrun (the default) runs the same chain on the pasted-texture fixture
(scripts/synthetic_bop.py:build) with GIGAPOSE_TINY=1's tiny nets: the
coarse CLI with model.serving_quant=int8 and =off, the refine CLI (its tiny
GigaPose refiner) with use_multiple=false and =true, and the scorer on
every top-1 csv against the fixture's analytic test poses (each pasted
object at 400 mm, unrotated), which the dryrun writes as the test split's
scene_gt.json. The JAX runbook's dry downloader has no counterpart: the
port downloads nothing.

Usage:
    python -m gigapose_tpu_torch.scripts.parity [mode=dryrun|real] [root_dir=<dir>] \\
        [dataset=lmo] [run_id=parity] [ae_model=vit_tiny_test] [device=cpu]

Every leg runs on cuda:0 unless `device=` names another device; with no card
and no device it raises. In the dryrun `ae_model` is the tiny CLI's AE
(cli.py tiny_ae_model): the int8 attention kernel takes head width 64, so on
the card pass ae_model=vit_deep_test; vit_tiny_test (head width 32) raises
there before any work. An unknown key raises. Prints one JSON line:
mode, steps, the csvs (dryrun) and their scores.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import tempfile
from typing import Dict, List

from gigapose_tpu_torch.scripts.selfcheck_e2e import check_int8_head_width, parse_args

KEYS = ("mode", "root_dir", "dataset", "run_id", "ae_model", "device")
MEGAPOSE_CKPTS = ("coarse-rgb-906902141", "refiner-rgb-653307694")


def required_files(root: str, dataset: str) -> List[str]:
    """The released files mode=real reads, as paths under root."""
    ds = osp.join(root, "datasets", dataset)
    year, det = ("24", "cnos-sam") if dataset in ("hope", "hopev2", "handal") else \
        ("19", "cnos-fastsam")
    return [
        osp.join(root, "pretrained", "gigaPose_v1.ckpt"),
        *(osp.join(root, "pretrained", c, "checkpoint.pth.tar") for c in MEGAPOSE_CKPTS),
        osp.join(ds, "test"),
        osp.join(ds, "models_cad" if dataset == "tless" else "models"),
        osp.join(ds, f"test_targets_bop{year}.json"),
        osp.join(root, "datasets", "default_detections", f"core{year}_model_based_unseen", det),
    ]


def _score_csvs(root: str, dataset: str, run_dir: str, device) -> Dict[str, dict]:
    from gigapose_tpu_torch.eval.scorer import score_bop

    scores = {}
    for sub in ("predictions", "predictions_refined"):
        d = osp.join(run_dir, sub)
        for f in sorted(os.listdir(d)) if osp.isdir(d) else []:
            if f.endswith(".csv") and "MultiHypothesis" not in f:
                scores[f"{osp.basename(run_dir)}/{sub}/{f}"] = score_bop(
                    osp.join(d, f), root, dataset, device=device)
    return scores


def run_real(root: str, dataset: str, run_id: str, device, device_args: List[str]) -> dict:
    from gigapose_tpu_torch import cli, refine

    missing = [p for p in required_files(root, dataset) if not osp.exists(p)]
    if missing:
        raise FileNotFoundError(
            "parity mode=real reads released files that are not under root_dir: "
            + ", ".join(missing) + " (the port downloads nothing)")
    ckpt = osp.join(root, "pretrained", "gigaPose_v1.ckpt")
    base = [f"machine.root_dir={root}", f"test_dataset_name={dataset}", *device_args]
    steps = []
    cli.main(base + [f"run_id={run_id}", f"model.checkpoint_path={ckpt}",
                     "model.serving_quant=int8"])
    steps.append("test")
    # the serving-precision A/B: the float AE beside the int8 one
    cli.main(base + [f"run_id={run_id}_fp", f"model.checkpoint_path={ckpt}",
                     "model.serving_quant=off"])
    steps.append("test:serving_quant=off")
    mp = [f"megapose_{kind.split('-')[0]}_ckpt="
          + osp.join(root, "pretrained", kind, "checkpoint.pth.tar") for kind in MEGAPOSE_CKPTS]
    for use_multiple, step in (("false", "refine:top1"), ("true", "refine:top5")):
        refine.main(base + [f"run_id={run_id}", *mp, "refiner_type=megapose",
                            f"use_multiple={use_multiple}"])
        steps.append(step)
    scores = {}
    for rid in (run_id, f"{run_id}_fp"):
        scores.update(_score_csvs(root, dataset, osp.join(root, "results", f"large_{rid}"),
                                  device))
    steps.append("score")
    return {"mode": "real", "steps": steps, "scores": scores}


def write_fixture_test_gt(root: str) -> None:
    """The pasted-texture fixture's test poses (synthetic_bop.build's slots:
    object 1 at (100, 380), object 2 at (280, 80), 120 px, at 400 mm,
    unrotated) as the test split's scene_gt.json, for the scorer."""
    from gigapose_tpu_torch.scripts.synthetic_bop import DS, K_LIST

    fx, _, cx, _, fy, cy = K_LIST[:6]
    sdir = osp.join(root, "datasets", DS, "test", "000001")
    gts = [{"obj_id": obj_id, "cam_R_m2c": [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0],
            "cam_t_m2c": [(qx + 60 - cx) * 400.0 / fx, (qy + 60 - cy) * 400.0 / fy, 400.0]}
           for obj_id, (qy, qx) in ((1, (100, 380)), (2, (280, 80)))]
    with open(osp.join(sdir, "scene_gt.json"), "w") as f:
        json.dump({"0": gts}, f)


def run_dryrun(root: str, run_id: str, ae_model: str, device,
               device_args: List[str]) -> dict:
    """The chain on the fixture with the tiny nets (GIGAPOSE_TINY=1 for the
    CLIs' calls, restored afterwards)."""
    from gigapose_tpu_torch import cli, refine
    from gigapose_tpu_torch.scripts import synthetic_bop

    check_int8_head_width(ae_model, device)
    fixture_root = synthetic_bop.build(root)
    write_fixture_test_gt(fixture_root)
    base = [f"machine.root_dir={fixture_root}", "test_dataset_name=tudl", f"run_id={run_id}",
            "data.template.num_templates=8", *device_args]
    test_args = [f"tiny_ae_model={ae_model}"]
    steps = []
    saved = os.environ.get("GIGAPOSE_TINY")
    os.environ["GIGAPOSE_TINY"] = "1"
    try:
        cli.main(base + test_args + ["model.serving_quant=int8"])
        steps.append("test")
        # the serving-precision A/B leg of the real chain, same flags
        cli.main([a if not a.startswith("run_id=") else f"run_id={run_id}_fp" for a in base]
                 + test_args + ["model.serving_quant=off"])
        steps.append("test:serving_quant=off")
        for use_multiple, step in (("false", "refine:top1"), ("true", "refine:top5")):
            refine.main(base + [f"use_multiple={use_multiple}", "min_score=0"])
            steps.append(step)
    finally:
        if saved is None:
            os.environ.pop("GIGAPOSE_TINY", None)
        else:
            os.environ["GIGAPOSE_TINY"] = saved
    run_dir = osp.join(fixture_root, "results", f"large_{run_id}")
    csvs = []
    for sub in ("predictions", "predictions_refined"):
        d = osp.join(run_dir, sub)
        if osp.isdir(d):
            csvs += [osp.join(sub, f) for f in sorted(os.listdir(d)) if f.endswith(".csv")]
    scores = {}
    for rid in (run_id, f"{run_id}_fp"):
        scores.update(_score_csvs(fixture_root, "tudl",
                                  osp.join(fixture_root, "results", f"large_{rid}"), device))
    steps.append("score")
    return {"mode": "dryrun", "steps": steps, "csvs": csvs, "root": fixture_root,
            "scores": scores, "device": str(device), "ae_model": ae_model}


def main(argv=None) -> dict:
    from gigapose_tpu_torch.utils.device import resolve_device

    kv = parse_args(argv, KEYS)
    mode = kv.get("mode", "dryrun")
    root = kv.get("root_dir") or osp.join(tempfile.gettempdir(), "gigapose_torch_parity")
    run_id = kv.get("run_id", "parity")
    device = resolve_device(kv.get("device"), "parity", "device=cpu")
    device_args = [f"device={kv['device']}"] if kv.get("device") else []
    if mode == "real":
        out = run_real(root, kv.get("dataset", "lmo"), run_id, device, device_args)
    elif mode == "dryrun":
        out = run_dryrun(root, run_id, kv.get("ae_model", "vit_tiny_test"), device, device_args)
    else:
        raise ValueError(f"mode={mode}: expected dryrun or real")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
