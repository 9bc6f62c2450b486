"""BOP benchmark script of the port (port of gigapose_tpu/scripts/eval_bop.py).

For each dataset: the coarse CLI (gigapose_tpu_torch.cli, which renders a
missing template set from the dataset's CAD models), then the refine CLI
(gigapose_tpu_torch.refine), then the score of the top-1 csv: bop_toolkit's
eval_bop19_pose when it is installed, else the port's BOP19 scorer
(eval/scorer.py).

Usage:
    python -m gigapose_tpu_torch.scripts.eval_bop machine.root_dir=<root> \
        [datasets=lmo,tless,...] [run_id=0] [refine=true] [use_multiple=true] \
        [device=cpu] [key=value ...]

Every other override goes to both CLIs, except the options that only one of
them reads (refine_renderer, min_score, ... to the refine CLI;
onboarding_cache, vis_every, ... to the coarse CLI). The scorer runs
on `device` when given, else on cuda:0.

Unlike the JAX script, a failure of the scorer raises: it is not turned
into an entry of the result (on the card that would hide a CUDA fault). A
dataset whose files are missing (FileNotFoundError) is reported as
"missing data", as the JAX script does.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import subprocess
import sys
from typing import Dict, List, Optional

BOP23_CORE = ["lmo", "tless", "tudl", "icbin", "itodd", "hb", "ycbv"]


def _split_overrides(overrides: List[str]):
    """-> (the coarse CLI's overrides, the refine CLI's): an option that
    only one of them reads goes to that one alone."""
    from gigapose_tpu_torch import cli
    from gigapose_tpu_torch import refine as refine_cli

    only_refine = set(refine_cli.OPTIONAL_KEYS) - set(cli.OPTIONAL_KEYS)
    only_coarse = set(cli.OPTIONAL_KEYS) - set(refine_cli.OPTIONAL_KEYS)
    key = lambda o: o.split("=", 1)[0]
    return ([o for o in overrides if key(o) not in only_refine],
            [o for o in overrides if key(o) not in only_coarse])


def run_dataset(ds: str, overrides: List[str], root: str, run_id, refine: bool,
                use_multiple: bool, device: Optional[str] = None) -> dict:
    from gigapose_tpu_torch import cli

    base = [f"test_dataset_name={ds}", f"run_id={run_id}"] + overrides
    coarse_args, refine_args = _split_overrides(base)
    cli.main(list(coarse_args))
    if refine:
        from gigapose_tpu_torch import refine as refine_cli

        refine_cli.main(list(refine_args) + [f"use_multiple={str(use_multiple).lower()}"])
    out = {"dataset": ds, "status": "csv_written"}
    cfg = cli.load_cli_config(coarse_args, cli.OPTIONAL_KEYS)
    save_dir = cfg.get("save_dir") or osp.join(
        cfg.machine.root_dir, "results", f"{cfg.model.model_name}_{cfg.run_id}")
    for sub in ("predictions_refined", "predictions"):
        pred_dir = osp.join(save_dir, sub)
        if osp.isdir(pred_dir):
            csvs = sorted(f for f in os.listdir(pred_dir)
                          if f.endswith(".csv") and "MultiHypothesis" not in f)
            if csvs:
                out[f"score_{sub}"] = score_csv(osp.join(pred_dir, csvs[0]), root, ds, device)
                break
    return out


def score_csv(csv_path: str, root: str, dataset: str, device: Optional[str] = None) -> dict:
    """bop_toolkit when installed; else the port's BOP19 scorer, whose
    failures raise."""
    out = score_with_bop_toolkit(csv_path)
    if out.get("bop19_average_recall") is not None:
        return out
    from gigapose_tpu_torch.eval import score_bop

    return score_bop(csv_path, root, dataset, device=device)


def score_with_bop_toolkit(csv_path: str) -> dict:
    """bop_toolkit's eval_bop19_pose in a subprocess, when it is installed."""
    try:
        import bop_toolkit_lib  # noqa: F401
    except ImportError:
        return {"bop19_average_recall": None, "note": "bop_toolkit not installed"}
    cmd = [
        sys.executable, "-m", "bop_toolkit_lib.scripts.eval_bop19_pose",
        "--renderer_type=vispy", f"--result_filenames={osp.basename(csv_path)}",
        f"--results_path={osp.dirname(csv_path)}",
        f"--eval_path={osp.dirname(csv_path)}",
    ]
    subprocess.run(cmd, check=False)
    scores_files = []
    for root_, _, files in os.walk(osp.dirname(csv_path)):
        scores_files += [osp.join(root_, f) for f in files if f == "scores_bop19.json"]
    if not scores_files:
        return {"bop19_average_recall": None}
    with open(sorted(scores_files)[-1]) as f:
        return json.load(f)


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    args = list(argv if argv is not None else sys.argv[1:])
    kv = dict(a.split("=", 1) for a in args)
    datasets = kv.pop("datasets", ",".join(BOP23_CORE)).split(",")
    run_id = kv.pop("run_id", "0")
    refine = kv.pop("refine", "true").lower() == "true"
    use_multiple = kv.pop("use_multiple", "true").lower() == "true"
    overrides = [f"{k}={v}" for k, v in kv.items()]

    results = {}
    for ds in datasets:
        print(f"=== {ds} ===")
        try:
            results[ds] = run_dataset(ds, overrides, kv.get("machine.root_dir", "."), run_id,
                                      refine, use_multiple, kv.get("device"))
        except FileNotFoundError as e:
            results[ds] = {"dataset": ds, "status": f"missing data: {e}"}
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
