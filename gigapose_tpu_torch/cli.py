"""Coarse inference CLI of the port (port of test.py, same override surface).

Usage:
    python -m gigapose_tpu_torch.cli test_dataset_name=lmo run_id=0 \
        [model=small] [device=cpu] [key=value ...]

Pipeline: load config -> build the estimator (seeded random weights, or
the weights at model.checkpoint_path: a checkpoint of the port's trainer, a
step_*.pt file or its checkpoint directory, one of the JAX trainer, a step_*
orbax directory or its checkpoint directory, read without orbax, or a
reference `.ckpt`) ->
onboard templates -> run the
BOP test split -> write npz batches + BOP csv under
<machine.root_dir>/results/<model>_<run_id>/predictions/.

It runs on cuda:0 unless `device=` names another device (the tests pass
`device=cpu`); with no card and no device it raises. `GIGAPOSE_TINY=1` in
the environment builds tiny nets with seeded random weights instead of the
configured ones (the full pipeline at a small size, as in test.py), or with
the weights of model.checkpoint_path when it is given; `tiny_ae_model=`
swaps the tiny AE (vit_tiny_test) for another of models/vit.py's configs,
such as vit_deep_test, whose head width 64 the int8 attention kernel takes.

Precision and kernels, as test.py decides them: `use_pallas_matching: auto`
is the fused matching kernel (ops/fused_matching) on CUDA and
match_templates on the CPU; `serving_quant: auto` is the int8 AE (ops/qmm)
on CUDA and off on the CPU; with the int8 AE, `model.serving_quant_ist`
(off | int8 | int8-static; default off) serves the IST backbone on int8
convolutions (ops/qconv) with per-image activation scales, or with static
scales calibrated on the first object's template crops at onboarding (an
unknown mode raises ValueError; test.py serves it as off);
`feature_dtype: bf16` gives a bf16 store.

A dataset with CAD models (<root>/datasets/<ds>/models) and no template set
gets one first, as in test.py: scripts/render_templates.py renders the
icosphere views of level data.template.level (default 1: 162 views; test.py
reads the absent key level_templates and so always renders level 1) on
the estimator's device: the rasterizer kernel on the card, the host C++
renderer (test.py's own) on the CPU.

Several processes (parallel/multihost.py's launch contract:
GIGAPOSE_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID, or GIGAPOSE_DISTRIBUTED=1
under torchrun; GIGAPOSE_DIST_BACKEND=gloo for ranks that share a card or
run on the CPU) split the images round-robin, one card each; with an
onboarding cache they onboard disjoint objects; process 0 writes the csv.
store_shards > 1 splits the store's views over that many of the process's
cards, its own first (device=cpu: the CPU that many times); fewer cards
raise ValueError. One process given no device= on a machine with more cards
than its shards use raises NotImplementedError: the JAX package would shard
the batch over them, the port runs one process per card
(parallel/mesh.py).

vis_every=N writes the correspondence and affine-warp plots of every N-th
image to <save_dir>/vis (pipeline/runner.py:_dump_vis, utils/vis.py).

An override whose key the CLI does not read (one of test.py's training or
loader options) raises ValueError: it would change nothing.
"""

from __future__ import annotations

import os
import os.path as osp
import sys
from typing import Optional

import torch

from gigapose_tpu_torch.dataloader.test_set import InferenceDataset
from gigapose_tpu_torch.models.ae_net import AENet
from gigapose_tpu_torch.models.convert import gigapose_ckpt_to_torch
from gigapose_tpu_torch.models.ist_net import ISTBackbone, ISTNet, Regressor
from gigapose_tpu_torch.parallel import multihost
from gigapose_tpu_torch.parallel.mesh import refuse_batch_mesh
from gigapose_tpu_torch.pipeline.estimator import (
    EstimatorConfig,
    GigaPoseEstimator,
    init_random_,
    set_f32_matmul_precision,
)
from gigapose_tpu_torch.pipeline.runner import CoarseRunner
from gigapose_tpu_torch.training.checkpoint import serving_weights
from gigapose_tpu_torch.utils.config import Config, load_config
from gigapose_tpu_torch.utils.device import resolve_device
from gigapose_tpu_torch.utils.logging import disable_output

# keys the CLI reads beside those of its config files
OPTIONAL_KEYS = ("device", "onboarding_cache", "max_images", "vis_every",
                 "model.serving_quant_ist", "tiny_ae_model")
# model.serving_quant_ist -> quantize_serving(ist=...)
IST_MODES = {"off": False, "int8": True, "int8-static": "static"}


def device_of(cfg: Config) -> torch.device:
    """cfg.device if given, else cuda:0; no card and no device raises."""
    return resolve_device(str(cfg.device) if cfg.get("device") else None, "the CLI",
                          "device=cpu")


def shard_devices(device: torch.device, shards: int):
    """The devices of a store split in `shards`: that many of the process's
    cards, `device` first, then the next ones (cyclically); on the CPU the
    CPU `shards` times. None for one shard. Fewer cards than shards raise."""
    if shards <= 1:
        return None
    if device.type != "cuda":
        return [device] * shards
    n = torch.cuda.device_count()
    if n < shards:
        raise ValueError(f"store_shards={shards} needs {shards} cards; this process sees {n}")
    return [torch.device("cuda", (device.index + i) % n) for i in range(shards)]


def template_renderer(device: torch.device) -> str:
    """The renderer of a missing template set: the device renderer (the
    rasterizer kernel) on the card, the host C++ one elsewhere."""
    return "device" if device.type == "cuda" else "native"


def build_estimator(cfg: Config, tiny: bool = False) -> GigaPoseEstimator:
    device = device_of(cfg)
    pallas = cfg.model.get("use_pallas_matching", "auto")
    if str(pallas) == "auto":
        pallas = device.type == "cuda"
    est_cfg = EstimatorConfig(
        k=cfg.model.testing_metric.k,
        sim_threshold=cfg.model.testing_metric.sim_threshold,
        patch_threshold=cfg.model.testing_metric.patch_threshold,
        pixel_threshold=cfg.model.ransac.pixel_threshold,
        use_pallas_matching=bool(pallas),
    )
    if tiny:  # smoke / end-to-end testing: tiny nets, the full pipeline
        set_f32_matmul_precision()
        gen = torch.Generator().manual_seed(0)
        ae = init_random_(AENet(str(cfg.get("tiny_ae_model") or "vit_tiny_test")), gen)
        ist = init_random_(ISTNet(
            ISTBackbone(initial_dim=16, block_dims=(16, 16, 24, 32), descriptor_size=32,
                        input_size=256),
            Regressor(64, hidden_dim=32),
        ), gen)
        est = GigaPoseEstimator(ae.to(device).eval(), ist.to(device).eval(), est_cfg)
        if cfg.model.get("checkpoint_path"):
            load_checkpoint_weights(est, str(cfg.model.checkpoint_path))
        return _maybe_quantize(est, cfg)

    cdt = str(cfg.model.get("compute_dtype") or "bf16")
    est = GigaPoseEstimator.create(
        model_name=cfg.model.ae_net.backbone,
        config=est_cfg,
        ist_descriptor_size=cfg.model.ist_net.descriptor_size,
        compute_dtype="bfloat16" if cdt in ("bf16", "bfloat16") else None,
        device=device,
    )
    ckpt = cfg.model.get("checkpoint_path")
    if ckpt:
        load_checkpoint_weights(est, str(ckpt))
    return _maybe_quantize(est, cfg)


def load_checkpoint_weights(est: GigaPoseEstimator, path: str) -> None:
    """Load model.checkpoint_path into the estimator's nets: a checkpoint of
    the port's or of the JAX trainer (a step_*.pt file, a step_* orbax
    directory, or the checkpoint directory of either) or a reference
    lightning `.ckpt`. A directory with no checkpoint raises
    FileNotFoundError."""
    if osp.isdir(path) or path.endswith(".pt"):
        if not osp.exists(path):
            raise FileNotFoundError(f"model.checkpoint_path={path}: no such checkpoint")
        ae_sd, ist_sd, path = serving_weights(path)
    elif path.endswith(".ckpt") and osp.isfile(path):
        ae_sd, ist_sd = gigapose_ckpt_to_torch(path)
    else:
        raise FileNotFoundError(f"model.checkpoint_path={path}: no such .ckpt or .pt file")
    est.ae_net.load_state_dict(ae_sd, strict=True)
    est.ist_net.load_state_dict(ist_sd, strict=True)
    print(f"Loaded checkpoint {path}")


def _maybe_quantize(est: GigaPoseEstimator, cfg: Config) -> GigaPoseEstimator:
    """model.serving_quant: auto (int8 on CUDA, off on the CPU) | int8 | off.
    Applied after checkpoint loading, so the int8 weights derive from the
    served ones; onboarding then uses the same extractor for the store."""
    sq = str(cfg.model.get("serving_quant", "auto")).lower()
    if sq == "auto":
        sq = "int8" if est.device.type == "cuda" else "off"
    ist_mode = cfg.model.get("serving_quant_ist", "off")
    # YAML reads an unquoted off as False
    ist_mode = "off" if ist_mode is False else str(ist_mode).lower()
    if ist_mode not in IST_MODES:
        raise ValueError(f"model.serving_quant_ist={ist_mode}: expected one of "
                         f"{', '.join(IST_MODES)}")
    if sq == "int8":
        ist = IST_MODES[ist_mode]
        est.quantize_serving(ist=ist)
        print("AE serving precision: int8 W8A8 kernels "
              + ({True: "+ int8 IST convolutions (per-image scales) ",
                  "static": "+ int8 IST convolutions (static scales, calibrated at onboarding) "}
                 .get(ist, ""))
              + "(model.serving_quant=off for the bf16 / f32 path)")
    return est


def _cache_tag(cfg: Config, est: GigaPoseEstimator) -> Optional[str]:
    """Onboarded-store cache key: int8-served features are not
    interchangeable with float ones, nor static-scale IST features with
    dynamic-scale ones: -int8 for the int8 AE, then -int8ist (-int8ists
    for static scales) for the int8 IST, as test.py tags them."""
    tag = cfg.get("onboarding_cache")
    if not tag:
        return tag
    if type(est.ae_net).__name__ == "AENetInt8":
        tag = f"{tag}-int8"
    if type(est.ist_net).__name__ == "ISTNetInt8":
        tag = f"{tag}-int8ist{'s' if est.ist_net.static_scales else ''}"
    return tag


def _has_key(cfg: dict, dotted: str) -> bool:
    node = cfg
    for k in dotted.split("."):
        if not isinstance(node, dict) or k not in node:
            return False
        node = node[k]
    return True


def load_cli_config(argv, optional_keys, name: str = "test") -> Config:
    """The `name` config with `argv`'s overrides (default sys.argv[1:]);
    `model=<name>` picks the model group file. An override of a key that is
    neither in the config files nor in `optional_keys` raises ValueError: it
    would change nothing."""
    overrides = list(argv if argv is not None else sys.argv[1:])
    # hydra-style group selection: model=small swaps the model group file
    group_sel = [o.split("=", 1)[1] for o in overrides if o.startswith("model=")]
    groups = {"model": group_sel[0]} if group_sel else None
    rest = [o for o in overrides if not o.startswith("model=")]
    files = load_config(name, groups=groups)
    unread = [k for k in (o.split("=", 1)[0] for o in rest if "=" in o)
              if not (_has_key(files, k) or k in optional_keys)]
    if unread:
        raise ValueError(f"the CLI reads no option {', '.join(unread)}")
    return load_config(name, rest, groups=groups)


def main(argv=None) -> CoarseRunner:
    """Run the CLI on `argv` (default sys.argv[1:]); returns the runner,
    whose `timing` holds onboarding and run times (this process's)."""
    multihost.maybe_initialize()  # before any CUDA call
    cfg = load_cli_config(argv, OPTIONAL_KEYS)
    ds = cfg.test_dataset_name
    if not ds:
        raise ValueError("test_dataset_name=... is required")
    shards = int(cfg.get("store_shards") or 1)
    refuse_batch_mesh(bool(cfg.get("device")), shards)
    root = osp.join(cfg.machine.root_dir, "datasets")
    save_dir = cfg.get("save_dir") or osp.join(
        cfg.machine.root_dir, "results", f"{cfg.model.model_name}_{cfg.run_id}"
    )
    os.makedirs(save_dir, exist_ok=True)
    if cfg.get("disable_output"):
        disable_output(osp.join(save_dir, "console.log"))

    tiny = bool(int(os.environ.get("GIGAPOSE_TINY", "0")))
    if cfg.get("tiny_ae_model") and not tiny:
        raise ValueError("tiny_ae_model= picks the AE of GIGAPOSE_TINY=1's tiny nets; "
                         "set GIGAPOSE_TINY=1 or drop it")
    est = build_estimator(cfg, tiny=tiny)
    template_dir = cfg.data.template.dir if cfg.get("data") and cfg.data.template.dir else osp.join(
        root, "templates", ds
    )
    cad_dir = osp.join(root, ds, "models")
    # process 0 decides, renders and tells the others
    if multihost.broadcast_object(not osp.isdir(template_dir) and osp.isdir(cad_dir)):
        if multihost.is_primary():
            from gigapose_tpu_torch.scripts import render_templates

            renderer = template_renderer(est.device)
            print(f"No template set at {template_dir}; rendering from {cad_dir}")
            render_templates.main(
                [f"cad_dir={cad_dir}", f"out_dir={template_dir}",
                 f"level={int(cfg.data.template.level)}", f"renderer={renderer}"]
                + ([f"device={est.device}"] if renderer == "device" else []))
        multihost.barrier()
    runner = CoarseRunner.onboard(
        est,
        template_dir=template_dir,
        save_dir=save_dir,
        dataset_name=ds,
        num_templates=cfg.data.template.num_templates if cfg.get("data") else None,
        scale_factor=cfg.data.template.scale_factor if cfg.get("data") else 1.0,
        max_dets_per_forward=cfg.get("max_num_dets_per_forward"),
        feature_dtype=torch.bfloat16 if str(cfg.model.get("feature_dtype", "")) == "bf16" else None,
        cache_tag=_cache_tag(cfg, est),
        store_shards=shards,
        shard_devices=shard_devices(est.device, shards),
        vis_every=int(cfg.get("vis_every") or 0),
    )
    dataset = InferenceDataset(
        root_dir=root, dataset_name=ds, test_setting=cfg.test_setting,
        depth_scale=cfg.data.depth_scale if cfg.get("data") else 10.0,
    )
    paths = runner.run(
        dataset,
        test_setting=cfg.test_setting,
        model_name=cfg.model.model_name,
        run_id=cfg.run_id,
        max_images=cfg.get("max_images"),
    )
    if paths:  # process 0 merges
        print("Wrote:", *paths, sep="\n  ")
    return runner


if __name__ == "__main__":
    main()
