"""Training CLI of the port (port of train.py, same override surface).

Usage:
    python -m gigapose_tpu_torch.train train_dataset_name=<ds> \
        machine.root_dir=<root> [model=small] [device=cpu] [key=value ...]

Builds the host TrainLoader over BOP scenes (tar shards or directories, PNG
images) and the template set of each training dataset, then trains the AE
and the IST nets (f32) with the two-group AdamW and writes checkpoints to
<root>/results/<model>_<run_id>/checkpoints and metrics to .../logs. The
coarse CLI serves a checkpoint with model.checkpoint_path=<that directory>.

It runs on cuda:0 unless `device=` names another device; with no card and
no device it raises. The nets start from seeded random weights (`seed`);
`pretrained_ist_path=` (or model.ist_net.pretrained_weights) warm-starts
the IST from a torch state dict by name. Several datasets in
train_dataset_name are interleaved batch by batch. `GIGAPOSE_TINY=1` gives
train.py's tiny nets.

Several processes (parallel/multihost.py's launch contract) train as one
global batch of machine.batch_size rows per process, one card each: each
process's loader draws from its own seed (seed + dataset index + 1000003 x
process id, as train.py), and process 0 writes the checkpoints and metrics
(training/loop.py). One process given no device= on a machine with several
cards raises: the JAX package would shard its batch over them
(parallel/mesh.py).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import torch

from gigapose_tpu_torch.cli import load_cli_config
from gigapose_tpu_torch.dataloader.scene import DirSceneSource, TarSceneSource
from gigapose_tpu_torch.dataloader.train_set import TrainLoader
from gigapose_tpu_torch.models.ae_net import AENet
from gigapose_tpu_torch.models.ist_net import (
    ISTBackbone, ISTNet, Regressor, default_ist_net,
)
from gigapose_tpu_torch.parallel import multihost
from gigapose_tpu_torch.parallel.mesh import refuse_batch_mesh
from gigapose_tpu_torch.pipeline.estimator import init_random_, set_f32_matmul_precision
from gigapose_tpu_torch.training.loop import FitConfig, fit
from gigapose_tpu_torch.training.state import OptimConfig, TrainState
from gigapose_tpu_torch.utils.device import resolve_device
from gigapose_tpu_torch.utils.weight import partial_load_state_dict

OPTIONAL_KEYS = ("device",)


class Interleaved:
    """Batches of several loaders, one of each in turn, until all end."""

    def __init__(self, loaders):
        self.loaders = loaders

    def __iter__(self):
        its = [iter(loader) for loader in self.loaders]
        while its:
            alive = []
            for it in its:
                b = next(it, None)
                if b is not None:
                    yield b
                    alive.append(it)
            its = alive


def build_nets(cfg, tiny: bool):
    """(AE, IST) with seeded random weights: the configured nets, or
    train.py's tiny ones."""
    gen = torch.Generator().manual_seed(int(cfg.seed))
    if tiny:
        ae = AENet("vit_tiny_test")
        ist = ISTNet(ISTBackbone(initial_dim=8, block_dims=(8, 8, 12, 16), descriptor_size=16,
                                 input_size=256), Regressor(32, hidden_dim=16))
    else:
        ae = AENet(cfg.model.ae_net.backbone, remat=cfg.model.ae_net.get("remat") or False)
        ist = default_ist_net(cfg.model.ist_net.descriptor_size)
    return init_random_(ae, gen), init_random_(ist, gen)


def main(argv=None) -> TrainState:
    proc_id, _ = multihost.maybe_initialize()  # before any CUDA call
    cfg = load_cli_config(argv, OPTIONAL_KEYS, name="train")
    refuse_batch_mesh(bool(cfg.get("device")))
    device = resolve_device(str(cfg.device) if cfg.get("device") else None, "the trainer",
                            "device=cpu")
    set_f32_matmul_precision()
    root = osp.join(cfg.machine.root_dir, "datasets")
    names = cfg.get("train_dataset_name") or ("gso" if cfg.train_dataset_id == 0 else "shapenet")
    ds_names = [n.strip() for n in str(names).split(",") if n.strip()]
    save_dir = cfg.get("save_dir") or osp.join(
        cfg.machine.root_dir, "results", f"{cfg.model.model_name}_{cfg.run_id}")
    os.makedirs(save_dir, exist_ok=True)
    n_cpu = os.cpu_count() or 1
    workers = max(1, min(int(cfg.machine.get("num_workers") or 1), n_cpu - 1 if n_cpu > 1 else 1))

    def make_loader(name, seed):
        split_dir = osp.join(root, name, cfg.get("train_split") or "train_pbr")
        has_tar = osp.isdir(split_dir) and any(f.endswith(".tar") for f in os.listdir(split_dir))
        source = (TarSceneSource(split_dir, depth_scale=cfg.data.depth_scale) if has_tar
                  else DirSceneSource(split_dir))
        return TrainLoader(scene_source=source, template_dir=osp.join(root, "templates", name),
                           batch_size=cfg.machine.batch_size,
                           template_scale_factor=cfg.data.template.scale_factor, seed=seed,
                           num_workers=workers)

    # each process draws its own rows (the webdataset split_by_node of the reference)
    loaders = [make_loader(n, cfg.seed + i + 1000003 * proc_id) for i, n in enumerate(ds_names)]
    loader = loaders[0] if len(loaders) == 1 else Interleaved(loaders)

    val_loader = None
    val_ds = cfg.get("val_dataset_name")
    if val_ds:
        val_split = osp.join(root, val_ds, cfg.get("val_split") or "test")
        if osp.isdir(val_split):
            val_loader = TrainLoader(scene_source=DirSceneSource(val_split),
                                     template_dir=osp.join(root, "templates", val_ds),
                                     batch_size=cfg.machine.batch_size,
                                     inplane_augmentation=False, rgb_augmentation=False,
                                     seed=cfg.seed + 1)

    warm_start = None
    ist_ckpt: Optional[str] = cfg.get("pretrained_ist_path") or cfg.model.ist_net.get(
        "pretrained_weights")
    if ist_ckpt:
        def warm_start(state: TrainState, path=str(ist_ckpt)) -> None:
            # a LoFTR-style checkpoint may pickle more than tensors: load only
            # files you trust
            sd = torch.load(path, map_location="cpu", weights_only=False)
            key = cfg.model.ist_net.get("checkpoint_key") or "state_dict"
            sd = sd.get(key, sd) if isinstance(sd, dict) else sd
            n = partial_load_state_dict(state.ist_net, sd,
                                        prefix=str(cfg.model.ist_net.get("pretrained_prefix") or ""))
            print(f"Warm-started IST from {path}: {n} tensors loaded")

    ae, ist = build_nets(cfg, tiny=bool(int(os.environ.get("GIGAPOSE_TINY", "0"))))
    o = cfg.model.optim
    state = fit(
        ae, ist, loader, device,
        optim_cfg=OptimConfig(ae_lr=o.ae_lr, ist_lr=o.ist_lr, weight_decay=o.weight_decay,
                              warm_up_steps=o.warm_up_steps, nets_to_train=o.nets_to_train),
        fit_cfg=FitConfig(max_steps=cfg.max_steps, log_every=cfg.log_every,
                          checkpoint_every=cfg.checkpoint_every,
                          ckpt_dir=osp.join(save_dir, "checkpoints"),
                          val_every=int(cfg.get("val_every") or 0),
                          log_dir=osp.join(save_dir, "logs")),
        resume=bool(cfg.get("resume")), val_loader=val_loader, warm_start=warm_start,
        tensorboard=bool(cfg.get("log_tensorboard")),
    )
    if multihost.is_primary():
        print(f"Training done at step {state.step}; checkpoints in {save_dir}/checkpoints")
    return state


if __name__ == "__main__":
    main()
