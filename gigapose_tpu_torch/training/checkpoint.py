"""Checkpoints of the train state (port of gigapose_tpu/training/checkpoint.py,
torch.save in place of orbax).

<ckpt_dir>/step_%08d.pt holds {"step", "ae", "ist", "optimizer"}: both nets'
state dicts (BatchNorm statistics included) and the optimizer's counts and
moments. <ckpt_dir>/last names the newest one. Both are written to a
temporary file and renamed, so a reader never finds a partial file.
`serving_weights` gives the coarse CLI the nets of a checkpoint.

The JAX trainer's checkpoints are read too (utils/orbax.py, without orbax):
<ckpt_dir>/step_%08d/ is an orbax directory of its TrainState (step,
ae_params, ist_params, ist_batch_stats, opt_state) and <ckpt_dir>/last holds
its absolute path. `load_checkpoint` maps one onto this module's dict: the
nets through models/convert.py's bridge, and optax's state (a
multi_transform of one adamw per net, "ae" / "ist" / "frozen", after an
optional clip_by_global_norm) onto training/state.py's Adam: per trained
net its count (adam's and the schedule's, which must agree) and its mu and
nu. A net whose moments are all masked is frozen there and has none here.
So the coarse CLI serves such a checkpoint and train.py resume=true carries
a JAX run on, from the same arrays bit for bit.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
from typing import Dict, Optional, Tuple

import torch

from gigapose_tpu_torch.models import convert
from gigapose_tpu_torch.training.state import NETS, TrainState
from gigapose_tpu_torch.utils import orbax


def _atomic(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if osp.exists(tmp):
            os.remove(tmp)


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}.pt"
    path = osp.join(ckpt_dir, name)
    _atomic(path, lambda tmp: torch.save(state.state_dict(), tmp))

    def write_last(tmp):
        with open(tmp, "w") as f:
            f.write(name)
    _atomic(osp.join(ckpt_dir, "last"), write_last)
    return path


def _is_checkpoint(path: str) -> bool:
    return osp.isfile(path) or orbax.is_checkpoint(path)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint that <ckpt_dir>/last names, if both exist: a step_*.pt
    file of this module, or a JAX orbax directory (found by its name in
    ckpt_dir too when the absolute path that JAX wrote is gone: a directory
    copied from another machine)."""
    p = osp.join(ckpt_dir, "last")
    if not osp.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    for path in (osp.join(ckpt_dir, name), osp.join(ckpt_dir, osp.basename(name))):
        if name and _is_checkpoint(path):
            return path
    return None


def _has_arrays(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_arrays(v) for v in tree.values())
    return tree is not None


def from_jax_train_state(tree: Dict, path: str) -> Dict:
    """The tree of a JAX TrainState (utils/orbax.read_tree) -> this module's
    checkpoint dict, and "clips_global_norm": whether its optimizer clipped."""
    missing = {"step", "ae_params", "ist_params", "ist_batch_stats", "opt_state"} - set(tree)
    if missing:
        raise ValueError(f"{path} is not a TrainState of the JAX trainer (no {sorted(missing)})")
    ae, ist = convert.train_state_flax_to_torch(tree["ae_params"], tree["ist_params"],
                                                tree["ist_batch_stats"])
    opt = tree["opt_state"]
    clipped = "inner_states" not in opt
    if clipped:  # optax.chain(clip_by_global_norm, multi_transform): (empty, the groups)
        opt = opt.get("1")
        if not isinstance(opt, dict) or "inner_states" not in opt or tree["opt_state"].get("0"):
            raise ValueError(f"{path}: an optimizer state that the JAX trainer does not write")
    optimizer = {}
    for net in NETS:
        group = opt["inner_states"].get(net)
        if not group or not _has_arrays(group["inner_state"]["0"]["mu"].get(net)):
            continue  # a frozen net: its parameters are masked in its group
        adam, schedule = group["inner_state"]["0"], group["inner_state"]["2"]
        count = int(adam["count"])
        if int(schedule["count"]) != count:
            raise ValueError(f"{path}: the {net} group's adam count {count} and schedule count "
                             f"{int(schedule['count'])} differ")
        optimizer[net] = {"count": count,
                          "mu": convert.params_flax_to_torch(net, adam["mu"][net]),
                          "nu": convert.params_flax_to_torch(net, adam["nu"][net])}
    return {"step": int(tree["step"]), "ae": ae, "ist": ist, "optimizer": optimizer,
            "clips_global_norm": clipped}


def load_checkpoint(path: str, map_location="cpu") -> Dict:
    """A checkpoint as {"step", "ae", "ist", "optimizer"}: a file of this
    module (tensors and plain containers only), or a JAX orbax directory
    (plus "clips_global_norm")."""
    if orbax.is_checkpoint(path):
        sd = from_jax_train_state(orbax.read_tree(path), path)
        for net in NETS:
            sd[net] = {k: v.to(map_location) for k, v in sd[net].items()}
        return sd
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    sd = load_checkpoint(path, map_location=next(state.ae_net.parameters()).device)
    clipped = sd.pop("clips_global_norm", None)
    if clipped is not None and clipped != (state.tx.grad_clip > 0):
        raise ValueError(f"{path}: the checkpoint's optimizer {'clips' if clipped else 'does not clip'}"
                         f" the gradients' global norm, this run's "
                         f"{'does' if state.tx.grad_clip > 0 else 'does not'}")
    state.load_state_dict(sd)
    return state


def serving_weights(path: str) -> Tuple[Dict, Dict, str]:
    """(AE state dict, IST state dict, checkpoint) of a checkpoint: `path`
    is a step_*.pt file, a JAX orbax step directory, or a checkpoint
    directory of either trainer (its `last` pointer, else its newest
    step_*.pt or step_* orbax directory). A directory with none of them
    raises FileNotFoundError."""
    if osp.isdir(path) and not orbax.is_checkpoint(path):
        steps = [p for p in glob.glob(osp.join(path, "step_*")) if _is_checkpoint(p)]
        found = latest_checkpoint(path) or max(steps, default=None)
        if found is None:
            raise FileNotFoundError(
                f"{path} holds no checkpoint: no step_*.pt file of the port's trainer and no "
                "step_* orbax directory of the JAX trainer")
        path = found
    sd = load_checkpoint(path)
    return sd["ae"], sd["ist"], path
