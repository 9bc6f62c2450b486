"""Checkpoints of the train state (port of gigapose_tpu/training/checkpoint.py,
torch.save in place of orbax).

<ckpt_dir>/step_%08d.pt holds {"step", "ae", "ist", "optimizer"}: both nets'
state dicts (BatchNorm statistics included) and the optimizer's counts and
moments. <ckpt_dir>/last names the newest one. Both are written to a
temporary file and renamed, so a reader never finds a partial file.
`serving_weights` gives the coarse CLI the nets of a checkpoint.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
from typing import Dict, Optional, Tuple

import torch

from gigapose_tpu_torch.training.state import TrainState


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


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint that <ckpt_dir>/last names, if both exist."""
    p = osp.join(ckpt_dir, "last")
    if not osp.exists(p):
        return None
    with open(p) as f:
        path = osp.join(ckpt_dir, f.read().strip())
    return path if osp.isfile(path) else None


def load_checkpoint(path: str, map_location="cpu") -> Dict:
    """A checkpoint file of this module (tensors and plain containers only)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    state.load_state_dict(load_checkpoint(path, map_location=next(state.ae_net.parameters()).device))
    return state


def serving_weights(path: str) -> Tuple[Dict, Dict, str]:
    """(AE state dict, IST state dict, file) of a checkpoint: `path` is a
    step_*.pt file or a checkpoint directory (its `last` pointer, else its
    newest step_*.pt). A directory without one (an orbax train state of the
    JAX package) raises NotImplementedError."""
    if osp.isdir(path):
        found = latest_checkpoint(path) or max(glob.glob(osp.join(path, "step_*.pt")), default=None)
        if found is None:
            raise NotImplementedError(
                f"{path} holds no step_*.pt checkpoint of the port's trainer; reading an "
                "orbax train state of the JAX package is ROADMAP A12")
        path = found
    sd = load_checkpoint(path)
    return sd["ae"], sd["ist"], path
