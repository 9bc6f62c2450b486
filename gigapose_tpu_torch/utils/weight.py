"""Partial, shape-checked loading of a foreign state dict (port of
gigapose_tpu/utils/weight.py; the warm start of the IST backbone from a
LoFTR-style checkpoint).

The port's modules carry the original PyTorch names, so a key maps by name
once `prefix` is stripped: a key that is missing from the module, or whose
shape differs, is skipped and logged; BatchNorm's num_batches_tracked
counters are not loaded.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from gigapose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def partial_load_state_dict(module: nn.Module, state_dict: Mapping, prefix: str = "") -> int:
    """Copy the tensors of `state_dict` whose keys start with `prefix` into
    `module`'s parameters and buffers of the same name (prefix stripped) and
    shape. Returns the number of tensors loaded."""
    own = module.state_dict()
    loaded = {}
    for key, value in state_dict.items():
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        if name not in own or name.endswith("num_batches_tracked"):
            continue
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(own[name].shape):
            logger.info(f"skip {name}: shape {tuple(value.shape)} != {tuple(own[name].shape)}")
            continue
        loaded[name] = value.to(own[name].dtype)
    module.load_state_dict(loaded, strict=False)
    logger.info(f"partial_load_state_dict: loaded {len(loaded)} tensors (prefix='{prefix}')")
    return len(loaded)
