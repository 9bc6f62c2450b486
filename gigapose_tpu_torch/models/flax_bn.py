"""BatchNorm as flax's nn.BatchNorm computes it, for the port's nets that the
JAX package builds with flax (the IST, the refiner and scorer ResNets).

Eval mode normalizes by the running statistics, as nn.BatchNorm2d does.
Training mode differs from nn.BatchNorm2d's: flax normalizes by the batch's
mean and its biased variance E[x^2] - mean^2 (floored at 0), computed in f32,
and moves the running statistics to them at momentum 0.9 (running = 0.9
running + 0.1 batch); nn.BatchNorm2d would store the unbiased variance.
A net cast to f64 normalizes in f64 (an f64 reference of its gradient).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# flax BatchNorm's momentum: running = momentum * running + (1 - momentum) * batch
BN_MOMENTUM = 0.9


def batch_norm(layer: nn.BatchNorm2d, x: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """BatchNorm in f32 (f64 stays f64): on the running statistics in eval mode; in training
    mode on the batch's statistics as flax computes them (mean and E[x^2] -
    mean^2 over N, H, W, floored at 0), moving the running statistics to
    them at BN_MOMENTUM. `out_dtype` (flax's `dtype`) rounds the output,
    e.g. to bf16; the statistics stay f32 either way."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    if not layer.training:
        y = F.batch_norm(x, layer.running_mean, layer.running_var, layer.weight, layer.bias,
                         False, 0.0, layer.eps)
    else:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            layer.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            layer.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + layer.eps) * layer.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + layer.bias[:, None, None]
    return y if out_dtype is None else y.to(out_dtype)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (the same parameters, buffers and state-dict keys)
    whose forward is `batch_norm`: flax's statistics in training mode."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(self, x)
