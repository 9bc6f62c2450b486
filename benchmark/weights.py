"""Seeded weights of the two nets, drawn on the card in one call.

The benchmark, not the program, makes the weights: one standard-normal
draw, clipped at two standard deviations, of every parameter and buffer of
the reference's state dicts together (`torch.Generator` on the device),
then each leaf scaled by its rule below. The same tensors load into the
program's nets (whose parameter names are the public state dicts' too) and
into the reference, which so takes nothing the program made.

Rules (a configuration's `assumed` lists the values this file fixes):
- matmul and convolution weights: lecun normal, std 1 / sqrt(fan_in);
- biases, CLS and position embeddings: std 0.02;
- LayerNorm / BatchNorm scales 1 + 0.05 n, shifts 0.02 n; BatchNorm running
  means 0.02 n and variances 1 + 0.1 |n|;
- LayerScale gammas layerscale + 0.02 n (DINOv2's init is 1e-5, which
  leaves the blocks inert at random weights; trained values are ~0.1-1);
- the regressor's last layers: weights scaled by `regressor_gain`, biases
  at scale 1 and angle 0, so that the regressed similarity varies by a few
  percent around the identity, as a trained IST's does around the truth,
  and RANSAC finds a consistent scene.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

CLIP = 2.0


def _rule(name: str, t: torch.Tensor, assumed: dict):
    """(scale, offset) of a leaf's standard-normal draw, or "fan_in"."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("num_batches_tracked"):
        return None
    if "predictor.4" in name:
        if leaf == "weight":
            return assumed["regressor_gain"] / math.sqrt(t.shape[1]), 0.0
        # scale 1; (cos, sin) = normalize(tanh(3 + d, d')) ~ angle 0
        return 0.0, (1.0 if "scale" in name else torch.tensor([3.0, 0.0], device=t.device))
    if leaf == "gamma":
        return 0.02, assumed["layerscale"]
    if leaf == "running_mean":
        return 0.02, 0.0
    if leaf == "running_var":
        return "abs", 0.1
    if leaf in ("cls_token", "pos_embed"):
        return 0.02, 0.0
    if leaf == "weight" and t.ndim >= 2:
        return 1.0 / math.sqrt(t[0].numel()), 0.0
    if leaf == "weight":  # a norm's scale
        return 0.05, 1.0
    return 0.02, 0.0  # biases, norm shifts


@torch.no_grad()
def draw(nets: Dict[str, nn.Module], seed: int, assumed: dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net name: state dict} for the reference modules `nets` (on the
    device the weights are made on), from `seed`. The modules are filled
    in place and their state dicts returned."""
    items = [(net, k, t) for net, m in nets.items() for k, t in m.state_dict().items()
             if t.is_floating_point()]
    total = sum(t.numel() for _, _, t in items)
    dev = items[0][2].device
    g = torch.Generator(device=dev).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=g, device=dev).clamp_(-CLIP, CLIP)
    o = 0
    for net, k, t in items:
        n = flat[o:o + t.numel()].view(t.shape)
        o += t.numel()
        rule = _rule(k, t, assumed)
        if rule is None:
            continue
        scale, offset = rule
        if scale == "abs":
            t.copy_(n.abs() * offset + 1.0)
        else:
            t.copy_(n * scale + offset)
    return {net: m.state_dict() for net, m in nets.items()}
