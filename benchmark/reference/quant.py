"""Fake quantization for the lower-precision controls: the reference's
matmul and convolution inputs and weights rounded to a grid one step below
the precision a configuration states, then computed on in float32.

- "int4": symmetric, 7 levels each side; activations per token (last axis),
  convolution inputs per image, weights per output channel.
- "fp8": float8 e4m3 after scaling each row (as above) to its range (448).
"""

from __future__ import annotations

from typing import Callable

import torch


def _absmax(t: torch.Tensor, role: str) -> torch.Tensor:
    if role == "act":
        return t.abs().amax(dim=-1, keepdim=True)
    dims = tuple(range(1, t.ndim))  # a weight's output channel, an NCHW input's image
    return t.abs().amax(dim=dims, keepdim=True)


def make_quant(kind: str) -> Callable[[torch.Tensor, str], torch.Tensor]:
    if kind == "int4":
        def q(t, role):
            s = _absmax(t, role).clamp(min=1e-20) / 7.0
            return torch.clamp(torch.round(t / s), -7, 7) * s
    elif kind == "fp8":
        def q(t, role):
            s = _absmax(t, role).clamp(min=1e-20) / 448.0
            return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    else:
        raise ValueError(f"unknown control precision {kind!r}: int4 or fp8")
    return q
