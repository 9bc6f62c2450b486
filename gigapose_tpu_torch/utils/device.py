"""The port's default device: its entry points run on the card."""

from __future__ import annotations

import torch


def resolve_device(device=None, what: str = "this call", how: str = "device='cpu'"
                   ) -> torch.device:
    """`device` if given, else cuda:0; with no card and no device it raises,
    naming `what` and `how` to ask for the CPU: nothing moves to the CPU on
    its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on the CUDA card by default and none is available; "
                           f"pass {how} to run on the CPU")
    return torch.device("cuda", 0)
