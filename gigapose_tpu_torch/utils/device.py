"""The port's default device: its entry points run on the card."""

from __future__ import annotations

import torch


def resolve_device(device=None, what: str = "this call", how: str = "device='cpu'"
                   ) -> torch.device:
    """`device` if given, else the card: cuda:0 in one process, this rank's
    card in a multi-process run (parallel/multihost.default_device); with no
    card and no device it raises, naming `what` and `how` to ask for the
    CPU: nothing moves to the CPU on its own."""
    from gigapose_tpu_torch.parallel import multihost

    if device is not None:
        device = torch.device(device)
        multihost.check_device(device)
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on the CUDA card by default and none is available; "
                           f"pass {how} to run on the CPU")
    if multihost.process_count() > 1:
        return multihost.default_device()
    return torch.device("cuda", 0)
