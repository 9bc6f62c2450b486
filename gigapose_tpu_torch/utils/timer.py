"""Wall-clock stage timers feeding the BOP runtime columns (port of
gigapose_tpu/utils/timer.py).

CUDA work is asynchronous, so `toc(block_on=t)` synchronizes the device of
the CUDA tensor `t` before reading the clock; for CPU tensors it reads the
clock directly.
"""

from __future__ import annotations

import time as _time

import torch


class Timer:
    def __init__(self):
        self._t0 = None
        self.total = 0.0

    def tic(self):
        self._t0 = _time.perf_counter()
        return self

    def toc(self, block_on=None) -> float:
        if isinstance(block_on, torch.Tensor) and block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
        dt = _time.perf_counter() - self._t0
        self.total += dt
        return dt

    def reset(self):
        self._t0 = None
        self.total = 0.0
