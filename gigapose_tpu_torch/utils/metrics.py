"""Training metrics sink (port of gigapose_tpu/utils/metrics.py).

Scalars always stream to <log_dir>/metrics.jsonl, one JSON object per call
with the step and the wall time. With `tensorboard=True` they also go to
TensorBoard event files under <log_dir>/tb when torch.utils.tensorboard can
be imported; it is off by default because that writer imports tensorflow,
and with it jax and PIL where those are installed, which the port does not
load. The JAX package's wandb sink and image logging are not ported.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict

from gigapose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class MetricsLogger:
    def __init__(self, log_dir: str, tensorboard: bool = False):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(osp.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                logger.info(f"tensorboard sink disabled ({e})")
            else:
                self._tb = SummaryWriter(log_dir=osp.join(log_dir, "tb"))

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        self._jsonl.write(json.dumps({"step": step, "time": time.time(), **scalars}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
