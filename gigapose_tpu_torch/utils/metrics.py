"""Training metrics sinks (port of gigapose_tpu/utils/metrics.py).

Scalars always stream to <log_dir>/metrics.jsonl, one JSON object per call
with the step and the wall time. With `tensorboard=True` they also go to
TensorBoard event files under <log_dir>/tb when torch.utils.tensorboard can
be imported; it is off by default because that writer imports tensorflow,
and with it jax and PIL where those are installed, which the port does not
load. Images (uint8 arrays: the port has no PIL) are written as PNGs under
<log_dir>/vis, and go to TensorBoard when it is on. With `use_wandb=True`
scalars and images also go to a wandb run (project `wandb_project`, name
`wandb_run_name`), finished on close; where the package is absent or its
run cannot start, that sink is disabled with an info log, as in the JAX
package.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict, Optional

import numpy as np

from gigapose_tpu_torch.dataloader.png import encode_png
from gigapose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class MetricsLogger:
    def __init__(self, log_dir: str, tensorboard: bool = False, use_wandb: bool = False,
                 wandb_project: str = "gigapose_tpu", wandb_run_name: Optional[str] = None):
        self.log_dir = log_dir
        os.makedirs(osp.join(log_dir, "vis"), exist_ok=True)
        self._jsonl = open(osp.join(log_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, name=wandb_run_name,
                                         dir=log_dir, resume="allow")
            except Exception as e:  # the package absent, or no network
                logger.info(f"wandb sink disabled ({e})")
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
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def log_image(self, step: int, name: str, image: np.ndarray) -> str:
        """(H, W) or (H, W, C) uint8 -> <log_dir>/vis/<name, / as _>_<step>.png;
        returns the path."""
        image = np.asarray(image)
        if image.dtype != np.uint8 or image.ndim not in (2, 3):
            raise ValueError(f"log_image takes (H, W[, C]) uint8, not {image.dtype} {image.shape}")
        path = osp.join(self.log_dir, "vis", f"{name.replace('/', '_')}_{step:08d}.png")
        with open(path, "wb") as f:
            f.write(encode_png(image))
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Image(image)}, step=step)
        if self._tb is not None:
            self._tb.add_image(name, image, step, dataformats="HW" if image.ndim == 2 else "HWC")
        return path

    def close(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()
