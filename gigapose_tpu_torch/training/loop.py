"""Training loop: host loader -> device prep -> step -> metrics, validation
and checkpoints (port of gigapose_tpu/training/loop.py).

One device per process. A resumed run restores the state of the last
checkpoint and replays the loader up to its step, so it sees the batches a
straight run would see (the host pays for the replayed batches again; the
device does no work for them).

In a multi-process run (parallel/multihost.py) each process feeds its own
loader and the processes step as one global batch (training/state.py:
train_step); the weights start as process 0's (broadcast), checkpoints,
metrics, TensorBoard and validation are process 0's alone, and a resume
restores the checkpoint on every process.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Iterator, Optional

import torch
import torch.distributed as dist

from gigapose_tpu_torch.dataloader.train_set import HostTrainRecords, prepare_train_batch
from gigapose_tpu_torch.parallel import multihost
from gigapose_tpu_torch.training import checkpoint as ckpt_lib
from gigapose_tpu_torch.training.state import OptimConfig, TrainState, train_step
from gigapose_tpu_torch.training.validate import validation_metrics
from gigapose_tpu_torch.utils.logging import get_logger
from gigapose_tpu_torch.utils.metrics import MetricsLogger
from gigapose_tpu_torch.utils.prefetch import prefetch

logger = get_logger(__name__)

VAL_BATCHES = 8  # batches per validation pass


@dataclasses.dataclass
class FitConfig:
    max_steps: int = 1000
    log_every: int = 100
    checkpoint_every: int = 1000
    ckpt_dir: Optional[str] = None
    val_every: int = 0  # 0 disables the periodic pass
    log_dir: Optional[str] = None  # metrics.jsonl


class _Cycle:
    """The loader's epochs one after another through a prefetch thread
    (finite sources restart; an empty one ends the stream)."""

    def __init__(self, loader: Iterable):
        self.loader, self.current = loader, None

    def __iter__(self) -> Iterator:
        while True:
            empty = True
            self.current = prefetch(self.loader, buffer_size=4)
            for x in self.current:
                empty = False
                yield x
            if empty:
                return

    def close(self) -> None:
        if self.current is not None:
            self.current.close()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(
    ae_net,
    ist_net,
    loader: Iterable[HostTrainRecords],
    device,
    optim_cfg: OptimConfig = OptimConfig(),
    fit_cfg: FitConfig = FitConfig(),
    metrics_hook: Optional[Callable[[int, Dict[str, float]], None]] = None,
    resume: bool = False,
    val_loader: Optional[Iterable[HostTrainRecords]] = None,
    warm_start: Optional[Callable[[TrainState], None]] = None,
    tensorboard: bool = False,
    timing: Optional[Dict] = None,
) -> TrainState:
    """Train the nets as given (their weights are the initial state) on
    `device` for fit_cfg.max_steps steps. `warm_start(state)` may change
    the nets before the first step; `resume` continues from the newest
    checkpoint in fit_cfg.ckpt_dir. With `timing` (a dict), each step ends
    in a device synchronize and timing gets the per-step lists wait_s (the
    time blocked on the next batch) and step_s, and in a multi-process run
    allreduce_s (the gradient sum)."""
    device = torch.device(device)
    state = TrainState(ae_net.to(device), ist_net.to(device), optim_cfg)
    if warm_start is not None:
        warm_start(state)
    primary = multihost.is_primary()
    if multihost.process_count() > 1:  # every process starts from process 0's weights
        for net in state.nets.values():
            for t in list(net.parameters()) + list(net.buffers()):
                dist.broadcast(t.data, src=0)
    start_step = 0
    if resume and fit_cfg.ckpt_dir:
        last = ckpt_lib.latest_checkpoint(fit_cfg.ckpt_dir)
        if last:
            ckpt_lib.restore_checkpoint(last, state)
            start_step = state.step
            logger.info(f"Resumed from {last} (step {start_step})")

    mlog = MetricsLogger(fit_cfg.log_dir, tensorboard) if fit_cfg.log_dir and primary else None

    def run_validation(step: int) -> None:
        if val_loader is None or not primary:
            return
        for net in state.nets.values():
            net.eval()
        agg: Dict[str, float] = {}
        n = 0
        for vrec in val_loader:
            vm = validation_metrics(state.ae_net, state.ist_net, prepare_train_batch(vrec, device))
            for k, v in vm.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n += 1
            if n >= VAL_BATCHES:
                break
        if n:
            vm = {k: v / n for k, v in agg.items()}
            logger.info(f"validation @ step {step}: {vm}")
            if mlog:
                mlog.log_scalars(step, vm)

    cycle = _Cycle(loader)
    stream = iter(cycle)
    try:
        for _ in range(start_step):  # replay the batches the checkpoint has seen
            if next(stream, None) is None:
                break
        t0 = time.perf_counter()
        step = start_step
        saved = validated = None
        while step < fit_cfg.max_steps:
            t_wait = time.perf_counter()
            rec = next(stream, None)
            if rec is None:
                break
            waited = time.perf_counter() - t_wait
            metrics = train_step(state, prepare_train_batch(rec, device), timing)
            step = state.step
            if timing is not None:
                _sync(device)
                timing.setdefault("wait_s", []).append(waited)
                timing.setdefault("step_s", []).append(time.perf_counter() - t_wait)
            if step % fit_cfg.log_every == 0 or step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                rate = (step - start_step) / (time.perf_counter() - t0)
                if primary:
                    logger.info(f"step {step}: {m} ({rate:.2f} it/s)")
                if mlog:
                    mlog.log_scalars(step, m)
                if metrics_hook:
                    metrics_hook(step, m)
            if fit_cfg.val_every and step % fit_cfg.val_every == 0:
                run_validation(step)
                validated = step
            if fit_cfg.ckpt_dir and step % fit_cfg.checkpoint_every == 0:
                if primary:
                    ckpt_lib.save_checkpoint(fit_cfg.ckpt_dir, state, step)
                saved = step
    finally:
        cycle.close()
    # the last step's checkpoint and validation, unless the loop just made them
    if fit_cfg.ckpt_dir and saved != state.step and primary:
        ckpt_lib.save_checkpoint(fit_cfg.ckpt_dir, state, state.step)
    if validated != state.step:
        run_validation(state.step)
    if mlog:
        mlog.close()
    multihost.barrier()  # process 0's files are written when any process returns
    return state
