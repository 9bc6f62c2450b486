"""Multi-process wiring of the port (port of gigapose_tpu/parallel/multihost.py),
on torch.distributed.

Launch contract (the JAX package's environment, read by `maybe_initialize`):

    GIGAPOSE_COORDINATOR=host:port GIGAPOSE_NUM_PROCESSES=N GIGAPOSE_PROCESS_ID=i
        -> init_process_group(init_method="tcp://host:port", world_size=N, rank=i)
    GIGAPOSE_DISTRIBUTED=1
        -> init_process_group(init_method="env://"): torchrun's environment
           (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK)
    GIGAPOSE_DIST_BACKEND=gloo
        -> the gloo backend instead of NCCL: for ranks on the CPU (device=cpu)
           and for ranks that share one card, which NCCL refuses

Neither of the first two set: one process, and every helper below is a
no-op. One process per card: each rank runs on cuda:<local rank % cards>,
the local rank being LOCAL_RANK where the launcher sets it, else the process
id. With the NCCL backend a CPU rank raises; the backend is never chosen
silently.

The port's collectives are those of GLOO_CUDA_COLLECTIVES (all_reduce,
broadcast, all_gather), which gloo takes on CUDA tensors (chip_smoke.py
checks it on the card, and that gloo refuses all_to_all there), so nothing
goes through host memory. That is why `all_gather_rows` is not
torch.distributed.nn.functional.all_gather: under gloo that one's backward
is an all_to_all, and staging it through host memory puts it on the
autograd engine's CPU thread while the BatchNorm sums' backward runs on the
CUDA thread: the two processes then may issue them in different orders,
and a run hung so on an H100. Each process issues its collectives from one
thread, in program order.

Contract (the JAX package's): every process runs the same program;
machine.batch_size is per process; each process feeds only its own data;
files (checkpoints, csv merges, metrics) are written by process 0.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKEND_VAR = "GIGAPOSE_DIST_BACKEND"
# the collectives that gloo runs on CUDA tensors; others go through host memory
GLOO_CUDA_COLLECTIVES = ("all_reduce", "broadcast", "all_gather")


def launch_requested(env=None) -> bool:
    """True where the environment asks for a multi-process run."""
    e = os.environ if env is None else env
    return bool(e.get("GIGAPOSE_COORDINATOR")) or e.get("GIGAPOSE_DISTRIBUTED") == "1"


def local_rank(env=None) -> int:
    """LOCAL_RANK where the launcher sets it, else the process id (0 in one
    process)."""
    e = os.environ if env is None else env
    if "LOCAL_RANK" in e:
        return int(e["LOCAL_RANK"])
    return process_index()


def maybe_initialize(env=None) -> Tuple[int, int]:
    """Initialize the default process group from the launch environment
    (see the module docstring); call it first, before any CUDA call.
    Idempotent. Returns (process index, process count)."""
    e = os.environ if env is None else env
    if dist.is_initialized() or not launch_requested(e):
        return process_index(), process_count()
    backend = e.get(BACKEND_VAR, "nccl")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"{BACKEND_VAR}={backend}: expected nccl or gloo")
    if e.get("GIGAPOSE_COORDINATOR"):
        missing = [k for k in ("GIGAPOSE_NUM_PROCESSES", "GIGAPOSE_PROCESS_ID") if k not in e]
        if missing:
            raise ValueError(f"GIGAPOSE_COORDINATOR is set without {', '.join(missing)}")
        dist.init_process_group(backend, init_method=f"tcp://{e['GIGAPOSE_COORDINATOR']}",
                                world_size=int(e["GIGAPOSE_NUM_PROCESSES"]),
                                rank=int(e["GIGAPOSE_PROCESS_ID"]))
    else:
        dist.init_process_group(backend, init_method="env://")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(f"the NCCL backend needs a CUDA card; set {BACKEND_VAR}=gloo "
                               "for ranks on the CPU")
        torch.cuda.set_device(local_rank(e) % torch.cuda.device_count())
    return process_index(), process_count()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes files (the reference's rank-0 guards)."""
    return process_index() == 0


def check_device(device: torch.device) -> None:
    """A CPU rank under NCCL raises: NCCL reduces CUDA tensors only."""
    if process_count() > 1 and device.type == "cpu" and dist.get_backend() == "nccl":
        raise ValueError(f"device=cpu in a multi-process run needs {BACKEND_VAR}=gloo")


def default_device() -> torch.device:
    """This rank's card: cuda:<local rank % cards>."""
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def split_work(items: Sequence, process_id: Optional[int] = None) -> list:
    """Round-robin slice of a work list for this process (objects to onboard,
    images): scenes of uneven length balance."""
    pi = process_index() if process_id is None else process_id
    return list(items)[pi::process_count()]


def barrier() -> None:
    """Every process waits for the others; a no-op in one process."""
    if process_count() > 1:
        dist.barrier()


def broadcast_object(value: Any, src: int = 0) -> Any:
    """`value` of process `src` on every process (a picklable Python value);
    in one process, `value`."""
    if process_count() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the processes; the gradient is the sum of the processes'
    gradients (each process's loss depends on every process's input)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Autograd-aware sum of `x` over the processes (x itself in one)."""
    return _AllReduceSum.apply(x) if process_count() > 1 else x


class _AllGatherRows(torch.autograd.Function):
    """Every process's rows, in process order; the gradient of this
    process's rows is its block of the gradient summed over the processes
    (an all_reduce, then the slice: no all_to_all)."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(process_count())]
        dist.all_gather(parts, x)
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        lo = process_index() * ctx.rows
        return g[lo:lo + ctx.rows]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Autograd-aware concatenation of every process's `x` (the same shape on
    each) along dim 0, in process order; x itself in one process."""
    return _AllGatherRows.apply(x) if process_count() > 1 else x
