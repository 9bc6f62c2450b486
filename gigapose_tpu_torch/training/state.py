"""Train state and one training step (port of gigapose_tpu/training/state.py).

- Two AdamW groups as optax builds them (`make_optimizer`): AE at ae_lr, IST
  at ist_lr, weight decay on every parameter, b1 0.9, b2 0.999, eps 1e-8, a
  linear warm-up read at the group's count *before* it is incremented (so
  the first update has lr 0), an optional global-norm clip over all
  gradients first. The net that `nets_to_train` leaves out is frozen: no
  update, no decay, no moments.
- The losses switch from plain MSE to log-scale / geodesic at step
  warm_up_steps of the state's step.
- src and tar go through the AE as one interleaved 2B batch; the IST runs
  its shared backbone on src, then on tar, in training mode (flax's
  BatchNorm statistics, models/flax_bn.py), or with fuse_ist_pair once on
  the interleaved 2B batch, BatchNorm on the pair's joint statistics.
- nce_dtype="bf16" keeps InfoNCE's (N, N) logit matrix in bf16
  (models/losses.info_nce_loss).
- In a multi-process run (parallel/multihost.py) each process steps on its
  own rows as one global batch, the JAX package's step on its dp-sharded
  batch: losses and metrics are each process's share of the global batch's
  (global counts, InfoNCE over every process's columns, BatchNorm on the
  global statistics), the gradients are summed over the processes, and
  every process applies the same update (`train_step`).

The arithmetic follows optax in f32: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2
+ b2 nu, u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p, p += -lr u.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from gigapose_tpu_torch.models import losses as L
from gigapose_tpu_torch.models.flax_bn import statistics_across_ranks
from gigapose_tpu_torch.ops.gather import gather_patches
from gigapose_tpu_torch.parallel import multihost

NETS = ("ae", "ist")


@dataclasses.dataclass
class TrainBatch:
    """One batch of training pairs on the trainer's device."""

    src_img: torch.Tensor  # (B, 3, H, W) template crop (normalized)
    tar_img: torch.Tensor  # (B, 3, H, W) query crop (normalized)
    src_pts: torch.Tensor  # (B, P, 2) ground-truth patch coordinates, -1 invalid
    tar_pts: torch.Tensor  # (B, P, 2)
    rel_scale: torch.Tensor  # (B,) relative scale
    rel_inplane: torch.Tensor  # (B,) relative in-plane angle (radians)
    src_mask: Optional[torch.Tensor] = None  # (B, P) patch masks, for validation
    tar_mask: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    ae_lr: float = 1e-5
    ist_lr: float = 1e-4
    weight_decay: float = 5e-4
    warm_up_steps: int = 200
    nets_to_train: str = "all"  # "ae" | "ist" | "all"
    tau: float = 0.1
    grad_clip: float = 0.0  # > 0: clip the global gradient norm first
    # linear anneal of the InfoNCE temperature from tau_start to tau over
    # tau_warmup_steps (0: off)
    tau_start: float = 0.0
    tau_warmup_steps: int = 0
    # the JAX package's memory knobs: one IST backbone pass over the
    # interleaved 2B pair (BatchNorm on the pair's joint statistics), and
    # "bf16" for InfoNCE's logit matrix
    fuse_ist_pair: bool = False
    nce_dtype: Optional[str] = None

    def __post_init__(self):
        if self.nets_to_train not in ("ae", "ist", "all"):
            raise ValueError(f"nets_to_train={self.nets_to_train!r}: ae, ist or all")
        if self.nce_dtype not in (None, "bf16"):
            raise ValueError(f"nce_dtype={self.nce_dtype!r}: None or bf16")

    def trains(self, net: str) -> bool:
        return self.nets_to_train in (net, "all")


def warmup_lr(base_lr: float, warm_up_steps: int, count: int) -> np.float32:
    """optax.join_schedules([linear_schedule(0, lr, warm), constant(lr)],
    [warm]) at `count`, in f32 as optax evaluates it."""
    f = np.float32
    if count >= warm_up_steps:
        return f(base_lr)
    frac = f(1) - f(np.float32(count) / f(warm_up_steps))
    return f(f(-base_lr) * frac + f(base_lr))


class Adam:
    """optax's adam / adamw over named nets: `init({name: net})` makes each
    net's moments, `update(opt_state, {name: net})` applies one step to the
    parameters in place from their .grad (None counts as zero). Each name
    has its own lr (`lrs`), each with the linear warm-up of `warmup_lr`
    (warm_up_steps 0: none); weight decay on every parameter (0: optax.adam,
    whose arithmetic is the same with the decay term left out); grad_clip > 0
    clips the global norm of every gradient given to one update."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lrs: Dict[str, float], weight_decay: float = 0.0,
                 warm_up_steps: int = 0, grad_clip: float = 0.0):
        self.lrs, self.weight_decay = dict(lrs), weight_decay
        self.warm_up_steps, self.grad_clip = warm_up_steps, grad_clip

    def init(self, nets: Dict[str, nn.Module]) -> Dict:
        return {net: {"count": 0,
                      "mu": {k: torch.zeros_like(p) for k, p in nets[net].named_parameters()},
                      "nu": {k: torch.zeros_like(p) for k, p in nets[net].named_parameters()}}
                for net in self.lrs}

    @torch.no_grad()
    def update(self, opt_state: Dict, nets: Dict[str, nn.Module]) -> None:
        grads = {net: {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                       for k, p in nets[net].named_parameters()} for net in opt_state}
        if self.grad_clip > 0:
            # optax.clip_by_global_norm over every gradient (a frozen net's are 0)
            clip = self.grad_clip
            norm = torch.sqrt(sum((g * g).sum() for gs in grads.values() for g in gs.values()))
            grads = {net: {k: torch.where(norm < clip, g, (g / norm) * clip)
                           for k, g in gs.items()} for net, gs in grads.items()}
        f = np.float32
        for net, st in opt_state.items():
            count = st["count"]
            t = count + 1
            bc1 = float(f(1) - f(self.b1) ** f(t))
            bc2 = float(f(1) - f(self.b2) ** f(t))
            neg_lr = -float(warmup_lr(self.lrs[net], self.warm_up_steps, count))
            wd = self.weight_decay
            for k, p in nets[net].named_parameters():
                g = grads[net][k]
                mu = torch.add(g * (1 - self.b1), st["mu"][k] * self.b1)
                nu = torch.add((g * g) * (1 - self.b2), st["nu"][k] * self.b2)
                st["mu"][k], st["nu"][k] = mu, nu
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                if wd:
                    u = u + wd * p
                p.add_(neg_lr * u)
            st["count"] = t


def make_optimizer(cfg: OptimConfig) -> Adam:
    """The two-group AdamW of the AE trainer: AE at ae_lr, IST at ist_lr,
    for the nets that cfg.nets_to_train names (the other one is frozen: no
    update, no decay, no moments), one global-norm clip over both."""
    return Adam({net: cfg.ae_lr if net == "ae" else cfg.ist_lr
                 for net in NETS if cfg.trains(net)},
                weight_decay=cfg.weight_decay, warm_up_steps=cfg.warm_up_steps,
                grad_clip=cfg.grad_clip)


class TrainState:
    """The step counter, both nets (parameters and BatchNorm statistics)
    and the optimizer with its moments."""

    def __init__(self, ae_net: nn.Module, ist_net: nn.Module, cfg: OptimConfig = OptimConfig()):
        self.step = 0
        self.ae_net, self.ist_net = ae_net, ist_net
        self.cfg = cfg
        self.tx = make_optimizer(cfg)
        self.opt_state = self.tx.init(self.nets)

    @property
    def nets(self) -> Dict[str, nn.Module]:
        return {"ae": self.ae_net, "ist": self.ist_net}

    def state_dict(self) -> Dict:
        return {"step": self.step, "ae": self.ae_net.state_dict(),
                "ist": self.ist_net.state_dict(), "optimizer": self.opt_state}

    def load_state_dict(self, sd: Dict) -> None:
        self.step = int(sd["step"])
        self.ae_net.load_state_dict(sd["ae"], strict=True)
        self.ist_net.load_state_dict(sd["ist"], strict=True)
        if set(sd["optimizer"]) != set(self.opt_state):
            raise ValueError(f"the checkpoint's optimizer trains {sorted(sd['optimizer'])}, "
                             f"this run {sorted(self.opt_state)}")
        for net, st in sd["optimizer"].items():
            mine = self.opt_state[net]
            for m in ("mu", "nu"):
                if set(st[m]) != set(mine[m]):
                    raise ValueError(f"the checkpoint's {net} {m} holds other parameters: "
                                     f"{sorted(set(st[m]) ^ set(mine[m]))[:4]}")
                for k, v in st[m].items():
                    if v.shape != mine[m][k].shape:
                        raise ValueError(f"the checkpoint's {net} {m}[{k}] is {tuple(v.shape)}, "
                                         f"this net's {tuple(mine[m][k].shape)}")
            mine["count"] = int(st["count"])
            for m in ("mu", "nu"):
                for k, v in st[m].items():
                    mine[m][k].copy_(v)


def compute_losses(ae_net: nn.Module, ist_net: nn.Module, batch: TrainBatch, step: int,
                   cfg: OptimConfig, across_ranks: bool = False):
    """-> (total loss, metrics): the IST regression losses and the AE's
    InfoNCE, for the nets that cfg.nets_to_train names. across_ranks: this
    process's share of the global batch's (models/losses.py; BatchNorm's
    statistics are global only inside flax_bn.statistics_across_ranks)."""
    B, P = batch.src_pts.shape[:2]
    ar = across_ranks
    global_count = lambda vf: (multihost.all_reduce_sum(vf.sum()) if ar else vf.sum()).clamp(min=1)
    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=batch.src_img.device)
    valid = (batch.src_pts[..., 0] >= 0) & (batch.tar_pts[..., 0] >= 0)  # (B, P)

    if cfg.trains("ist"):
        if cfg.fuse_ist_pair:
            pair = torch.stack([batch.src_img, batch.tar_img], dim=1)
            feats = ist_net.features(pair.reshape((2 * B,) + pair.shape[2:]))
            feats = feats.reshape((B, 2) + feats.shape[1:])
            out = ist_net.regress(feats[:, 0], feats[:, 1], batch.src_pts, batch.tar_pts)
        else:
            out = ist_net(batch.src_img, batch.tar_img, batch.src_pts, batch.tar_pts)
        v = (out.valid & valid).reshape(-1)
        pred_scale = out.scale.reshape(-1)
        pred_cossin = out.cossin.reshape(-1, 2)
        gt_scale = batch.rel_scale[:, None].expand(B, P).reshape(-1)
        gt_cs = torch.stack([torch.cos(batch.rel_inplane), torch.sin(batch.rel_inplane)], -1)
        gt_cs = gt_cs[:, None].expand(B, P, 2).reshape(-1, 2)
        if step < cfg.warm_up_steps:
            loss_s, loss_i = L.l2_warmup_losses(pred_scale, pred_cossin, gt_scale, gt_cs, v,
                                                across_ranks=ar)
        else:
            loss_s = L.scale_loss(pred_scale, gt_scale, v, log=True, across_ranks=ar)
            loss_i = L.inplane_loss(pred_cossin, gt_cs, v, loss="geodesic", across_ranks=ar)
        total = total + loss_s + loss_i
        vf = v.to(pred_scale.dtype)
        metrics["scale"], metrics["inp"] = loss_s, loss_i
        metrics["scale_err"] = ((pred_scale - gt_scale).abs() * vf).sum() / global_count(vf)

    if cfg.trains("ae"):
        stacked = torch.stack([batch.src_img, batch.tar_img], dim=1)
        both = ae_net(stacked.reshape((2 * B,) + stacked.shape[2:]))
        both = both.reshape((B, 2) + both.shape[1:])
        src_g, sv = gather_patches(both[:, 0], batch.src_pts)
        tar_g, tv = gather_patches(both[:, 1], batch.tar_pts)
        v = (sv & tv).reshape(-1)
        tau = cfg.tau
        if cfg.tau_start > 0 and cfg.tau_warmup_steps > 0:
            frac = min(max(step / cfg.tau_warmup_steps, 0.0), 1.0)
            tau = cfg.tau_start + (cfg.tau - cfg.tau_start) * frac
        C = src_g.shape[-1]
        nce = L.info_nce_loss(src_g.reshape(-1, C), tar_g.reshape(-1, C), v, tau=tau,
                              compute_dtype=torch.bfloat16 if cfg.nce_dtype == "bf16" else None,
                              across_ranks=ar)
        total = total + nce
        vf = v.to(nce.dtype)
        pos = (src_g * tar_g).sum(-1).reshape(-1)
        metrics["infoNCE"] = nce
        metrics["pos_sim"] = (pos * vf).sum() / global_count(vf)

    metrics["total"] = total
    return total, metrics


def sum_gradients(state: TrainState) -> None:
    """Sum the trained nets' gradients over the processes, in one all_reduce
    of a flat buffer (a missing gradient counts as zero)."""
    params = [p for net in state.opt_state for p in state.nets[net].parameters()]
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat)
    o = 0
    for p in params:
        p.grad = flat[o:o + p.numel()].view_as(p)
        o += p.numel()


def train_step(state: TrainState, batch: TrainBatch,
               timing: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on `batch`, in place on `state`; returns the
    step's metrics (detached tensors on the trainer's device).

    In a multi-process run `batch` is this process's rows of the global
    batch. Each process's loss L_r is its share of the global loss
    L = sum_r L_r (global counts; InfoNCE's columns and BatchNorm's
    statistics come from every process through autograd-aware collectives,
    whose backward hands each process the gradient that the other
    processes' losses send to its activations). So after the backward,
    process r holds the gradient of L along every path through its own
    forward, and grad L = the SUM of the processes' gradients: not DDP's
    mean, which would divide the global loss's gradient by the process
    count. The same summed gradient and the same Adam arithmetic give the
    same update on every process. The metrics returned are the global
    batch's (the shares summed). `timing`, when given, gets the seconds of
    the gradient sum (after a device synchronize) in "allreduce_s"."""
    across = multihost.process_count() > 1
    for net in state.nets.values():
        net.train()
        for p in net.parameters():
            p.grad = None
    with statistics_across_ranks(across):
        total, metrics = compute_losses(state.ae_net, state.ist_net, batch, state.step,
                                        state.cfg, across_ranks=across)
    total.backward()
    if across:
        dev = total.device
        if timing is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sum_gradients(state)
        if timing is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timing.setdefault("allreduce_s", []).append(time.perf_counter() - t0)
        names = sorted(metrics)
        summed = torch.stack([metrics[k].detach() for k in names])
        dist.all_reduce(summed)
        metrics = dict(zip(names, summed))
    state.tx.update(state.opt_state, state.nets)
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}
