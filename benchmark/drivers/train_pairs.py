"""Generator and driver of the training step (traffic `kind` "train_pairs"):
`dataloader/train_set.py:prepare_train_batch` (the upload and the device
prep) and `training/state.py:train_step` (both nets, the default
`OptimConfig`), one batch after another from a pool of host records made
at set-up from the seed; the host loader stays out of the window.

Each pair is one object seen twice: a template render (an elliptic
silhouette over a random texture, a fronto-parallel plane at the template
distance, a random object rotation) and a query view of the same plane
moved by a random in-plane rotation about the optical axis, a depth and a
place in the image, rendered by the exact image map of that motion over a
random background. Depths and poses agree, so the trainer's ground-truth
correspondences find the object's patches. The seed draws the pixels and
the motions; the batch shapes are the same for every seed.

Set-up builds the train state from the seed and drives it through the
first steps (the same call and feed as the window, on distinct batches);
the reference follows those steps after the window.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from benchmark import weights as W
from benchmark.reference import nets as RN
from benchmark.reference import train as RT
from benchmark.synth import make_templates, texture

FIRST_STEPS = 3  # the steps the reference follows


def _K(v) -> torch.Tensor:
    fx, fy, cx, cy = v
    return torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=torch.float32)


def make_pairs(g: torch.Generator, t: dict, B: int, device) -> Dict[str, np.ndarray]:
    """One batch of host records (HostTrainRecords' fields, float32)."""
    H, W_ = t["image_hw"]
    rgba, boxes, poses = make_templates(g, t, B, device)
    t_rgba = rgba.float() / 255
    z_t = t["template_distance"]
    t_K, q_K = _K(t["template_K"]).to(device), _K(t["K"]).to(device)
    u = torch.rand(B, 4, generator=g, device=device)
    theta = u[:, 0] * 2 * math.pi
    lo, hi = t["query_depth_m"]
    z_q = lo + (hi - lo) * u[:, 1]
    mx, my = t["centre_margin_px"]
    centre = torch.stack([mx + (W_ - 2 * mx) * u[:, 2], my + (H - 2 * my) * u[:, 3]], -1)
    c, s = torch.cos(theta), torch.sin(theta)
    Rz = torch.zeros(B, 3, 3, device=device)
    Rz[:, 0, 0], Rz[:, 0, 1], Rz[:, 1, 0], Rz[:, 1, 1], Rz[:, 2, 2] = c, -s, s, c, 1
    # move the template's box centre to `centre` at depth z_q: P_q = Rz P_t + tr
    box_c = torch.stack([(boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2,
                         torch.ones(B, device=device)], -1).float()
    P = z_t * (Rz @ (torch.linalg.inv(t_K) @ box_c[..., None]))[..., 0]
    qc = torch.cat([centre, torch.ones(B, 1, device=device)], -1)
    tr = z_q[:, None] * (torch.linalg.inv(q_K) @ qc[..., None])[..., 0] - P
    T = torch.eye(4, device=device).repeat(B, 1, 1)
    T[:, :3, :3], T[:, :3, 3] = Rz, tr
    t_pose = poses.clone()
    t_pose[:, :3, 3] = torch.tensor([0.0, 0.0, z_t], device=device)
    q_pose = T @ t_pose
    # the image map template pixel -> query pixel of the plane z = z_t: affine
    Hm = q_K @ (z_t * Rz @ torch.linalg.inv(t_K) + tr[..., None] * torch.tensor(
        [0.0, 0.0, 1.0], device=device)) / z_q[:, None, None]
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W_, device=device, dtype=torch.float32), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    src = (torch.linalg.inv(Hm) @ pix.T).transpose(1, 2)  # (B, HW, 3)
    sx = torch.floor(src[..., 0] / src[..., 2] + 0.5).long()
    sy = torch.floor(src[..., 1] / src[..., 2] + 0.5).long()
    ok = (sx >= 0) & (sx < W_) & (sy >= 0) & (sy < H)
    idx = (sy.clamp(0, H - 1) * W_ + sx.clamp(0, W_ - 1))
    warped = torch.gather(t_rgba.reshape(B, 4, -1), 2, idx[:, None].expand(B, 4, -1))
    warped = warped.reshape(B, 4, H, W_) * ok.reshape(B, 1, H, W_)
    q_mask = (warped[:, 3] > 0.5).float()
    bg = texture(g, B, H, W_, device)
    q_rgb = torch.where(q_mask[:, None] > 0, warped[:, :3], bg)
    q_depth = torch.where(q_mask > 0, z_q[:, None, None], torch.full_like(q_mask, t["background_depth_m"]))
    t_depth = torch.where(t_rgba[:, 3] > 0.5, torch.full_like(q_mask, z_t), torch.zeros_like(q_mask))
    cols, rows = q_mask.any(1), q_mask.any(2)
    iw, ih = torch.arange(W_, device=device), torch.arange(H, device=device)
    q_box = torch.stack([torch.where(cols, iw, W_).amin(1), torch.where(rows, ih, H).amin(1),
                         torch.where(cols, iw, -1).amax(1) + 1, torch.where(rows, ih, -1).amax(1) + 1], 1)
    host = lambda x: x.float().cpu().numpy()
    return dict(q_rgb=host(q_rgb), q_depth=host(q_depth), q_mask=host(q_mask),
                q_K=host(q_K.expand(B, 3, 3)), q_pose=host(q_pose), q_box=host(q_box),
                t_rgba=host(t_rgba), t_depth=host(t_depth), t_K=host(t_K.expand(B, 3, 3)),
                t_pose=host(t_pose), t_box=host(boxes))


def _leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, tracer, control=None):
        self.cfg, self.t, self.seed, self.device = cfg, traffic, int(seed), torch.device(device)
        self.m = cfg["model"]
        self.tracer = tracer
        self.control = control or {}
        self.counters = {}

    def _weights(self, device):
        vit, ist = RN.build_nets(self.cfg, device)
        W.draw({"vit": vit, "ist": ist}, self.seed, self.cfg["assumed"])
        return vit, ist

    def _inputs(self):
        from gigapose_tpu_torch.dataloader.train_set import HostTrainRecords

        g = torch.Generator(device=self.device).manual_seed((self.seed + 1) % (2 ** 63))
        self.pool = [HostTrainRecords(**make_pairs(g, self.t, self.t["batch_size"], self.device))
                     for _ in range(self.t["pool_batches"])]

    def _program(self):
        from gigapose_tpu_torch.dataloader.train_set import prepare_train_batch
        from gigapose_tpu_torch.models.ae_net import AENet
        from gigapose_tpu_torch.models.ist_net import ISTBackbone, ISTNet, Regressor
        from gigapose_tpu_torch.pipeline.estimator import set_f32_matmul_precision
        from gigapose_tpu_torch.training.state import OptimConfig, TrainState

        m = self.m
        set_f32_matmul_precision()
        vit, ist = self._weights(self.device)
        with torch.device(self.device):
            ae_net = AENet(m["backbone"])
            D = m["ist_descriptor"]
            ist_net = ISTNet(ISTBackbone(m["ist_initial_dim"], tuple(m["ist_block_dims"]), D,
                                         m["ist_input_size"]), Regressor(2 * D, hidden_dim=D))
        ae_net.vit.load_state_dict(vit.state_dict(), strict=True)
        ist_net.load_state_dict(ist.state_dict(), strict=True)
        self.prepare = prepare_train_batch
        return TrainState(ae_net, ist_net, OptimConfig(**m["optim"]))

    def _step(self, i: int):
        from gigapose_tpu_torch.training.state import train_step

        batch = self.prepare(self.pool[i % len(self.pool)], self.device)
        self.last_batch = batch
        return train_step(self.state, batch)

    def setup(self) -> None:
        self._inputs()
        self.state = self._program()
        self.tracer.install(self)
        nets = self.state.nets
        p0 = {n: {k: p.detach().clone() for k, p in net.named_parameters()} for n, net in nets.items()}
        self.first = []
        for i in range(FIRST_STEPS):
            metrics = self._step(i)
            self.first.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                b1 = self.state.tx.b1
                self.g1 = {n: _leaf_norms({k: mu / (1 - b1) for k, mu in st["mu"].items()})
                           for n, st in self.state.opt_state.items()}
        self.d3 = {n: _leaf_norms({k: p.detach() - p0[n][k] for k, p in net.named_parameters()})
                   for n, net in nets.items()}
        del p0
        self.tracer.warm_profiler()

    def window(self, seconds: float) -> None:
        B = self.t["batch_size"]
        prof = range(2, 2 + self.t["profiled_steps"]) if self.tracer.enabled else range(0)
        torch.cuda.synchronize(self.device) if self.device.type == "cuda" else None
        self.tracer.start_window()
        steps, i = 0, FIRST_STEPS
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            if steps == prof.start and len(prof):
                self.tracer.profile_on()
            if steps == prof.stop and len(prof):
                self.tracer.profile_off()
            if time.perf_counter() >= deadline and steps > 0 and not self.tracer.profiling:
                break
            key = "traced" if self.tracer.profiling else "plain"
            self.tracer.counters[f"steps_{key}"] += 1
            self.last = self._step(i)
            steps, i = steps + 1, i + 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.state_t = dict(t_start=t_start, t_end=time.perf_counter(), steps=steps, pairs=steps * B)

    def end_to_end(self) -> dict:
        s = self.state_t
        finite = all(math.isfinite(v) for f in self.first for v in f.values()) and \
            bool(torch.isfinite(self.last["total"]))
        return {"train_pairs_per_s": s["pairs"] / (s["t_end"] - s["t_start"]),
                "attempted": s["steps"], "failed": 0 if finite else 1}

    def free_program(self) -> None:
        self.state = self.last_batch = self.last = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the comparison --------------------------------------------------------
    def _reference(self, tf32: bool = False, half: bool = False, loss_scale: float = 1.0) -> dict:
        """The reference's first steps from the same weights and records:
        each step's total loss, the first gradient's and the change's norms
        per leaf. The arguments plant a control in it: TF32, half of each
        batch left out, or the loss altered by a factor."""
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        vit, ist = self._weights(self.device)
        vit.train(), ist.train()
        groups = {"ae": dict(vit.named_parameters()), "ist": dict(ist.named_parameters())}
        o = self.m["optim"]
        opt = RT.AdamW(groups, {"ae": o["ae_lr"], "ist": o["ist_lr"]}, o["weight_decay"],
                       o["warm_up_steps"])
        p0 = {n: {k: p.detach().clone() for k, p in g.items()} for n, g in groups.items()}
        out = {"loss": []}
        for i in range(FIRST_STEPS):
            rec = {k: torch.as_tensor(v, device=self.device)
                   for k, v in vars(self.pool[i % len(self.pool)]).items()}
            batch = RT.prepare(rec)
            if half:
                h = len(batch["rel_scale"]) // 2
                batch = {k: v[:h] for k, v in batch.items()}
            for g in groups.values():
                for p in g.values():
                    p.grad = None
            loss = RT.losses(vit, ist, batch, i, o["warm_up_steps"], o["tau"])["total"] * loss_scale
            loss.backward()
            out["loss"].append(float(loss.detach()))
            if i == 0:
                out["g1"] = {n: _leaf_norms({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                                             for k, p in g.items()}) for n, g in groups.items()}
            opt.step()
        out["d3"] = {n: _leaf_norms({k: p.detach() - p0[n][k] for k, p in g.items()})
                     for n, g in groups.items()}
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return out

    @torch.no_grad()
    def _gaps(self, got: dict, ref: dict) -> dict:
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
        out = {"loss_gap": loss_gap}
        g_ref = [v for n in ref["g1"] for v in ref["g1"][n].values()]
        med_g = float(np.median(g_ref))
        grad, change, moved = [], [], []
        for n in ref["g1"]:
            d_ref = ref["d3"][n]
            for k, gr in ref["g1"][n].items():
                grad.append(abs(got["g1"][n][k] - gr) / max(gr, med_g))
                if gr >= 1e-3 * med_g:  # leaves the reference moves by their gradient
                    moved.append((n, k))
        med_d = float(np.median([ref["d3"][n][k] for n, k in moved]))
        for n, k in moved:
            dr = ref["d3"][n][k]
            change.append(abs(got["d3"][n][k] - dr) / max(dr, med_d))
        out.update(grad_gap=max(grad), change_gap=max(change), grad_gap_p50=float(np.median(grad)),
                   change_gap_p50=float(np.median(change)), leaves_compared=len(moved),
                   leaves=len(grad))
        return out

    def judge(self) -> dict:
        ref = self._reference()
        if self.control:
            got = self._reference(**self.control)
        else:
            strip = lambda d: {k[4:] if k.startswith("vit.") else k: v for k, v in d.items()}
            got = {"loss": [f["total"] for f in self.first],
                   "g1": {n: strip(v) for n, v in self.g1.items()},
                   "d3": {n: strip(v) for n, v in self.d3.items()}}
        out = self._gaps(got, ref)
        out["first_losses"] = got["loss"]
        return out
