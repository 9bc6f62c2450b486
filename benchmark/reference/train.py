"""Plain reference of GigaPose's training step (arXiv 2311.14155, Sec. 3.3;
the public trainer's arithmetic), in float32 with TF32 off, for the nets of
benchmark/reference/nets.py. Imports nothing of the program.

One step on one batch of host records:
1. crops: the query masked by its mask, both RGBA views cropped and resized
   to 224 (nearest), CLIP-normalised; patch masks;
2. ground-truth correspondences: each query patch centre uncropped, lifted
   by its depth, moved by T_template <- query, projected and cropped into the
   template; kept where both masks hold (the reference's lookups);
3. relative scale (depth, crop and focal ratios) and in-plane angle;
4. losses: the AE's InfoNCE over the matched patch features (tau 0.1,
   in-batch negatives), the IST's regression losses (MSE on the scale and
   on (cos, sin) during warm-up; log-scale L2 and geodesic after), the IST
   backbone in training mode: batch statistics, biased variance;
5. AdamW, one group per net (lr with a linear warm-up read before the
   count is incremented, so the first update has lr 0), weight decay on
   every parameter, b1 0.9, b2 0.999, eps 1e-8.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import coarse as C
from benchmark.reference.nets import IST, ViT, resize_align_corners


def _apply(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    h = torch.cat([pts, torch.ones_like(pts[..., :1])], -1) @ M.transpose(-1, -2)
    return h[..., :2] / h[..., 2:3]


def _inv_crop(M: torch.Tensor) -> torch.Tensor:
    """The closed-form inverse of crop similarities (scale s, shift t):
    scale 1 / s, shift -t / s. Patch centres often land on whole pixels of
    the full image, where a general 3 x 3 inverse rounds to either side
    and the floored lookup then reads the neighbouring pixel."""
    inv = torch.zeros_like(M)
    r = 1.0 / M[:, 0, 0]
    inv[:, 0, 0], inv[:, 1, 1], inv[:, 2, 2] = r, r, 1.0
    inv[:, 0, 2], inv[:, 1, 2] = -M[:, 0, 2] * r, -M[:, 1, 2] * r
    return inv


def _lookup(pts: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    H, W = img.shape[-2:]
    x = pts[..., 0].long().clamp(0, W - 1)
    y = pts[..., 1].long().clamp(0, H - 1)
    return torch.gather(img.reshape(img.shape[0], -1), 1, y * W + x)


def prepare(rec: Dict[str, torch.Tensor], size: int = 224, patch: int = 14) -> dict:
    """Host records (as tensors on the device) -> the step's inputs."""
    qm = rec["q_mask"][:, None]
    q_rgb, q_pm, q_M = C.crops_of(torch.cat([rec["q_rgb"] * qm, qm], 1), rec["q_box"], size, size // patch)
    t_rgb, t_pm, t_M = C.crops_of(rec["t_rgba"], rec["t_box"], size, size // patch)
    q_mask = C.crop_nearest(qm, q_M, rec["q_box"], size)[:, 0]
    t_mask = C.crop_nearest(rec["t_rgba"][:, 3:], t_M, rec["t_box"], size)[:, 0]
    B = q_rgb.shape[0]
    g = torch.arange(0, size, patch, dtype=torch.float32, device=q_rgb.device) + patch / 2
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1).expand(B, -1, 2)

    def inside(pts, mask):
        H, W = mask.shape[-2:]
        ok = (pts[..., 0] >= 0) & (pts[..., 1] >= 0) & (pts[..., 0] < W) & (pts[..., 1] < H)
        return ok & (_lookup(pts, mask) >= 0.5)

    q_ok, t_ok = inside(grid, q_mask), inside(grid, t_mask)
    full = _apply(_inv_crop(q_M), grid)
    d = _lookup(full, rec["q_depth"])
    rays = torch.cat([full, torch.ones_like(full[..., :1])], -1) @ torch.linalg.inv(rec["q_K"]).transpose(-1, -2)
    p3 = rays * d[..., None]
    T = rec["t_pose"] @ torch.linalg.inv(rec["q_pose"])
    p3t = p3 @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
    proj = p3t @ rec["t_K"].transpose(-1, -2)
    in_t = _apply(t_M, proj[..., :2] / proj[..., 2:3])
    q_ok = q_ok & inside(in_t, t_mask) & (p3[..., 2] > 1e-8)
    valid = q_ok & t_ok
    neg = torch.tensor(-1.0, device=grid.device)
    rel_z = rec["t_pose"][:, 2, 3] / rec["q_pose"][:, 2, 3]
    crop = torch.linalg.vector_norm(q_M[:, :2, 0], dim=-1) / torch.linalg.vector_norm(t_M[:, :2, 0], dim=-1)
    rel_scale = rel_z * crop / (rec["t_K"][:, 0, 0] / rec["q_K"][:, 0, 0])
    R = rec["q_pose"][:, :3, :3] @ rec["t_pose"][:, :3, :3].transpose(-1, -2)
    inplane = torch.remainder(torch.atan2(R[:, 1, 0], R[:, 1, 1]) + 2 * math.pi, 2 * math.pi)
    return dict(src_img=t_rgb, tar_img=q_rgb,
                src_pts=torch.where(valid[..., None], in_t / patch, neg),
                tar_pts=torch.where(valid[..., None], grid / patch, neg),
                rel_scale=rel_scale, rel_inplane=inplane)


def gather(feat: torch.Tensor, pts: torch.Tensor):
    n = int(round(feat.shape[1] ** 0.5))
    x, y = pts[..., 0].long(), pts[..., 1].long()
    ok = (x >= 0) & (y >= 0) & (x < n) & (y < n)
    idx = torch.where(ok, y * n + x, 0).clamp(0, feat.shape[1] - 1)
    return torch.gather(feat, 1, idx[..., None].expand(-1, -1, feat.shape[-1])), ok


def _bn_train(layer, x):
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    return (x - mean[:, None, None]) * (torch.rsqrt(var + layer.eps) * layer.weight)[:, None, None] \
        + layer.bias[:, None, None]


def ist_features_train(ist: IST, x: torch.Tensor) -> torch.Tensor:
    b = ist.backbone
    x = resize_align_corners(x, b.input_size)
    x = F.relu(_bn_train(b.bn1, b.conv1(x)))
    for i in range(1, 5):
        for blk in getattr(b, f"layer{i}"):
            y = F.relu(_bn_train(blk.bn1, blk.conv1(x)))
            y = _bn_train(blk.bn2, blk.conv2(y))
            if blk.downsample is not None:
                x = _bn_train(blk.downsample[1], blk.downsample[0](x))
            x = F.relu(x + y)
    return b.layer4_outconv(x).flatten(2).transpose(1, 2)


def losses(vit: ViT, ist: IST, batch: dict, step: int, warm_up: int, tau: float) -> dict:
    B = batch["src_pts"].shape[0]
    valid = (batch["src_pts"][..., 0] >= 0) & (batch["tar_pts"][..., 0] >= 0)
    mean = lambda e, v: (e * v).sum() / v.sum().clamp(min=1)
    src_f = ist_features_train(ist, batch["src_img"])
    tar_f = ist_features_train(ist, batch["tar_img"])
    sg, sv = gather(src_f, batch["src_pts"])
    tg, tv = gather(tar_f, batch["tar_pts"])
    scale, cs = ist.regressor(torch.cat([tg, sg], -1))
    v = (sv & tv & valid).reshape(-1).float()
    scale, cs = scale.reshape(-1), cs.reshape(-1, 2)
    gs = batch["rel_scale"][:, None].expand(-1, sg.shape[1]).reshape(-1)
    a = batch["rel_inplane"][:, None].expand(-1, sg.shape[1]).reshape(-1)
    gcs = torch.stack([torch.cos(a), torch.sin(a)], -1)
    if step < warm_up:
        l_s = mean((scale - gs) ** 2, v)
        l_i = mean(((cs - gcs) ** 2).mean(-1), v)
    else:
        l_s = mean((torch.log(scale.clamp(min=1e-6)) - torch.log(gs)) ** 2, v)
        l_i = mean(torch.arccos(torch.clamp((cs * gcs).sum(-1), -1 + 1e-6, 1 - 1e-6)), v)
    both = vit.features(torch.stack([batch["src_img"], batch["tar_img"]], 1).flatten(0, 1))
    both = both.reshape((B, 2) + both.shape[1:])
    a_s, av_s = gather(both[:, 0], batch["src_pts"])
    a_t, av_t = gather(both[:, 1], batch["tar_pts"])
    vn = (av_s & av_t).reshape(-1)
    q = F.normalize(a_s.reshape(-1, a_s.shape[-1]), dim=-1, eps=1e-8)
    r = F.normalize(a_t.reshape(-1, a_t.shape[-1]), dim=-1, eps=1e-8)
    logits = torch.where(vn[None, :], (q @ r.T) / tau, torch.full((), -1e9, device=q.device))
    nce = mean(torch.logsumexp(logits, 1) - torch.diagonal(logits), vn.float())
    return dict(total=l_s + l_i + nce, scale=l_s, inp=l_i, infoNCE=nce)


class AdamW:
    """Two groups, one per net; updates p in place from p.grad."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, groups: Dict[str, dict], lrs: Dict[str, float], wd: float, warm_up: int):
        self.groups, self.lrs, self.wd, self.warm_up = groups, lrs, wd, warm_up
        self.count = 0
        self.mu = {n: {k: torch.zeros_like(p) for k, p in g.items()} for n, g in groups.items()}
        self.nu = {n: {k: torch.zeros_like(p) for k, p in g.items()} for n, g in groups.items()}

    @torch.no_grad()
    def step(self) -> None:
        t = self.count + 1
        for n, g in self.groups.items():
            lr = self.lrs[n] * min(self.count / self.warm_up, 1.0) if self.warm_up else self.lrs[n]
            for k, p in g.items():
                gr = p.grad if p.grad is not None else torch.zeros_like(p)
                self.mu[n][k] = self.b1 * self.mu[n][k] + (1 - self.b1) * gr
                self.nu[n][k] = self.b2 * self.nu[n][k] + (1 - self.b2) * gr * gr
                u = (self.mu[n][k] / (1 - self.b1 ** t)) / \
                    (torch.sqrt(self.nu[n][k] / (1 - self.b2 ** t)) + self.eps)
                p.add_(-lr * (u + self.wd * p))
        self.count = t
