"""Seeded synthetic inputs on the card: random textures, rotations and
template renders of an object (an elliptic silhouette over a smooth random
texture, black outside it), shared by the traffic drivers."""

import numpy as np
import torch
import torch.nn.functional as F


def texture(g: torch.Generator, n: int, H: int, W_: int, device) -> torch.Tensor:
    """(n, 3, H, W) random RGB in (0, 1): random fields at three scales
    (40, 8 and 3 pixels), bilinearly upsampled, so that neighbouring
    patches differ."""
    up = lambda t: F.interpolate(t, size=(H, W_), mode="bilinear", align_corners=False)
    x = 0.0
    for cell, w in ((40, 1.5), (8, 0.7), (3, 0.5)):
        x = x + w * up(torch.randn(n, 3, H // cell, W_ // cell, generator=g, device=device))
    return torch.sigmoid(x)


def rotations(g: torch.Generator, n: int, device) -> torch.Tensor:
    q = torch.randn(n, 4, generator=g, device=device)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def make_templates(g: torch.Generator, t: dict, V: int, device):
    """One object's (V, 4, H, W) uint8 RGBA renders, (V, 4) alpha boxes and
    (V, 4, 4) poses."""
    H, W_ = t["template_hw"]
    rgb = texture(g, V, H, W_, device)
    u = torch.rand(V, 5, generator=g, device=device)
    lo, hi = t["template_axes_px"]
    ax, ay = lo + (hi - lo) * u[:, 0], lo + (hi - lo) * u[:, 1]
    ang = u[:, 2] * np.pi
    cx, cy = W_ / 2 + (u[:, 3] - 0.5) * 40, H / 2 + (u[:, 4] - 0.5) * 40
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W_, device=device, dtype=torch.float32), indexing="ij")
    dx, dy = xs[None] - cx[:, None, None], ys[None] - cy[:, None, None]
    c, s = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
    inside = ((dx * c + dy * s) / ax[:, None, None]) ** 2 + \
        ((-dx * s + dy * c) / ay[:, None, None]) ** 2 <= 1.0
    rgba = torch.cat([rgb * inside[:, None], inside[:, None].float()], 1)
    rgba = (rgba * 255).round().to(torch.uint8)
    cols, rows = inside.any(1), inside.any(2)
    idx_w = torch.arange(W_, device=device)
    idx_h = torch.arange(H, device=device)
    boxes = torch.stack([
        torch.where(cols, idx_w, W_).amin(1), torch.where(rows, idx_h, H).amin(1),
        torch.where(cols, idx_w, -1).amax(1) + 1, torch.where(rows, idx_h, -1).amax(1) + 1], 1)
    poses = torch.eye(4, device=device).repeat(V, 1, 1)
    poses[:, :3, :3] = rotations(g, V, device)
    poses[:, 2, 3] = t["template_distance"]
    return rgba, boxes, poses
