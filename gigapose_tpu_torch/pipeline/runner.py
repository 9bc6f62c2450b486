"""Request preparation (the device part of gigapose_tpu/pipeline/runner.py).

`prepare_batch` is what the runner does per test image: masked RGBA per
detection, crop + normalize, patch masks, and padding of the detection count
to a shape bucket. It takes arrays instead of the JAX package's
ImageDetections, whose dataset loaders (PIL, yaml) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from gigapose_tpu_torch.ops.crop import crop_resize_pad
from gigapose_tpu_torch.ops.matching import downsample_mask
from gigapose_tpu_torch.pipeline.estimator import DetectionBatch
from gigapose_tpu_torch.pipeline.templates import normalize_rgb

PAD_BUCKETS = (4, 8, 16, 32, 64, 128)


def pad_bucket(n: int) -> int:
    for b in PAD_BUCKETS:
        if n <= b:
            return b
    return ((n + PAD_BUCKETS[-1] - 1) // PAD_BUCKETS[-1]) * PAD_BUCKETS[-1]


def prepare_batch(
    rgb: np.ndarray,  # (H, W, 3) uint8
    masks: np.ndarray,  # (N, H, W) modal masks, {0, 1}
    boxes_xyxy: np.ndarray,  # (N, 4) integer pixel boxes
    labels: np.ndarray,  # (N,) 1-based object labels
    K: np.ndarray,  # (3, 3) intrinsics
    device: torch.device,
    target_size: int = 224,
    num_patches: int = 16,
) -> DetectionBatch:
    """One image's detections -> a DetectionBatch padded to pad_bucket(N)."""
    N = len(labels)
    pad = pad_bucket(N) - N
    img = torch.as_tensor(np.asarray(rgb)).to(device, torch.float32) / 255.0  # (H, W, 3)
    m = torch.as_tensor(np.asarray(masks)).to(device, torch.float32)  # (N, H, W)
    rgba = torch.cat([img.permute(2, 0, 1)[None] * m[:, None], m[:, None]], dim=1)
    boxes = torch.as_tensor(np.asarray(boxes_xyxy)).to(device, torch.float32)
    crops, Ms = crop_resize_pad(rgba, boxes, target_size)
    crop_rgb = normalize_rgb(crops[:, :3])
    crop_mask = downsample_mask(crops[:, 3], num_patches)

    z = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    # K / M padding rows are identity, not zeros: the recovery inverts them
    eye_pad = lambda a: torch.cat([a, torch.eye(3, dtype=a.dtype, device=device).expand(pad, 3, 3)])
    Ks = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device).expand(N, 3, 3)
    lab = torch.as_tensor(np.asarray(labels).astype(np.int64) - 1).to(device, torch.int32)
    return DetectionBatch(
        crops=z(crop_rgb),
        masks=z(crop_mask),
        labels=z(lab),  # 0-based store index
        Ks=eye_pad(Ks),
        Ms=eye_pad(Ms),
        valid=torch.cat([torch.ones(N, dtype=torch.bool, device=device),
                         torch.zeros(pad, dtype=torch.bool, device=device)]),
    )
