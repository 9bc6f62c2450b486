"""Template store + onboarding (port of gigapose_tpu/pipeline/templates.py).

For every object, its V (162) rendered RGBA templates are cropped to 224
around the alpha bbox, normalized, pushed through both networks, and kept on
the device:

- ae_features  (O, V, P, C_ae)   L2-normalized ViT patch features
- ist_features (O, V, P, C_ist)  IST descriptor grids
- masks        (O, V, P)         patch-level alpha masks (f32)
- Ms           (O, V, 3, 3)      crop affines
- poses        (O, V, 4, 4)      object poses of each view
- K            (O, 3, 3)         template intrinsics

`onboard_templates` onboards the objects one after another on one device;
`onboard_templates_sharded` splits them over a list of devices (the JAX
package's object-parallel onboarding over its mesh's "dp" axis).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gigapose_tpu_torch.ops.crop import crop_resize_pad
from gigapose_tpu_torch.ops.matching import downsample_mask

# CLIP-style normalization of the original GigaPose data config
RGB_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
RGB_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

# fixed template intrinsics of the rendered template sets (480x640, object at 0.4 m)
TEMPLATE_K = np.array(
    [[572.4114, 0.0, 320.0], [0.0, 573.57043, 240.0], [0.0, 0.0, 1.0]], np.float32
)


def normalize_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) in [0, 1] -> CLIP-normalized."""
    mean = torch.as_tensor(RGB_MEAN, device=rgb.device).reshape(3, 1, 1)
    std = torch.as_tensor(RGB_STD, device=rgb.device).reshape(3, 1, 1)
    return (rgb - mean) / std


def alpha_bboxes(alphas: np.ndarray) -> np.ndarray:
    """(V, H, W) alpha channels -> (V, 4) xyxy tight boxes (exclusive max
    edge; an empty alpha gives the full image)."""
    V, H, W = alphas.shape
    boxes = np.zeros((V, 4), np.int32)
    for v in range(V):
        ys, xs = np.nonzero(alphas[v] > 0)
        if len(ys) == 0:
            boxes[v] = (0, 0, W, H)
        else:
            boxes[v] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
    return boxes


@dataclasses.dataclass
class TemplateStore:
    ae_features: torch.Tensor  # (O, V, P, C_ae)
    ist_features: torch.Tensor  # (O, V, P, C_ist)
    masks: torch.Tensor  # (O, V, P) float {0, 1}
    Ms: torch.Tensor  # (O, V, 3, 3)
    poses: torch.Tensor  # (O, V, 4, 4)
    K: torch.Tensor  # (O, 3, 3)


def _prepare(rgbas: torch.Tensor, boxes: torch.Tensor, target_size: int, num_patches: int):
    if rgbas.dtype == torch.uint8:
        rgbas = rgbas.to(torch.float32) / 255.0
    crops, Ms = crop_resize_pad(rgbas, boxes, target_size)
    rgb = normalize_rgb(crops[:, :3])
    mask_img = crops[:, 3]
    return rgb, mask_img, downsample_mask(mask_img, num_patches), Ms


def prepare_template_crops(rgbas: np.ndarray, device: torch.device,
                           target_size: int = 224, num_patches: int = 16) -> torch.Tensor:
    """(V, 4, H, W) RGBA templates -> (V, 3, S, S) CLIP-normalized crops,
    exactly what the onboarding extractors consume."""
    rgbas = np.asarray(rgbas)
    boxes = torch.as_tensor(alpha_bboxes(rgbas[:, 3]), device=device)
    rgb, _, _, _ = _prepare(torch.as_tensor(rgbas, device=device), boxes,
                            target_size, num_patches)
    return rgb


@torch.inference_mode()
def onboard_object(
    ae_apply: Callable[[torch.Tensor], torch.Tensor],
    ist_apply: Callable[[torch.Tensor], torch.Tensor],
    rgbas: np.ndarray,
    poses: np.ndarray,
    device: torch.device,
    K: Optional[np.ndarray] = None,
    target_size: int = 224,
    num_patches: int = 16,
    chunk: int = 64,
    feature_dtype: torch.dtype = torch.float32,
) -> dict:
    """One object's (V, 4, H, W) RGBA templates (float in [0, 1] or uint8)
    -> per-view features / masks / Ms. `chunk` bounds activation memory: the
    extractors see at most `chunk` crops per call."""
    rgbas = np.asarray(rgbas)
    V = rgbas.shape[0]
    boxes = torch.as_tensor(alpha_bboxes(rgbas[:, 3]), device=device)
    rgb, mask_img, masks, Ms = _prepare(
        torch.as_tensor(rgbas).to(device), boxes, target_size, num_patches
    )
    ae = torch.cat([ae_apply(rgb[i:i + chunk]) for i in range(0, V, chunk)])
    ist = torch.cat([ist_apply(rgb[i:i + chunk]) for i in range(0, V, chunk)])
    return dict(
        ae_features=ae.to(feature_dtype),
        ist_features=ist.to(feature_dtype),
        masks=masks.to(torch.float32),
        Ms=Ms,
        poses=torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=device),
        K=torch.as_tensor(TEMPLATE_K if K is None else K, dtype=torch.float32, device=device),
        rgb=rgb,
        mask_img=mask_img,
    )


def onboard_templates(
    ae_apply: Callable[[torch.Tensor], torch.Tensor],
    ist_apply: Callable[[torch.Tensor], torch.Tensor],
    rgbas_per_object,  # iterable of (V, 4, H, W) arrays
    poses_per_object,  # iterable of (V, 4, 4) arrays
    device: torch.device,
    Ks_per_object=None,
    **kwargs,
) -> TemplateStore:
    """Onboard a dataset's objects, one at a time, into a stacked TemplateStore."""
    entries = []
    for i, (rgbas, poses) in enumerate(zip(rgbas_per_object, poses_per_object)):
        K = None if Ks_per_object is None else Ks_per_object[i]
        entry = onboard_object(ae_apply, ist_apply, rgbas, poses, device, K, **kwargs)
        entries.append({k: entry[k] for k in ("ae_features", "ist_features", "masks",
                                              "Ms", "poses", "K")})
    stack = lambda name: torch.stack([e[name] for e in entries])
    return TemplateStore(
        ae_features=stack("ae_features"),
        ist_features=stack("ist_features"),
        masks=stack("masks"),
        Ms=stack("Ms"),
        poses=stack("poses"),
        K=stack("K"),
    )


def onboard_templates_sharded(
    ae_apply,
    ist_apply,
    rgbas_per_object,  # (O, V, 4, H, W) array or a list of same-shape arrays
    poses_per_object,  # (O, V, 4, 4)
    devices: Sequence,
    Ks_per_object=None,
    **kwargs,
) -> TemplateStore:
    """Object-parallel onboarding (port of the JAX package's, which vmaps
    the per-object program over an object axis sharded on its mesh's "dp"
    devices and replicates the store on the way out).

    The objects are padded to a multiple of len(devices) (a padding object
    keeps one nonzero alpha pixel, so its box is defined, as in JAX), device
    s onboards the s-th contiguous block of them (onboard_object, with
    `kwargs`), and the store is gathered on devices[0] without the padding.
    `ae_apply` / `ist_apply`: one callable for every device, or one per
    device (the nets' copies there). A device may repeat: [cuda:0] * S runs
    the S shards on one card. All objects share the template count and
    image size, as every template set does. On one device the result is
    onboard_templates' bit for bit."""
    devices = [torch.device(d) for d in devices]
    S = len(devices)
    if S < 1:
        raise ValueError("onboard_templates_sharded needs at least one device")
    per_device = lambda fn: list(fn) if isinstance(fn, (list, tuple)) else [fn] * S
    ae_fns, ist_fns = per_device(ae_apply), per_device(ist_apply)
    if len(ae_fns) != S or len(ist_fns) != S:
        raise ValueError(f"{len(ae_fns)} AE and {len(ist_fns)} IST callables for {S} devices")
    rgbas = np.stack([np.asarray(r) for r in rgbas_per_object])
    poses = np.stack([np.asarray(p) for p in poses_per_object])
    O = rgbas.shape[0]
    Op = -(-O // S) * S
    if Op != O:
        pad = np.zeros((Op - O,) + rgbas.shape[1:], rgbas.dtype)
        pad[:, :, 3, 0, 0] = 1
        rgbas = np.concatenate([rgbas, pad])
        poses = np.concatenate([poses, np.tile(np.eye(4, dtype=poses.dtype),
                                               (Op - O,) + poses.shape[1:-2] + (1, 1))])
    per = Op // S
    entries = []
    for s, dev in enumerate(devices):
        for o in range(s * per, (s + 1) * per):
            K = None if Ks_per_object is None or o >= O else Ks_per_object[o]
            entries.append(onboard_object(ae_fns[s], ist_fns[s], rgbas[o], poses[o], dev, K,
                                          **kwargs))
    home = devices[0]
    stack = lambda name: torch.stack([e[name].to(home) for e in entries[:O]])
    return TemplateStore(
        ae_features=stack("ae_features"),
        ist_features=stack("ist_features"),
        masks=stack("masks"),
        Ms=stack("Ms"),
        poses=stack("poses"),
        K=stack("K"),
    )
