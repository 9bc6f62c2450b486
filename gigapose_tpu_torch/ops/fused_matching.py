"""Fused template matching: wrapper of the CUDA kernel in
csrc/fused_matching.cu, and its plain PyTorch version.

Counterpart of gigapose_tpu/ops/pallas_matching.py (`pallas_match_scores`,
`pallas_match_templates`): per (detection b, view v of object labels[b]),

    sim = src . tar^T (P x P, f32 accumulate) -> sim * src_m * tar_m
    -> zero below sim_threshold -> first-index argmax both ways
    -> cycle check -> idx != 0 guards -> view score,

reading the (O, V, P, C) store in place by label, never gathered per batch.
Both inputs are L2-normalized already (the AE output and the store are) and
are not renormalized. Outputs: sim_avg (B, V) f32, idx_t2s (B, V, P) i32,
score_t2s (B, V, P) f32, valid (B, V, P) i32.

Dispatch is by device and nothing else: CUDA tensors launch a kernel (or
raise on what it does not take), CPU tensors take `match_scores_plain`. On
the card the store's dtype picks one of two hand-written kernels: a bf16
store the tensor-core (wgmma) kernel, which takes C a multiple of 8; an f32
store the CUDA-core kernel, which keeps full f32 inputs.
`fused_match_scores.launches` counts kernel launches, and
`fused_match_scores.launches_by_dtype` counts them per kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from gigapose_tpu_torch.ops.matching import MatchResult, select_top_k

# both kernels hold all query patches of a detection at once: a 64-row strip
# of MAX_PATCHES columns in shared memory (f32) or a 64 x 256 wgmma
# accumulator per warpgroup (bf16) (csrc/fused_matching.cu)
MAX_PATCHES = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_threshold(sim_threshold: float) -> None:
    if sim_threshold <= 0:
        raise ValueError(
            "fused matching requires sim_threshold > 0 (the kernel's mask "
            "elision contract, as in the Pallas kernel, is only exact above 0)"
        )


def match_scores_plain(
    tar_feat: torch.Tensor,
    store_feats: torch.Tensor,
    tar_mask: torch.Tensor,
    store_masks: torch.Tensor,
    labels: torch.Tensor,
    sim_threshold: float = 0.5,
    patch_threshold: int = 3,
    num_patches: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same four outputs, same multiply
    order, f32 similarity from inputs of any float dtype, first-index argmax."""
    _check_threshold(sim_threshold)
    P = tar_feat.shape[1]
    lab = labels.to(torch.int64)
    src = store_feats[lab].to(torch.float32)  # (B, V, P, C)
    src_m = store_masks[lab].to(torch.float32)  # (B, V, P)
    tar_m = tar_mask.to(torch.float32)
    # sim[b, v, s, t] = <src[s], tar[t]>: template patch s, query patch t
    sim = torch.matmul(src, tar_feat.to(torch.float32)[:, None].transpose(-1, -2))
    sim = sim * src_m[..., :, None] * tar_m[:, None, None, :]
    simz = torch.where(sim < sim_threshold, torch.zeros_like(sim), sim)

    score_t2s, idx_t2s = simz.max(dim=2)[0], torch.argmax(simz, dim=2)  # (B, V, P_t)
    score_s2t, idx_s2t = simz.max(dim=3)[0], torch.argmax(simz, dim=3)  # (B, V, P_s)
    mask_sim = score_t2s >= sim_threshold
    if patch_threshold > 0:
        idx_cycle = torch.gather(idx_s2t, 2, idx_t2s)
        sim_cycle = torch.gather(score_s2t, 2, idx_t2s)
        t = torch.arange(P, device=tar_feat.device)
        dx = (idx_cycle % num_patches - t % num_patches).to(torch.float32)
        dy = (idx_cycle // num_patches - t // num_patches).to(torch.float32)
        dist = torch.sqrt(dx * dx + dy * dy)
        mask_cycle = (dist <= patch_threshold) & (sim_cycle >= sim_threshold)
    else:
        mask_cycle = torch.ones_like(mask_sim)
    mask_nonzero = (
        (tar_m[:, None, :] > 0)
        & (torch.gather(src_m, 2, idx_t2s) > 0)
        & (idx_s2t != 0)
        & (idx_t2s != 0)
    )
    valid = mask_sim & mask_cycle & mask_nonzero
    total = (score_t2s * valid).sum(dim=2)
    sim_avg = torch.where(
        valid.any(dim=2), total / (num_patches**2), torch.zeros_like(total)
    )
    return sim_avg, idx_t2s.to(torch.int32), score_t2s, valid.to(torch.int32)


@functools.cache
def _entry_point():
    """gp_fused_match of the built library, with its C signature declared."""
    from gigapose_tpu_torch.kernels.build import load_library

    fn = load_library("fused_matching").gp_fused_match
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch(tar_feat, store_feats, tar_mask, store_masks, labels,
            sim_threshold, patch_threshold, num_patches):
    B, P, C = tar_feat.shape
    O, V = store_feats.shape[:2]
    dev = tar_feat.device
    for name, t in (("store_feats", store_feats), ("tar_mask", tar_mask),
                    ("store_masks", store_masks), ("labels", labels)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, tar_feat on {dev}")
    if tar_feat.dtype not in _DTYPE_CODES or store_feats.dtype != tar_feat.dtype:
        raise TypeError(
            f"features must share one dtype of {list(_DTYPE_CODES)}; got "
            f"tar {tar_feat.dtype}, store {store_feats.dtype}"
        )
    if tar_mask.dtype != torch.float32 or store_masks.dtype != torch.float32:
        raise TypeError("masks must be float32")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    if store_feats.shape[2:] != (P, C) or tar_mask.shape != (B, P):
        raise ValueError(f"shape mismatch: tar {tuple(tar_feat.shape)}, store "
                         f"{tuple(store_feats.shape)}, tar_mask {tuple(tar_mask.shape)}")
    if store_masks.shape != (O, V, P) or labels.shape != (B,):
        raise ValueError(f"shape mismatch: store_masks {tuple(store_masks.shape)}, "
                         f"labels {tuple(labels.shape)}")
    if not 0 < P <= MAX_PATCHES:
        raise ValueError(f"the kernel takes 1..{MAX_PATCHES} patches, got P={P}")
    if tar_feat.dtype == torch.bfloat16 and C % 8:
        raise ValueError(f"the bf16 kernel reads 16-byte rows: C={C} must be a multiple of 8")
    for name, t in (("tar_feat", tar_feat), ("store_feats", store_feats),
                    ("tar_mask", tar_mask), ("store_masks", store_masks),
                    ("labels", labels)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tar_feat.data_ptr() % 16 or store_feats.data_ptr() % 16:
        raise ValueError("features must start on a 16-byte boundary")

    sim_avg = torch.empty((B, V), dtype=torch.float32, device=dev)
    idx = torch.empty((B, V, P), dtype=torch.int32, device=dev)
    score = torch.empty((B, V, P), dtype=torch.float32, device=dev)
    valid = torch.empty((B, V, P), dtype=torch.int32, device=dev)
    if B * V == 0:
        return sim_avg, idx, score, valid
    fn = _entry_point()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            tar_feat.data_ptr(), store_feats.data_ptr(), tar_mask.data_ptr(),
            store_masks.data_ptr(), labels.data_ptr(),
            sim_avg.data_ptr(), idx.data_ptr(), score.data_ptr(), valid.data_ptr(),
            B, O, V, P, C, _DTYPE_CODES[tar_feat.dtype],
            float(sim_threshold), int(patch_threshold), int(num_patches), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused matching kernel launch failed: CUDA error {err}")
    fused_match_scores.launches += 1
    fused_match_scores.launches_by_dtype[tar_feat.dtype] += 1
    return sim_avg, idx, score, valid


def fused_match_scores(
    tar_feat: torch.Tensor,  # (B, P, C) L2-normalized query features
    store_feats: torch.Tensor,  # (O, V, P, C) L2-normalized template store
    tar_mask: torch.Tensor,  # (B, P) f32
    store_masks: torch.Tensor,  # (O, V, P) f32
    labels: torch.Tensor,  # (B,) int32 0-based object index
    sim_threshold: float = 0.5,
    patch_threshold: int = 3,
    num_patches: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(detection, view) matching -> (sim_avg (B, V), idx_t2s (B, V, P),
    score_t2s (B, V, P), valid (B, V, P)). CUDA tensors run the kernel; CPU
    tensors run match_scores_plain; anything else raises."""
    _check_threshold(sim_threshold)
    args = (tar_feat, store_feats, tar_mask, store_masks, labels,
            sim_threshold, patch_threshold, num_patches)
    if tar_feat.device.type == "cuda":
        return _launch(*args)
    if tar_feat.device.type == "cpu":
        return match_scores_plain(*args)
    raise ValueError(f"fused matching runs on cuda or cpu tensors, not {tar_feat.device}")


fused_match_scores.launches = 0
fused_match_scores.launches_by_dtype = {dtype: 0 for dtype in _DTYPE_CODES}


def fused_match_templates(
    tar_feat: torch.Tensor,
    store_feats: torch.Tensor,
    tar_mask: torch.Tensor,
    store_masks: torch.Tensor,
    labels: torch.Tensor,
    k: int = 5,
    sim_threshold: float = 0.5,
    patch_threshold: int = 3,
    num_patches: int = 16,
) -> MatchResult:
    """Drop-in for ops.matching.match_templates that reads the store in
    place (no per-batch gather). Returns the same MatchResult."""
    outs = fused_match_scores(
        tar_feat, store_feats, tar_mask, store_masks, labels,
        sim_threshold, patch_threshold, num_patches,
    )
    return select_top_k(*outs, k=k, num_patches=num_patches)
