"""Fused template matching: wrapper of the CUDA kernels in
csrc/fused_matching.cu, and their plain PyTorch versions.

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
the card the store's dtype picks one of two hand-written kernels, both on
the tensor cores (wgmma): a bf16 store the bf16 kernel, which takes C a
multiple of 8; an f32 store the TF32 kernel with a three-product split
(hi . hi + hi . lo + lo . hi, "3xTF32"), which keeps f32-grade scores
(about 7e-7 from the exact product on unit rows) and takes any C. Before it
`split_query` writes the query's tf32 hi and lo once per launch
(`split_tf32` is that rounding in torch bit operations), and
`match_f32_route` picks how the kernel loads the template rows.
`fused_match_scores.launches` counts matching launches,
`fused_match_scores.launches_by_dtype` counts them per kernel and
`split_query.launches` counts the split kernel's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from gigapose_tpu_torch.ops.matching import MatchResult, select_top_k

# both kernels hold all query patches of a detection at once: a 64 x 256
# wgmma accumulator per warpgroup (csrc/fused_matching.cu)
MAX_PATCHES = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_F32_ROUTES = {"tma": 0, "cp_async": 1}
_TF32_MASK = -(1 << 13)  # the 13 low mantissa bits that tf32 drops, as an int32 mask


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 x -> (hi, lo), x = hi + lo up to 2^-22 |x|, as the f32 kernel splits
    its operands: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact in f32),
    where tf32 rounds to 10 mantissa bits, to nearest with ties away from
    zero (cvt.rna.tf32.f32), and leaves the 13 low bits zero."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {x.dtype}")

    def tf32(v: torch.Tensor) -> torch.Tensor:
        # adding half of the dropped bits' unit to the magnitude bits rounds
        # the magnitude half up: to nearest, ties away from zero
        return ((v.view(torch.int32) + (1 << 12)) & _TF32_MASK).view(torch.float32)

    hi = tf32(x)
    return hi, tf32(x - hi)


def split_width(C: int) -> int:
    """Channels of a row of split_query's output: C rounded up to 4, so that
    its rows are 16 bytes apart, as the kernel's TMA loads need."""
    return -(-C // 4) * 4


def match_f32_route(C: int) -> str:
    """How the f32 kernel loads the store's template rows: "tma" where C is
    a multiple of 4 (rows 16 bytes apart, as TMA needs: every AE width,
    384 / 768 / 1024 / 1536), else "cp_async" (4-byte copies with zero
    fill). The query always comes through TMA from split_query's rows. The
    decision is made here alone; the C entry point checks only that TMA can
    take what it is given."""
    return "tma" if C % 4 == 0 else "cp_async"


def split_query(x: torch.Tensor) -> torch.Tensor:
    """(..., C) f32 -> (2, ..., split_width(C)) f32: split_tf32's hi, then lo,
    channels past C zero. A CUDA tensor launches csrc/fused_matching.cu's
    split kernel (counted in split_query.launches), a CPU tensor takes
    split_tf32; anything else raises."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_query takes float32, got {x.dtype}")
    C = x.shape[-1]
    Cp = split_width(C)
    if x.device.type == "cpu":
        hi, lo = split_tf32(x)
        return F.pad(torch.stack([hi, lo]), (0, Cp - C))
    if x.device.type != "cuda":
        raise ValueError(f"split_query runs on cuda or cpu tensors, not {x.device}")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError("split_query takes a contiguous, non-empty tensor")
    out = torch.empty((2, *x.shape[:-1], Cp), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _entry_points()[1](x.data_ptr(), out.data_ptr(), x.numel() // C, C, Cp,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tf32 split kernel launch failed: CUDA error {err}")
    split_query.launches += 1
    return out


split_query.launches = 0


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
    products: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernels: same four outputs, same multiply
    order, first-index argmax, the similarity from inputs of any float
    dtype. products: "f32" (the f32 product), "3xtf32" (the f32 kernel's
    three products of split_tf32's parts, summed in f32), or "f64" (the
    exact reference: similarity and scores in f64)."""
    _check_threshold(sim_threshold)
    if products not in ("f32", "3xtf32", "f64"):
        raise ValueError(f"products must be f32, 3xtf32 or f64, got {products!r}")
    dt = torch.float64 if products == "f64" else torch.float32
    P = tar_feat.shape[1]
    lab = labels.to(torch.int64)
    src = store_feats[lab].to(dt)  # (B, V, P, C)
    src_m = store_masks[lab].to(dt)  # (B, V, P)
    tar_m = tar_mask.to(dt)
    tar_t = tar_feat.to(dt)[:, None].transpose(-1, -2)
    # sim[b, v, s, t] = <src[s], tar[t]>: template patch s, query patch t
    if products == "3xtf32":
        (s_hi, s_lo), (t_hi, t_lo) = split_tf32(src), split_tf32(tar_t)
        sim = (torch.matmul(s_hi, t_hi) + torch.matmul(s_hi, t_lo)) + torch.matmul(s_lo, t_hi)
    else:
        sim = torch.matmul(src, tar_t)
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
def _entry_points():
    """gp_fused_match and gp_split_tf32 of the built library."""
    from gigapose_tpu_torch.kernels.build import load_library

    return declare(load_library("fused_matching"))


def declare(lib: ctypes.CDLL):
    """(gp_fused_match, gp_split_tf32) of a library built from
    csrc/fused_matching.cu, with their C signatures declared."""
    match, split = lib.gp_fused_match, lib.gp_split_tf32
    match.restype = split.restype = ctypes.c_int
    match.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    split.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return match, split


def _launch(tar_feat, store_feats, tar_mask, store_masks, labels,
            sim_threshold, patch_threshold, num_patches, match_entry=None):
    """The checks and the launch of fused_match_scores on CUDA tensors;
    match_entry: gp_fused_match of another build of the source (a variant
    of scripts/match_f32_variants.py; its launches are not counted)."""
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
    split, route = None, 0
    if tar_feat.dtype == torch.float32:  # the query's tf32 parts, once per launch
        split = split_query(tar_feat)
        route = _F32_ROUTES[match_f32_route(C)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = (match_entry or _entry_points()[0])(
            tar_feat.data_ptr(), store_feats.data_ptr(), tar_mask.data_ptr(),
            store_masks.data_ptr(), labels.data_ptr(),
            sim_avg.data_ptr(), idx.data_ptr(), score.data_ptr(), valid.data_ptr(),
            B, O, V, P, C, _DTYPE_CODES[tar_feat.dtype],
            float(sim_threshold), int(patch_threshold), int(num_patches),
            None if split is None else split.data_ptr(), split_width(C), route, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused matching kernel launch failed: CUDA error {err}")
    if match_entry is not None:
        return sim_avg, idx, score, valid
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
