#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gigapose_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's coarse path at the full width of `model=large` (DINOv2
ViT-L/14, the default IST backbone, bf16 compute and a bf16 template store,
k=5, sim_threshold 0.5, patch_threshold 3, pixel_threshold 14, 162
templates per object) with seeded random weights and numpy-synthesised
inputs, twice: with the bf16 AE (`serving_quant=off`) and with the int8 AE
(`est.quantize_serving()`). Phases, one line each or more:

1. device + build: the card, its power limit, the nvcc builds of the
   kernels (one nvcc per source, all started together) with ptxas's
   registers and spills;
2. the fused matching kernel against its plain PyTorch version on planted
   worlds, at P=16 and at the serving shape B=32, V=162, P=256, C=1024, in
   f32 and bf16 stores (idx / valid / top-k ids exact, scores within
   MATCH_ATOL), with both times from CUDA events;
3. the int8 kernels (ops/qmm.py) against their plain versions at the ViT-L
   serving shapes, T = 32 x 257 tokens: qmm in its four (LN, residual) forms
   at K=1024, N=3072 and at the main path's proj and fc2 shapes; the GEMM's
   GELU (fc1) and bf16 (qkv) epilogues alone on the plain version's int8
   rows, in ulps; the attention core alone on the plain version's bf16 qkv;
   qmm_mlp at C=1024, hidden 4096; qmm_attn_block with 16 heads at Np=257
   and at Np=264 with 7 padded keys masked; errors in quantization steps for
   qmm (check_steps) and relative to the output or branch elsewhere
   (check_rel), both times from CUDA events;
4. bf16 onboarding of 2 objects x 162 procedurally textured 480x640 RGBA
   templates;
5. bf16 requests: images with several detections, one of them a template
   pasted unscaled, through prepare_batch -> GigaPoseEstimator; the
   matching kernel is then held against its plain version on the features
   of a request;
6. int8 serving: the same estimator after quantize_serving(), onboarding
   and the same requests, with the launch counts of every kernel per
   forward (24 qmm_attn_block, 24 qmm_mlp, 48 qmm inside them, 1 matching);
7. the int8 AE's wiring: with LayerScale raised from its 1e-5 init to 0.3
   (so that every block moves the features), the AE on the card against the
   same AENetInt8 on the CPU (the plain versions) on a request's crops;
8. int8 against bf16: per-token cosine of the AE features of a request's
   crops (> 0.99, the JAX package's gate), and the AE forward's device time
   in both precisions at B = 4, 8, 16, 32.

Every kernel count is set to 0 just before a path is driven and read just
after; launches made to compare a kernel with its plain version are not
counted.

Any failed check raises, so the script exits non-zero. It needs CUDA and
never falls back to the CPU. The last lines are the kernels' JSON record,
the card's name and power limit from nvidia-smi, and the result JSON.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gigapose_tpu_torch.kernels.build import build, load_library
from gigapose_tpu_torch.lib3d.icosphere import template_object_poses
from gigapose_tpu_torch.models import vit_int8 as v8
from gigapose_tpu_torch.ops import fused_matching as fm
from gigapose_tpu_torch.ops import qmm as Q
from gigapose_tpu_torch.ops.matching import select_top_k
from gigapose_tpu_torch.pipeline.estimator import EstimatorConfig, GigaPoseEstimator
from gigapose_tpu_torch.pipeline.runner import prepare_batch
from gigapose_tpu_torch.pipeline.templates import onboard_templates

SEED = 0
MODEL = "dinov2_vitl14"
H, W = 480, 640
NUM_VIEWS = 162
MATCH = dict(sim_threshold=0.5, patch_threshold=3)
# scores are f32 sums of up to C=1024 exact products, taken in another order
# by the kernel (sequential FMA) and by cuBLAS: O(1e-6) apart on O(1) values
MATCH_ATOL = 1e-4
# int8 kernels against their plain versions (tests/test_torch_cuda_qmm.py):
# the same int8 rows give the same outputs (exact int32 sums, the same
# rounding of each product and sum): the GEMM epilogues within EPI_ULPS;
# ulp-level differences before a quantization (LN means, tanh, the
# attention sums) now and then flip one int8 by a step. In qmm that moves an
# output by at most zmax[t] * ws[n] * |ls[n]|: MAX_STEPS such steps
# anywhere, MEAN_STEPS on average.
MAX_STEPS, MEAN_STEPS = 4.0, 0.25
EPI_ULPS = 2.0
# check_rel limits (max |diff| / max |ref|, mean |diff| / mean |ref|, and
# 1 - the least per-token cosine), about twice the readings at these shapes
# on an H100 (PERF.md, PR 2). The attention core alone differs from its
# plain version only by its f32 sums' order and the rare bf16 rounding of p
# that this flips. In the chained kernels the reference is the branch
# out - x: a flip before the first matmul re-rounds the whole row
# downstream, and requantizing it flips more. The wiring check compares the
# whole AE's unit features after 24 blocks, where flips compound.
CORE_LIMITS = dict(rel_max=3e-3, rel_mean=2e-6, cos_gap=2.5e-6)
MLP_LIMITS = dict(rel_max=6e-3, rel_mean=1e-5, cos_gap=5e-5)
ATTN_LIMITS = dict(rel_max=2e-2, rel_mean=3.5e-4, cos_gap=3e-4)
WIRING_LIMITS = dict(rel_max=3e-2, rel_mean=2.5e-2, cos_gap=3e-4)
# and LayerScale 0.3 must move them: some token's cosine to the features at
# LayerScale's init below this
WIRING_MOVED_COS = 0.9
TOKENS = 257  # ViT-L/14 at 224 x 224: CLS + 16 x 16 patches, not padded
INT8_COS_MIN = 0.99
KERNELS = ("fused_matching", "qmm")


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, warmup: int = 2, iters: int = 5) -> float:
    """Mean device time of fn() over `iters` runs after `warmup`, from CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def planted_world(seed, B, O, V, npat, C):
    """Random unit features; view (labels[b], b % V) copies half of query b's
    patches up to noise (as tests/test_pallas_matching.py builds its worlds)."""
    rng = np.random.default_rng(seed)
    P = npat * npat
    tar = rng.standard_normal((B, P, C), dtype=np.float32)
    store = rng.standard_normal((O, V, P, C), dtype=np.float32)
    labels = rng.integers(0, O, size=B).astype(np.int32)
    for b in range(B):
        take = rng.integers(0, P, size=P // 2)
        store[labels[b], b % V, take] = tar[b, take] + 0.05 * rng.standard_normal(
            (len(take), C), dtype=np.float32)
    tar /= np.linalg.norm(tar, axis=-1, keepdims=True)
    store /= np.linalg.norm(store, axis=-1, keepdims=True)
    tmask = (rng.uniform(size=(B, P)) > 0.2).astype(np.float32)
    smask = (rng.uniform(size=(O, V, P)) > 0.2).astype(np.float32)
    return tar, store, tmask, smask, labels


def compare_matcher(args, npat: int, k: int = 5, exact: bool = True) -> dict:
    """Kernel vs plain version on the same CUDA tensors. exact: idx, valid
    and top-k ids must be equal; otherwise their disagreement is reported.
    Scores must agree within MATCH_ATOL either way."""
    kw = dict(MATCH, num_patches=npat)
    got = fm.fused_match_scores(*args, **kw)
    want = fm.match_scores_plain(*args, **kw)
    torch.cuda.synchronize()
    top_got = select_top_k(*got, k=k, num_patches=npat)
    top_want = select_top_k(*want, k=k, num_patches=npat)
    err = max(float((got[0] - want[0]).abs().max()), float((got[2] - want[2]).abs().max()))
    stats = dict(
        max_abs_err=err,
        idx_mismatch=int((got[1] != want[1]).sum()),
        valid_mismatch=int((got[3] != want[3]).sum()),
        topk_mismatch=int((top_got.ids != top_want.ids).sum()),
        valid_frac=round(float(want[3].float().mean()), 4),
        zero_views=round(float((want[0] == 0).float().mean()), 4),
    )
    check(err <= MATCH_ATOL, f"matcher scores differ by {err} > {MATCH_ATOL}")
    if exact:
        check(stats["idx_mismatch"] == 0, f"idx_t2s differs: {stats}")
        check(stats["valid_mismatch"] == 0, f"valid differs: {stats}")
        check(stats["topk_mismatch"] == 0, f"top-k ids differ: {stats}")
    return stats


def phase_kernel_vs_plain(dev) -> dict:
    """Planted worlds at P=16 and at the serving shape, f32 and bf16 stores."""
    record = {}
    for name, shape in (("P16", dict(B=4, O=2, V=6, npat=4, C=64)),
                        ("serving", dict(B=32, O=2, V=NUM_VIEWS, npat=16, C=1024))):
        tar, store, tmask, smask, labels = planted_world(SEED, **shape)
        for dtype in (torch.float32, torch.bfloat16):
            args = (torch.as_tensor(tar).to(dev, dtype), torch.as_tensor(store).to(dev, dtype),
                    torch.as_tensor(tmask).to(dev), torch.as_tensor(smask).to(dev),
                    torch.as_tensor(labels).to(dev))
            stats = compare_matcher(args, shape["npat"])
            kw = dict(MATCH, num_patches=shape["npat"])
            ms = cuda_ms(lambda: fm.fused_match_scores(*args, **kw))
            plain_ms = cuda_ms(lambda: fm.match_scores_plain(*args, **kw))
            tag = f"{name}_{str(dtype).split('.')[-1]}"
            log("kernel_vs_plain", world=tag, kernel_ms=f"{ms:.4f}",
                plain_ms=f"{plain_ms:.4f}", **stats)
            record[tag] = dict(ms=ms, plain_ms=plain_ms, **stats)
            del args
    torch.cuda.empty_cache()
    return record


def randn(dev, shape, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale
    return torch.from_numpy(a).to(dev)


def int8_weight(dev, K, N, seed):
    wq, ws = Q.quantize_weight(randn(dev, (K, N), seed, K ** -0.5))
    return wq, ws, randn(dev, (1, N), seed + 1, 0.1)


def check_steps(name, got, want, zmax, ws, ls=None, exact=False) -> dict:
    """Kernel output against plain, in quantization steps zmax[t] * ws[n] *
    |ls[n]| (MAX_STEPS / MEAN_STEPS; bit-equal where `exact`)."""
    step = zmax.reshape(-1, 1) * ws * (1.0 if ls is None else ls.abs())
    diff = (got - want).abs()
    steps = diff / step
    stats = dict(max_abs_err=float(diff.max()), max_steps=float(steps.max()),
                 mean_steps=float(steps.mean()), equal=float((got == want).float().mean()))
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(stats["max_steps"] <= MAX_STEPS and stats["mean_steps"] <= MEAN_STEPS,
          f"{name} differs from its plain version: {stats}")
    if exact:
        check(stats["equal"] == 1.0, f"{name} is not bit-equal to its plain version: {stats}")
    return stats


def check_ulps(name, got, want, mantissa_bits) -> dict:
    """Bit-level agreement: |got - want| in units in the last place of want
    (24 mantissa bits for f32, 8 for bf16), at most EPI_ULPS."""
    _, e = torch.frexp(want.float())
    ulps = (got.float() - want.float()).abs() / torch.ldexp(torch.ones_like(want.float()),
                                                          e - mantissa_bits)
    stats = dict(max_abs_err=float((got.float() - want.float()).abs().max()),
                 max_ulps=float(ulps.max()), equal=float((got == want).float().mean()))
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    check(stats["max_ulps"] <= EPI_ULPS, f"{name} differs from its plain version: {stats}")
    return stats


def check_rel(name, got, want, limits, x=0.0) -> dict:
    """A kernel against its plain version, relative to r = want - x (the
    output, or the branch of a residual block): max |got - want| / max |r|,
    mean |got - want| / mean |r| and 1 - the least per-token cosine of got - x
    and r (in f64, below f32's own rounding) within `limits`."""
    diff = (got - want).abs()
    r_want, r_got = (want - x).double(), (got - x).double()
    cos = (r_got * r_want).sum(-1) / (r_got.norm(dim=-1) * r_want.norm(dim=-1))
    stats = dict(max_abs_err=float(diff.max()),
                 rel_max=float(diff.max() / r_want.abs().max()),
                 rel_mean=float(diff.mean() / r_want.abs().mean()),
                 cos_gap=1.0 - float(cos.min()), equal=float((got == want).float().mean()))
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(all(stats[k] <= limits[k] for k in ("rel_max", "rel_mean", "cos_gap")),
          f"{name} differs from its plain version: {stats}, limits {limits}")
    return stats


def phase_qmm_vs_plain(dev) -> dict:
    """The three int8 wrappers against their plain versions at ViT-L serving
    shapes (32 crops of 257 tokens, C=1024, 16 heads, hidden 4096), LayerScale
    0.3 so that the branches show in the outputs."""
    T, C, Hd = 32 * TOKENS, 1024, 4096
    x = randn(dev, (T, C), SEED + 20)
    g, be = randn(dev, (1, C), SEED + 21).abs() + 0.5, randn(dev, (1, C), SEED + 22, 0.2)
    rec = {}

    def record(name, stats, kernel, plain):
        stats.update(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain))
        log("qmm_vs_plain", case=name, **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                          for k, v in stats.items()})
        rec[name] = stats
        torch.cuda.empty_cache()

    w3 = int8_weight(dev, C, 3 * C, SEED + 30)
    r3, ls3 = randn(dev, (T, 3 * C), SEED + 32), randn(dev, (1, 3 * C), SEED + 33, 0.3)
    for ln in (False, True):
        for res in (False, True):
            args = (x, *w3, g if ln else None, be if ln else None,
                    r3 if res else None, ls3 if res else None)
            z = (Q._ln(x, g, be) if ln else x).abs().amax(dim=-1)
            stats = check_steps(f"qmm ln={ln} res={res}", Q.qmm(*args), Q.qmm_plain(*args), z,
                                w3[1], ls3 if res else None, exact=not ln)
            record(f"qmm_K1024_N3072_ln{int(ln)}_res{int(res)}", stats,
                   lambda: Q.qmm(*args), lambda: Q.qmm_plain(*args))
    del r3
    ls = randn(dev, (1, C), SEED + 34, 0.3)
    for name, K in (("proj", C), ("fc2", Hd)):  # the main path's qmm calls
        a = randn(dev, (T, K), SEED + 35)
        w = int8_weight(dev, K, C, SEED + 36)
        args = (a, *w, None, None, x, ls)
        stats = check_steps(f"qmm {name}", Q.qmm(*args), Q.qmm_plain(*args),
                            a.abs().amax(dim=-1), w[1], ls, exact=K <= 1024)
        record(f"qmm_{name}", stats, lambda: Q.qmm(*args), lambda: Q.qmm_plain(*args))
        del a

    w1, w2 = int8_weight(dev, C, Hd, SEED + 40), int8_weight(dev, Hd, C, SEED + 42)
    wqkv, wproj = int8_weight(dev, C, 3 * C, SEED + 50), int8_weight(dev, C, C, SEED + 52)
    # the GELU (fc1) and bf16 (qkv) epilogues alone, on the plain version's
    # int8 rows of LN(x): K = 1024, so the plain f32 sums are exact too
    xq, xs = Q._quant_rows(Q._ln(x, g, be))
    for mode, (wq, ws, b), dtype, bits, plain in (
        (Q._MODE_GELU, w1, torch.float32, 24, Q._gelu_tanh),
        (Q._MODE_BF16, wqkv, torch.bfloat16, 8, lambda y: y.to(torch.bfloat16)),
    ):
        out = torch.empty((T, wq.shape[1]), dtype=dtype, device=dev)
        name = "gemm_gelu_fc1" if mode == Q._MODE_GELU else "gemm_bf16_qkv"
        gemm = lambda: Q._gemm(xq, xs, wq, ws, b, out, mode)
        gemm_plain = lambda: plain(Q._dot_i8(xq, wq) * xs * ws + b)
        gemm()
        stats = check_ulps(name, out, gemm_plain(), bits)
        record(name, stats, gemm, gemm_plain)
        del out
    del xq, xs

    margs = (x, *w1, *w2, g, be, ls)
    stats = check_rel("qmm_mlp", Q.qmm_mlp(*margs), Q.qmm_mlp_plain(*margs), MLP_LIMITS, x)
    record("qmm_mlp", stats, lambda: Q.qmm_mlp(*margs), lambda: Q.qmm_mlp_plain(*margs))

    kw = dict(batch=32, num_heads=16)
    for Np, masked in ((TOKENS, 0), (264, 7)):
        xa = randn(dev, (32 * Np, C), SEED + 54)
        kb = torch.where(torch.arange(Np, device=dev) < Np - masked, 0.0, -1e9).reshape(1, Np)
        # the attention core alone, on the plain version's bf16 qkv
        qkv = Q.qmm_plain(xa, *wqkv, g, be).to(torch.bfloat16)
        stats = check_rel(f"attention core Np={Np}", Q._attention(qkv, kb, **kw),
                          Q.attention_plain(qkv, kb, **kw), CORE_LIMITS)
        record(f"attention_core_Np{Np}_masked{masked}", stats,
               lambda: Q._attention(qkv, kb, **kw), lambda: Q.attention_plain(qkv, kb, **kw))
        del qkv
        aargs = (xa, *wqkv, *wproj, g, be, ls, kb)
        stats = check_rel(f"qmm_attn_block Np={Np}", Q.qmm_attn_block(*aargs, **kw),
                          Q.qmm_attn_block_plain(*aargs, **kw), ATTN_LIMITS, xa)
        record(f"qmm_attn_block_Np{Np}_masked{masked}", stats,
               lambda: Q.qmm_attn_block(*aargs, **kw), lambda: Q.qmm_attn_block_plain(*aargs, **kw))
        del xa
    return rec


def reset_counts() -> None:
    for fn in (fm.fused_match_scores, Q.qmm, Q.qmm_mlp, Q.qmm_attn_block):
        fn.launches = 0


def counts() -> dict:
    return dict(fused_matching=fm.fused_match_scores.launches, qmm=Q.qmm.launches,
                qmm_mlp=Q.qmm_mlp.launches, qmm_attn_block=Q.qmm_attn_block.launches)


def onboard(est, templates, dev, tag):
    poses = [template_object_poses(1).astype(np.float32)] * len(templates)
    for rnd in ("cold", "warm"):  # the cold call includes cuBLAS / cuDNN set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store = onboard_templates(est.ae_apply, est.ist_apply, templates, poses, dev,
                                  feature_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        onboard_s = time.perf_counter() - t0
        log("onboarding", ae=tag, call=rnd, objects=len(templates), views=NUM_VIEWS,
            seconds=f"{onboard_s:.3f}", s_per_object=f"{onboard_s / len(templates):.3f}")
    check(tuple(store.ae_features.shape) == (2, NUM_VIEWS, 256, 1024), "store shape")
    check(bool(torch.isfinite(store.ae_features.float()).all()), "store features finite")
    return store


def serve(est, store, scenes, planted, dev, tag):
    """Two rounds over the scenes (round 0 cold); checks every output is
    finite and each planted view is retrieved with sim > 0.9. Returns the
    (prediction, batch) pairs and the kernel counts of the run."""
    reset_counts()
    latencies, preds = [], []
    for rnd in range(2):
        for scene in scenes:
            rgb, masks, boxes, labels, K, _ = scene
            t0 = time.perf_counter()
            batch = prepare_batch(rgb, masks, boxes, labels, K, dev)
            pred = est(store, batch)
            torch.cuda.synchronize()
            latencies.append((rnd, len(labels), int(batch.crops.shape[0]),
                              (time.perf_counter() - t0) * 1e3))
            preds.append((pred, batch))
    launched = counts()
    planted_sims = []
    for (pred, _), obj_view, scene in zip(preds, planted * 2, scenes * 2):
        for f in ("poses", "scores", "M", "sim_scores", "src_pts", "tar_pts"):
            check(bool(torch.isfinite(getattr(pred, f)).all()), f"{f} finite")
        i = scene[-1]
        ids = pred.view_ids[i].tolist()
        check(obj_view[1] in ids, f"{tag}: planted view {obj_view} not in top-k {ids}")
        planted_sims.append(float(pred.sim_scores[i][ids.index(obj_view[1])]))
        check(planted_sims[-1] > 0.9, f"{tag}: planted view {obj_view} sim {planted_sims[-1]}")
    for rnd, n, padded, ms in latencies:
        log("request", ae=tag, round=rnd, detections=n, padded=padded, latency_ms=f"{ms:.2f}")
    log("requests", ae=tag, forwards=len(latencies), planted_sim_min=f"{min(planted_sims):.4f}",
        **launched)
    return preds, launched


def phase_int8_wiring(est8, batch) -> dict:
    """The int8 AE with LayerScale 0.3 on the card against the same module
    on the CPU, where every wrapper runs its plain version, on a request's
    crops: a fault in how the network drives the kernels (token counts,
    heads, key bias, a block skipped) moves the features by O(1)."""
    q = est8.ae_net
    qp = q.params
    ls = lambda t: torch.full_like(t, 0.3)
    qp["blocks"] = [dict(b, ls1=ls(b["ls1"]), ls2=ls(b["ls2"])) for b in qp["blocks"]]
    net = v8.AENetInt8(q.cfg, qp)
    crops = batch.crops
    with torch.inference_mode():
        got = net(crops).float()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = net.to(torch.device("cpu"))(crops.cpu()).float()
        cpu_s = time.perf_counter() - t0
        base = est8.ae_apply(crops).float().cpu()  # LayerScale at its init
    base_cos = (got.cpu() * base).sum(-1) / (got.cpu().norm(dim=-1) * base.norm(dim=-1))
    stats = check_rel("int8 AE, card against CPU", got.cpu(), want, WIRING_LIMITS)
    log("int8_wiring", crops=int(crops.shape[0]), layerscale=0.3, cpu_s=f"{cpu_s:.2f}",
        cos_to_init_ls_min=f"{float(base_cos.min()):.4f}",
        **{k: f"{v:.4g}" for k, v in stats.items()})
    # the blocks must show: far from the features at LayerScale's init
    check(float(base_cos.min()) < WIRING_MOVED_COS, "LayerScale 0.3 does not move the features")
    return stats


def phase_int8_vs_bf16(est, est8, batch, dev) -> dict:
    """Per-token cosine of int8 against bf16 AE features on a request's
    crops, and the AE forward's device time in both precisions per B."""
    with torch.inference_mode():
        a = est.ae_apply(batch.crops).float()
        b = est8.ae_apply(batch.crops).float()
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    check(float(cos.min()) > INT8_COS_MIN, f"int8 / bf16 per-token cosine {float(cos.min())}")
    log("int8_vs_bf16", crops=int(batch.crops.shape[0]), cos_min=f"{float(cos.min()):.6f}",
        cos_mean=f"{float(cos.mean()):.6f}")
    times = {}
    for B in (4, 8, 16, 32):
        crops = randn(dev, (B, 3, 224, 224), SEED + 60 + B)
        with torch.inference_mode():
            bf16_ms = cuda_ms(lambda: est.ae_apply(crops))
            int8_ms = cuda_ms(lambda: est8.ae_apply(crops))
        times[B] = dict(bf16_ms=bf16_ms, int8_ms=int8_ms)
        log("ae_forward", B=B, bf16_ms=f"{bf16_ms:.3f}", int8_ms=f"{int8_ms:.3f}",
            int8_over_bf16=f"{int8_ms / bf16_ms:.3f}")
    return dict(cos_min=float(cos.min()), times=times)


def template_rgbas(seed: int, num_views: int = NUM_VIEWS) -> np.ndarray:
    """(V, 4, H, W) uint8 procedural templates: a square object (side varies
    with the view) near the image centre, textured with per-view stripes plus
    noise; rgb is 0 outside the alpha, as in rendered templates."""
    rng = np.random.default_rng(seed)
    rgbas = np.zeros((num_views, 4, H, W), np.uint8)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    for v in range(num_views):
        side = int(rng.integers(120, 220))
        y0 = H // 2 - side // 2 + int(rng.integers(-20, 21))
        x0 = W // 2 - side // 2 + int(rng.integers(-20, 21))
        ang = np.pi * v / num_views
        phase = np.cos(ang) * xx[:side, :side] + np.sin(ang) * yy[:side, :side]
        base = rng.uniform(40, 215, size=3).astype(np.float32)
        tex = (base[:, None, None] + 40 * np.sin(phase / (4 + v % 7))[None]
               + rng.normal(scale=25, size=(3, side, side)))
        rgbas[v, :3, y0:y0 + side, x0:x0 + side] = np.clip(tex, 0, 255).astype(np.uint8)
        rgbas[v, 3, y0:y0 + side, x0:x0 + side] = 255
    return rgbas


def make_scene(rng, templates, pasted, num_others):
    """One 480x640 image: noise background, `num_others` (<= 5) textured
    rectangles around the border, and template view `pasted=(obj, view)`
    pasted unscaled at its own pixels, so its crop equals that template's
    crop. -> (rgb, masks, boxes, 1-based labels, K, index of the pasted
    detection)."""
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    masks, boxes, labels = [], [], []
    spots = [(10, 10), (530, 10), (10, 370), (530, 370), (270, 5)]
    for x0, y0 in spots[:num_others]:
        w, h = int(rng.integers(60, 100)), int(rng.integers(60, 100))
        rgb[y0:y0 + h, x0:x0 + w] = rng.integers(0, 256, (h, w, 3))
        m = np.zeros((H, W), np.uint8)
        m[y0:y0 + h, x0:x0 + w] = 1
        masks.append(m)
        boxes.append([x0, y0, x0 + w, y0 + h])
        labels.append(int(rng.integers(1, len(templates) + 1)))
    obj, view = pasted
    t = templates[obj][view]
    alpha = t[3] > 0
    rgb[alpha] = t[:3].transpose(1, 2, 0)[alpha]
    ys, xs = np.nonzero(alpha)
    masks.append(alpha.astype(np.uint8))
    boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
    labels.append(obj + 1)
    K = np.array([[600.0, 0, W / 2], [0, 600.0, H / 2], [0, 0, 1]], np.float32)
    return rgb, np.stack(masks), np.array(boxes, np.int32), np.array(labels), K, len(labels) - 1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run never runs on the CPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    # 1. device + build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(build, KERNELS)))
    for name in KERNELS:
        load_library(name)
    build_s = time.perf_counter() - t0
    log("device", kind=repr(kind), count=torch.cuda.device_count(), nvidia_smi=repr(smi),
        torch=torch.__version__, cuda=torch.version.cuda)
    for name, path in libs.items():
        ptxas = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        log("build", source=f"{name}.cu", seconds=f"{build_s:.2f}", library=path.name,
            ptxas=repr(" | ".join(ptxas)))

    # 2. matching kernel vs plain on planted worlds; 3. int8 kernels vs plain
    record = phase_kernel_vs_plain(dev)
    qrec = phase_qmm_vs_plain(dev)

    # 4. bf16 onboarding; 5. bf16 requests (the matching kernel's path)
    cfg = EstimatorConfig(k=5, sim_threshold=0.5, patch_threshold=3, pixel_threshold=14.0,
                          use_pallas_matching=True)
    est = GigaPoseEstimator.create(MODEL, seed=SEED, config=cfg, ist_descriptor_size=256,
                                   compute_dtype="bfloat16", device=dev)
    templates = [template_rgbas(SEED + 1 + o) for o in range(2)]
    store = onboard(est, templates, dev, "bf16")
    rng = np.random.default_rng(SEED + 10)
    planted = [(0, 40), (1, 100), (0, 7)]
    # 3, 4 and 5 detections: padded to 4, 4 and 8
    scenes = [make_scene(rng, templates, p, n) for p, n in zip(planted, (2, 3, 4))]
    preds, bf16_counts = serve(est, store, scenes, planted, dev, "bf16")
    forwards = len(preds)
    check(bf16_counts == dict(fused_matching=forwards, qmm=0, qmm_mlp=0, qmm_attn_block=0),
          f"bf16 path launches {bf16_counts} for {forwards} forwards")

    # the matching kernel on the main path's own features (not counted above);
    # random ViT features have near-equal similarities, so idx may differ on
    # ties within MATCH_ATOL: reported, not required equal
    _, batch = preds[0]
    with torch.inference_mode():
        tar = est.ae_apply(batch.crops).to(torch.bfloat16).contiguous()
    args = (tar, store.ae_features, batch.masks.contiguous(), store.masks, batch.labels)
    stats = compare_matcher(args, 16, exact=False)
    log("main_path_inputs", shape=repr(tuple(tar.shape)), **stats)

    # 6. int8 serving: the same weights, quantized; its own store and requests
    est8 = dataclasses.replace(est).quantize_serving()
    store8 = onboard(est8, templates, dev, "int8")
    depth = len(est8.ae_net.blocks)
    preds8, int8_counts = serve(est8, store8, scenes, planted, dev, "int8")
    want = dict(fused_matching=forwards, qmm=2 * depth * forwards,
                qmm_mlp=depth * forwards, qmm_attn_block=depth * forwards)
    check(int8_counts == want, f"int8 path launches {int8_counts}, expected {want}")

    # 7. the int8 AE's wiring, card against CPU; 8. int8 against bf16
    phase_int8_wiring(est8, preds8[0][1])
    phase_int8_vs_bf16(est, est8, preds8[0][1], dev)

    serving = record["serving_bfloat16"]
    kernels = [dict(
        name="fused_matching", route="cuda",
        source="gigapose_tpu_torch/csrc/fused_matching.cu",
        replaces="gigapose_tpu/ops/pallas_matching.py:69",
        launches=bf16_counts["fused_matching"],
        max_abs_err=max(serving["max_abs_err"], stats["max_abs_err"]),
        ms=serving["ms"], plain_ms=serving["plain_ms"],
    )]
    qmm_errs = [v["max_abs_err"] for k, v in qrec.items() if k.startswith("qmm_K") or
                k in ("qmm_proj", "qmm_fc2")]
    for name, line, case, err in (
        ("qmm", 87, "qmm_fc2", max(qmm_errs)),
        ("qmm_mlp", 173, "qmm_mlp", qrec["qmm_mlp"]["max_abs_err"]),
        ("qmm_attn_block", 235, f"qmm_attn_block_Np{TOKENS}_masked0",
         max(v["max_abs_err"] for k, v in qrec.items() if k.startswith("qmm_attn_block"))),
    ):
        kernels.append(dict(
            name=name, route="cuda", source="gigapose_tpu_torch/csrc/qmm.cu",
            replaces=f"gigapose_tpu/ops/qmm.py:{line}", launches=int8_counts[name],
            max_abs_err=err, ms=qrec[case]["ms"], plain_ms=qrec[case]["plain_ms"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
