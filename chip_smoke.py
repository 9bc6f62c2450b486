#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gigapose_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's coarse path, then its refinement, at the full width of
`model=large` and of the JAX refiner (DINOv2
ViT-L/14, the default IST backbone, bf16 compute and a bf16 template store,
k=5, sim_threshold 0.5, patch_threshold 3, pixel_threshold 14, 162
templates per object) with seeded random weights and numpy-synthesised
inputs, twice: with the bf16 AE (`serving_quant=off`) and with the int8 AE
(`est.quantize_serving()`). Phases, one line each or more:

1. device + build: the card, its power limit, the nvcc builds of the
   kernels and the host compiler's build of the host rasterizer (one
   compiler per source, all started together) with ptxas's registers and
   spills per kernel (any spill fails the run);
2. the fused matching kernels against their plain PyTorch version on
   planted worlds, at P=16 and at the serving shape B=32, V=162, P=256,
   C=1024: the wgmma kernel on a bf16 store and the CUDA-core kernel on an
   f32 store (idx / valid / top-k ids exact, scores within MATCH_ATOL),
   with both times from CUDA events, and at the serving shape the bound and
   a partial yardstick (one batched matmul of the pre-gathered views: the
   similarity alone);
3. the int8 kernels (ops/qmm.py) against their plain versions at the ViT-L
   serving shapes, T = 32 x 257 tokens: qmm in its four (LN, residual) forms
   at K=1024, N=3072 and at the main path's proj and fc2 shapes; the GEMM's
   GELU (fc1) and bf16 (qkv) epilogues alone on the plain version's int8
   rows, in ulps; the attention core alone on the plain version's bf16 qkv;
   qmm_mlp at C=1024, hidden 4096; qmm_attn_block with 16 heads at Np=257
   and at Np=264 with 7 padded keys masked; errors in quantization steps for
   qmm (check_steps) and relative to the output or branch elsewhere
   (check_rel), both times from CUDA events; then each int8 kernel alone
   at the main path's shapes (the row prologue at its four widths, the GEMM
   in its four epilogue modes, the attention core) with its time, plain
   time, bound and yardstick (SDPA for the attention core; torch._int_mm,
   the int32 product alone, for the GEMM); the GEMM shapes, the prologue
   widths and their yardsticks as device time (the median of 7 replays of
   a CUDA graph of 10 launches, with the least and the most), and beside
   it the wrapper's time as a caller sees it, host work included;
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
   in both precisions at B = 4, 8, 16, 32;
9. the whole coarse forward at B=32 (a request of 32 detections through
   prepare_batch and the estimator) on both paths, on the host clock around
   work that ends in synchronize, with its stages from CUDA events;
10. the CLI on the card: a BOP dataset written with the port's PNG and RLE
   encoders, rows filtered as real PNG writers filter them (per row the
   least-cost filter, encode_png's "adaptive"): 2 objects x 162 templates,
   CLI_IMAGES test images of 3-10 detections, CNOS detections, localization
   targets; through `gigapose_tpu_torch.cli.main` at model=large, with the
   bf16 AE and the int8 AE, each run cold (decoding the template PNGs) and
   twice from the onboarding cache (the same csv, time column aside), the
   two AEs alternating; per run the launch counts (one matching launch per
   forward of at most 4 detections, the int8 kernels per AE call), and on
   the cold runs the csvs' rows and poses and the npz batches against the
   estimator called directly; one [cli] line per run (onboarding s/object,
   per-image latency p50 / p90, images/s, detections/s, the host's decoding
   share and ms per image), the spread over each AE's three runs and the
   int8 / bf16 ratios per pair of runs; the PNG decode time of one 480x640
   image per row filter.
11. refinement on the card, in phase 10's dataset: a closed mesh per object
   (a displaced 100 x 100-segment sphere, 19,800 faces, about 150 mm across,
   vertex colours, binary PLY in datasets/tudl/models), and beside the
   dataset two 224 x 224-segment spheres (99,904 faces, the top of BOP
   models' range); on each set the rasterizer kernel (csrc/rasterizer.cu)
   against its plain version at B = 8, 160 x 160, on seeded poses seen
   through the refine loop's crop camera (hit masks and face ids, rgb
   within a step, depth within an ulp) and against the host C++ renders
   (pixels that differ, the largest difference, the JAX package's bound),
   with its time, the plain version's, the bound of the work the function
   needs (each face tested at the pixels of its screen bounding box) and
   that of the kernel's brute-force work; refine_batch at full width
   (RefinerNet 64, CoarseScorerNet 32, 160 x 160, 500 points, 5
   iterations, keep_best_init) with the pose head and BatchNorm statistics
   randomized, at B = 8 with the host and the device renderer on both mesh
   sets: whole ms per batch, the host loop's phases; on the dataset's
   meshes the card's host loop against the CPU (B = 2), the renderers
   against each other at the same batch without keep_best_init, the device
   renderer at B = 8 against two batches of 4, the referee's choice with
   it, every pose moved; then the refine CLI
   (`gigapose_tpu_torch.refine.main`) on the MultiHypothesis csv of phase
   10's last run, 40 images, min_score 0, with each renderer: one row per
   instance, each equal to one of its coarse hypotheses (the CLI's
   untrained head is the identity), rasterizer launches per batch, and a
   [refine_cli] line per run (per-image p50 / p90, images/s,
   hypotheses/s).

Every kernel count is set to 0 just before a path is driven and read just
after; launches made to compare a kernel with its plain version are not
counted.

Any failed check raises, so the script exits non-zero. It needs CUDA and
never falls back to the CPU. The last lines are the kernels' JSON record
(one entry per hand-written kernel and per chain that ports a TPU kernel:
launches in the main path's runs, error, ms, plain_ms, bound_ms, bound_by,
and library_ms or partial_library_ms), the card's name and power limit from
nvidia-smi, and the result JSON.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import os.path as osp
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from gigapose_tpu_torch import cli
from gigapose_tpu_torch import refine as refine_cli
from gigapose_tpu_torch.dataloader import bop_io
from gigapose_tpu_torch.dataloader.png import decode_png, encode_png
from gigapose_tpu_torch.dataloader.test_set import InferenceDataset
from gigapose_tpu_torch.kernels.build import build, load_library
from gigapose_tpu_torch.lib3d.icosphere import template_object_poses
from gigapose_tpu_torch.models import vit_int8 as v8
from gigapose_tpu_torch.ops import fused_matching as fm
from gigapose_tpu_torch.ops import qmm as Q
from gigapose_tpu_torch.ops.matching import select_top_k
from gigapose_tpu_torch.pipeline.estimator import EstimatorConfig, GigaPoseEstimator
from gigapose_tpu_torch.pipeline.runner import prepare_batch
from gigapose_tpu_torch.pipeline.templates import onboard_templates
from gigapose_tpu_torch.refiner import device_render as DR
from gigapose_tpu_torch.refiner.ops import normalize_T
from gigapose_tpu_torch.refiner.refiner import (
    MeshStore,
    RefinerConfig,
    RenderCompareRefiner,
    crop_prep,
)
from gigapose_tpu_torch.render import rasterize as RZ
from gigapose_tpu_torch.render.mesh_io import load_mesh

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
KERNELS = ("fused_matching", "qmm", "rasterizer")
HOST_SOURCES = ("rasterizer.cpp",)  # built with the host compiler
# phase 10: test images, detections per test image (image i has
# CLI_DETECTIONS[i % 6]), and the CLI's chunk (test.yaml's
# max_num_dets_per_forward)
CLI_IMAGES = 200
CLI_DETECTIONS = (3, 5, 7, 10, 4, 8)
CLI_CHUNK = 4
# the CLI's poses against the estimator called directly: the CPU slice
# test's tolerance (tests/test_torch_pipeline.py)
CLI_POSE_TOL = dict(rtol=1e-4, atol=1e-3)
# published dense peaks of an H100 SXM at 700 W (NVIDIA's data sheet): the
# least time of a kernel is the larger of its operations over the peak of
# their type and its bytes (each input read once, each output written once)
# over the memory rate
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


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


def graph_stats(fn, reps: int = 7, iters: int = 10) -> dict:
    """Device time of one fn(): `iters` calls captured in a CUDA graph, so
    that no host work between launches shows, the graph replayed `reps`
    times after a warm-up; the median over the replays, with the least and
    the most reading as its spread."""
    fn()  # outside the capture: builds and per-device launch settings
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    times = [cuda_ms(graph.replay, warmup=2 if i == 0 else 0, iters=1) / iters
             for i in range(reps)]
    del graph
    return dict(ms=float(np.median(times)), ms_min=min(times), ms_max=max(times))


def bound(ops: float, kind: str, nbytes: float) -> dict:
    """The least time the card could take: max(ops / peak of their type,
    bytes / memory rate), and which of the two it is."""
    t_ops, t_bytes = ops / PEAK_OPS[kind] * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def ptxas_report(log_text: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from nvcc's -Xptxas -v."""
    out, name = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(r"(match_bf16|match_f32|gemm|quant_rows|attention|vertex|face|raster)"
                          r"_kernel(I\w*?E)?", m.group(1))
            name = k.group(1) + (k.group(2) or "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and name in out:
            out[name][0] = int(m.group(1))
    return out


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


def matcher_bound(args, dtype) -> dict:
    """Bound of one matching launch: 2 B V P^2 C operations in the
    features' type (bf16 tensor cores, or f32 CUDA cores), and the bytes of
    the labelled objects' views, the query, the masks, labels and outputs."""
    tar, store = args[0], args[1]
    B, P, C = tar.shape
    V = store.shape[1]
    objs = int(torch.unique(args[4]).numel())
    esz = tar.element_size()
    nbytes = (objs * V * P * C + B * P * C) * esz + (objs * V * P + B * P + B) * 4 \
        + (B * V + 3 * B * V * P) * 4
    return bound(2.0 * B * V * P * P * C, "bf16" if dtype == torch.bfloat16 else "f32", nbytes)


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
            extra = {}
            if name == "serving":
                extra = matcher_bound(args, dtype)
                # partial yardstick: the similarity alone, one batched matmul
                # of the pre-gathered views, in the store's dtype
                B, P, C = args[0].shape
                src = args[1][args[4].long()].reshape(B, -1, C)
                tar_t = args[0].transpose(1, 2)
                extra["partial_library_ms"] = cuda_ms(lambda: torch.bmm(src, tar_t))
                del src
            log("kernel_vs_plain", world=tag, kernel_ms=f"{ms:.4f}",
                plain_ms=f"{plain_ms:.4f}", **stats, **extra)
            record[tag] = dict(ms=ms, plain_ms=plain_ms, **stats, **extra)
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
        if not masked:  # yardstick: SDPA on the same q, k, v (the port never calls it)
            q, k, v = qkv.view(32, Np, 3, 16, C // 16).permute(2, 0, 3, 1, 4)
            rec[f"attention_core_Np{Np}_masked0"]["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v), iters=10)
            del q, k, v
        del qkv
        aargs = (xa, *wqkv, *wproj, g, be, ls, kb)
        stats = check_rel(f"qmm_attn_block Np={Np}", Q.qmm_attn_block(*aargs, **kw),
                          Q.qmm_attn_block_plain(*aargs, **kw), ATTN_LIMITS, xa)
        record(f"qmm_attn_block_Np{Np}_masked{masked}", stats,
               lambda: Q.qmm_attn_block(*aargs, **kw), lambda: Q.qmm_attn_block_plain(*aargs, **kw))
        del xa
    return rec


# the int8 kernels' main-path shapes per ViT-L block at B=32 (T = 32 x 257):
# row prologues (input width, LayerNorm) and GEMMs (mode, K, N, name)
PROLOGUES = ((1024, True), (1024, False), (1024, True), (4096, False))
GEMMS = ((Q._MODE_BF16, 1024, 3072, "qkv"), (Q._MODE_RES, 1024, 1024, "proj"),
         (Q._MODE_GELU, 1024, 4096, "fc1"), (Q._MODE_RES, 4096, 1024, "fc2"),
         (Q._MODE_F32, 1024, 3072, "plain qmm, off the main path"))


def phase_int8_kernels(dev, qrec) -> dict:
    """Each int8 kernel alone at the main path's shapes: time, plain time,
    bound and yardstick. The row prologue's int8 rows against the plain
    version's: equal without LayerNorm, within one step with it (LN's mean
    in another order). The GEMM epilogues' agreement is held in phase 3."""
    T, C = 32 * TOKENS, 1024
    rec = {"row_prologue": [], "gemm": {}}
    g, be = randn(dev, (1, C), SEED + 21).abs() + 0.5, randn(dev, (1, C), SEED + 22, 0.2)
    for K, ln in PROLOGUES:
        x = randn(dev, (T, K), SEED + 70 + K)
        lnargs = (g, be) if ln else (None, None)
        kern = lambda: Q._quantize_rows(x, *lnargs)
        plain = lambda: Q._quant_rows(Q._ln(x, g, be) if ln else x)
        (xq, xs), (pq, ps) = kern(), plain()
        steps = int((xq.int() - pq.int()).abs().max())
        check(steps <= (1 if ln else 0) and bool(torch.isfinite(xs).all()),
              f"row prologue K={K} ln={ln}: {steps} steps from its plain version")
        r = dict(K=K, ln=ln, **graph_stats(kern), wrapper_ms=cuda_ms(kern, iters=20),
                 plain_ms=cuda_ms(plain),
                 max_abs_err=float((xs - ps.reshape(-1)).abs().max()), max_steps=steps,
                 # bytes only: its few f32 operations per element take far less
                 **bound(0.0, "f32", T * K * 5 + T * 4 + (2 * K * 4 if ln else 0)))
        log("int8_kernel", kernel="row_prologue",
            **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in r.items()})
        rec["row_prologue"].append(r)
    for mode, K, N, name in GEMMS:
        xq, xs = Q._quantize_rows(randn(dev, (T, K), SEED + 80 + K))
        wq, ws, b = int8_weight(dev, K, N, SEED + 81)
        res, ls = randn(dev, (T, N), SEED + 82), randn(dev, (1, N), SEED + 83, 0.3)
        odt = torch.bfloat16 if mode == Q._MODE_BF16 else torch.float32
        out = torch.empty((T, N), dtype=odt, device=dev)
        kern = lambda: Q._gemm(xq, xs, wq, ws, b, out, mode, res, ls)

        def plain():
            y = Q._dot_i8(xq, wq) * xs.reshape(-1, 1) * ws + b
            if mode == Q._MODE_RES:
                return res + y * ls
            return Q._gelu_tanh(y) if mode == Q._MODE_GELU else y.to(odt)

        nbytes = T * K + N * K + T * 4 + 2 * N * 4 + T * N * out.element_size() \
            + (T * N * 4 + N * 4 if mode == Q._MODE_RES else 0)
        lib = graph_stats(lambda: torch._int_mm(xq, wq))
        r = dict(name=name, K=K, N=N, **graph_stats(kern), wrapper_ms=cuda_ms(kern, iters=20),
                 plain_ms=cuda_ms(plain),
                 partial_library_ms=lib["ms"],
                 partial_library_spread=(lib["ms_min"], lib["ms_max"]),
                 **bound(2.0 * T * K * N, "int8", nbytes))
        log("int8_kernel", kernel=f"gemm mode {mode}",
            **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in r.items()})
        rec["gemm"].setdefault(mode, []).append(r)
        del out, res
    # the attention core at B=32, Np=257, 16 heads, as phase 3 timed it
    B, H, hd = 32, 16, 64
    core = qrec[f"attention_core_Np{TOKENS}_masked0"]
    rec["attention"] = dict(
        ms=core["ms"], plain_ms=core["plain_ms"], max_abs_err=core["max_abs_err"],
        library_ms=core["library_ms"],
        **bound(4.0 * B * H * TOKENS * TOKENS * hd, "bf16",
                B * TOKENS * 3 * C * 2 + TOKENS * 4 + B * TOKENS * C * 4))
    log("int8_kernel", kernel="attention_core",
        **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec["attention"].items()})
    return rec


def reset_counts() -> None:
    for fn in (fm.fused_match_scores, Q.qmm, Q.qmm_mlp, Q.qmm_attn_block, Q._quantize_rows,
               Q._attention):
        fn.launches = 0
    for c in (fm.fused_match_scores.launches_by_dtype, Q._gemm.launches):
        for key in c:
            c[key] = 0


def counts() -> dict:
    """Launches of every wrapper and of every hand-written kernel."""
    by_dtype = fm.fused_match_scores.launches_by_dtype
    gemm = Q._gemm.launches
    return dict(fused_matching=fm.fused_match_scores.launches, qmm=Q.qmm.launches,
                qmm_mlp=Q.qmm_mlp.launches, qmm_attn_block=Q.qmm_attn_block.launches,
                match_bf16=by_dtype[torch.bfloat16], match_f32=by_dtype[torch.float32],
                row_prologue=Q._quantize_rows.launches, attention_core=Q._attention.launches,
                gemm_f32=gemm[Q._MODE_F32], gemm_residual=gemm[Q._MODE_RES],
                gemm_gelu=gemm[Q._MODE_GELU], gemm_bf16=gemm[Q._MODE_BF16])


def expected_counts(forwards: int, depth: int = 0, int8_ae_calls: int = 0) -> dict:
    """Launches of every kernel after `forwards` coarse forwards on a bf16
    store, `int8_ae_calls` of them (and of onboarding's AE calls) through
    the int8 AE of `depth` blocks."""
    n = int8_ae_calls
    return dict(fused_matching=forwards, qmm=2 * depth * n, qmm_mlp=depth * n,
                qmm_attn_block=depth * n, match_bf16=forwards, match_f32=0,
                row_prologue=4 * depth * n, attention_core=depth * n, gemm_f32=0,
                gemm_residual=2 * depth * n, gemm_gelu=depth * n, gemm_bf16=depth * n)


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
    """One 480x640 image: noise background, `num_others` (<= 14) textured
    rectangles around the border, and template view `pasted=(obj, view)`
    pasted unscaled at its own pixels, so its crop equals that template's
    crop. -> (rgb, masks, boxes, 1-based labels, K, index of the pasted
    detection)."""
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    masks, boxes, labels = [], [], []
    spots = [(10, 10), (530, 10), (10, 370), (530, 370), (270, 5), (120, 10), (420, 10),
             (120, 375), (420, 375), (270, 375), (10, 130), (10, 240), (530, 130), (530, 240)]
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


def phase_forward_b32(paths, scene, dev) -> dict:
    """A request of 32 detections (a scene's detections repeated) through
    prepare_batch and the estimator on each path: the whole forward on the
    host clock around work that ends in synchronize (what a caller waits),
    and its stages from CUDA events."""
    rgb, masks, boxes, labels, K, _ = scene
    take = np.arange(32) % len(labels)
    req = (rgb, masks[take], boxes[take], labels[take], K)
    out = {}
    for tag, est, store in paths:
        run = lambda: est(store, prepare_batch(*req, dev))
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        batch = prepare_batch(*req, dev)
        check(batch.crops.shape[0] == 32, "B=32 request")
        with torch.inference_mode():
            tar = est.ae_apply(batch.crops).to(store.ae_features.dtype).contiguous()
            match_args = (tar, store.ae_features, batch.masks.contiguous(), store.masks,
                          batch.labels.contiguous())
            stages = dict(
                prep_ms=cuda_ms(lambda: prepare_batch(*req, dev)),
                ae_ms=cuda_ms(lambda: est.ae_apply(batch.crops)),
                ist_ms=cuda_ms(lambda: est.ist_apply(batch.crops)),
                matching_ms=cuda_ms(lambda: fm.fused_match_templates(*match_args)),
                forward_device_ms=cuda_ms(lambda: est(store, batch)))
        whole = float(np.mean(times))
        stages["rest_ms"] = whole - sum(v for k, v in stages.items() if k != "forward_device_ms")
        out[tag] = dict(whole_ms=whole, whole_ms_min=min(times), crops_per_s=32e3 / whole,
                        **stages)
        log("forward_b32", ae=tag, **{k: f"{v:.3f}" for k, v in out[tag].items()})
    return out


def cli_detections(im: int) -> int:
    return CLI_DETECTIONS[im % len(CLI_DETECTIONS)]


def write_bop_dataset(root: str, templates, rng) -> list:
    """A BOP dataset named tudl under root/datasets, written with the port's
    PNG and RLE encoders, every PNG with adaptive row filters: the templates
    (2 objects x 162 RGBA views, poses from the icosphere), a test scene of
    CLI_IMAGES 480x640 images (make_scene: one template pasted unscaled,
    the other detections textured rectangles), the CNOS detections with
    random scores, and the localization targets (every instance of the
    pasted object; one fewer of the other object in odd images). -> per
    image (pasted (obj, view), its box, the targets)."""
    ds = osp.join(root, "datasets")
    tdir = osp.join(ds, "templates", "tudl")
    os.makedirs(osp.join(tdir, "object_poses"))
    for o, rgbas in enumerate(templates):
        odir = osp.join(tdir, f"{o + 1:06d}")
        os.makedirs(odir)
        for v, rgba in enumerate(rgbas):
            with open(osp.join(odir, f"{v:06d}.png"), "wb") as f:
                f.write(encode_png(rgba.transpose(1, 2, 0), "adaptive"))
        np.save(osp.join(tdir, "object_poses", f"{o + 1:06d}.npy"), template_object_poses(1))
    sdir = osp.join(ds, "tudl", "test", "000001")
    os.makedirs(osp.join(sdir, "rgb"))
    cams, dets, targets, info = {}, [], [], []
    for im in range(CLI_IMAGES):
        pasted = (im % 2, int(rng.integers(0, NUM_VIEWS)))
        rgb, masks, boxes, labels, K, _ = make_scene(rng, templates, pasted,
                                                     cli_detections(im) - 1)
        with open(osp.join(sdir, "rgb", f"{im:06d}.png"), "wb") as f:
            f.write(encode_png(rgb, "adaptive"))
        cams[str(im)] = {"cam_K": K.reshape(-1).tolist(), "depth_scale": 1.0}
        for m, (x0, y0, x1, y1), lab in zip(masks, boxes, labels):
            dets.append({"scene_id": 1, "image_id": im, "category_id": int(lab),
                         "score": float(rng.uniform(0.3, 1.0)),
                         "bbox": [int(x0), int(y0), int(x1 - x0), int(y1 - y0)],
                         "segmentation": bop_io.rle_encode(m), "time": 0.1})
        im_targets = []
        for obj in sorted(set(labels.tolist())):
            count = int((labels == obj).sum())
            keep = count if obj == pasted[0] + 1 or im % 2 == 0 else max(1, count - 1)
            im_targets.append({"scene_id": 1, "im_id": im, "obj_id": obj, "inst_count": keep})
        targets += im_targets
        info.append((pasted, boxes[-1].tolist(), im_targets))
    bop_io.save_json(osp.join(sdir, "scene_camera.json"), cams)
    det_dir = osp.join(ds, "default_detections", "core19_model_based_unseen", "cnos-fastsam")
    os.makedirs(det_dir)
    bop_io.save_json(osp.join(det_dir, "cnos-fastsam_tudl-test_chip_smoke.json"), dets)
    bop_io.save_json(osp.join(ds, "tudl", "test_targets_bop19.json"), targets)
    return info


def png_decode_times(templates) -> dict:
    """Host ms to decode one 480x640 image (median of 5): a template (RGBA)
    written with filter 0, with Paeth rows, with a random filter per row and
    with adaptive filters (what write_bop_dataset writes), and a test image
    (RGB, adaptive). Also the share of each adaptive image's rows that are
    Average or Paeth rows, which the decoder takes as a wavefront."""
    rgba = templates[0][0].transpose(1, 2, 0)
    rgb = make_scene(np.random.default_rng(SEED + 91), templates, (0, 0), 5)[0]
    rng = np.random.default_rng(SEED + 90)
    out = {}
    for name, img, filt in (("filter0", rgba, 0), ("paeth", rgba, 4),
                            ("mixed", rgba, rng.integers(0, 5, H)),
                            ("adaptive", rgba, "adaptive"), ("scene_adaptive", rgb, "adaptive")):
        data = encode_png(img, filt)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            got = decode_png(data)
            times.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(got, img), f"PNG {name} round trip")
        out[f"{name}_ms"] = float(np.median(times))
        if isinstance(filt, str):  # adaptive: the filter byte that opens each row
            rows = np.frombuffer(zlib.decompress(data[41:-16]), np.uint8).reshape(H, -1)
            out[f"{name}_avg_paeth_rows"] = float((rows[:, 0] >= 3).mean())
    return out


def csv_rows(path: str):
    """The csv's lines with the time column (the run's own clock) dropped."""
    with open(path) as f:
        return [line.split(",")[:6] + line.split(",")[7:] for line in f.read().splitlines()]


def cli_run(root: str, args, tag: str):
    """One cli.main run with every kernel count set to 0 just before it and
    read just after -> (runner, counts, csv paths)."""
    reset_counts()
    runner = cli.main([f"machine.root_dir={root}", "test_dataset_name=tudl", "model=large",
                       f"run_id={tag}", "onboarding_cache=phase10"] + args)
    torch.cuda.synchronize()
    launched = counts()
    pred = osp.join(root, "results", f"large_{tag}", "predictions")
    name = f"large-pbrreal-rgb-mmodel_tudl-test_{tag}"
    return runner, launched, (osp.join(pred, name + ".csv"),
                              osp.join(pred, name + "MultiHypothesis.csv"))


def check_cli_outputs(runner, paths, info, root, dev, tag) -> dict:
    """The csvs' rows, rotations and translations; the npz batches against
    the runner's estimator and store called directly (prepare_batch, chunks
    of CLI_CHUNK): view ids exact, poses within CLI_POSE_TOL; each pasted
    detection kept and retrieving its view with sim > 0.9."""
    top1 = bop_io.load_bop_csv(paths[0])
    multi = bop_io.load_bop_csv(paths[1], extra_column="instance_id")
    want_rows = sum(t["inst_count"] for _, _, targets in info for t in targets)
    check(len(top1) == want_rows, f"{tag}: {len(top1)} top-1 rows, {want_rows} target instances")
    per_instance = np.bincount([int(r["instance_id"]) for r in multi], minlength=want_rows)
    check(len(multi) == 5 * want_rows and (per_instance == 5).all(),
          f"{tag}: not 5 hypotheses per instance")
    for r in multi:
        check(np.abs(r["R"] @ r["R"].T - np.eye(3)).max() <= 1e-4, f"{tag}: R not orthonormal")
        check(bool(np.isfinite(r["t"]).all()), f"{tag}: t not finite")
    est, store = runner.estimator, runner.store
    pred_dir = osp.dirname(paths[0])
    rows, sims, worst, images = [], [], 0.0, 0
    for idx, (image, (pasted, box, _)) in enumerate(
            zip(InferenceDataset(osp.join(root, "datasets"), "tudl"), info)):
        images += 1
        N = len(image.labels)
        got = {"poses": [], "scores": [], "view_ids": [], "sim_scores": []}
        for s in range(0, N, CLI_CHUNK):
            sl = slice(s, min(s + CLI_CHUNK, N))
            p = est(store, prepare_batch(image.rgb, image.masks[sl], image.boxes_xyxy[sl],
                                         image.labels[sl], image.K, dev))
            for f, out in got.items():
                out.append(getattr(p, f)[: sl.stop - s].float().cpu().numpy())
        got = {f: np.concatenate(v) for f, v in got.items()}
        sel, _ = runner.filter_localization(image, got["scores"][:, 0].astype(np.float64))
        with np.load(osp.join(pred_dir, f"{idx:06d}.npz")) as npz:
            check(np.array_equal(npz["view_ids"], got["view_ids"][sel]), f"{tag}: view ids differ")
            check(np.allclose(npz["poses"], got["poses"][sel], **CLI_POSE_TOL),
                  f"{tag}: CLI poses differ from the estimator's")
            worst = max(worst, float(np.abs(npz["poses"] - got["poses"][sel]).max()))
        j = int(np.nonzero((image.boxes_xyxy == box).all(1))[0][0])
        ids = got["view_ids"][j].tolist()
        check(j in sel and pasted[1] in ids, f"{tag}: pasted view {pasted} not retrieved: {ids}")
        sims.append(float(got["sim_scores"][j][ids.index(pasted[1])]))
        check(sims[-1] > 0.9, f"{tag}: pasted view {pasted} sim {sims[-1]}")
        rows += [got["poses"][d] for d in sel]
    check(images == len(info), f"{tag}: {images} images, {len(info)} written")
    for r, (i, k) in zip(multi, ((i, k) for i in range(len(rows)) for k in range(5))):
        check(np.allclose(r["R"], rows[i][k][:3, :3], **CLI_POSE_TOL)
              and np.allclose(r["t"].reshape(3), rows[i][k][:3, 3], **CLI_POSE_TOL),
              f"{tag}: csv row {i}/{k} differs from the estimator's pose")
    return dict(rows=len(top1), planted_sim_min=min(sims), pose_max_abs_diff=worst)


def npz_time_ms(path: str) -> float:
    """An npz batch's per-image latency (the runner's own `time` field), ms."""
    with np.load(path) as npz:
        return float(npz["time"][0]) * 1e3


# phase 10's runs: (tag, AE, from the onboarding cache); the AEs alternate,
# and each AE is run cold once (its onboarding decodes the template PNGs)
# and twice from the cache
CLI_RUNS = (("bf16", "bf16", False), ("int8", "int8", False),
            ("int8_cached", "int8", True), ("bf16_cached", "bf16", True),
            ("bf16_cached2", "bf16", True), ("int8_cached2", "int8", True))
CLI_PAIRS = (("int8", "bf16"), ("int8_cached", "bf16_cached"), ("int8_cached2", "bf16_cached2"))


def phase_cli(templates, dev, smi, then=None) -> dict:
    """10. The CLI on the card: a BOP dataset on disk through cli.main at
    model=large, the runs of CLI_RUNS (cold: no onboarded store and no pixel
    cache of the templates); launch counts per run; the cold runs' outputs
    against the estimator called directly and each cached run's csv against
    its AE's cold run; latency, throughput, onboarding and the host's
    decoding per run, the spread over each AE's runs and the int8 / bf16
    ratios per pair of runs. `then(root, csv)`, when given, runs last in the
    dataset's directory with the MultiHypothesis csv of the last run; its
    result is record["then"]."""
    record = {"png": png_decode_times(templates)}
    log("png", shape="480x640", **{k: f"{v:.4g}" for k, v in record["png"].items()})
    quant = {"bf16": "model.serving_quant=off", "int8": "model.serving_quant=int8"}
    runs, image_ms, csvs = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="gigapose_cli_") as root:
        t0 = time.perf_counter()
        info = write_bop_dataset(root, templates, np.random.default_rng(SEED + 11))
        detections = sum(cli_detections(im) for im in range(CLI_IMAGES))
        log("bop_dataset", images=len(info), detections=detections,
            templates=f"{len(templates)}x{NUM_VIEWS}", write_s=f"{time.perf_counter() - t0:.2f}")
        forwards = sum(-(-cli_detections(im) // CLI_CHUNK) for im in range(CLI_IMAGES))
        onboard_calls = len(templates) * -(-NUM_VIEWS // 64)  # onboard_object's chunk of 64
        for tag, precision, cached in CLI_RUNS:
            if not cached:  # a cold run decodes the template PNGs
                shutil.rmtree(osp.join(root, "datasets", "templates", "tudl", "preprocessed"),
                              ignore_errors=True)
            runner, launched, paths = cli_run(root, [quant[precision]], tag)
            check(runner.timing["onboard_cached"] == cached, f"{tag}: onboarding cache")
            check(runner.timing["forwards"] == forwards, f"{tag}: {runner.timing['forwards']} "
                  f"forwards, {forwards} expected")
            int8 = type(runner.estimator.ae_net).__name__ == "AENetInt8"
            check(int8 == (precision == "int8"), f"{tag}: AE {type(runner.estimator.ae_net)}")
            depth = len(runner.estimator.ae_net.blocks) if int8 else 0
            want = expected_counts(forwards, depth,
                                   forwards + (0 if cached else onboard_calls) if int8 else 0)
            check(launched == want, f"{tag}: launches {launched}, expected {want}")
            if cached:  # the cold run of this AE was held against the estimator
                for a, b in zip(csvs[precision], paths):
                    check(csv_rows(a) == csv_rows(b), f"{tag}: the cached run wrote another csv")
                stats = {}
            else:
                stats = check_cli_outputs(runner, paths, info, root, dev, tag)
            csvs[tag] = paths
            image_ms[tag] = np.array([npz_time_ms(osp.join(osp.dirname(paths[0]), f"{i:06d}.npz"))
                                      for i in range(CLI_IMAGES)])
            t = runner.timing
            runs[tag] = dict(
                onboard_s_per_object=t["onboard_s"] / t["objects"],
                image_ms_p50=float(np.percentile(image_ms[tag], 50)),
                image_ms_p90=float(np.percentile(image_ms[tag], 90)),
                images_per_s=t["images"] / t["run_s"], detections_per_s=t["detections"] / t["run_s"],
                decode_share=t["decode_s"] / t["run_s"],
                decode_ms_per_image=t["decode_s"] / t["images"] * 1e3, run_s=t["run_s"],
                images=t["images"], detections=t["detections"], forwards=t["forwards"], **stats,
                launches=launched)
            log("cli", run=tag, **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                   for k, v in runs[tag].items() if k != "launches"},
                card=repr(smi))
            del runner
            torch.cuda.empty_cache()
        if then is not None:
            record["then"] = then(root, csvs[CLI_RUNS[-1][0]][1])
    record["runs"], record["spread"] = runs, {}
    for precision in ("bf16", "int8"):
        mine = [runs[tag] for tag, p, _ in CLI_RUNS if p == precision]
        spread = {k: [min(r[k] for r in mine), max(r[k] for r in mine)]
                  for k in ("image_ms_p50", "image_ms_p90", "images_per_s", "decode_share")}
        record["spread"][precision] = spread
        log("cli_spread", ae=precision, runs=len(mine),
            **{k: "{:.4g}-{:.4g}".format(*v) for k, v in spread.items()})
    record["int8_over_bf16"] = [dict(
        runs=f"{a}/{b}", image_ms_p50=runs[a]["image_ms_p50"] / runs[b]["image_ms_p50"],
        image_ms_p90=runs[a]["image_ms_p90"] / runs[b]["image_ms_p90"],
        images_per_s=runs[a]["images_per_s"] / runs[b]["images_per_s"],
        per_image_median=float(np.median(image_ms[a] / image_ms[b]))) for a, b in CLI_PAIRS]
    for r in record["int8_over_bf16"]:
        log("cli_int8_over_bf16", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                     for k, v in r.items()})
    return record


# 11. refinement on the card. Each object is a displaced latitude-longitude
# sphere of n x n segments (2 n (n - 1) faces), about 150 mm across with
# per-vertex colours, written as binary PLY: SPHERE_SEGMENTS gives the
# 19,800-face meshes of the dataset (the refine CLI reads them),
# SPHERE_SEGMENTS_LARGE 99,904 faces, the top of BOP models' 10^4-10^5,
# which 11.3 and 11.4 also run (the device pack pads every mesh to the
# largest, and every pixel of a render tests every face)
SPHERE_SEGMENTS = 100
SPHERE_SEGMENTS_LARGE = 224
SPHERE_RADIUS_MM = 75.0
REFINE_B = 8  # run_refinement's chunk of hypotheses
REFINE_SIZE = (160, 160)
REFINE_ITERS = 5
# renders per refine_batch: the iterations, the final score and
# keep_best_init's two renders in the init pose's crop frame
RENDERS_PER_BATCH = REFINE_ITERS + 1 + 2
# the rasterizer against its plain version (csrc/rasterizer.cu is built with
# -fmad=false and rounds as the plain version does): hit masks and face ids
# equal on all but RASTER_MISMATCH of the pixels; where both hit the same
# face, rgb within 1 step and depth within 1 ulp
RASTER_MISMATCH = 1e-4
# the device rasterizer against the host C++ one: the JAX package's bound
# (tests/test_refiner.py:test_device_render_matches_host_render)
HOST_P99, HOST_IOU = 2.5 / 255, 0.98
# f32 operations of the rasterizer's work (csrc/rasterizer.cu): a (pixel,
# face) depth test 24 (the face's validity, two edge functions of 5, w2 2,
# three inside compares, the 1/z interpolation 5, the clamp, the reciprocal,
# the depth compare); a vertex 31 (camera transform 18, depth test,
# projection 12); a face's set-up 29; the shading of a hit pixel 93. The
# function needs the tests of each valid face at the pixel centres inside
# its screen bounding box only; the kernel makes B x H x W x F of them
RASTER_OPS = dict(test=24, vertex=31, face=29, shade=93)
# the random pose head: std HEAD_SCALE / sqrt(features), so that the
# untrained refiner moves each pose by a few centimetres and degrees
HEAD_SCALE = 0.04
REFINE_K = np.array([[572.4114, 0, 320], [0, 573.57043, 240], [0, 0, 1]], np.float32)
# phase 11's refine_batch bounds (max |R entry| difference, max |t|
# difference in mm, max |score| difference), each a few times the H100
# reading (PERF.md). The card's host path against the same refiner on
# the CPU read R 1.7e-6, t 1.0e-3 mm, score 1.8e-6: cuDNN's and the CPU's
# convolutions sum in other orders; one render pixel flipped by that would
# move them to about 1e-4 (tests/test_torch_refiner.py), which the bound
# allows. The device renderer against the host one, both at B = 8, read R
# 1.6e-4, t 0.064 mm, score 1.0e-4: the two rasterizers pick another face
# at a few dozen pixels inside the objects' silhouettes (11.3: 67 of
# 204,800 pixels differ, by up to 99 steps, none in the mask), and the
# random nets carry that into the poses; the batch is not the cause (B = 8
# against two batches of 4 read R 0, score 6e-8, held to CPU_BOUND).
# DEVICE_BOUND is about three times that reading
CPU_BOUND = dict(R=1e-4, t_mm=0.05, score=1e-4)
DEVICE_BOUND = dict(R=5e-4, t_mm=0.2, score=3e-4)
# the refine CLI with its untrained (identity) head returns the coarse poses
CLI_REFINE_TOL = dict(R=1e-4, t_rtol=1e-4)
REFINE_CLI_IMAGES = 40


def write_sphere_ply(path: str, seed: int, n: int = SPHERE_SEGMENTS) -> int:
    """A closed latitude-longitude sphere of radius about SPHERE_RADIUS_MM mm,
    displaced by seeded waves that vanish at the poles, with colours from
    the position, as binary little-endian PLY. -> its face count."""
    rng = np.random.default_rng(seed)
    amp, k = rng.uniform(0.03, 0.08, 2), rng.integers(2, 7, 3)
    th, ph = np.meshgrid(np.linspace(0, np.pi, n + 1)[1:-1], np.linspace(0, 2 * np.pi, n,
                                                                          endpoint=False),
                         indexing="ij")
    r = 1 + amp[0] * np.sin(k[0] * th) * np.cos(k[1] * ph) \
        + amp[1] * np.sin(th) ** 2 * np.sin(k[2] * ph)
    ring = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)], -1)
    verts = np.concatenate([[[0, 0, 1]], ring.reshape(-1, 3), [[0, 0, -1]]]) * SPHERE_RADIUS_MM
    cols = np.clip((verts / SPHERE_RADIUS_MM * 0.5 + 0.5) * 180 + 40
                   + rng.normal(0, 8, verts.shape), 0, 255).astype(np.uint8)
    j, jn = np.arange(n), (np.arange(n) + 1) % n
    ringv = lambda i, jj: 1 + i * n + jj
    last = 1 + (n - 1) * n
    faces = [np.stack([np.zeros(n, int), ringv(0, j), ringv(0, jn)], 1)]
    for i in range(n - 2):
        a, b, c, d = ringv(i, j), ringv(i, jn), ringv(i + 1, j), ringv(i + 1, jn)
        faces += [np.stack([a, c, b], 1), np.stack([b, c, d], 1)]
    faces.append(np.stack([np.full(n, last), ringv(n - 2, jn), ringv(n - 2, j)], 1))
    faces = np.concatenate(faces)
    vrec = np.empty(len(verts), [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                 ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    for c, name in enumerate("xyz"):
        vrec[name] = verts[:, c]
    for c, name in enumerate(("red", "green", "blue")):
        vrec[name] = cols[:, c]
    frec = np.empty(len(faces), [("n", "u1"), ("idx", "<i4", (3,))])
    frec["n"], frec["idx"] = 3, faces
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(verts)}\nproperty float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              f"element face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode() + vrec.tobytes() + frec.tobytes())
    return len(faces)


def random_poses(rng, B: int) -> np.ndarray:
    """(B, 4, 4) object -> camera poses in metres: random rotations, the
    object 0.45-0.6 m in front of the camera, near the optical axis."""
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    T[:, :3, :3] = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)], 1)
    T[:, :3, 3] = np.stack([rng.uniform(-0.05, 0.05, B), rng.uniform(-0.05, 0.05, B),
                            rng.uniform(0.45, 0.6, B)], 1)
    return T


def ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(want)
    return (got - want).abs() / torch.ldexp(torch.ones_like(want), e - 24)


def raster_work(verts, faces, K, T, H: int, W: int) -> dict:
    """The (pixel, face) tests the rasterizer's function needs on these
    inputs (each valid face at the pixel centres inside its screen bounding
    box) and the B x H x W x F the kernel makes."""
    cam, scr = RZ._camera(verts, K, T)
    bi = torch.arange(len(faces), device=faces.device)[:, None, None]
    idx = faces.long()
    p, z = scr[bi, idx].double(), cam[..., 2][bi, idx]  # (B, F, 3, 2), (B, F, 3)
    (x0, y0), (x1, y1), (x2, y2) = (p[..., k, :].unbind(-1) for k in range(3))
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    valid = (area.abs() > RZ.EPS_AREA) & (z > RZ.EPS_Z).all(-1)
    n = torch.tensor([W, H], device=p.device, dtype=p.dtype)
    first = torch.ceil(p.amin(2) - 0.5).clamp_min(0)  # pixel i has its centre at i + 0.5
    last = torch.minimum(torch.floor(p.amax(2) - 0.5), n - 1)
    span = (last - first + 1).clamp_min(0)
    return dict(tests=float((span[..., 0] * span[..., 1] * valid).sum()),
                tests_brute=float(faces.shape[0] * faces.shape[1] * H * W))


def raster_case(dev, mesh_paths, store, tag: str) -> dict:
    """11.3 on one mesh set: the rasterizer kernel against its plain version
    and against the host C++ renders (pixels that differ, the largest
    difference in uint8 steps, the JAX package's p99 and IoU), at B = 8,
    160 x 160, on seeded poses seen through the refine loop's crop camera;
    its time, the plain version's, the bound of the function's work and
    that of the kernel's brute-force work."""
    B, (RH, RW) = REFINE_B, REFINE_SIZE
    labels = np.array([1 + i % 2 for i in range(B)])
    TCO = random_poses(np.random.default_rng(SEED + 12), B)
    pts = torch.as_tensor(np.stack([store.points[l] for l in labels]), dtype=torch.float32,
                          device=dev)
    images = torch.zeros((B, 3, H, W), device=dev)
    Kd = torch.as_tensor(np.repeat(REFINE_K[None], B, 0), device=dev)
    TCO_n, _, K_crop, _ = crop_prep(images, Kd, torch.as_tensor(TCO, device=dev), pts,
                                    REFINE_SIZE, 1.4)
    pack = DR.build_device_meshes(mesh_paths, store.unit_to_m, dev)
    rows = torch.as_tensor(pack.rows_for(labels), device=dev)
    args = (pack.verts[rows], pack.faces[rows], pack.colors[rows], K_crop.contiguous(),
            TCO_n.contiguous(), RH, RW)
    got, want = RZ.rasterize(*args), RZ.rasterize_plain(*args)
    torch.cuda.synchronize()
    hit_g, hit_w = got["rgba"][..., 3] > 0, want["rgba"][..., 3] > 0
    same = hit_g & hit_w & (got["face_id"] == want["face_id"])
    mismatch = float(((hit_g != hit_w) | (hit_g & hit_w & ~same)).float().mean())
    rgb_steps = int((got["rgba"][..., :3].int() - want["rgba"][..., :3].int()).abs()[same].max())
    depth_ulps = float(ulps(got["depth"][same], want["depth"][same]).max())
    normals_err = float((got["normals"] - want["normals"]).abs()[same].max())
    # the host C++ raster at the same poses (mesh units: mm) and crop cameras
    host = store.render_batch(labels, TCO_n.cpu().numpy(), K_crop.cpu().numpy(), REFINE_SIZE,
                              out_dtype=np.uint8).astype(np.int32)
    dev_rgb = got["rgba"][..., :3].permute(0, 3, 1, 2).int().cpu().numpy()
    steps = np.abs(host - dev_rgb)
    mh, md = host.sum(1) > 0, dev_rgb.sum(1) > 0
    iou = float((mh & md).sum() / max((mh | md).sum(), 1))
    # the object's extent in each crop: its silhouette's larger side over the crop's
    rows_hit, cols_hit = hit_w.any(2), hit_w.any(1)
    span = lambda m: (m.shape[1] - m.int().argmax(1) - m.flip(1).int().argmax(1)).float()
    extent = torch.maximum(span(rows_hit) / RH, span(cols_hit) / RW)
    stats = dict(faces=int(pack.faces.shape[1]), hit_share=float(hit_w.float().mean()),
                 extent_min=float(extent.min()), extent_max=float(extent.max()),
                 mismatch=mismatch, rgb_steps=rgb_steps, depth_ulps=depth_ulps,
                 normals_max_abs_err=normals_err,
                 host_diff_pixels=int((steps.max(1) > 0).sum()), host_max_steps=int(steps.max()),
                 host_mask_diff_pixels=int((mh != md).sum()),
                 host_p99=float(np.percentile(steps / 255.0, 99)), host_iou=iou)
    check(mismatch <= RASTER_MISMATCH, f"rasterizer {tag}: hit / face id mismatch {stats}")
    check(rgb_steps <= 1 and depth_ulps <= 1.0,
          f"rasterizer {tag} differs from its plain version: {stats}")
    check(stats["host_p99"] <= HOST_P99 and iou > HOST_IOU,
          f"rasterizer {tag} against host: {stats}")
    check(0.3 <= stats["extent_min"] and stats["extent_max"] <= 0.8,
          f"the objects span {stats['extent_min']}-{stats['extent_max']} of the crops")
    times = [cuda_ms(lambda: RZ.rasterize(*args), warmup=2 if i == 0 else 0, iters=1)
             for i in range(7)]
    work = raster_work(args[0], args[1], args[3], args[4], RH, RW)
    F, V = pack.faces.shape[1], pack.verts.shape[1]
    nbytes = B * (V * 3 * 4 * 2 + F * 3 * 4 + (9 + 16) * 4) + B * RH * RW * (4 + 4 + 12 + 4)
    fixed = (RASTER_OPS["vertex"] * B * V + RASTER_OPS["face"] * B * F
             + RASTER_OPS["shade"] * float(hit_w.sum()))
    brute = bound(RASTER_OPS["test"] * work["tests_brute"] + fixed, "f32", nbytes)
    rec = dict(ms=float(np.median(times)), ms_min=min(times), ms_max=max(times),
               plain_ms=cuda_ms(lambda: RZ.rasterize_plain(*args), warmup=1, iters=1),
               max_abs_err=max(float(rgb_steps), normals_err),
               **bound(RASTER_OPS["test"] * work["tests"] + fixed, "f32", nbytes),
               bound_ms_brute=brute["bound_ms"], bound_by_brute=brute["bound_by"], **work,
               **stats)
    log("raster", mesh=tag, B=B, size=f"{RH}x{RW}",
        **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec.items()})
    return rec


def scene_images(store, labels, gts, rng) -> np.ndarray:
    """(B, 3, 480, 640) f32 observed images: each object rendered at its
    ground-truth pose by the host rasterizer over a noise background."""
    out = np.empty((len(labels), 3, H, W), np.float32)
    for i, (label, gt) in enumerate(zip(labels, gts)):
        pose = gt.copy()
        pose[:3, 3] /= store.unit_to_m[int(label)]
        rgba, _ = store.rasterizers[int(label)].render(REFINE_K, pose, W, H)
        img = rng.integers(0, 60, (H, W, 3)).astype(np.uint8)
        fg = rgba[..., 3] > 0
        img[fg] = rgba[..., :3][fg]
        out[i] = img.transpose(2, 0, 1).astype(np.float32) / 255.0
    return out


def perturb_refiner_(ref: RenderCompareRefiner, seed: int) -> None:
    """Seeded random pose head (the identity head leaves every pose as it
    is) and BatchNorm statistics (mean 0 and var 1 hide a swapped mapping)."""
    rng = np.random.default_rng(seed)
    rnd = lambda t, a: t.copy_(torch.from_numpy(a.astype(np.float32)))
    with torch.no_grad():
        w = ref.refiner_net.pose_head.weight
        rnd(w, rng.normal(0, HEAD_SCALE / np.sqrt(w.shape[1]), w.shape))
        for net in (ref.refiner_net, ref.scorer_net):
            for m in net.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    rnd(m.running_mean, rng.normal(0, 0.1, m.num_features))
                    rnd(m.running_var, rng.uniform(0.5, 1.5, m.num_features))


def pose_gap(a: np.ndarray, b: np.ndarray) -> dict:
    """Largest |R entry| and |t| (mm) difference over a batch of poses in metres."""
    return dict(R=float(np.abs(a[:, :3, :3] - b[:, :3, :3]).max()),
                t_mm=float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max() * 1e3))


def result_gap(a: tuple, b: tuple) -> dict:
    """pose_gap of two refine_batch results (poses, scores), and the largest
    |score| difference."""
    return dict(**pose_gap(a[0], b[0]), score=float(np.abs(a[1] - b[1]).max()))


def time_refine(r: RenderCompareRefiner, args, tag: str, smi) -> tuple:
    """refine_batch once to warm (cuDNN's plans, the device mesh pack), then
    3 times with every count at 0 -> (the output, the record: whole ms per
    batch on the host clock, the host loop's phases, rasterizer launches)."""
    B, host = len(args[2]), r.config.renderer == "host"
    r.refine_batch(*args)
    reset_counts()
    RZ.rasterize.launches = 0
    r.timing = {} if host else None
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = r.refine_batch(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = RZ.rasterize.launches
    check(launches == (0 if host else 3 * RENDERS_PER_BATCH),
          f"{tag}: {launches} rasterizer launches in 3 batches")
    check(counts() == expected_counts(0), f"{tag}: other kernels launched")
    check(bool(np.isfinite(out[0]).all() and np.isfinite(out[1]).all()),
          f"{tag}: non-finite output")
    rec = dict(batch_ms=float(np.median(times)), batch_ms_min=min(times),
               batch_ms_max=max(times), per_hypothesis_ms=float(np.median(times)) / B,
               launches_per_batch=launches // 3)
    if host:  # per batch
        rec.update({f"{k}_ms": v / 3 * 1e3 for k, v in r.timing.items()})
        r.timing = None
    log("refine_batch", run=tag, B=B, **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                         for k, v in rec.items()}, card=repr(smi))
    return out, rec


def phase_refine(dev, mesh_paths, large_paths, smi) -> dict:
    """11.4: refine_batch at full width (RefinerNet 64, scorer 32, 160 x
    160, 500 points, 5 iterations, keep_best_init) at B = 8 with the head
    and BN statistics perturbed: the host and the device renderer on the
    card, on the dataset's meshes and on the largest ones (the whole ms per
    batch, host clock, the result fetched; the host loop's phases); the
    card's host loop against the CPU (B = 2); without keep_best_init the
    device renderer against the host one at the same batch, and the device
    renderer at B = 8 against the same hypotheses in two batches of 4 (the
    renders are the same, only the batch size differs); every pose moved;
    the referee's choice."""
    B = REFINE_B
    ref = RenderCompareRefiner.create(mesh_paths, seed=SEED, config=RefinerConfig(), device=dev)
    perturb_refiner_(ref, SEED + 13)
    rng = np.random.default_rng(SEED + 14)
    labels = np.array([1 + i % 2 for i in range(B)])
    gts = random_poses(rng, B)
    init = gts.copy()
    init[:, :3, 3] += rng.uniform(-0.01, 0.01, (B, 3))  # 1 cm off, and a few degrees
    a = rng.uniform(-0.08, 0.08, (B, 3))
    for i in range(B):
        c, s = np.cos(a[i]), np.sin(a[i])
        rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
        ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
        init[i, :3, :3] = (rz @ ry @ init[i, :3, :3]).astype(np.float32)
    images = scene_images(ref.meshes, labels, gts, rng)
    Ks = np.repeat(REFINE_K[None], B, 0)
    args = (images, Ks, labels, init)
    with_config = lambda r, **kw: dataclasses.replace(r, config=RefinerConfig(**kw))
    out, rec = {}, {}
    for renderer in ("host", "device"):
        out[renderer], rec[renderer] = time_refine(with_config(ref, renderer=renderer), args,
                                                   renderer, smi)
    large = dataclasses.replace(ref, meshes=MeshStore(large_paths, 500), _device_pack=None)
    for renderer in ("host", "device"):
        _, rec[f"{renderer}_large"] = time_refine(with_config(large, renderer=renderer), args,
                                                  f"{renderer}_large", smi)
    large.meshes.close()
    # the same refiner on the CPU, on the first two hypotheses
    cpu = dataclasses.replace(ref, refiner_net=copy.deepcopy(ref.refiner_net).cpu(),
                              scorer_net=copy.deepcopy(ref.scorer_net).cpu(),
                              device=torch.device("cpu"), _device_pack=None)
    t0 = time.perf_counter()
    cpu_out = cpu.refine_batch(*(x[:2] for x in args))
    cpu_s = time.perf_counter() - t0
    # keep_best_init keeps the init pose wherever the random scorer ranks it
    # higher, and a near tie may fall either way under the two renderers: so
    # the renderers are compared without it, where every pose must also move
    # by more than their bound, and with it each output must be the init
    # pose (normalized) or its renderer's refined pose
    free = {k: with_config(ref, renderer=k, keep_best_init=False).refine_batch(*args)
            for k in ("host", "device")}
    halves = [with_config(ref, renderer="device", keep_best_init=False).refine_batch(
        *(x[s] for x in args)) for s in (slice(0, B // 2), slice(B // 2, B))]
    split = tuple(np.concatenate([h[i] for h in halves]) for i in range(2))
    gaps = dict(cpu=result_gap(tuple(x[:2] for x in out["host"]), cpu_out),
                device=result_gap(free["device"], free["host"]),
                split=result_gap(free["device"], split))
    init_n = normalize_T(torch.as_tensor(init)).numpy()
    moved = [pose_gap(free["device"][0][i:i + 1], init[i:i + 1]) for i in range(B)]
    kept, referee = {}, 0.0
    for k in ("host", "device"):
        gap = lambda T, i: float(np.abs(out[k][0][i] - T[i]).max())
        kept[k] = [gap(init_n, i) < 1e-6 for i in range(B)]
        referee = max([referee] + [gap(init_n if keep else free[k][0], i)
                                   for i, keep in enumerate(kept[k])])
    rec.update(gaps=gaps, cpu_s=cpu_s, referee_gap=referee,
               kept_init={k: int(sum(v)) for k, v in kept.items()},
               moved_min=dict(R=min(m["R"] for m in moved), t_mm=min(m["t_mm"] for m in moved)))
    log("refine_parity", cpu_B=2, cpu_s=f"{cpu_s:.2f}",
        **{f"{k}_{q}": f"{v:.4g}" for k, g in gaps.items() for q, v in g.items()},
        **{f"moved_min_{q}": f"{v:.4g}" for q, v in rec["moved_min"].items()},
        kept_init=repr(rec["kept_init"]).replace(" ", ""), referee_gap=f"{referee:.3g}")
    for q in ("R", "t_mm", "score"):
        check(gaps["cpu"][q] <= CPU_BOUND[q], f"card against CPU: {gaps['cpu']} > {CPU_BOUND}")
        check(gaps["device"][q] <= DEVICE_BOUND[q],
              f"device renderer against host: {gaps['device']} > {DEVICE_BOUND}")
        check(gaps["split"][q] <= CPU_BOUND[q],
              f"a batch of 8 against two of 4: {gaps['split']} > {CPU_BOUND}")
    for q in ("R", "t_mm"):
        check(rec["moved_min"][q] > DEVICE_BOUND[q],
              f"a pose moved {rec['moved_min']}, not more than {DEVICE_BOUND}")
    check(referee <= 1e-5,
          f"keep_best_init returned neither the init nor the refined pose: {referee}")
    ref.meshes.close()
    return rec


def phase_refine_cli(root: str, init_csv: str, smi) -> dict:
    """11.5: `python -m gigapose_tpu_torch.refine` through main() on phase
    10's dataset and the MultiHypothesis csv of one of its runs, min_score 0,
    REFINE_CLI_IMAGES images, with the host and the device renderer: one
    refined row per instance, each equal to one of its instance's coarse
    hypotheses (the CLI's untrained head is the identity), rasterizer
    launches RENDERS_PER_BATCH per batch of at most REFINE_B hypotheses."""
    coarse = bop_io.load_bop_csv(init_csv, extra_column="instance_id")
    per_image = bop_io.group_by_image(coarse, image_key="im_id")
    keys = sorted(per_image)[:REFINE_CLI_IMAGES]
    want_rows = sum(len({int(r["instance_id"]) for r in per_image[k]}) for k in keys)
    batches = sum(-(-len(per_image[k]) // REFINE_B) for k in keys)
    rec = {}
    for renderer in ("host", "device"):
        RZ.rasterize.launches = 0
        save_dir = osp.join(root, "results", f"refine_{renderer}")
        paths, timing = refine_cli.main([
            f"machine.root_dir={root}", "test_dataset_name=tudl", "model=large", "run_id=refine",
            f"init_loc_path={init_csv}", f"save_dir={save_dir}", "min_score=0",
            f"max_images={REFINE_CLI_IMAGES}", f"refine_renderer={renderer}"])
        torch.cuda.synchronize()
        launches = RZ.rasterize.launches
        check(launches == (RENDERS_PER_BATCH * batches if renderer == "device" else 0),
              f"refine CLI {renderer}: {launches} rasterizer launches, {batches} batches")
        rows = bop_io.load_bop_csv(paths[0])
        check(len(rows) == want_rows and timing["images"] == len(keys),
              f"refine CLI {renderer}: {len(rows)} rows for {want_rows} instances")
        worst = 0.0
        for r in rows:
            cands = [c for c in per_image[f"{r['scene_id']:06d}_{r['im_id']:06d}"]
                     if c["obj_id"] == r["obj_id"]]
            gap = min(max(float(np.abs(r["R"] - c["R"]).max()),
                          float((np.abs(r["t"] - c["t"]) / np.maximum(np.abs(c["t"]), 10.0)).max()))
                      for c in cands)
            worst = max(worst, gap)
        check(worst <= CLI_REFINE_TOL["R"], f"refine CLI {renderer}: a refined pose is "
              f"{worst} from every coarse hypothesis of its object")
        ms = np.asarray(timing["image_s"]) * 1e3
        rec[renderer] = dict(images=timing["images"], hypotheses=timing["hypotheses"],
                             rows=len(rows), image_ms_p50=float(np.percentile(ms, 50)),
                             image_ms_p90=float(np.percentile(ms, 90)),
                             images_per_s=timing["images"] / timing["run_s"],
                             hypotheses_per_s=timing["hypotheses"] / timing["run_s"],
                             run_s=timing["run_s"], batches=batches, raster_launches=launches,
                             max_gap_to_coarse=worst)
        log("refine_cli", renderer=renderer, **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                                for k, v in rec[renderer].items()}, card=repr(smi))
    return rec


def phase_refinement(root: str, init_csv: str, dev, smi) -> dict:
    """11. Refinement on the card, in phase 10's dataset: the meshes of its
    two objects written to datasets/tudl/models, and two meshes at the top
    of BOP's range beside the dataset; then 11.3-11.5."""
    models, large_dir = osp.join(root, "datasets", "tudl", "models"), osp.join(root, "large")
    sets = {}
    for tag, folder, n in (("dataset", models, SPHERE_SEGMENTS),
                           ("large", large_dir, SPHERE_SEGMENTS_LARGE)):
        os.makedirs(folder)
        faces = [write_sphere_ply(osp.join(folder, f"obj_{o:06d}.ply"), SEED + 20 + o, n)
                 for o in (1, 2)]
        sets[tag] = refine_cli.mesh_paths_of(folder)
        log("meshes", set=tag, objects=len(sets[tag]), faces=faces,
            vertices=[len(load_mesh(p)[0]) for p in sets[tag].values()])
    rec = {}
    for tag, paths in sets.items():
        store = MeshStore(paths, 500)
        rec[f"raster_{tag}"] = raster_case(dev, paths, store, tag)
        store.close()
    rec["refine"] = phase_refine(dev, sets["dataset"], sets["large"], smi)
    rec["cli"] = phase_refine_cli(root, init_csv, smi)
    torch.cuda.empty_cache()
    return rec


def raster_record(rec: dict) -> dict:
    """The rasterizer's entry of the kernels line, at the dataset's meshes:
    launches in phase 11.4's device runs on them (3 batches), launches_cli
    in each refine CLI run; bound_ms from the work the function needs,
    bound_ms_brute from the tests the kernel makes; the same at the largest
    meshes under "large"."""
    r, big = rec["raster_dataset"], rec["raster_large"]
    entry = dict(name="rasterizer", route="cuda", source="gigapose_tpu_torch/csrc/rasterizer.cu",
                 replaces="gigapose_tpu/render/jax_renderer.py:200 (XLA, no Pallas kernel)",
                 launches=3 * rec["refine"]["device"]["launches_per_batch"], on_main_path=True,
                 max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                 bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
                 bound_ms_brute=r["bound_ms_brute"], faces=r["faces"],
                 launches_cli={f"refine_{k}": v["raster_launches"] for k, v in rec["cli"].items()},
                 large={k: big[k] for k in ("faces", "ms", "plain_ms", "max_abs_err", "bound_ms",
                                            "bound_by", "bound_ms_brute")})
    entry["bound_share"] = entry["bound_ms"] / entry["ms"]
    log("kernel", **{f: (f"{v:.4g}" if isinstance(v, float) else v) for f, v in entry.items()
                     if f not in ("source", "route", "launches_cli", "large")},
        launches_cli=repr(entry["launches_cli"]).replace(" ", ""),
        large=repr({k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in entry["large"].items()}).replace(" ", ""))
    return entry


def kernel_records(record, qrec, krec, main_stats, bf16_counts, int8_counts, forwards, cli_rec):
    """One entry per hand-written kernel (and per chain that ports a TPU
    kernel): launches in the main path's runs, error against the plain
    version, times, bound and yardstick ("library_ms" where one PyTorch call
    computes the same function, "partial_library_ms" where it computes only
    part of it); launches_cli: the launches in each CLI run of phase 10."""
    mean = lambda xs: float(np.mean(xs))
    kernels = []
    cli_runs = {run: r["launches"] for run, r in cli_rec["runs"].items()}

    def add(name, source, replaces, launches, key, **fields):
        entry = dict(name=name, route="cuda", source=f"gigapose_tpu_torch/csrc/{source}",
                     replaces=replaces, launches=launches,
                     launches_per_forward=launches / forwards, library_ms=None,
                     launches_cli={run: n[key] for run, n in cli_runs.items()})
        entry.update(fields)
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        kernels.append(entry)

    pallas, qmm_py = "gigapose_tpu/ops/pallas_matching.py:69", "gigapose_tpu/ops/qmm.py"
    for dt, key in (("bfloat16", "match_bf16"), ("float32", "match_f32")):
        r = record[f"serving_{dt}"]
        err = max(r["max_abs_err"], main_stats["max_abs_err"]) if dt == "bfloat16" \
            else r["max_abs_err"]
        add(f"fused_matching_{dt}", "fused_matching.cu", pallas, bf16_counts[key], key,
            on_main_path=dt == "bfloat16", max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            partial_library_ms=r["partial_library_ms"])
    a = krec["attention"]
    add("attention_core", "qmm.cu", f"{qmm_py}:235", int8_counts["attention_core"],
        "attention_core", on_main_path=True, **a)
    errs = {Q._MODE_BF16: qrec["gemm_bf16_qkv"]["max_abs_err"],
            Q._MODE_GELU: qrec["gemm_gelu_fc1"]["max_abs_err"],
            Q._MODE_RES: max(qrec["qmm_proj"]["max_abs_err"], qrec["qmm_fc2"]["max_abs_err"]),
            Q._MODE_F32: qrec["qmm_K1024_N3072_ln0_res0"]["max_abs_err"]}
    for mode, name, line, key in ((Q._MODE_BF16, "gemm_bf16", 235, "gemm_bf16"),
                                  (Q._MODE_RES, "gemm_residual", 87, "gemm_residual"),
                                  (Q._MODE_GELU, "gemm_gelu", 173, "gemm_gelu"),
                                  (Q._MODE_F32, "gemm_f32", 87, "gemm_f32")):
        rs = krec["gemm"][mode]
        lib = [r["partial_library_ms"] for r in rs]
        add(name, "qmm.cu", f"{qmm_py}:{line}", int8_counts[key], key,
            on_main_path=int8_counts[key] > 0, max_abs_err=errs[mode],
            ms=mean([r["ms"] for r in rs]), plain_ms=mean([r["plain_ms"] for r in rs]),
            bound_ms=mean([r["bound_ms"] for r in rs]), bound_by=rs[0]["bound_by"],
            partial_library_ms=mean(lib),
            shapes={r["name"]: dict(K=r["K"], N=r["N"], ms=r["ms"], ms_min=r["ms_min"],
                                    ms_max=r["ms_max"], wrapper_ms=r["wrapper_ms"],
                                    bound_ms=r["bound_ms"],
                                    partial_library_ms=r["partial_library_ms"])
                    for r in rs})
    rs = krec["row_prologue"]
    add("row_prologue", "qmm.cu", f"{qmm_py}:87", int8_counts["row_prologue"], "row_prologue",
        on_main_path=True, max_abs_err=max(r["max_abs_err"] for r in rs),
        ms=mean([r["ms"] for r in rs]), plain_ms=mean([r["plain_ms"] for r in rs]),
        bound_ms=mean([r["bound_ms"] for r in rs]), bound_by="bytes",
        shapes=[dict(K=r["K"], ln=r["ln"], ms=r["ms"], ms_min=r["ms_min"], ms_max=r["ms_max"],
                     wrapper_ms=r["wrapper_ms"], bound_ms=r["bound_ms"]) for r in rs])
    # the chains that port each qmm.py TPU kernel, as measured in phase 3
    T, C, Hd, H, hd = 32 * TOKENS, 1024, 4096, 16, 64
    vec = lambda n, k: n * k * 4
    chain_bounds = {
        "qmm": bound(2.0 * T * Hd * C, "int8",
                     T * Hd * 4 + Hd * C + vec(C, 3) + 2 * T * C * 4),
        "qmm_mlp": bound(4.0 * T * C * Hd, "int8",
                         2 * T * C * 4 + 2 * C * Hd + vec(Hd, 2) + vec(C, 5)),
        # int8 GEMMs plus bf16 attention, as int8-rate operations
        "qmm_attn_block": bound(
            8.0 * T * C * C + 4.0 * 32 * H * TOKENS * TOKENS * hd
            * PEAK_OPS["int8"] / PEAK_OPS["bf16"], "int8",
            2 * T * C * 4 + 4 * C * C + vec(3 * C, 2) + vec(C, 5) + TOKENS * 4),
    }
    qmm_errs = [v["max_abs_err"] for k, v in qrec.items() if k.startswith("qmm_K") or
                k in ("qmm_proj", "qmm_fc2")]
    for name, line, case, err in (
        ("qmm", 87, "qmm_fc2", max(qmm_errs)),
        ("qmm_mlp", 173, "qmm_mlp", qrec["qmm_mlp"]["max_abs_err"]),
        ("qmm_attn_block", 235, f"qmm_attn_block_Np{TOKENS}_masked0",
         max(v["max_abs_err"] for k, v in qrec.items() if k.startswith("qmm_attn_block"))),
    ):
        add(name, "qmm.cu", f"{qmm_py}:{line}", int8_counts[name], name, on_main_path=True,
            chain=True, max_abs_err=err, ms=qrec[case]["ms"], plain_ms=qrec[case]["plain_ms"],
            **chain_bounds[name])
    for k in kernels:
        log("kernel", **{f: (f"{v:.4g}" if isinstance(v, float) else v) for f, v in k.items()
                         if f not in ("shapes", "source", "route", "launches_cli")},
            launches_cli=repr(k["launches_cli"]).replace(" ", ""))
    return kernels


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
    sources = KERNELS + HOST_SOURCES
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build, sources)))
    for name in sources:
        load_library(name)
    build_s = time.perf_counter() - t0
    log("device", kind=repr(kind), count=torch.cuda.device_count(), nvidia_smi=repr(smi),
        torch=torch.__version__, cuda=torch.version.cuda)
    for name, path in libs.items():
        report = ptxas_report(path.with_suffix(".log").read_text())
        log("build", source=name if name.endswith(".cpp") else f"{name}.cu",
            seconds=f"{build_s:.2f}", library=path.name,
            registers_spill_stores_loads=repr(report).replace(" ", ""))
        spills = {k: v for k, v in report.items() if v[1] or v[2]}
        check(not spills, f"ptxas spills registers in {spills}")

    # 2. matching kernel vs plain on planted worlds; 3. int8 kernels vs plain,
    # and each int8 kernel alone at the main path's shapes
    record = phase_kernel_vs_plain(dev)
    qrec = phase_qmm_vs_plain(dev)
    krec = phase_int8_kernels(dev, qrec)

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
    want = expected_counts(forwards)
    check(bf16_counts == want, f"bf16 path launches {bf16_counts} for {forwards} forwards")

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
    want = expected_counts(forwards, depth, int8_ae_calls=forwards)
    check(int8_counts == want, f"int8 path launches {int8_counts}, expected {want}")

    # 7. the int8 AE's wiring, card against CPU; 8. int8 against bf16;
    # 9. the whole forward at B=32 on both paths
    phase_int8_wiring(est8, preds8[0][1])
    phase_int8_vs_bf16(est, est8, preds8[0][1], dev)
    phase_forward_b32([("bf16", est, store), ("int8", est8, store8)], scenes[2], dev)
    del est, est8, store, store8, preds, preds8
    torch.cuda.empty_cache()

    # 10. the CLI on the card: a BOP dataset on disk through cli.main; 11.
    # refinement on the card, in that dataset
    cli_rec = phase_cli(templates, dev, smi,
                        then=lambda root, csv: phase_refinement(root, csv, dev, smi))

    kernels = kernel_records(record, qrec, krec, stats, bf16_counts, int8_counts, forwards,
                             cli_rec)
    kernels.append(raster_record(cli_rec["then"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
