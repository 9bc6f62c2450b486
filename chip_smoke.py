#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gigapose_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's coarse path once at the full width of `model=large`
(DINOv2 ViT-L/14, the default IST backbone, bf16 compute and a bf16 template
store, k=5, sim_threshold 0.5, patch_threshold 3, pixel_threshold 14, 162
templates per object) with seeded random weights and numpy-synthesised
inputs. Phases, one line each:

1. device + build: the card, its power limit, the nvcc build of the kernels;
2. the fused matching kernel against its plain PyTorch version on planted
   worlds, at P=16 and at the serving shape B=32, V=162, P=256, C=1024, in
   f32 and bf16 stores (idx / valid / top-k ids exact, scores within
   MATCH_ATOL), with both times from CUDA events;
3. onboarding of 2 objects x 162 procedurally textured 480x640 RGBA templates;
4. requests: images with several detections, one of them a template pasted
   unscaled, through prepare_batch -> GigaPoseEstimator; the kernel is then
   held against its plain version on the features of a request.

Any failed check raises, so the script exits non-zero. It needs CUDA and
never falls back to the CPU. The last lines are the kernels' JSON record,
the card's name and power limit from nvidia-smi, and the result JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from gigapose_tpu_torch.kernels.build import build, load_library
from gigapose_tpu_torch.lib3d.icosphere import template_object_poses
from gigapose_tpu_torch.ops import fused_matching as fm
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

    # 1. device + build
    t0 = time.perf_counter()
    lib_path = build("fused_matching")
    load_library("fused_matching")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    log("device", kind=repr(kind), count=torch.cuda.device_count(), nvidia_smi=repr(smi),
        torch=torch.__version__, cuda=torch.version.cuda)
    log("build", seconds=f"{build_s:.2f}", library=lib_path.name, ptxas=repr(" | ".join(ptxas)))

    # 2. kernel vs plain on planted worlds
    record = phase_kernel_vs_plain(dev)

    # 3. onboarding
    cfg = EstimatorConfig(k=5, sim_threshold=0.5, patch_threshold=3, pixel_threshold=14.0,
                          use_pallas_matching=True)
    est = GigaPoseEstimator.create(MODEL, seed=SEED, config=cfg, ist_descriptor_size=256,
                                   compute_dtype="bfloat16", device=dev)
    templates = [template_rgbas(SEED + 1 + o) for o in range(2)]
    poses = [template_object_poses(1).astype(np.float32)] * 2
    for rnd in ("cold", "warm"):  # the cold call includes cuBLAS / cuDNN set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store = onboard_templates(est.ae_apply, est.ist_apply, templates, poses, dev,
                                  feature_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        onboard_s = time.perf_counter() - t0
        log("onboarding", call=rnd, objects=2, views=NUM_VIEWS, seconds=f"{onboard_s:.3f}",
            s_per_object=f"{onboard_s / 2:.3f}")
    check(tuple(store.ae_features.shape) == (2, NUM_VIEWS, 256, 1024), "store shape")
    check(bool(torch.isfinite(store.ae_features.float()).all()), "store features finite")

    # 4. requests: the main path, with the kernel's launch count
    rng = np.random.default_rng(SEED + 10)
    planted = [(0, 40), (1, 100), (0, 7)]
    # 3, 4 and 5 detections: padded to 4, 4 and 8
    scenes = [make_scene(rng, templates, p, n) for p, n in zip(planted, (2, 3, 4))]
    fm.fused_match_scores.launches = 0
    latencies, preds = [], []
    for rnd in range(2):  # round 0 is cold (cuBLAS / cuDNN plans); round 1 warm
        for scene in scenes:
            rgb, masks, boxes, labels, K, _ = scene
            t0 = time.perf_counter()
            batch = prepare_batch(rgb, masks, boxes, labels, K, dev)
            pred = est(store, batch)
            torch.cuda.synchronize()
            latencies.append((rnd, len(labels), int(batch.crops.shape[0]),
                              (time.perf_counter() - t0) * 1e3))
            preds.append((pred, batch))
    launches = fm.fused_match_scores.launches
    check(launches == len(latencies), f"{launches} kernel launches for {len(latencies)} forwards")
    planted_sims = []
    for (pred, _), obj_view, scene in zip(preds, planted * 2, scenes * 2):
        for f in ("poses", "scores", "M", "sim_scores", "src_pts", "tar_pts"):
            check(bool(torch.isfinite(getattr(pred, f)).all()), f"{f} finite")
        i = scene[-1]
        ids = pred.view_ids[i].tolist()
        check(obj_view[1] in ids, f"planted view {obj_view} not in top-k {ids}")
        planted_sims.append(float(pred.sim_scores[i][ids.index(obj_view[1])]))
        check(planted_sims[-1] > 0.9, f"planted view {obj_view} sim score {planted_sims[-1]}")
    for rnd, n, padded, ms in latencies:
        log("request", round=rnd, detections=n, padded=padded, latency_ms=f"{ms:.2f}")
    log("requests", forwards=len(latencies), kernel_launches=launches,
        planted_sim_min=f"{min(planted_sims):.4f}")

    # the kernel on the main path's own features (not counted above); random
    # ViT features have near-equal similarities, so idx may differ on ties
    # within MATCH_ATOL: reported, not required equal
    _, batch = preds[0]
    with torch.inference_mode():
        tar = est.ae_apply(batch.crops).to(torch.bfloat16).contiguous()
    args = (tar, store.ae_features, batch.masks.contiguous(), store.masks, batch.labels)
    stats = compare_matcher(args, 16, exact=False)
    log("main_path_inputs", shape=repr(tuple(tar.shape)), **stats)

    serving = record["serving_bfloat16"]
    kernels = [dict(
        name="fused_matching", route="cuda",
        source="gigapose_tpu_torch/csrc/fused_matching.cu",
        replaces="gigapose_tpu/ops/pallas_matching.py:69",
        launches=launches,
        max_abs_err=max(serving["max_abs_err"], stats["max_abs_err"]),
        ms=serving["ms"], plain_ms=serving["plain_ms"],
    )]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
