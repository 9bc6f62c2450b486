#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gigapose_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's coarse path, its refinement (GigaPose's and MegaPose's)
and its training at the full width of `model=large`, of the JAX refiner and
of the released MegaPose checkpoints (DINOv2
ViT-L/14, the default IST backbone, bf16 compute and a bf16 template store,
k=5, sim_threshold 0.5, patch_threshold 3, pixel_threshold 14, 162
templates per object) with seeded random weights and numpy-synthesised
inputs, twice: with the bf16 AE (`serving_quant=off`) and with the int8 AE
(`est.quantize_serving()`). Phases, one line each or more:

1. device + build: the card, its power limit, the nvcc builds of the
   kernels and the host compiler's builds of the host rasterizer and of the
   image codecs (csrc/codecs.cpp) (one compiler per source, all started
   together) with ptxas's registers and spills per kernel (any spill fails
   the run); phase 17 follows;
2. the fused matching kernels against their plain PyTorch version on
   planted worlds, at P=16 and at the serving shape B=32, V=162, P=256,
   C=1024: the bf16 wgmma kernel on a bf16 store and the TF32 wgmma kernel
   with its three-product split on an f32 store (idx / valid / top-k ids
   exact, scores within MATCH_ATOL), with both times from CUDA events, and
   at the serving shape the bound (the f32 store's at the TF32 rate counted
   three times, the CUDA cores' beside it) and a partial yardstick (one
   batched matmul of the pre-gathered views, f32 at "highest" precision:
   the similarity alone; on the f32 store also the same matmul in TF32, one
   product that is not f32-grade, as the card's TF32 rate); on the f32
   store also each side's largest gap
   from an f64 product of the same inputs, and the split kernel alone
   (bit-equal to split_tf32, its time, plain time and bound);
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
   prepare_batch and the estimator) on both paths and on the bf16 path with
   its store cast to f32 (the f32 matching kernel; launches counted per
   path), on the host clock around work that ends in synchronize, with its
   stages from CUDA events;
10. the CLI on the card: a BOP dataset written with the port's PNG and RLE
   encoders, rows filtered as real PNG writers filter them (per row the
   least-cost filter, encode_png's "adaptive"): 2 objects x 162 templates,
   CLI_IMAGES test images of 3-10 detections, CNOS detections, localization
   targets; through `gigapose_tpu_torch.cli.main` at model=large, with the
   bf16 AE and the int8 AE, each run cold (decoding the template PNGs) and
   once from the onboarding cache (the same csv, time column aside), the
   two AEs alternating; per run the launch counts (one matching launch per
   forward of at most 4 detections, the int8 kernels per AE call), and on
   the cold runs the csvs' rows and poses and the npz batches against the
   estimator called directly; one [cli] line per run (onboarding s/object,
   per-image latency p50 / p90, images/s, detections/s, the host's decoding
   share and ms per image), the spread over each AE's two runs and the
   int8 / bf16 ratios per pair of runs; then one more run with the bf16 AE
   from the cache with model.feature_dtype=f32 (an f32 store: the f32
   matching kernel and its split, one each a forward, no bf16 matching),
   its [cli] line beside the bf16 cached runs; the PNG decode time of one
   480x640 image per row filter.
11. refinement on the card, in phase 10's dataset: a closed mesh per object
   (a displaced 100 x 100-segment sphere, 19,800 faces, about 150 mm across,
   vertex colours, binary PLY in datasets/tudl/models), and beside the
   dataset two 224 x 224-segment spheres (99,904 faces, the top of BOP
   models' range); on each set the rasterizer kernel (csrc/rasterizer.cu)
   against its plain version at B = 8, 160 x 160, on seeded poses seen
   through the refine loop's crop camera (bit-equal: hit masks, face ids,
   rgba, the depth's bits, the normals) and against the host C++ renders
   (pixels that differ, the largest difference, the JAX package's bound),
   and bit-equal on an adversarial set (20,000 slivers, needles and
   sub-pixel faces, one view across the camera plane); its device time
   (CUDA-graph replays), the wrapper's, the plain version's, the bound of
   the work the function needs (each face tested at the pixels of its
   screen bounding box) and that of the kernel's own (its cull boxes and
   row spans), with both test counts, the faces it tests at the whole view
   and each of its four launches' device time; refine_batch at full width
   (RefinerNet 64, CoarseScorerNet 32, 160 x 160, 500 points, 5
   iterations, keep_best_init) with the pose head and BatchNorm statistics
   randomized, at B = 8 with the host and the device renderer on both mesh
   sets: whole ms per batch, the host loop's phases; on the dataset's
   meshes the card's host loop against the CPU (B = 2), the renderers
   against each other at the same batch without keep_best_init, the device
   renderer at B = 8 against two batches of 4, the referee's choice with
   it, every pose moved; refine_batch without keep_best_init on both
   renderers, beside the batch with it: the referee's own cost ([referee]);
   the host loop in PIPELINE_CHUNKS chunks (one CUDA stream each) on both
   mesh sets: ms p50, the device's busy share and the largest pose and
   score gap from one chunk, held to CPU_BOUND ([refine_chunks]); then the
   refine CLI (`gigapose_tpu_torch.refine.main`) on the MultiHypothesis
   csv of phase 10's last run, REFINE_CLI_IMAGES images, min_score 0, with
   each renderer and with the host loop in 2 chunks: one row per instance,
   each equal to one of its coarse hypotheses (the CLI's untrained head is
   the identity), the chunked run's rows those of one chunk, rasterizer
   launches per batch, and a [refine_cli] line per run (per-image p50 /
   p90, images/s, hypotheses/s).
12. templates from CAD models and BOP scoring, beside phase 10's dataset:
   12.1 the 162 views of level 1 at 640 x 480 (the object at 0.4 m) of
   phase 11's two dataset meshes and of one 99,904-face mesh, through the
   device renderer (render/templates.py:render_template_views_device: one
   rasterizer launch per object at 19,800 faces, two at 99,904, counted)
   and the host renderer (render/rasterizer.py:render_template_views),
   each timed as render and PNG encode; every written PNG decoded back to
   the rendered arrays exactly; four views per mesh (those beside the cut
   between launches first) bit-equal to the plain version; the pixels where
   the device and host renders differ; each launch's device time (CUDA
   events), the bound of the function's work over the stack (raster_work)
   and the plain version's time for one view; one view's PNG bytes and
   decode time with filter-0 and with adaptive rows ([templates] per mesh).
   12.2 a second BOP dataset under root/e2e: the two meshes in models/ and
   no template set, E2E_IMAGES test images of both objects at known poses
   (host renders composed by depth: RGB, depth, scene_gt, scene_gt_info,
   camera, targets, CNOS detections from the render masks), then
   `gigapose_tpu_torch.scripts.eval_bop.main` with the int8 AE, templates
   and refinement on the device renderer, refine=true, min_score 0, with
   every kernel count set to 0 just before it and read just after (each
   kernel of the path launched; the rasterizer 2 + 8 per refine batch):
   the rendered template set, the csvs, AR from the port's scorer; a csv
   of the ground truth scored on the card (AR 1.0 on VSD, MSSD and MSPD)
   and the pipeline's csv scored again, timed per image ([eval_bop]).
13. training on the card, in 12.2's dataset: 13.1 a train_pbr split of
   TRAIN_IMAGES and a val split of VAL_IMAGES 480x640 images, both objects
   in each at seeded poses (host renders composed by depth: rgb, depth and
   mask_visib PNGs with adaptive rows, scene_gt, scene_gt_info, camera),
   12.2's level-1 template sets; 13.2 `gigapose_tpu_torch.train.main` at
   model=large (ViT-L/14 AE and the ResNet IST, f32, TF32 off),
   machine.batch_size=12, TRAIN_STEPS steps, checkpoints and validation
   every TRAIN_EVERY: s per step p50 / p90 (host clock to a sync), pairs/s,
   the loader wait per step, peak memory and its share of the card, the
   device's busy share of 3 steps on held batches (torch.profiler) and the
   step's f32 bound counted from the nets; every loss finite, every
   parameter with a gradient and every BatchNorm statistic moved between
   step 1 and the last, metrics.jsonl with total and val/matching, no
   hand-written kernel launched ([train]); 13.3 3 steps at B=2 from one
   init on the card and on the host CPU, losses and parameters within the
   PARITY_* tolerances ([train_parity]); 13.4 2 steps, a resume, 1 more,
   against 3 straight with deterministic algorithms, bit-equal
   ([train_resume]); 13.5 the coarse CLI with the int8 AE on phase 10's
   first SERVE_IMAGES images from 13.2's checkpoint directory, its csvs,
   the served IST's weights and phase 10's launch formula, and the static
   int8 IST of the served checkpoint against its f32 IST (per-descriptor
   cosine on phase 10's first images' detections: the int8 IST on trained
   weights) ([train_serve]); 13.6 training from JPEG shards: 13.1's
   train_pbr split copied with each rgb PNG replaced by a 480 x 640 JPEG
   fixture of tests/data/codecs (image im gets fixture im mod 4), turned
   into tar shards by the port's convert_to_shards, then train.main at
   model=large, batch 12, TRAIN_JPG_STEPS steps from a TarSceneSource over
   them: every loss finite, no hand-written kernel, s per step p50 and the
   loader's wait and its share beside 13.2's ([train_jpg]).
14. MegaPose refinement on the card, in phase 10's dataset and on phase 11's
   meshes, at the released checkpoints' width (WideResNet-34 width 1.0,
   240 x 320 renders with normals, 500 points, 5 iterations, one rendered
   view) with seeded nets (a small pose head around the identity update,
   random BatchNorm statistics): the nets' f32 work counted by hooks and
   their device time alone ([megapose_nets]); refine_batch at B = 8 on the
   19,800- and 99,904-face meshes, ms per batch with its host phases
   (fetch, render, upload, update) and the device's busy share of one
   profiled batch ([megapose_batch]); every pose moved; the card against
   the CPU on 2 hypotheses; classify_coarse on the 576-grid for 4
   detections, s per detection and its phases, the card against the CPU on
   one detection's 72-grid ([megapose_classify]); the refine CLI from
   checkpoint.pth.tar files of these nets (the coarse one with the older
   key names) with refiner_type=megapose on phase 10's MultiHypothesis
   csv (MEGAPOSE_CLI_IMAGES images; its first image's rows against
   run_refinement with the refiner itself) and with coarse_mode=so3grid on 2 images
   ([megapose_cli]); no hand-written kernel launched ([megapose], with the
   phase's seconds).
16. refiner training on the card, in phase 11's dataset (its two
   19,840-face meshes), through `gigapose_tpu_torch.scripts.train_refiner`
   at its defaults (RefinerNet 64 (3, 4, 6, 3), scorer 32 (2, 2, 2, 2),
   160 x 160, batch 8, the curriculum, the scorer's three classes) for
   RT_STEPS steps (cut from the script's 2,000): s per step p50 / p90 and
   the host's split (batch: the draws and the 480 x 640 observed renders;
   crop: the crop steps and their fetch; render: the 8 + 16 renders of
   160 x 160; step: the uploads and both optimizer steps), the refiner loss
   and the scorer's BCE at the first and last step, peak memory, the f32
   bound of a step's convolutions (counted by hooks) and the card's busy
   share over 3 more steps (torch.profiler) ([refiner_train]); no
   hand-written kernel and no rasterizer launch; one step of each net from
   the same weights on the same inputs (a batch, its crops and renders made
   once) on the card and on the CPU, TF32 off: the losses, each
   parameter's gradient against the CPU's f64 gradient, the BatchNorm
   statistics, and two planted gradient faults that the check must catch
   ([refiner_train_parity]); the saved checkpoint loaded as refine.py loads
   it, on a held batch of the training distribution (ground truth known):
   the same poses as the trainer's own nets, the random nets' poses the
   init, every pose in the scene, the mean point distance to the ground
   truth against the init's ([refiner_train_held]);
   the checkpoint through `python -m gigapose_tpu_torch.refine
   refiner_checkpoint=...` on phase 10's first RT_SERVE_IMAGES images: a
   finite csv, other poses than the random nets' run of phase 11 on the
   same images, the inits' and the served translations, per-image p50
   ([refiner_train_serve]).
15. the int8 IST on the card (models/ist_int8 on csrc/qconv.cu), at the
   default IST (stem 7x7/s2 to 128 x 128 x 128, stages 128 / 192 / 256 /
   512, 1x1 out conv to 256) and B = 32. 15.1 (after phase 9) each of its
   convolution shapes: qconv (the stem's 3 channels padded to 16 inside
   the call; at each block's conv1 also the int8 output under a static
   scale), and act_absmax and quantize on its input (also a static scale
   that clips), bit-equal to their plain versions; device ms (CUDA-graph
   replays), the N tile and the route of the im2col tiles (TMA windows or
   16-byte gathers), the bound (with the int8 output's bytes where it
   writes int8),
   the plain version's ms and the yardsticks (bf16 cuDNN F.conv2d of the
   shape, torch._int_mm on a pre-built im2col, vector_norm(inf) for the
   absmax), per shape ([ist_kernel]) and summed over the launches of one
   forward with static scales (21 qconv, 8 of them int8 out, 13 quantize)
   and with per-image scales (21 of each) ([ist_kernels_per_forward]);
   15.2 the int8 IST with per-image and with static scales (calibrated on
   the first object's first 16 template crops, margin 1.1) on phase 9's
   request of 32 against the f32 IST: mean per-descriptor cosine over
   0.995 / 0.99 (the JAX tests' gates), launches a forward (per-image: 21
   qconv, 21 quantize, 21 act_absmax; static: 21, 13, 0), device ms of the
   bf16, f32, int8 dynamic and static IST ([ist_forward]); 15.3 the
   forward at B = 32 with the int8 AE and the static int8 IST on its own
   store, stages as phase 9 ([forward_b32]), and that IST on the card
   against the CPU on 4 crops, equal ([ist_card_vs_cpu]); 15.4 (after
   phase 14) the coarse CLI with model.serving_quant=int8
   model.serving_quant_ist=int8-static on phase 10's first IST_CLI_IMAGES
   images, cold and from the cache: launches per run (calibration's dynamic forward at
   each onboarding), per-image p50 / p90, the cold run against the
   estimator called directly, the cached csv equal ([ist_cli]).
18. multi-device runs (parallel/): 18a (after phase 9) phase 4's bf16
   store split over [cuda:0] * S for S in SHARDS (162 views padded to 164
   at S = 4) and phase 9's f32 store at S = 2, on phase 9's request of 32
   through coarse_forward_sharded: view ids, correspondences, inlier masks,
   M and poses equal to the whole store's forward, the scores' gap from it
   (expected 0: each (detection, view) is matched alone), S matching
   launches a forward (and S split launches on the f32 store), ms per
   forward on the host clock to a synchronize against the whole store's
   ([sharded]); 18b/18d (after phase 11) two processes on cuda:0 through
   the GIGAPOSE_COORDINATOR contract with GIGAPOSE_DIST_BACKEND=gloo (NCCL
   refuses two ranks on one card): the coarse CLI with the bf16 AE on phase
   10's dataset cold (onboarding split between the processes, merged by
   process 0) and from the cache, then the refine CLI on phase 11's
   csv and images with the host renderer: the cache equal to phase 10's
   bf16 cache array for array, the merged csvs to phase 10's bf16 run's and
   to phase 11's host refine run's row for row (time column aside), the
   images split round-robin, each process's matching launches one a
   forward, images/s per process and in all ([mp_cli], [mp_refine]), and
   which collectives gloo takes on CUDA tensors ([gloo_cuda]); 18c (after
   13.6) data-parallel training at model=large: one process steps DP_STEPS
   times on held batches of TRAIN_B from the seeded init (13.3's warm-up),
   then two
   processes on cuda:0 (gloo) each step on its half of the same batches
   from the same init (checked equal): metrics to DP_LOSS_RTOL, parameters
   within 2 x the summed lr with at most DP_FAR_SHARE (per net) beyond a
   tenth of it,
   BatchNorm statistics to DP_STATS_ATOL, the processes' weights equal bit
   for bit; s per step and the gradient all-reduce's share; then train.py
   itself for DP_STEPS steps in two processes at batch TRAIN_B / 2 each:
   one checkpoint written (by process 0), the same weights on both
   ([dp_train], [dp_train_cli]). Two processes share one card here: these
   legs check correctness and overhead, not scaling.
20. the last modules: 20a (after phase 11) the JAX trainers' orbax
   checkpoints read without orbax (utils/orbax.py): the committed fixtures
   of tests/data/orbax (GIGAPOSE_TINY's nets, written by the JAX package's
   save functions) against the manifest of orbax's own restore (every
   array's sha256), the zstd library taken; the train state served by
   cli.main on phase 10's first ORBAX_CLI_IMAGES images (the nets equal
   to the bridge's bit for bit, the matching kernel's launches), the
   refiner by refine.py refiner_checkpoint= with the device renderer on
   the first image (finite poses that moved, rasterizer launches)
   ([orbax_read], [orbax_serve]); 20b (after 18a) ViT-L in bf16 split over
   TP_MP gloo processes on cuda:0 (parallel/tp.py) at B = TP_B against the
   one-process forward (every patch's cosine above BF16_COS), ms per
   forward, the all-reduces' share, GSPMD's bf16 partials beside the
   port's f32 sums ([tp]); 20c (after 18a) onboard_templates_sharded of
   phase 4's objects on [cuda:0] * 2, bit-equal to phase 4's store, and a
   forward on it: one matching launch, outputs equal ([sharded_onboarding]).
19. (after phase 15.4) the port's selfcheck_full on the card
   (scripts/selfcheck_full.py, in a temp dir), cut to about 50 s: level 0,
   seed 0, SELFCHECK_STEPS coarse and SELFCHECK_REFINER_STEPS refiner steps
   (the JAX gates' budget is 900 + 400; PERF.md keeps the full-budget runs),
   the int8 leg on vit_deep_test (head width 64, the attention kernel's):
   its JSON line complete (the JAX script's keys) and finite, the int8
   retrieval agreement at least 0.99, and with every count set to 0 just
   before it the launches of its coarse path and int8 leg
   (expected_counts: 4 matching forwards on a bf16 store, 3 calls of the
   int8 AE: one onboarding chunk and two queries) ([selfcheck]);
17. (right after phase 1) the image decoders on the host: each committed
   fixture of tests/data/codecs (five 480 x 640 JPEGs, one progressive, a
   1280 x 960 LZW TIFF, a 16-bit RGB and an Adam7 PNG, and 35 small files
   of the other JPEG and TIFF kinds) decoded by the reader's choice
   by signature, its array's shape, dtype and sha256 against the manifest
   that PIL wrote; ms per image (p50 of CODEC_REPS) of the q95 4:2:0 JPEG,
   the TIFF, the JPEG's image as a PNG with adaptive rows and the
   progressive JPEG; the JPEG's images/s on one thread and on the
   TrainLoader's worker count; the host CPU's model ([codecs]).

Every kernel count is set to 0 just before a path is driven and read just
after; launches made to compare a kernel with its plain version are not
counted.

Any failed check raises, so the script exits non-zero. It needs CUDA and
never falls back to the CPU. The last lines are the kernels' JSON record
(one entry per hand-written kernel and per chain that ports a TPU kernel:
launches in the main path's runs, error, ms, plain_ms, bound_ms, bound_by,
and library_ms or partial_library_ms; the rasterizer's also
launches_templates and its template-shape times; the three csrc/qconv.cu
kernels' launches from 15.4's cold CLI run and their times summed over one
static B = 32 forward, the per-image-scale forward's beside them), the
card's name and power limit from nvidia-smi, and the result JSON.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import os.path as osp
import re
import shutil
import socket
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
from gigapose_tpu_torch.dataloader import scene as SCENE
from gigapose_tpu_torch.dataloader.jpeg import decode_jpeg
from gigapose_tpu_torch.dataloader.png import decode_png, encode_png
from gigapose_tpu_torch.dataloader.scene import DirSceneSource
from gigapose_tpu_torch.dataloader.test_set import InferenceDataset
from gigapose_tpu_torch.dataloader.train_set import TrainLoader, prepare_train_batch
from gigapose_tpu_torch.eval import errors as EV
from gigapose_tpu_torch.eval import scorer as SC
from gigapose_tpu_torch.eval import score_bop
from gigapose_tpu_torch.kernels.build import build, load_library
from gigapose_tpu_torch.lib3d.icosphere import template_object_poses
from gigapose_tpu_torch.dataloader.templates_disk import list_objects, load_object_templates
from gigapose_tpu_torch.models import vit_int8 as v8
from gigapose_tpu_torch.models.ist_int8 import ISTNetInt8
from gigapose_tpu_torch.models.vit import VIT_CONFIGS
from gigapose_tpu_torch.ops import fused_matching as fm
from gigapose_tpu_torch.ops import qconv as QC
from gigapose_tpu_torch.ops import qmm as Q
from gigapose_tpu_torch.ops.matching import select_top_k
from gigapose_tpu_torch.parallel import multihost
from gigapose_tpu_torch.parallel.sharded_store import coarse_forward_sharded, shard_template_store
from gigapose_tpu_torch.pipeline.estimator import EstimatorConfig, GigaPoseEstimator
from gigapose_tpu_torch.pipeline.runner import CALIB_MARGIN, CALIB_VIEWS, prepare_batch
from gigapose_tpu_torch.pipeline.templates import (
    TEMPLATE_K,
    onboard_templates,
    onboard_templates_sharded,
    prepare_template_crops,
)
from gigapose_tpu_torch.refiner import device_render as DR
from gigapose_tpu_torch.refiner import training as RTRAIN
from gigapose_tpu_torch.refiner.ops import normalize_T
from gigapose_tpu_torch.refiner.checkpoint import load_refiner_checkpoint
from gigapose_tpu_torch.refiner.refiner import (
    MeshStore,
    RefinerConfig,
    RenderCompareRefiner,
    crop_prep,
    no_tf32,
)
from gigapose_tpu_torch.render import rasterize as RZ
from gigapose_tpu_torch.render import rasterizer as TR
from gigapose_tpu_torch.render import templates as TP
from gigapose_tpu_torch.render.mesh_io import diameter as mesh_diameter
from gigapose_tpu_torch.render.mesh_io import load_mesh
from gigapose_tpu_torch.render.rasterizer import Rasterizer
from gigapose_tpu_torch.scripts import convert_to_shards
from gigapose_tpu_torch.scripts import eval_bop
from gigapose_tpu_torch.scripts import render_templates as RT
from gigapose_tpu_torch.scripts import selfcheck_full as SELFCHECK
from gigapose_tpu_torch.scripts import train_refiner as TRAIN_REFINER
from gigapose_tpu_torch.training.checkpoint import serving_weights
from gigapose_tpu_torch.utils import orbax as ORBAX
from gigapose_tpu_torch.utils import zstd as ZSTD
from gigapose_tpu_torch.training.loop import FitConfig, fit
from gigapose_tpu_torch.training.state import (
    Adam,
    OptimConfig,
    TrainBatch,
    TrainState,
    train_step,
    warmup_lr,
)

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
INT8_AGREEMENT_MIN = 0.99  # tests/test_selfcheck_e2e.py's int8 retrieval gate
KERNELS = ("fused_matching", "qmm", "rasterizer", "qconv")
HOST_SOURCES = ("rasterizer.cpp", "codecs.cpp")  # built with the host compiler
# phase 10: test images, detections per test image (image i has
# CLI_DETECTIONS[i % 6]), and the CLI's chunk (test.yaml's
# max_num_dets_per_forward)
CLI_IMAGES = 40  # 40 rather than 200 keeps the script inside its time limit
CLI_DETECTIONS = (3, 5, 7, 10, 4, 8)
CLI_CHUNK = 4
# the CLI's poses against the estimator called directly: the CPU slice
# test's tolerance (tests/test_torch_pipeline.py)
CLI_POSE_TOL = dict(rtol=1e-4, atol=1e-3)
# published dense peaks of an H100 SXM at 700 W (NVIDIA's data sheet): the
# least time of a kernel is the larger of its operations over the peak of
# their type and its bytes (each input read once, each output written once)
# over the memory rate
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
# phase 17: the decoders' fixtures (tests/data/codecs/make_fixtures.py wrote
# them and the manifest with PIL), decodes per timed file, images per
# throughput reading
CODEC_DIR = osp.join(osp.dirname(osp.abspath(__file__)), "tests", "data", "codecs")
CODEC_MANIFEST = (json.load(open(osp.join(CODEC_DIR, "manifest.json")))
                  if osp.exists(osp.join(CODEC_DIR, "manifest.json")) else {})
CODEC_REPS, CODEC_THREAD_IMAGES = 20, 140
CODEC_FIXTURES = 43  # the files of the manifest
# 13.6's training images: the four 480 x 640 baseline JPEGs
TRAIN_JPEGS = ("jpeg_gray_q90.jpg", "jpeg_q100_444_opt.jpg", "jpeg_q90_422_rst.jpg",
               "jpeg_q95_420.jpg")


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


def device_profile(fn, iters: int = 1) -> dict:
    """fn() `iters` times under torch.profiler (CUDA activity), warm: the
    device time of each kernel (or copy) name per call in µs, their sum, the
    wall time per call on the host clock to a synchronize (the profiler's own
    cost included) and the device's busy share of it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    per_call = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
        if us > 0:
            per_call[e.key] = us / iters
    busy_ms = sum(per_call.values()) / 1e3
    return dict(kernels_us=per_call, busy_ms=busy_ms, wall_ms=wall_ms,
                busy_share=busy_ms / wall_ms)


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
            k = re.search(r"(match_bf16|match_f32|split_tf32|gemm|quant_rows|attention|prep|face"
                          r"|big|resolve"
                          r"|act_absmax|quantize|qconv)_kernel(I\w*?E)?", m.group(1))
            name = k.group(1) + (k.group(2) or "") if k else m.group(1)
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
    """Bound of one matching launch: 2 B V P^2 C products in the features'
    type (bf16 tensor cores; an f32 store's f32-grade products as three TF32
    products each, with the bound of the same work in f32 on the CUDA cores
    beside it), and the bytes of the labelled objects' views, the query, the
    masks, labels and outputs."""
    tar, store = args[0], args[1]
    B, P, C = tar.shape
    V = store.shape[1]
    objs = int(torch.unique(args[4]).numel())
    esz = tar.element_size()
    nbytes = (objs * V * P * C + B * P * C) * esz + (objs * V * P + B * P + B) * 4 \
        + (B * V + 3 * B * V * P) * 4
    ops = 2.0 * B * V * P * P * C
    if dtype == torch.bfloat16:
        return bound(ops, "bf16", nbytes)
    return dict(bound(3 * ops, "tf32", nbytes),
                bound_ms_cuda_cores=bound(ops, "f32", nbytes)["bound_ms"])


def split_record(tar) -> dict:
    """The split kernel alone on the serving query: bit-equal to split_tf32
    on the card, its time and the plain version's (CUDA events), and its
    bound (the query read once, hi and lo written once)."""
    got = fm.split_query(tar)
    hi, lo = fm.split_tf32(tar)
    Cp = got.shape[-1]
    C = tar.shape[-1]
    torch.cuda.synchronize()
    same = torch.equal(got[0, ..., :C].view(torch.int32), hi.view(torch.int32)) and \
        torch.equal(got[1, ..., :C].view(torch.int32), lo.view(torch.int32)) and \
        not bool(got[..., C:].any())
    check(same, "the split kernel differs from split_tf32")
    rec = dict(max_abs_err=0.0, ms=cuda_ms(lambda: fm.split_query(tar)),
               plain_ms=cuda_ms(lambda: fm.split_tf32(tar)),
               **bound(0.0, "f32", tar.numel() * 4 + 2 * tar.numel() // C * Cp * 4))
    log("split_tf32", shape=repr(tuple(tar.shape)),
        **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec.items()})
    return rec


def phase_kernel_vs_plain(dev) -> dict:
    """Planted worlds at P=16 and at the serving shape, f32 and bf16 stores."""
    record = {}
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32, "f32 matmuls are not full f32")
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
                if dtype == torch.float32:  # the card's TF32 rate, one product (not f32-grade)
                    torch.backends.cuda.matmul.allow_tf32 = True
                    try:
                        extra["partial_library_tf32_ms"] = cuda_ms(lambda: torch.bmm(src, tar_t))
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = False
                del src
            if dtype == torch.float32:  # each side's largest gap from an f64 product
                kw = dict(MATCH, num_patches=shape["npat"])
                ref = fm.match_scores_plain(*args, products="f64", **kw)
                for side, out in (("kernel", fm.fused_match_scores(*args, **kw)),
                                  ("plain", fm.match_scores_plain(*args, **kw))):
                    extra[f"{side}_gap_f64"] = max(float((out[i].double() - ref[i]).abs().max())
                                                   for i in (0, 2))
                del ref, out
                if name == "serving":
                    record["split_tf32"] = split_record(args[0])
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
    for fn in (fm.fused_match_scores, fm.split_query, Q.qmm, Q.qmm_mlp, Q.qmm_attn_block,
               Q._quantize_rows, Q._attention, QC.act_scale, QC.quantize_act, QC.qconv):
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
                split_tf32=fm.split_query.launches, row_prologue=Q._quantize_rows.launches, attention_core=Q._attention.launches,
                gemm_f32=gemm[Q._MODE_F32], gemm_residual=gemm[Q._MODE_RES],
                gemm_gelu=gemm[Q._MODE_GELU], gemm_bf16=gemm[Q._MODE_BF16],
                qconv=QC.qconv.launches, quantize=QC.quantize_act.launches,
                act_absmax=QC.act_scale.launches)


def expected_counts(forwards: int, depth: int = 0, int8_ae_calls: int = 0,
                    int8_ist_calls: int = 0, dynamic_ist_calls: int = 0,
                    f32_store: bool = False) -> dict:
    """Launches of every kernel after `forwards` coarse forwards on a bf16
    store (an f32 one with f32_store: the f32 matching kernel and its split
    instead of the bf16 kernel), `int8_ae_calls` of them (and of onboarding's AE calls) through
    the int8 AE of `depth` blocks, `int8_ist_calls` IST calls through the
    int8 IST (IST_CONVS_PER_FORWARD convolutions each), `dynamic_ist_calls`
    of them with per-image scales (calibration's forward, on static ones);
    the static calls quantize IST_FUSED_PER_FORWARD times fewer (each
    block's conv1 writes conv2's codes)."""
    n = int8_ae_calls
    return dict(fused_matching=forwards, qmm=2 * depth * n, qmm_mlp=depth * n,
                qmm_attn_block=depth * n, match_bf16=0 if f32_store else forwards,
                match_f32=forwards if f32_store else 0, split_tf32=forwards if f32_store else 0,
                row_prologue=4 * depth * n, attention_core=depth * n, gemm_f32=0,
                gemm_residual=2 * depth * n, gemm_gelu=depth * n, gemm_bf16=depth * n,
                qconv=IST_CONVS_PER_FORWARD * int8_ist_calls,
                quantize=IST_CONVS_PER_FORWARD * int8_ist_calls
                - IST_FUSED_PER_FORWARD * (int8_ist_calls - dynamic_ist_calls),
                act_absmax=IST_CONVS_PER_FORWARD * dynamic_ist_calls)


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
    and its stages from CUDA events. The matching launches of each path's 7
    forwards are counted: the bf16 kernel on a bf16 store, the f32 kernel
    and its split on an f32 one."""
    rgb, masks, boxes, labels, K, _ = scene
    take = np.arange(32) % len(labels)
    req = (rgb, masks[take], boxes[take], labels[take], K)
    out = {}
    for tag, est, store in paths:
        run = lambda: est(store, prepare_batch(*req, dev))
        reset_counts()
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        f32 = store.ae_features.dtype == torch.float32
        got = {k: counts()[k] for k in ("match_bf16", "match_f32", "split_tf32")}
        want = dict(match_bf16=0 if f32 else 7, match_f32=7 if f32 else 0,
                    split_tf32=7 if f32 else 0)
        check(got == want, f"forward_b32 {tag}: matching launches {got}, expected {want}")
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
        log("forward_b32", ae=tag, **{k: f"{v:.3f}" for k, v in out[tag].items()},
            store=str(store.ae_features.dtype).split(".")[-1], launches=repr(got).replace(" ", ""))
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
            ("int8_cached", "int8", True), ("bf16_cached", "bf16", True))
CLI_PAIRS = (("int8", "bf16"), ("int8_cached", "bf16_cached"))
# and after them the f32 store: the bf16 AE from the cache with
# model.feature_dtype=f32
CLI_F32_RUN = "bf16_f32store_cached"


def phase_cli(templates, dev, smi, then=None) -> dict:
    """10. The CLI on the card: a BOP dataset on disk through cli.main at
    model=large, the runs of CLI_RUNS (cold: no onboarded store and no pixel
    cache of the templates); launch counts per run; the cold runs' outputs
    against the estimator called directly and each cached run's csv against
    its AE's cold run; latency, throughput, onboarding and the host's
    decoding per run, the spread over each AE's runs and the int8 / bf16
    ratios per pair of runs. `then(root, csv, info)`, when given, runs last
    in the dataset's directory with the MultiHypothesis csv of the last run
    and the dataset's per-image information (write_bop_dataset); its result
    is record["then"]."""
    record = {"png": png_decode_times(templates)}
    log("png", shape="480x640", **{k: f"{v:.4g}" for k, v in record["png"].items()})
    quant = {"bf16": "model.serving_quant=off", "int8": "model.serving_quant=int8"}
    runs, image_ms, csvs = {}, {}, {}

    def record_run(tag, runner, paths, launched, **stats):
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
            record_run(tag, runner, paths, launched, **stats)
            del runner
            torch.cuda.empty_cache()
        # the f32 store: the bf16 AE's onboarding cache read back as f32
        runner, launched, paths = cli_run(root, [quant["bf16"], "model.feature_dtype=f32"],
                                          CLI_F32_RUN)
        check(runner.timing["onboard_cached"], f"{CLI_F32_RUN}: onboarding cache")
        check(runner.store.ae_features.dtype == torch.float32,
              f"{CLI_F32_RUN}: store {runner.store.ae_features.dtype}")
        check(runner.timing["forwards"] == forwards, f"{CLI_F32_RUN}: forwards")
        want = expected_counts(forwards, f32_store=True)
        check(launched == want, f"{CLI_F32_RUN}: launches {launched}, expected {want}")
        record_run(CLI_F32_RUN, runner, paths, launched, same_csv_as_bf16=all(
            csv_rows(a) == csv_rows(b) for a, b in zip(csvs["bf16"], paths)))
        del runner
        torch.cuda.empty_cache()
        if then is not None:
            record["then"] = then(root, csvs[CLI_RUNS[-1][0]][1], info)
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
    cached = [runs[tag]["image_ms_p50"] for tag, p, c in CLI_RUNS if p == "bf16" and c]
    record["f32store"] = dict(image_ms_p50=runs[CLI_F32_RUN]["image_ms_p50"],
                              bf16_cached_p50=cached,
                              over_bf16_cached=runs[CLI_F32_RUN]["image_ms_p50"] / np.mean(cached))
    log("cli_f32store", **{k: (f"{v:.4g}" if isinstance(v, float) else
                               "/".join(f"{x:.4g}" for x in v) if isinstance(v, list) else v)
                           for k, v in record["f32store"].items()})
    return record


# 11. refinement on the card. Each object is a displaced latitude-longitude
# sphere of n x n segments (2 n (n - 1) faces), about 150 mm across with
# per-vertex colours, written as binary PLY: SPHERE_SEGMENTS gives the
# 19,800-face meshes of the dataset (the refine CLI reads them),
# SPHERE_SEGMENTS_LARGE 99,904 faces, the top of BOP models' 10^4-10^5,
# which 11.3 and 11.4 also run (the device pack pads every mesh to the
# largest)
SPHERE_SEGMENTS = 100
SPHERE_SEGMENTS_LARGE = 224
SPHERE_RADIUS_MM = 75.0
REFINE_B = 8  # run_refinement's chunk of hypotheses
REFINE_SIZE = (160, 160)
REFINE_ITERS = 5
# renders per refine_batch: the iterations, the final score and
# keep_best_init's two renders in the init pose's crop frame
RENDERS_PER_BATCH = REFINE_ITERS + 1 + 2
# without keep_best_init: the iterations and the final score
RENDERS_NO_REFEREE = REFINE_ITERS + 1
# the rasterizer against its plain version: bit-equal (csrc/rasterizer.cu is
# built with -fmad=false and rounds as the plain version does, culls only
# the pixels its f32 error bound proves the inside test rejects, and breaks
# depth ties by the least face): hit masks, face ids, rgba, the depth's bits
# and the normals on every pixel
# the device rasterizer against the host C++ one: the JAX package's bound
# (tests/test_refiner.py:test_device_render_matches_host_render)
HOST_P99, HOST_IOU = 2.5 / 255, 0.98
# f32 operations of the rasterizer's work (csrc/rasterizer.cu): a (pixel,
# face) depth test 24 (the face's validity, two edge functions of 5, w2 2,
# three inside compares, the 1/z interpolation 5, the clamp, the reciprocal,
# the key's compare); a vertex 31 (camera transform 18, depth test,
# projection 12); a face's set-up 29; the shading of a hit pixel 93. The
# function needs the tests of each valid face at the pixel centres inside
# its screen bounding box only; the kernel makes those of its small cull
# boxes and of the row spans of its big ones (raster_work)
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
REFINE_CLI_IMAGES = 10  # the images of phase 11.5 and 18d
# 11.4's pipelined host loop: the chunk counts timed (1 is the default)
PIPELINE_CHUNKS = (1, 2, 4)
# 11.3's adversarial set: faces per kind (one mesh of 20,000 faces), seen
# at B = 8, 160 x 160 through a camera of focal length 572 px at about 0.5 m
# (about 1,100 px a metre), one view across the camera plane
ADVERSARIAL = dict(slivers=6000, needles=6000, subpixel=8000)
ADVERSARIAL_K = np.array([[572.4114, 0, 80], [0, 573.57043, 80], [0, 0, 1]], np.float32)


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
    box), those the kernel makes (the pixels of its small cull boxes and the
    row spans of its big ones, render/rasterize.py:cull_boxes_plain and
    cull_row_span), the faces it tests at the whole view and those whose
    accepting region reaches over a pixel beyond their screen box, and the
    B x H x W x F tests of the earlier brute-force design."""
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
    cull = RZ.cull_boxes_plain(verts, faces, K, T, H, W)
    box = cull["box"].long()
    side = lambda lo, hi: (box[..., hi] - box[..., lo] + 1).clamp_min(0)
    pixels = side(0, 1) * side(2, 3)
    big = pixels > RZ.CULL_SMALL_BOX
    tests_kernel = float(pixels[~big].sum())
    # each row of a big face at its columns from cull_row_span, 16,384 faces at a time
    b, f = big.nonzero(as_tuple=True)
    rows = side(2, 3)[b, f]
    for s in range(0, len(b), 1 << 14):
        sel = slice(s, s + (1 << 14))
        nr = rows[sel]
        bb, ff = b[sel].repeat_interleave(nr), f[sel].repeat_interleave(nr)
        start = torch.cumsum(nr, 0) - nr
        row = box[bb, ff, 2] + torch.arange(len(bb), device=bb.device) - start.repeat_interleave(nr)
        first, last = RZ.cull_row_span(cull["corners"][bb, ff], cull["spans"][bb, ff],
                                       box[bb, ff], row, W)
        tests_kernel += float((last - first + 1).clamp_min(0).sum())
    return dict(tests=float((span[..., 0] * span[..., 1] * valid).sum()),
                tests_kernel=tests_kernel,
                whole_faces=int(cull["whole"].sum()),
                widened_faces=int((cull["reach"] > 1).sum()),
                tests_brute=float(faces.shape[0] * faces.shape[1] * H * W))


def raster_exact(got: dict, want: dict, tag: str) -> dict:
    """The kernel's outputs against its plain version's: every one equal bit
    for bit, else the run fails; -> the pixels whose hit or face differ, the
    largest rgb step, depth ulp and normal difference (all 0)."""
    hit_g, hit_w = got["rgba"][..., 3] > 0, want["rgba"][..., 3] > 0
    same = hit_g & hit_w & (got["face_id"] == want["face_id"])
    stats = dict(mismatch=int(((hit_g != hit_w) | (hit_g & hit_w & ~same)).sum()),
                 rgb_steps=int((got["rgba"].int() - want["rgba"].int()).abs().max()),
                 depth_ulps=float(ulps(got["depth"][same], want["depth"][same]).max())
                 if same.any() else 0.0,
                 normals_max_abs_err=float((got["normals"] - want["normals"]).abs().max()))
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    equal = {k: torch.equal(bits(got[k]), bits(want[k])) for k in want}
    check(all(equal.values()) and not any(stats.values()),
          f"rasterizer {tag} differs from its plain version: {equal} {stats}")
    return stats


def raster_times(args, hits: float) -> dict:
    """11.3's timing of one rasterizer input: device time (the median of 7
    CUDA-graph replays of 10 launches, with the least and the most), each of
    its four launches' device time from torch.profiler (launch_us), the
    wrapper's time as a caller sees it, the plain version's; the bound of
    the function's work and of the kernel's own (raster_work)."""
    verts, faces, _, K, T, RH, RW = args
    (B, V), F = verts.shape[:2], faces.shape[1]
    work = raster_work(verts, faces, K, T, RH, RW)
    nbytes = B * (V * 3 * 4 * 2 + F * 3 * 4 + (9 + 16) * 4) + B * RH * RW * (4 + 4 + 12 + 4)
    fixed = RASTER_OPS["vertex"] * B * V + RASTER_OPS["face"] * B * F + RASTER_OPS["shade"] * hits
    own = bound(RASTER_OPS["test"] * work["tests_kernel"] + fixed, "f32", nbytes)
    prof = device_profile(lambda: RZ.rasterize(*args), iters=10)["kernels_us"]
    launch_us = {k: round(v, 3) for name, v in prof.items()
                 for k in ("prep", "face", "big", "resolve") if f"{k}_kernel" in name}
    return dict(**graph_stats(lambda: RZ.rasterize(*args)), launch_us=launch_us,
                wrapper_ms=cuda_ms(lambda: RZ.rasterize(*args), warmup=2, iters=7),
                plain_ms=cuda_ms(lambda: RZ.rasterize_plain(*args), warmup=1, iters=1),
                **bound(RASTER_OPS["test"] * work["tests"] + fixed, "f32", nbytes),
                bound_ms_kernel=own["bound_ms"], bound_by_kernel=own["bound_by"], **work)


def raster_case(dev, mesh_paths, store, tag: str) -> dict:
    """11.3 on one mesh set: the rasterizer kernel against its plain version
    (bit-equal) and against the host C++ renders (pixels that differ, the
    largest difference in uint8 steps, the JAX package's p99 and IoU), at
    B = 8, 160 x 160, on seeded poses seen through the refine loop's crop
    camera; raster_times."""
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
    exact = raster_exact(got, want, tag)
    hit_w = want["rgba"][..., 3] > 0
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
                 extent_min=float(extent.min()), extent_max=float(extent.max()), **exact,
                 host_diff_pixels=int((steps.max(1) > 0).sum()), host_max_steps=int(steps.max()),
                 host_mask_diff_pixels=int((mh != md).sum()),
                 host_p99=float(np.percentile(steps / 255.0, 99)), host_iou=iou)
    check(stats["host_p99"] <= HOST_P99 and iou > HOST_IOU,
          f"rasterizer {tag} against host: {stats}")
    check(0.3 <= stats["extent_min"] and stats["extent_max"] <= 0.8,
          f"the objects span {stats['extent_min']}-{stats['extent_max']} of the crops")
    rec = dict(max_abs_err=max(float(exact["rgb_steps"]), exact["normals_max_abs_err"]),
               **raster_times(args, float(hit_w.sum())), **stats)
    log("raster", mesh=tag, B=B, size=f"{RH}x{RW}",
        **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec.items()})
    return rec


def adversarial_mesh(seed: int) -> tuple:
    """11.3's adversarial mesh (metres; ADVERSARIAL faces per kind), about
    3 cm across: slivers with one edge of 1e-7-8e-7 m (1e-4-1e-3 px at
    0.5 m) and two of about 1 cm; needles, three nearly collinear vertices
    1e-7-1e-6 m off their line; sub-pixel faces of 1e-5-5e-4 m.
    -> verts (V, 3), faces (F, 3) int32, colors (V, 3) in [0, 255]."""
    rng = np.random.default_rng(seed)
    unit = lambda n: (lambda d: d / np.linalg.norm(d, axis=1, keepdims=True))(
        rng.normal(size=(n, 3)))
    n = ADVERSARIAL["slivers"]
    a = rng.normal(0, 0.02, (n, 3))
    b = a + rng.normal(0, 0.01, (n, 3))
    parts = [np.stack([a, b, b + unit(n) * rng.uniform(1e-7, 8e-7, (n, 1))], 1)]
    n = ADVERSARIAL["needles"]
    p = rng.normal(0, 0.02, (n, 3))
    q = p + rng.normal(0, 0.015, (n, 3))
    parts.append(np.stack([p, q, p + (q - p) * rng.uniform(0.1, 0.9, (n, 1))
                           + unit(n) * rng.uniform(1e-7, 1e-6, (n, 1))], 1))
    n = ADVERSARIAL["subpixel"]
    parts.append(rng.normal(0, 0.02, (n, 1, 3))
                 + rng.normal(0, 1, (n, 3, 3)) * rng.uniform(1e-5, 5e-4, (n, 1, 1)))
    verts = np.concatenate(parts).reshape(-1, 3).astype(np.float32)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return verts, faces, rng.uniform(0, 255, verts.shape).astype(np.float32)


def raster_adversarial(dev) -> dict:
    """11.3's adversarial set: adversarial_mesh at B = 8, 160 x 160, seeded
    poses at 0.45-0.6 m, view 0 moved to 1 cm in front of the camera so
    that the mesh straddles its plane: the kernel bit-equal to its plain
    version; raster_times, with the whole-view faces counted."""
    B, (RH, RW) = REFINE_B, REFINE_SIZE
    verts, faces, colors = adversarial_mesh(SEED + 15)
    T = random_poses(np.random.default_rng(SEED + 16), B)
    T[0, 2, 3] = 0.01
    rep = lambda a: torch.as_tensor(np.ascontiguousarray(np.repeat(a[None], B, 0)), device=dev)
    args = (rep(verts), rep(faces), rep(colors), rep(ADVERSARIAL_K),
            torch.as_tensor(T, device=dev), RH, RW)
    got, want = RZ.rasterize(*args), RZ.rasterize_plain(*args)
    torch.cuda.synchronize()
    exact = raster_exact(got, want, "adversarial")
    hits = float((want["rgba"][..., 3] > 0).sum())
    rec = dict(faces=int(faces.shape[0]), hit_share=hits / (B * RH * RW),
               max_abs_err=max(float(exact["rgb_steps"]), exact["normals_max_abs_err"]),
               **raster_times(args, hits), **exact)
    check(hits > 0, "the adversarial set hit no pixel")
    log("raster", mesh="adversarial", B=B, size=f"{RH}x{RW}",
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
    batch on the host clock, the host loop's phases, rasterizer launches;
    then one batch under torch.profiler: the device's busy share of it)."""
    B, host = len(args[2]), r.config.renderer == "host"
    renders = RENDERS_PER_BATCH if r.config.keep_best_init else RENDERS_NO_REFEREE
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
    check(launches == (0 if host else 3 * renders),
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
    # one more batch under the profiler: the device's busy share of it
    prof = device_profile(lambda: r.refine_batch(*args))
    rec.update(profiled_batch_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
               device_busy_share=prof["busy_share"])
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
    the referee's choice; the host loop in PIPELINE_CHUNKS chunks on both
    mesh sets against one chunk."""
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
    # the referee's own cost: the same batch without keep_best_init
    for renderer in ("host", "device"):
        _, off = time_refine(with_config(ref, renderer=renderer, keep_best_init=False), args,
                             f"{renderer}_no_referee", smi)
        on = rec[renderer]
        rec[f"{renderer}_no_referee"] = off
        log("referee", renderer=renderer, B=B, keep_best_init_ms=f"{on['batch_ms']:.4g}",
            without_ms=f"{off['batch_ms']:.4g}",
            referee_ms=f"{on['batch_ms'] - off['batch_ms']:.4g}",
            referee_share=f"{1 - off['batch_ms'] / on['batch_ms']:.4g}",
            hypotheses_per_s_on=f"{B / on['batch_ms'] * 1e3:.4g}",
            hypotheses_per_s_off=f"{B / off['batch_ms'] * 1e3:.4g}", card=repr(smi))
    large = dataclasses.replace(ref, meshes=MeshStore(large_paths, 500), _device_pack=None)
    for renderer in ("host", "device"):
        _, rec[f"{renderer}_large"] = time_refine(with_config(large, renderer=renderer), args,
                                                  f"{renderer}_large", smi)
    # the pipelined host loop at PIPELINE_CHUNKS on both mesh sets, each
    # chunking against one chunk: the same hypotheses, other batch sizes
    for tag, r in (("", ref), ("_large", large)):
        one = None
        for n in PIPELINE_CHUNKS:
            got, c = time_refine(with_config(r, renderer="host", pipeline_chunks=n), args,
                                 f"host{tag}_chunks{n}", smi)
            one = got if n == 1 else one
            c["gap_to_one_chunk"] = gap = result_gap(got, one)
            rec[f"host{tag}_chunks{n}"] = c
            log("refine_chunks", mesh="large" if tag else "dataset", chunks=n, B=B,
                batch_ms_p50=f"{c['batch_ms']:.4g}",
                device_busy_share=f"{c['device_busy_share']:.4g}",
                **{f"gap_{q}": f"{v:.4g}" for q, v in gap.items()}, card=repr(smi))
            for q in ("R", "t_mm", "score"):
                check(gap[q] <= CPU_BOUND[q],
                      f"{n} chunks against one{tag}: {gap} > {CPU_BOUND}")
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
    REFINE_CLI_IMAGES images, with the host and the device renderer, then
    the host loop in 2 chunks (refine_pipeline_chunks=2): one refined row
    per instance, each equal to one of its instance's coarse hypotheses
    (the CLI's untrained head is the identity), rasterizer launches
    RENDERS_PER_BATCH per batch of at most REFINE_B hypotheses; the chunked
    run's rows those of one chunk within CPU_BOUND."""
    coarse = bop_io.load_bop_csv(init_csv, extra_column="instance_id")
    per_image = bop_io.group_by_image(coarse, image_key="im_id")
    keys = sorted(per_image)[:REFINE_CLI_IMAGES]
    want_rows = sum(len({int(r["instance_id"]) for r in per_image[k]}) for k in keys)
    batches = sum(-(-len(per_image[k]) // REFINE_B) for k in keys)
    rec, host_rows = {}, None
    for renderer, chunks in (("host", 1), ("device", 1), ("host", 2)):
        RZ.rasterize.launches = 0
        tag = renderer if chunks == 1 else f"{renderer}_chunks{chunks}"
        save_dir = osp.join(root, "results", f"refine_{tag}")
        paths, timing = refine_cli.main([
            f"machine.root_dir={root}", "test_dataset_name=tudl", "model=large", "run_id=refine",
            f"init_loc_path={init_csv}", f"save_dir={save_dir}", "min_score=0",
            f"max_images={REFINE_CLI_IMAGES}", f"refine_renderer={renderer}",
            f"refine_pipeline_chunks={chunks}"])
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
        if chunks == 1 and renderer == "host":
            host_rows = rows
        elif chunks > 1:  # the pipelined loop writes the rows of one chunk
            check(len(rows) == len(host_rows), f"refine CLI {tag}: {len(rows)} rows, "
                  f"{len(host_rows)} in one chunk")
            for a, b in zip(rows, host_rows):
                check((a["scene_id"], a["im_id"], a["obj_id"])
                      == (b["scene_id"], b["im_id"], b["obj_id"])
                      and float(np.abs(a["R"] - b["R"]).max()) <= CPU_BOUND["R"]
                      and float(np.abs(a["t"] - b["t"]).max()) <= CPU_BOUND["t_mm"]
                      and abs(a["score"] - b["score"]) <= CPU_BOUND["score"],
                      f"refine CLI {tag}: a row differs from one chunk's")
        rec[tag] = dict(images=timing["images"], hypotheses=timing["hypotheses"],
                        rows=len(rows), image_ms_p50=float(np.percentile(ms, 50)),
                        image_ms_p90=float(np.percentile(ms, 90)),
                        images_per_s=timing["images"] / timing["run_s"],
                        hypotheses_per_s=timing["hypotheses"] / timing["run_s"],
                        run_s=timing["run_s"], batches=batches, raster_launches=launches,
                        max_gap_to_coarse=worst)
        log("refine_cli", renderer=renderer, chunks=chunks,
            **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec[tag].items()},
            card=repr(smi))
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
    rec["raster_adversarial"] = raster_adversarial(dev)
    rec["refine"] = phase_refine(dev, sets["dataset"], sets["large"], smi)
    rec["cli"] = phase_refine_cli(root, init_csv, smi)
    torch.cuda.empty_cache()
    return rec


# 12. templates from CAD models and BOP scoring. 12.1 renders every view of
# level 1 (162 at 640 x 480, TEMPLATE_K, the object at 0.4 m) of phase 11's
# two dataset meshes and of one 99,904-face mesh, with the device and the
# host renderer; 12.2 runs the port's eval_bop from CAD models to AR.
TEMPLATE_LEVEL = 1
TEMPLATE_CHECK_VIEWS = 4  # views per mesh held bit-equal to the plain version
E2E_IMAGES = 10
E2E_RUN = "e2e"


def png_sizes(rgba: np.ndarray, depth_mm: np.ndarray) -> dict:
    """Bytes and host decode ms (median of 5) of one view's RGBA and depth
    PNGs, with filter-0 rows (what render/templates.py writes) and with
    adaptive ones."""
    out = {}
    for name, img in (("rgba", rgba), ("depth", depth_mm)):
        for filt in (TP.PNG_FILTER, "adaptive"):
            data = encode_png(img, filt)
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                got = decode_png(data)
                times.append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(got, img), f"template PNG {name} {filt} round trip")
            tag = "filter0" if filt == TP.PNG_FILTER else "adaptive"
            out[f"{name}_{tag}_bytes"] = len(data)
            out[f"{name}_{tag}_decode_ms"] = float(np.median(times))
    return out


def template_case(dev, mesh: str, out_root: str, tag: str, smi) -> dict:
    """12.1 on one mesh: render_template_views_device (its rasterizer
    launches counted) and the host render_template_views, each timed as
    render and PNG encode; the written PNGs decoded back to the rendered
    arrays exactly; TEMPLATE_CHECK_VIEWS views (those beside each cut
    between launches first) bit-equal to the plain version; the pixels where
    the device and host renders differ; each launch's device time and the
    bound of the function's work (raster_work) over the stack, the mesh
    counted once a launch (the launch takes it expanded, not copied)."""
    verts, faces, colors = load_mesh(mesh)
    colors = (np.full((len(verts), 3), TP.DEFAULT_COLOR, np.uint8) if colors is None
              else colors).astype(np.float32)
    unit = TP.mm_per_unit(mesh_diameter(verts))
    poses = TP.template_poses(TEMPLATE_LEVEL).astype(np.float32)
    poses[:, :3, 3] /= unit
    N, (V, F) = len(poses), (len(verts), len(faces))
    per_launch = RZ.views_per_launch(F, H, W, V)
    n_launches = -(-N // per_launch)
    rec = dict(faces=F, vertices=V, views=N, views_per_launch=per_launch)
    for renderer in ("device", "native"):
        out_dir = osp.join(out_root, f"{tag}_{renderer}")
        timing = {}
        RZ.rasterize.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if renderer == "device":
            n = TP.render_template_views_device(mesh, out_dir, level=TEMPLATE_LEVEL, device=dev,
                                                timing=timing)
        else:
            n = TR.render_template_views(mesh, out_dir, level=TEMPLATE_LEVEL, timing=timing)
        total = time.perf_counter() - t0
        launches = RZ.rasterize.launches
        want = n_launches if renderer == "device" else 0
        check(n == N and launches == want and timing.get("launches", 0) == want,
              f"templates {tag} {renderer}: {n} views, {launches} launches, {want} expected")
        rec[renderer] = dict(s=total, render_s=timing["render_s"], encode_s=timing["encode_s"],
                             launches=launches, dir_bytes=sum(
                                 osp.getsize(osp.join(out_dir, f)) for f in os.listdir(out_dir)))
    # the device stack again (the kernel is deterministic), its files decoded back
    rgba, depth = TP.render_view_stack(verts, faces, colors, TP.TEMPLATE_K, poses, H, W, dev)
    read = lambda d, name: decode_png(open(osp.join(out_root, d, name), "rb").read())
    native_rgba, native_depth = [], []
    for v in range(N):
        check(np.array_equal(read(f"{tag}_device", f"{v:06d}.png"), rgba[v]) and
              np.array_equal(read(f"{tag}_device", f"{v:06d}_depth.png"),
                             TP.depth_mm_u16(depth[v], unit)),
              f"templates {tag}: view {v}'s PNGs do not decode to the rendered arrays")
        native_rgba.append(read(f"{tag}_native", f"{v:06d}.png"))
        native_depth.append(read(f"{tag}_native", f"{v:06d}_depth.png"))
    native_rgba, native_depth = np.stack(native_rgba), np.stack(native_depth)
    # bit-equal to the plain version at the views beside each cut, then spread out
    cuts = [v for c in range(per_launch, N, per_launch) for v in (c - 1, c)]
    sel = sorted(set(cuts[:TEMPLATE_CHECK_VIEWS]) | set(
        np.linspace(0, N - 1, TEMPLATE_CHECK_VIEWS).astype(int).tolist()))[:TEMPLATE_CHECK_VIEWS]
    # one mesh expanded over the views, as render_view_stack gives it; K copied
    mesh = lambda a, b: torch.as_tensor(a, device=dev)[None].expand(b, *a.shape)
    put = lambda a, b: mesh(a, b).contiguous()
    args = (mesh(verts, len(sel)), mesh(faces, len(sel)), mesh(colors, len(sel)),
            put(TP.TEMPLATE_K, len(sel)), torch.as_tensor(poses[sel], device=dev), H, W)
    got, want = RZ.rasterize(*args), RZ.rasterize_plain(*args)
    torch.cuda.synchronize()
    exact = raster_exact(got, want, f"templates {tag}")
    check(np.array_equal(rgba[sel], want["rgba"].cpu().numpy()) and np.array_equal(
        depth[sel].view(np.int32), want["depth"].cpu().numpy().view(np.int32)),
          f"templates {tag}: the stack's views {sel} differ from the plain version")
    # the device renders against the host renders, as 11.3 counts them
    steps = np.abs(rgba[..., :3].astype(np.int32) - native_rgba[..., :3]).max(-1)
    mask_d, mask_h = rgba[..., 3] > 0, native_rgba[..., 3] > 0
    depth_d = TP.depth_mm_u16(depth, unit).astype(np.int32)
    both = mask_d & mask_h
    rec.update(checked_views=sel, **exact, hit_pixels=int(mask_d.sum()),
               host_diff_pixels=int(((steps > 0) | (mask_d != mask_h)).sum()),
               host_mask_diff_pixels=int((mask_d != mask_h).sum()),
               host_max_steps=int(steps[both].max(initial=0)),
               host_depth_diff_pixels=int((depth_d != native_depth)[both].sum()),
               host_depth_max_mm=int(np.abs(depth_d - native_depth)[both].max(initial=0)))
    # device time per launch shape, and the bound of the function's work
    launch_ms, bound_ms, tests = [], [], 0.0
    for s in range(0, N, per_launch):
        b = min(per_launch, N - s)
        args = (mesh(verts, b), mesh(faces, b), mesh(colors, b), put(TP.TEMPLATE_K, b),
                torch.as_tensor(poses[s:s + b], device=dev), H, W)
        launch_ms.append(cuda_ms(lambda: RZ.rasterize(*args), warmup=1, iters=3))
        work = raster_work(*args[:2], args[3], args[4], H, W)
        hits = float(mask_d[s:s + b].sum())
        # the one mesh read once, each view's K and T, each view's outputs
        nbytes = V * 3 * 4 * 2 + F * 3 * 4 + b * (9 + 16) * 4 + b * H * W * (4 + 4 + 12 + 4)
        fixed = RASTER_OPS["vertex"] * b * V + RASTER_OPS["face"] * b * F \
            + RASTER_OPS["shade"] * hits
        bound_ms.append(bound(RASTER_OPS["test"] * work["tests"] + fixed, "f32", nbytes))
        tests += work["tests"]
        del args
    rec.update(launch_ms=launch_ms, ms=float(sum(launch_ms)),
               bound_ms=float(sum(b["bound_ms"] for b in bound_ms)),
               bound_by=bound_ms[0]["bound_by"], tests=tests,
               plain_ms_per_view=cuda_ms(lambda: RZ.rasterize_plain(
                   put(verts, 1), put(faces, 1), put(colors, 1), put(TP.TEMPLATE_K, 1),
                   torch.as_tensor(poses[:1], device=dev), H, W), warmup=0, iters=1),
               png=png_sizes(rgba[0], TP.depth_mm_u16(depth[0], unit)))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log("templates", mesh=tag, **{k: (f"{v:.4g}" if isinstance(v, float) else
                                      repr(v).replace(" ", "") if isinstance(v, (dict, list))
                                      else v) for k, v in rec.items()}, card=repr(smi))
    torch.cuda.empty_cache()
    return rec


def write_e2e_dataset(root: str, mesh_paths: dict, rng) -> dict:
    """12.2's BOP dataset tudl under root/datasets: the meshes in models/
    and no template set; E2E_IMAGES 480x640 test images, each with both
    objects at seeded poses (random rotations, 0.48-0.6 m away, one on each
    side of the optical axis), rendered by the host rasterizer and composed
    by depth on a noise background: RGB (adaptive PNG), depth (uint16 mm),
    scene_gt, scene_gt_info, camera; CNOS detections from the render masks,
    the localization targets. -> {(im_id, obj_id): (R, t mm)}."""
    ds = osp.join(root, "datasets", "tudl")
    models, sdir = osp.join(ds, "models"), osp.join(ds, "test", "000001")
    for sub in ("rgb", "depth"):
        os.makedirs(osp.join(sdir, sub))
    os.makedirs(models)
    rasters = {}
    for obj, path in sorted(mesh_paths.items()):
        shutil.copy(path, osp.join(models, f"obj_{obj:06d}.ply"))
        rasters[obj] = Rasterizer(path)
    K = TP.TEMPLATE_K
    cams, gts, infos, dets, targets, poses = {}, {}, {}, [], [], {}
    for im in range(E2E_IMAGES):
        T = random_poses(rng, len(rasters))
        rgb = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
        zbuf = np.zeros((H, W), np.float32)
        owner = np.zeros((H, W), np.int32)
        renders = {}
        for k, obj in enumerate(sorted(rasters)):
            T[k, :3, 3] *= 1000.0  # mm, the meshes' unit
            T[k, 0, 3] = (-1) ** k * rng.uniform(90, 110)
            poses[(im, obj)] = (T[k, :3, :3].astype(np.float64), T[k, :3, 3].astype(np.float64))
            rgba, depth = rasters[obj].render(K, T[k], W, H)
            renders[obj] = depth > 0
            win = (depth > 0) & ((zbuf == 0) | (depth < zbuf))
            zbuf[win], owner[win], rgb[win] = depth[win], obj, rgba[win][:, :3]
        cams[str(im)] = {"cam_K": K.reshape(-1).tolist(), "depth_scale": 1.0}
        gts[str(im)], infos[str(im)] = [], []
        for obj in sorted(rasters):
            mask = owner == obj
            ys, xs = np.nonzero(mask)
            box = [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                   int(ys.max() - ys.min() + 1)]
            R, t = poses[(im, obj)]
            gts[str(im)].append({"obj_id": obj, "cam_R_m2c": R.reshape(-1).tolist(),
                                 "cam_t_m2c": t.tolist()})
            infos[str(im)].append({"bbox_visib": box,
                                   "visib_fract": float(mask.sum() / renders[obj].sum())})
            dets.append({"scene_id": 1, "image_id": im, "category_id": obj, "score": 0.9,
                         "bbox": box, "segmentation": bop_io.rle_encode(mask.astype(np.uint8)),
                         "time": 0.1})
            targets.append({"scene_id": 1, "im_id": im, "obj_id": obj, "inst_count": 1})
        with open(osp.join(sdir, "rgb", f"{im:06d}.png"), "wb") as f:
            f.write(encode_png(rgb, "adaptive"))
        with open(osp.join(sdir, "depth", f"{im:06d}.png"), "wb") as f:
            f.write(encode_png(np.clip(zbuf, 0, 65535).astype(np.uint16), "adaptive"))
    for name, data in (("scene_camera", cams), ("scene_gt", gts), ("scene_gt_info", infos)):
        bop_io.save_json(osp.join(sdir, f"{name}.json"), data)
    det_dir = osp.join(root, "datasets", "default_detections", "core19_model_based_unseen",
                       "cnos-fastsam")
    os.makedirs(det_dir)
    bop_io.save_json(osp.join(det_dir, "cnos-fastsam_tudl-test_chip_smoke.json"), dets)
    bop_io.save_json(osp.join(ds, "test_targets_bop19.json"), targets)
    return poses


def score_card_and_host(dev, root: str, gt: dict) -> dict:
    """The ground truth perturbed by seeded rotations of 2-20 degrees and
    offsets of 2-30 mm, scored on the card and on the host: AR strictly
    between 0 and 1 on MSSD and MSPD, the ARs equal within 1e-9, and each
    pair's MSSD and MSPD, on the scorer's own points and symmetries, equal
    within rtol 1e-5."""
    rng = np.random.default_rng(SEED + 31)
    rows = []
    for (im, obj), (R, t) in sorted(gt.items()):
        axis, dt = rng.normal(size=3), rng.normal(size=3)
        dR = SC._axis_angle(axis / np.linalg.norm(axis), np.deg2rad(rng.uniform(2, 20)))
        rows.append(dict(scene_id=1, im_id=im, obj_id=obj, score=1.0, R=dR @ R,
                         t=t + dt / np.linalg.norm(dt) * rng.uniform(2, 30), time=-1))
    csv = osp.join(root, "perturbed.csv")
    bop_io.save_bop_csv(csv, rows)
    timing = {}
    card = score_bop(csv, root, "tudl", device=dev, timing=timing)
    host = score_bop(csv, root, "tudl", device="cpu")
    keys = [f"bop19_average_recall{e}" for e in ("", "_vsd", "_mssd", "_mspd")]
    check(all(abs(card[k] - host[k]) <= 1e-9 for k in keys) and
          all(0 < card[f"bop19_average_recall_{e}"] < 1 for e in ("mssd", "mspd")),
          f"the perturbed csv scores {card} on the card, {host} on the host")
    models = osp.join(root, "datasets", "tudl", "models")
    info, geo = SC.load_models_info(models), {}
    for obj in {obj for _, obj in gt}:
        pts, _ = SC._load_vertices_mm(osp.join(models, f"obj_{obj:06d}.ply"))
        pts = pts[np.linspace(0, len(pts) - 1, min(len(pts), 2000)).astype(int)]
        geo[obj] = (pts, *SC.symmetry_set(info[obj], pts))
    rel = 0.0
    for r in bop_io.load_bop_csv(csv):
        R_g, t_g = gt[(r["im_id"], r["obj_id"])]
        pts, sym_R, sym_t = geo[r["obj_id"]]
        args = (r["R"], r["t"].reshape(3), R_g, t_g, pts)
        for fn, extra in ((EV.mssd_error, ()), (EV.mspd_error, (TP.TEMPLATE_K,))):
            a, b = (fn(*args, *extra, sym_R, sym_t, device=d) for d in (dev, "cpu"))
            rel = max(rel, abs(a - b) / abs(b))
    check(rel <= 1e-5, f"the perturbed pairs' MSSD / MSPD differ by {rel:.3g} (relative) "
          "between the card and the host")
    return dict(perturbed_ar=card["bop19_average_recall"],
                perturbed_ar_mssd=card["bop19_average_recall_mssd"],
                perturbed_ar_mspd=card["bop19_average_recall_mspd"],
                perturbed_ar_vsd=card["bop19_average_recall_vsd"], perturbed_pair_rel_err=rel,
                perturbed_score_s_per_image=timing["seconds"] / timing["images"])


def phase_eval_bop(dev, mesh_paths: dict, root: str, smi) -> dict:
    """12.2: write_e2e_dataset, then the port's eval_bop.main (int8 AE,
    refine=true, templates and refinement on the device renderer, min_score
    0) with every kernel count set to 0 just before it and read just after:
    every kernel of the path launched, the template set rendered from the
    meshes, the csvs, AR from the port's scorer; then a csv of the ground
    truth scored on the card (AR 1.0 on VSD, MSSD and MSPD), the pipeline's
    csv scored again, timed per image, and score_card_and_host. The
    rasterizer's launches are read around the template render and checked
    apart from refinement's."""
    rng = np.random.default_rng(SEED + 30)
    t0 = time.perf_counter()
    gt = write_e2e_dataset(root, mesh_paths, rng)
    write_s = time.perf_counter() - t0
    # the rasterizer's launches inside the coarse CLI's template render, read
    # around the call to render_templates.main that it makes
    render_main, template_launches = RT.main, []

    def counted_render(argv):
        before = RZ.rasterize.launches
        out = render_main(argv)
        template_launches.append(RZ.rasterize.launches - before)
        return out

    reset_counts()
    RZ.rasterize.launches = 0
    RT.main = counted_render
    t0 = time.perf_counter()
    try:
        result = eval_bop.main([f"machine.root_dir={root}", "datasets=tudl",
                                f"run_id={E2E_RUN}", "refine=true", "model=large",
                                "model.serving_quant=int8", "refine_renderer=device",
                                "min_score=0"])
        torch.cuda.synchronize()
    finally:
        RT.main = render_main
    run_s = time.perf_counter() - t0
    launched, raster_launches = counts(), RZ.rasterize.launches
    check(len(template_launches) == 1, f"eval_bop: {len(template_launches)} template renders")
    template_launches = template_launches[0]
    refine_launches = raster_launches - template_launches
    res = result["tudl"]
    check(res["status"] == "csv_written" and "score_predictions_refined" in res,
          f"eval_bop: {res}")
    tdir = osp.join(root, "datasets", "templates", "tudl")
    n_views = len(template_object_poses(TEMPLATE_LEVEL))
    for obj in mesh_paths:
        pngs = [f for f in os.listdir(osp.join(tdir, f"{obj:06d}")) if f.endswith(".png")]
        check(len(pngs) == 2 * n_views and np.load(osp.join(
            tdir, "object_poses", f"{obj:06d}.npy")).shape == (n_views, 4, 4),
              f"eval_bop: object {obj}'s rendered template set")
    pred = osp.join(root, "results", f"large_{E2E_RUN}")
    name = f"large-pbrreal-rgb-mmodel_tudl-test_{E2E_RUN}"
    multi = bop_io.load_bop_csv(osp.join(pred, "predictions", name + "MultiHypothesis.csv"),
                                extra_column="instance_id")
    refined_csv = [osp.join(pred, "predictions_refined", f)
                   for f in os.listdir(osp.join(pred, "predictions_refined"))
                   if f.endswith(".csv") and "MultiHypothesis" not in f][0]
    rows = bop_io.load_bop_csv(refined_csv)
    check(len(rows) == len(gt) and all(np.isfinite(r["t"]).all() for r in rows),
          f"eval_bop: {len(rows)} refined rows for {len(gt)} instances")
    per_image = bop_io.group_by_image(multi, image_key="im_id")
    batches = sum(-(-len(v) // REFINE_B) for v in per_image.values())
    sizes = [(len(f), len(v)) for v, f, _ in map(load_mesh, mesh_paths.values())]
    want = sum(-(-n_views // RZ.views_per_launch(F, H, W, V)) for F, V in sizes)
    check(template_launches == want,
          f"eval_bop: {template_launches} rasterizer launches rendering templates, {want} expected")
    check(refine_launches == RENDERS_PER_BATCH * batches,
          f"eval_bop: {refine_launches} rasterizer launches refining, "
          f"{RENDERS_PER_BATCH} x {batches} expected")
    missing = [k for k in ("match_bf16", "attention_core", "gemm_bf16", "gemm_gelu",
                           "gemm_residual", "row_prologue") if launched[k] == 0]
    check(not missing, f"eval_bop: kernels of the path never launched: {missing}")
    # the ground truth as a csv, scored on the card; the pipeline's csv again, timed
    gt_csv = osp.join(root, "gt.csv")
    bop_io.save_bop_csv(gt_csv, [dict(scene_id=1, im_id=im, obj_id=obj, score=1.0, R=R, t=t,
                                      time=-1) for (im, obj), (R, t) in sorted(gt.items())])
    gt_timing, run_timing = {}, {}
    gt_score = score_bop(gt_csv, root, "tudl", device=dev, timing=gt_timing)
    check(all(gt_score[f"bop19_average_recall_{e}"] == 1.0 for e in ("vsd", "mssd", "mspd")),
          f"the ground truth scores {gt_score}")
    again = score_bop(refined_csv, root, "tudl", device=dev, timing=run_timing)
    check(again == res["score_predictions_refined"], "scoring the refined csv twice differs")
    perturbed = score_card_and_host(dev, root, gt)
    rec = dict(images=E2E_IMAGES, instances=len(gt), write_s=write_s, run_s=run_s,
               hypotheses=len(multi), batches=batches, raster_launches=raster_launches,
               template_launches=template_launches, refine_launches=refine_launches,
               launches=launched, **perturbed,
               ar=res["score_predictions_refined"]["bop19_average_recall"],
               ar_vsd=res["score_predictions_refined"]["bop19_average_recall_vsd"],
               ar_mssd=res["score_predictions_refined"]["bop19_average_recall_mssd"],
               ar_mspd=res["score_predictions_refined"]["bop19_average_recall_mspd"],
               gt_ar=gt_score["bop19_average_recall"],
               score_s_per_image=run_timing["seconds"] / run_timing["images"],
               gt_score_s_per_image=gt_timing["seconds"] / gt_timing["images"])
    log("eval_bop", **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec.items()
                       if k != "launches"}, launches=repr(launched).replace(" ", ""),
        card=repr(smi))
    return rec


def phase_templates(root: str, dev, smi) -> dict:
    """12. Templates from CAD models and BOP scoring, beside phase 10's
    dataset: 12.1 on phase 11's meshes (the dataset's two and one of the
    99,904-face ones), 12.2 in a second dataset under root/e2e."""
    models = osp.join(root, "datasets", "tudl", "models")
    meshes = {"dataset_1": osp.join(models, "obj_000001.ply"),
              "dataset_2": osp.join(models, "obj_000002.ply"),
              "large_1": osp.join(root, "large", "obj_000001.ply")}
    out_root = osp.join(root, "template_renders")
    rec = {tag: template_case(dev, path, out_root, tag, smi) for tag, path in meshes.items()}
    shutil.rmtree(out_root)
    rec["eval_bop"] = phase_eval_bop(dev, {1: meshes["dataset_1"], 2: meshes["dataset_2"]},
                                     osp.join(root, "e2e"), smi)
    return rec


# 13. training on the card: gigapose_tpu_torch.train at model=large (ViT-L/14
# AE, the ResNet IST with descriptor 256, f32 parameters and compute, TF32
# off) on a train_pbr split rendered from phase 11's meshes beside 12.2's
# dataset, with 12.2's level-1 template sets; then the card against the
# host, a resume, and the coarse CLI serving the trained checkpoint.
TRAIN_IMAGES, VAL_IMAGES = 40, 10  # 480 x 640, both objects in each
TRAIN_B = 12  # machine.batch_size of the train config (the reference's local.yaml)
TRAIN_STEPS, TRAIN_EVERY = 12, 6  # max_steps; checkpoint_every and val_every
TRAIN_RUN = "train"
TRAIN_JPG_STEPS = 5  # 13.6: max_steps from the JPEG shards
PARITY_B, PARITY_STEPS, PARITY_WARM = 2, 3, 2
SERVE_IMAGES = 20  # phase 10's first images, served from the trained checkpoint
# 13.3, the card against the host after PARITY_STEPS steps from one init
# with warm-up 2 (lr 0, half, full): losses within PARITY_LOSS_RTOL; every
# parameter within 2 x its net's summed lr and all but PARITY_FAR_SHARE of
# them within a tenth of it (Adam moves every entry by about lr, so one
# whose gradient is within the two devices' rounding of 0 may move either
# way; tests/test_torch_train_step.py; the IST's BatchNorm over a batch of
# 2 makes its backbone gradient ill-conditioned: 2.8 % of its entries moved
# apart on an H100, PERF.md); the BatchNorm statistics within PARITY_STATS_ATOL
PARITY_LOSS_RTOL, PARITY_FAR_SHARE, PARITY_STATS_ATOL = 1e-3, 0.05, 1e-3


def write_train_split(ds: str, split: str, mesh_paths: dict, n_images: int, rng) -> int:
    """A BOP split <ds>/<split>/000001 of n_images 480x640 images, each with
    both objects at seeded poses (random rotations, 0.48-0.6 m away, one on
    each side of the optical axis), host renders composed by depth on a
    noise background: rgb and uint16-mm depth PNGs and a mask_visib PNG per
    instance (adaptive rows), scene_camera, scene_gt, scene_gt_info. -> the
    instances written."""
    sdir = osp.join(ds, split, "000001")
    for sub in ("rgb", "depth", "mask_visib"):
        os.makedirs(osp.join(sdir, sub))
    rasters = {obj: Rasterizer(path) for obj, path in sorted(mesh_paths.items())}
    K = TP.TEMPLATE_K
    cams, gts, infos, n = {}, {}, {}, 0
    for im in range(n_images):
        T = random_poses(rng, len(rasters))
        rgb = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
        zbuf = np.zeros((H, W), np.float32)
        owner = np.zeros((H, W), np.int32)
        full = {}
        for k, obj in enumerate(sorted(rasters)):
            T[k, :3, 3] *= 1000.0  # mm, the meshes' unit
            T[k, 0, 3] = (-1) ** k * rng.uniform(90, 110)
            rgba, depth = rasters[obj].render(K, T[k], W, H)
            full[obj] = depth > 0
            win = (depth > 0) & ((zbuf == 0) | (depth < zbuf))
            zbuf[win], owner[win], rgb[win] = depth[win], obj, rgba[win][:, :3]
        cams[str(im)] = {"cam_K": K.reshape(-1).tolist(), "depth_scale": 1.0}
        gts[str(im)], infos[str(im)] = [], []
        for i, obj in enumerate(sorted(rasters)):
            mask = owner == obj
            ys, xs = np.nonzero(mask)
            gts[str(im)].append({"obj_id": obj, "cam_R_m2c": T[i, :3, :3].reshape(-1).tolist(),
                                 "cam_t_m2c": T[i, :3, 3].tolist()})
            infos[str(im)].append({"bbox_visib": [int(xs.min()), int(ys.min()),
                                                  int(xs.max() - xs.min() + 1),
                                                  int(ys.max() - ys.min() + 1)],
                                   "visib_fract": float(mask.sum() / full[obj].sum())})
            with open(osp.join(sdir, "mask_visib", f"{im:06d}_{i:06d}.png"), "wb") as f:
                f.write(encode_png(mask.astype(np.uint8) * 255, "adaptive"))
            n += 1
        with open(osp.join(sdir, "rgb", f"{im:06d}.png"), "wb") as f:
            f.write(encode_png(rgb, "adaptive"))
        with open(osp.join(sdir, "depth", f"{im:06d}.png"), "wb") as f:
            f.write(encode_png(np.clip(zbuf, 0, 65535).astype(np.uint16), "adaptive"))
    for name, data in (("scene_camera", cams), ("scene_gt", gts), ("scene_gt_info", infos)):
        bop_io.save_json(osp.join(sdir, f"{name}.json"), data)
    return n


def train_step_work(ae, ist, B: int, dev) -> dict:
    """The f32 work of one training step of B pairs, counted from the nets:
    the multiply-adds of every convolution and linear layer in one forward
    of one crop (forward hooks on a call at B = 1: output elements x inputs
    per output, x 2) and the AE's attention products (QK^T and AV: 4 x depth
    x heads x N^2 x head width); each net runs on 2B crops (src and tar),
    the backward costs twice the forward. Bytes: each parameter, its
    gradient and both Adam moments read and written once, and the 2B crops
    read. -> per-crop forward GFLOP of each net, step TFLOP, the bound."""
    x = torch.zeros(1, 3, 224, 224, device=dev)

    def forward_flops(net, call) -> float:
        total = [0.0]

        def hook(m, inp, out):
            per_out = (m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
                       if isinstance(m, torch.nn.Conv2d) else m.in_features)
            total[0] += 2.0 * out.numel() * per_out

        handles = [m.register_forward_hook(hook) for m in net.modules()
                   if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
        try:
            with torch.no_grad():
                call()
        finally:
            for h in handles:
                h.remove()
        return total[0]

    training = {net: net.training for net in (ae, ist)}
    ae.eval(), ist.eval()
    c = ae.vit.cfg
    per_crop = {"ae": forward_flops(ae, lambda: ae(x))
                + 4.0 * c.depth * c.num_heads * TOKENS * TOKENS * (c.embed_dim // c.num_heads),
                "ist": forward_flops(ist, lambda: ist.backbone(x))}
    ae.train(training[ae]), ist.train(training[ist])
    step_ops = 3 * 2 * B * (per_crop["ae"] + per_crop["ist"])
    params = sum(p.numel() for net in (ae, ist) for p in net.parameters())
    nbytes = 4.0 * params * 8 + 2 * B * 3 * 224 * 224 * 4
    return dict(fwd_gflop_per_crop={k: v / 1e9 for k, v in per_crop.items()},
                step_tflop=step_ops / 1e12, params=params, **bound(step_ops, "f32", nbytes))


def _state_copy(state) -> dict:
    return {net: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for net, m in state.nets.items()}


def phase_train_run(e2e_root: str, dev, smi) -> dict:
    """13.2: train.main at model=large, machine.batch_size TRAIN_B, TRAIN_STEPS
    steps, checkpoints and validation every TRAIN_EVERY, on the card; each
    step's host time to a synchronize and its wait on the loader (fit's
    timing), peak memory, the state after step 1 (a wrapper of the loop's
    train_step). Checks: no hand-written kernel launched, every logged loss
    finite, metrics.jsonl with total and val/matching, every parameter with
    a gradient and every BatchNorm statistic moved between step 1 and the
    last. Then 4 more steps of held batches, 3 of them under torch.profiler
    (the device's busy share without the loader), and the step's bound."""
    from gigapose_tpu_torch import train as train_cli
    from gigapose_tpu_torch.training import loop as TLOOP

    timing, first = {}, {}
    fit_orig, step_orig = train_cli.fit, TLOOP.train_step

    def fit_timed(*args, **kw):
        return fit_orig(*args, timing=timing, **kw)

    def step_kept(state, batch, *args):
        out = step_orig(state, batch, *args)
        if state.step == 1:
            first.update(_state_copy(state))
        return out

    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    train_cli.fit, TLOOP.train_step = fit_timed, step_kept
    t0 = time.perf_counter()
    try:
        state = train_cli.main([f"machine.root_dir={e2e_root}", "train_dataset_name=tudl",
                                "model=large", f"machine.batch_size={TRAIN_B}",
                                f"max_steps={TRAIN_STEPS}", f"checkpoint_every={TRAIN_EVERY}",
                                f"val_every={TRAIN_EVERY}", "val_dataset_name=tudl",
                                "val_split=val", "log_every=1", f"run_id={TRAIN_RUN}"])
        torch.cuda.synchronize()
    finally:
        train_cli.fit, TLOOP.train_step = fit_orig, step_orig
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launched = counts()
    check(not any(launched.values()), f"training launched hand-written kernels: {launched}")
    check(state.step == TRAIN_STEPS and len(timing["step_s"]) == TRAIN_STEPS,
          f"training stopped at step {state.step}")
    save_dir = osp.join(e2e_root, "results", f"large_{TRAIN_RUN}")
    with open(osp.join(save_dir, "logs", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    train_lines = [m for m in lines if "total" in m]
    check(len(train_lines) == TRAIN_STEPS and any("val/matching" in m for m in lines),
          f"metrics.jsonl: {len(train_lines)} step lines, validation "
          f"{any('val/matching' in m for m in lines)}")
    check(all(np.isfinite(v) for m in lines for v in m.values()), "a logged metric is not finite")
    last = _state_copy(state)
    stuck = [f"{net}.{k}" for net in last for k, v in last[net].items()
             if not k.endswith("num_batches_tracked") and not k.startswith("vit.norm.")
             and torch.equal(v, first[net][k])]
    # vit.norm (the final LayerNorm) lies after x_prenorm: no gradient, and
    # its decay (lr x wd x p) stays below an ulp
    check(not stuck, f"not moved between step 1 and step {TRAIN_STEPS}: {stuck}")

    steps = np.array(timing["step_s"][1:])  # the first step warms cuBLAS / cuDNN up
    waits = np.array(timing["wait_s"][1:])
    held = iter(_held_batches(e2e_root, SEED + 42, TRAIN_B, 4))
    prof = device_profile(lambda: train_step(state, prepare_train_batch(next(held), dev)), iters=3)
    work = train_step_work(state.ae_net, state.ist_net, TRAIN_B, dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    rec = dict(steps=TRAIN_STEPS, batch=TRAIN_B, run_s=run_s, first_step_s=timing["step_s"][0],
               step_s_p50=float(np.median(steps)), step_s_p90=float(np.percentile(steps, 90)),
               pairs_per_s=TRAIN_B / float(np.median(steps)),
               wait_s_mean=float(waits.mean()), wait_s_p50=float(np.median(waits)),
               wait_share=float(waits.sum() / steps.sum()),
               held_step_ms=prof["wall_ms"], held_busy_ms=prof["busy_ms"],
               busy_share=prof["busy_share"], peak_gib=peak / 2**30, peak_share=peak / total,
               final_total=train_lines[-1]["total"], **work,
               ckpt_dir=osp.join(save_dir, "checkpoints"))
    top = sorted(prof["kernels_us"].items(), key=lambda kv: -kv[1])[:12]
    rec["top_kernels_ms"] = {name[:60]: us / 1e3 for name, us in top}
    log("train_kernels", **{f"k{i}": f"{us / 1e3:.2f}ms:{name[:60].replace(' ', '')}"
                            for i, (name, us) in enumerate(top)})
    log("train", **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec.items()
                    if k not in ("fwd_gflop_per_crop", "ckpt_dir", "top_kernels_ms")},
        fwd_gflop_per_crop=repr({k: round(v, 2) for k, v in work["fwd_gflop_per_crop"].items()})
        .replace(" ", ""), card=repr(smi))
    del state
    torch.cuda.empty_cache()
    return rec


def _train_loader(e2e_root: str, seed: int, batch: int) -> TrainLoader:
    return TrainLoader(
        scene_source=DirSceneSource(osp.join(e2e_root, "datasets", "tudl", "train_pbr")),
        template_dir=osp.join(e2e_root, "datasets", "templates", "tudl"), batch_size=batch,
        seed=seed)


def _held_batches(e2e_root: str, seed: int, batch: int, n: int) -> list:
    return [r for _, r in zip(range(n), _train_loader(e2e_root, seed, batch))]


def phase_train_parity(e2e_root: str, nets, dev) -> dict:
    """13.3: the same init and the same PARITY_STEPS batches of PARITY_B at
    full width, TF32 off, through train_step on the card and on the host
    CPU: each step's losses, then the parameters and BatchNorm statistics
    (tolerances above)."""
    recs = _held_batches(e2e_root, SEED + 43, PARITY_B, PARITY_STEPS)
    cfg = OptimConfig(warm_up_steps=PARITY_WARM)
    runs = []
    for where in (dev, torch.device("cpu")):
        state = TrainState(copy.deepcopy(nets[0]).to(where), copy.deepcopy(nets[1]).to(where), cfg)
        t0 = time.perf_counter()
        losses = [{k: float(v) for k, v in train_step(state, prepare_train_batch(r, where)).items()}
                  for r in recs]
        runs.append((state, losses, time.perf_counter() - t0))
    (card, card_losses, card_s), (host, host_losses, host_s) = runs
    loss_gap = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                   for a, b in zip(card_losses, host_losses) for k in b)
    check(loss_gap <= PARITY_LOSS_RTOL and all(np.isfinite(v) for m in card_losses
                                                  for v in m.values()),
          f"card and host losses {loss_gap:.3g} apart (relative)")
    lr_sum = {"ae": cfg.ae_lr * 1.5, "ist": cfg.ist_lr * 1.5}  # lr 0, 1/2, 1
    rec = dict(steps=PARITY_STEPS, batch=PARITY_B, loss_rel_gap=loss_gap, card_s=card_s,
               host_s=host_s)
    for net in ("ae", "ist"):
        a, b = card.nets[net].state_dict(), host.nets[net].state_dict()
        worst, far, n, stats = 0.0, 0, 0, 0.0
        for k, v in b.items():
            d = (a[k].cpu().double() - v.double()).abs()
            if k.endswith(("running_mean", "running_var")):
                stats = max(stats, float(d.max()))
            elif not k.endswith("num_batches_tracked"):
                worst = max(worst, float(d.max()))
                far += int((d > 0.1 * lr_sum[net]).sum())
                n += d.numel()
        check(worst <= 2 * lr_sum[net] and far <= PARITY_FAR_SHARE * n
              and stats <= PARITY_STATS_ATOL,
              f"{net}: card and host parameters {worst:.3g} apart ({far} of {n} beyond "
              f"{0.1 * lr_sum[net]:.3g}), statistics {stats:.3g}")
        rec[f"{net}_param_max_gap"], rec[f"{net}_far_share"] = worst, far / n
        if net == "ist":
            rec["ist_stats_max_gap"] = stats
    log("train_parity", **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec.items()})
    del card, host, runs
    torch.cuda.empty_cache()
    return rec


def phase_train_resume(e2e_root: str, nets, dev, tmp: str) -> dict:
    """13.4: 2 steps with a checkpoint, then a resume for 1 more, against 3
    steps straight on the card, with deterministic algorithms (cuDNN's and
    the gathers' backward): equal bit for bit (parameters, BatchNorm
    statistics, Adam moments, the last step's metrics)."""
    cfg = OptimConfig(warm_up_steps=PARITY_WARM)

    def run(max_steps, ckpt_dir, resume=False):
        metrics = {}
        state = fit(copy.deepcopy(nets[0]), copy.deepcopy(nets[1]),
                    _train_loader(e2e_root, SEED + 44, PARITY_B), dev, cfg,
                    FitConfig(max_steps=max_steps, log_every=1, checkpoint_every=2,
                              ckpt_dir=ckpt_dir),
                    metrics_hook=lambda step, m: metrics.setdefault(step, m), resume=resume)
        return state, metrics

    was_det, was_cudnn = (torch.are_deterministic_algorithms_enabled(),
                          torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        straight, m_straight = run(PARITY_STEPS, None)
        run(PARITY_STEPS - 1, osp.join(tmp, "resumed"))
        resumed, m_resumed = run(PARITY_STEPS, osp.join(tmp, "resumed"), resume=True)
    finally:
        torch.use_deterministic_algorithms(was_det)
        torch.backends.cudnn.deterministic = was_cudnn
    gaps = {}
    for net in ("ae", "ist"):
        a, b = straight.nets[net].state_dict(), resumed.nets[net].state_dict()
        gaps[net] = max(float((a[k].double() - b[k].double()).abs().max()) for k in a)
        for m in ("mu", "nu"):
            sa, sb = straight.opt_state[net][m], resumed.opt_state[net][m]
            gaps[f"{net}_{m}"] = max(float((sa[k] - sb[k]).abs().max()) for k in sa)
    same_metrics = m_resumed.get(PARITY_STEPS) == m_straight.get(PARITY_STEPS)
    check(resumed.step == PARITY_STEPS and same_metrics and not any(gaps.values()),
          f"the resumed run differs from the straight one: {gaps}, metrics {same_metrics}")
    rec = dict(steps=PARITY_STEPS, resumed_at=PARITY_STEPS - 1, max_gaps=gaps,
               last_total=m_resumed[PARITY_STEPS]["total"])
    log("train_resume", steps=PARITY_STEPS, resumed_at=PARITY_STEPS - 1, bit_equal=True,
        gaps=repr(gaps).replace(" ", ""))
    del straight, resumed
    torch.cuda.empty_cache()
    return rec


def phase_train_serve(cli_root: str, ckpt_dir: str, smi) -> dict:
    """13.5: the coarse CLI on phase 10's dataset (its first SERVE_IMAGES
    images) with model.checkpoint_path=13.2's checkpoint directory and the
    int8 AE, every kernel count set to 0 just before it and read just
    after: the csvs written (one row per target instance, five hypotheses
    each, finite poses), the IST served with the checkpoint's weights, and
    the launches of phase 10's formula for a cold run (onboarding and
    forwards through the int8 AE, one matching launch per forward)."""
    reset_counts()
    t0 = time.perf_counter()
    runner = cli.main([f"machine.root_dir={cli_root}", "test_dataset_name=tudl", "model=large",
                       f"run_id={TRAIN_RUN}", "model.serving_quant=int8",
                       f"model.checkpoint_path={ckpt_dir}", f"max_images={SERVE_IMAGES}"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launched = counts()
    forwards = sum(-(-cli_detections(im) // CLI_CHUNK) for im in range(SERVE_IMAGES))
    onboard_calls = 2 * -(-NUM_VIEWS // 64)
    est = runner.estimator
    check(type(est.ae_net).__name__ == "AENetInt8" and runner.timing["forwards"] == forwards,
          f"serving: AE {type(est.ae_net).__name__}, {runner.timing['forwards']} forwards")
    want = expected_counts(forwards, len(est.ae_net.blocks), forwards + onboard_calls)
    check(launched == want, f"serving the checkpoint: launches {launched}, expected {want}")
    _, ist_sd, path = serving_weights(ckpt_dir)
    served = est.ist_net.state_dict()
    check(all(torch.equal(served[k].cpu(), v) for k, v in ist_sd.items()),
          f"the served IST is not {path}'s")
    targets = bop_io.load_json(osp.join(cli_root, "datasets", "tudl", "test_targets_bop19.json"))
    rows = sum(t["inst_count"] for t in targets if t["im_id"] < SERVE_IMAGES)
    pred = osp.join(cli_root, "results", f"large_{TRAIN_RUN}", "predictions")
    name = f"large-pbrreal-rgb-mmodel_tudl-test_{TRAIN_RUN}"
    top1 = bop_io.load_bop_csv(osp.join(pred, name + ".csv"))
    multi = bop_io.load_bop_csv(osp.join(pred, name + "MultiHypothesis.csv"),
                                extra_column="instance_id")
    check(len(top1) == rows and len(multi) == 5 * rows
          and all(np.isfinite(r["t"]).all() and np.isfinite(r["R"]).all() for r in multi),
          f"serving: {len(top1)} / {len(multi)} rows for {rows} target instances")
    t = runner.timing
    rec = dict(images=t["images"], forwards=forwards, rows=rows, run_s=run_s,
               images_per_s=t["images"] / t["run_s"], checkpoint=osp.basename(path),
               launches=launched, int8_ist=trained_int8_ist_cos(cli_root, est))
    log("train_serve", **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec.items()
                          if k != "launches"}, launches=repr(launched).replace(" ", ""),
        card=repr(smi))
    del runner, est
    torch.cuda.empty_cache()
    return rec


def trained_int8_ist_cos(cli_root: str, est) -> dict:
    """13.5's int8-IST reading on trained weights: the served checkpoint's
    IST as the static int8 IST (calibrated as onboarding calibrates it, on
    the first object's first template crops of phase 10's dataset) against
    the same IST in f32, per-descriptor cosine on the detections of phase
    10's first images (held out from the calibration)."""
    dev = est.device
    ist32 = f32_ist(est.ist_net)
    q = ISTNetInt8.from_ist_net(ist32, static_scales=True).eval()
    tdir = osp.join(cli_root, "datasets", "templates", "tudl")
    rgba = load_object_templates(tdir, list_objects(tdir)[0], None, 1.0, as_uint8=True)["rgba"]
    crops = []
    for i, image in enumerate(InferenceDataset(osp.join(cli_root, "datasets"), "tudl")):
        if i == 4:
            break
        crops.append(prepare_batch(image.rgb, image.masks, image.boxes_xyxy, image.labels,
                                   image.K, dev).crops[:len(image.labels)])
    crops = torch.cat(crops)
    q.calibrate(prepare_template_crops(rgba[:CALIB_VIEWS], dev), margin=CALIB_MARGIN)
    with torch.inference_mode():
        got, ref = q.features(crops), ist32.features(crops)
    check(bool(torch.isfinite(got).all()), "the trained int8 IST's features are not finite")
    cos = descriptor_cos(got, ref)
    return dict(crops=int(crops.shape[0]), cos_mean=float(cos.mean()), cos_min=float(cos.min()))


def phase_train_jpg(e2e_root: str, png_run: dict, smi) -> dict:
    """13.6: training from JPEG shards, as a train_pbr split is read. 13.1's
    train_pbr split copied with every rgb/{im}.png replaced by the 480 x 640
    JPEG fixture im mod 4 (tests/data/codecs: 4:2:0, 4:4:4, 4:2:2 with
    restart markers, gray), as rgb/{im}.jpg, then turned into tar shards by
    the port's convert_to_shards; train.main at model=large, batch TRAIN_B,
    TRAIN_JPG_STEPS steps from a TarSceneSource over them (train_split names
    the shards' directory). The annotations no longer describe the pixels:
    this drives the reading path (decode, crop, augment), not learning.
    Checks: every step ran, every logged loss finite, no hand-written kernel
    launched. s per step p50 and the loader's wait and its share, beside
    13.2's PNG run ([train_jpg])."""
    from gigapose_tpu_torch import train as train_cli

    ds = osp.join(e2e_root, "datasets", "tudl")
    src, split = osp.join(ds, "train_pbr", "000001"), osp.join(ds, "train_pbr_jpg")
    jpegs = list(TRAIN_JPEGS)
    check(all(n in CODEC_MANIFEST for n in jpegs), f"JPEG fixtures: {jpegs}")
    t0 = time.perf_counter()
    dst = osp.join(split, "000001")
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("rgb"))
    os.makedirs(osp.join(dst, "rgb"))
    images = sorted(int(n[:6]) for n in os.listdir(osp.join(src, "rgb")))
    for im in images:
        shutil.copyfile(osp.join(CODEC_DIR, jpegs[im % len(jpegs)]),
                        osp.join(dst, "rgb", f"{im:06d}.jpg"))
    shards = osp.join(ds, "train_pbr_jpg_shards")
    n = convert_to_shards.main([f"split_dir={split}", f"out_dir={shards}", "shard_size=16"])
    check(n == len(images), f"convert_to_shards wrote {n} of {len(images)} images")
    convert_s = time.perf_counter() - t0
    timing, fit_orig = {}, train_cli.fit

    def fit_timed(*args, **kw):
        return fit_orig(*args, timing=timing, **kw)

    reset_counts()
    train_cli.fit = fit_timed
    t0 = time.perf_counter()
    try:
        state = train_cli.main([f"machine.root_dir={e2e_root}", "train_dataset_name=tudl",
                                "train_split=train_pbr_jpg_shards", "model=large",
                                f"machine.batch_size={TRAIN_B}", f"max_steps={TRAIN_JPG_STEPS}",
                                f"checkpoint_every={TRAIN_JPG_STEPS}", "log_every=1",
                                "run_id=train_jpg"])
        torch.cuda.synchronize()
    finally:
        train_cli.fit = fit_orig
    run_s = time.perf_counter() - t0
    launched = counts()
    check(not any(launched.values()), f"training from JPEG launched hand-written kernels: {launched}")
    check(state.step == TRAIN_JPG_STEPS, f"training from JPEG stopped at step {state.step}")
    with open(osp.join(e2e_root, "results", "large_train_jpg", "logs", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    check(sum("total" in m for m in lines) == TRAIN_JPG_STEPS
          and all(np.isfinite(v) for m in lines for v in m.values()),
          "training from JPEG: a step's losses missing or not finite")
    steps, waits = np.array(timing["step_s"][1:]), np.array(timing["wait_s"][1:])
    rec = dict(steps=TRAIN_JPG_STEPS, batch=TRAIN_B, images=len(images), shards=len(
        [f for f in os.listdir(shards) if f.endswith(".tar")]), convert_s=convert_s, run_s=run_s,
        step_s_p50=float(np.median(steps)), wait_s_p50=float(np.median(waits)),
        wait_share=float(waits.sum() / steps.sum()), final_total=lines[-1]["total"],
        png_step_s_p50=png_run["step_s_p50"], png_wait_s_p50=png_run["wait_s_p50"],
        png_wait_share=png_run["wait_share"])
    log("train_jpg", **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec.items()},
        card=repr(smi))
    del state
    torch.cuda.empty_cache()
    return rec


def phase_training(cli_root: str, dev, smi) -> dict:
    """13. Training on the card, in 12.2's dataset (cli_root/e2e): 13.1 its
    train_pbr and val splits; 13.2 the train CLI at model=large; 13.3 the
    card against the host; 13.4 a resume; 13.5 the coarse CLI serving
    13.2's checkpoint on phase 10's dataset; 13.6 training from JPEG
    shards."""
    from gigapose_tpu_torch import train as train_cli

    e2e_root = osp.join(cli_root, "e2e")
    ds = osp.join(e2e_root, "datasets", "tudl")
    meshes = {o: osp.join(ds, "models", f"obj_{o:06d}.ply") for o in (1, 2)}
    rng = np.random.default_rng(SEED + 40)
    t0 = time.perf_counter()
    n_train = write_train_split(ds, "train_pbr", meshes, TRAIN_IMAGES, rng)
    n_val = write_train_split(ds, "val", meshes, VAL_IMAGES, rng)
    log("train_data", train_images=TRAIN_IMAGES, train_instances=n_train, val_images=VAL_IMAGES,
        val_instances=n_val, templates=f"2x{NUM_VIEWS}", write_s=f"{time.perf_counter() - t0:.2f}")
    rec = {"run": phase_train_run(e2e_root, dev, smi)}
    cfg = cli.load_cli_config(["model=large", f"machine.root_dir={e2e_root}"], ("device",),
                              name="train")
    nets = train_cli.build_nets(cfg, tiny=False)  # on the host, seeded
    rec["parity"] = phase_train_parity(e2e_root, nets, dev)
    with tempfile.TemporaryDirectory(prefix="gigapose_resume_") as tmp:
        rec["resume"] = phase_train_resume(e2e_root, nets, dev, tmp)
    rec["serve"] = phase_train_serve(cli_root, rec["run"]["ckpt_dir"], smi)
    t0 = time.perf_counter()
    rec["train_jpg"] = phase_train_jpg(e2e_root, rec["run"], smi)
    log("train_jpg_phase", seconds=f"{time.perf_counter() - t0:.1f}")
    # 18c. data-parallel training in two processes
    rec["dp"] = phase_dp_training(e2e_root, nets, dev, smi)
    return rec


# 14. MegaPose refinement on the card, at the released checkpoints' width
# (WideResNet-34 width 1.0, 240 x 320 renders with normals, 500 points, 5
# iterations, n_rendered_views 1), with seeded random nets: the pose head
# small (HEAD_SCALE) around the identity update, BatchNorm statistics
# random; the same nets written as checkpoint.pth.tar files in the released
# key layout (the coarse one with the older names) for the CLI runs
MEGAPOSE_CPU_B = 2  # hypotheses of the card-against-CPU check
MEGAPOSE_CLASSIFY_DETS = 4  # detections through classify_coarse on the 576-grid
MEGAPOSE_CLI_IMAGES = 10  # refine CLI, refiner_type=megapose, on phase 10's csv
MEGAPOSE_SO3_IMAGES = 2  # refine CLI, coarse_mode=so3grid
# the card against the CPU (refine_batch and classify_coarse): the cuDNN
# and CPU convolutions sum in other orders (the H100 read R 2.8e-6, t 1.1e-3
# mm, score 1.8e-6 on refine_batch), and crop cameras an ulp apart move
# hundreds of pixels of an f32 render by a colour step (classify_coarse's
# 72-grid read 1.1e-4; tests/test_torch_megapose.py saw up to 4e-4 between
# the JAX package and the port); the bound of tests/test_torch_cuda_render.py
MEGAPOSE_CPU_BOUND = dict(R=1e-3, t_mm=0.5, score=1e-3)
IDENTITY_POSE_HEAD = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
# the pose head's std times sqrt(features): the random WideResNet's pooled
# features are large, and HEAD_SCALE moved every pose by 14 cm or more in 5
# iterations on an H100; a tenth of it keeps the renders near the object
MEGAPOSE_HEAD_SCALE = HEAD_SCALE / 10


def perturb_megapose_(ref, seed: int) -> None:
    """A small random pose head around the identity update and random
    BatchNorm statistics in both nets (flax's init would leave mean 0 and
    var 1, and the head's lecun init would throw every pose off the object)."""
    rng = np.random.default_rng(seed)
    rnd = lambda t, a: t.copy_(torch.from_numpy(a.astype(np.float32)))
    with torch.no_grad():
        w = ref.refiner_net.pose_fc.weight
        rnd(w, rng.normal(0, MEGAPOSE_HEAD_SCALE / np.sqrt(w.shape[1]), w.shape))
        rnd(ref.refiner_net.pose_fc.bias, np.array(IDENTITY_POSE_HEAD))
        for net in (ref.refiner_net, ref.coarse_net):
            for m in net.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    rnd(m.running_mean, rng.normal(0, 0.1, m.num_features))
                    rnd(m.running_var, rng.uniform(0.5, 1.5, m.num_features))


def megapose_net_work(net, n_inputs: int, B: int, size, dev) -> float:
    """f32 operations of one forward of `net` at (B, n_inputs, H, W): 2 per
    multiply-add of its convolutions and linear layers (BatchNorm, ReLU,
    pooling and the residual sums left out), counted by hooks on one
    forward."""
    ops = [0.0]

    def hook(m, inp, out):
        if isinstance(m, torch.nn.Conv2d):
            ops[0] += 2.0 * out.numel() * (m.in_channels // m.groups) * m.kernel_size[0] \
                * m.kernel_size[1]
        elif isinstance(m, torch.nn.Linear):
            ops[0] += 2.0 * out.numel() * m.in_features

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.inference_mode():
        net(torch.zeros((B, n_inputs, *size), device=dev))
    for h in handles:
        h.remove()
    return ops[0]


def megapose_nets_ms(ref, B: int, dev) -> dict:
    """Device time of the nets alone at a refine_batch's shapes (CUDA events,
    f32, TF32 off): one refiner and one coarse forward at B, and per batch
    n_iterations of the first and one of the second."""
    cfg = ref.config
    H, W = cfg.render_size
    xr = torch.rand((B, cfg.n_inputs, H, W), device=dev)
    xc = torch.rand((B, 3 + cfg.n_render_channels, H, W), device=dev)
    with no_tf32(), torch.inference_mode():
        r_ms = cuda_ms(lambda: ref.refiner_net(xr), warmup=2, iters=10)
        c_ms = cuda_ms(lambda: ref.coarse_net(xc), warmup=2, iters=10)
    return dict(refiner_ms=r_ms, coarse_ms=c_ms, per_batch_ms=cfg.n_iterations * r_ms + c_ms)


def time_megapose(ref, args, tag: str, smi) -> tuple:
    """refine_batch once to warm, then 3 times with the host phases timed
    -> (the output, the record: whole ms per batch on the host clock, the
    phases per batch, the device's busy share of one profiled batch)."""
    B = len(args[2])
    ref.refine_batch(*args)
    ref.timing = {}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = ref.refine_batch(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    check(bool(np.isfinite(out[0]).all() and np.isfinite(out[1]).all()),
          f"megapose {tag}: non-finite output")
    rec = dict(batch_ms=float(np.median(times)), batch_ms_min=min(times),
               batch_ms_max=max(times), per_hypothesis_ms=float(np.median(times)) / B,
               **{f"{k}_ms": v / 3 * 1e3 for k, v in ref.timing.items()})
    ref.timing = None
    prof = device_profile(lambda: ref.refine_batch(*args))
    rec.update(profiled_batch_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
               device_busy_share=prof["busy_share"])
    log("megapose_batch", run=tag, B=B, **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                          for k, v in rec.items()}, card=repr(smi))
    return out, rec


def megapose_scene(ref, rng, B: int) -> tuple:
    """B hypotheses of phase 11's kind: the two objects alternating at
    random poses rendered into noise, the init 1 cm and a few degrees off
    -> (images, K, labels, init, boxes: each object's render box)."""
    labels = np.array([1 + i % 2 for i in range(B)])
    gts = random_poses(rng, B)
    init = gts.copy()
    init[:, :3, 3] += rng.uniform(-0.01, 0.01, (B, 3))
    a = rng.uniform(-0.08, 0.08, (B, 3))
    for i in range(B):
        c, s = np.cos(a[i]), np.sin(a[i])
        rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
        ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
        init[i, :3, :3] = (rz @ ry @ init[i, :3, :3]).astype(np.float32)
    images = scene_images(ref.meshes, labels, gts, rng)
    boxes = np.zeros((B, 4), np.float32)
    for i in range(B):
        pose = gts[i].copy()
        pose[:3, 3] /= ref.meshes.unit_to_m[int(labels[i])]
        rgba, _ = ref.meshes.rasterizers[int(labels[i])].render(REFINE_K, pose, W, H)
        ys, xs = np.nonzero(rgba[..., 3])
        boxes[i] = (xs.min(), ys.min(), xs.max(), ys.max())
    return images, np.repeat(REFINE_K[None], B, 0), labels, init, boxes


def write_megapose_checkpoints(ref, folder: str) -> tuple:
    """The refiner as {"state_dict": ...} with today's keys, the coarse
    model at the top level with the older names (backbone.backbone.*,
    backbone.head.0.*), as released checkpoint.pth.tar files -> their paths."""
    os.makedirs(folder, exist_ok=True)
    rpath, cpath = osp.join(folder, "refiner.pth.tar"), osp.join(folder, "coarse.pth.tar")
    torch.save({"state_dict": {k: v.cpu() for k, v in ref.refiner_net.state_dict().items()}},
               rpath)
    old = {}
    for k, v in ref.coarse_net.state_dict().items():
        k = k.replace("backbone.", "backbone.backbone.", 1).replace("views_logits_head.",
                                                                    "backbone.head.0.")
        old[k] = v.cpu()
    torch.save(old, cpath)
    return rpath, cpath


def megapose_cli(root: str, args: list, tag: str, smi) -> tuple:
    """The refine CLI through main() with every count at 0 -> (the rows,
    the timing, the record)."""
    reset_counts()
    RZ.rasterize.launches = 0
    paths, timing = refine_cli.main([f"machine.root_dir={root}", "test_dataset_name=tudl",
                                     "model=large", f"save_dir={osp.join(root, 'results', tag)}",
                                     f"run_id={tag}"] + args)
    torch.cuda.synchronize()
    check(counts() == expected_counts(0) and RZ.rasterize.launches == 0,
          f"megapose CLI {tag}: a hand-written kernel launched")
    rows = bop_io.load_bop_csv(paths[0])
    check(len(rows) > 0 and all(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all()
                                and np.abs(r["R"] @ r["R"].T - np.eye(3)).max() < 1e-4
                                for r in rows), f"megapose CLI {tag}: a row is not a pose")
    ms = np.asarray(timing["image_s"]) * 1e3
    n_key = "hypotheses" if "hypotheses" in timing else "detections"
    rec = dict(images=timing["images"], rows=len(rows), image_ms_p50=float(np.percentile(ms, 50)),
               image_ms_p90=float(np.percentile(ms, 90)),
               images_per_s=timing["images"] / timing["run_s"], run_s=timing["run_s"],
               **{n_key: timing[n_key], f"{n_key}_per_s": timing[n_key] / timing["run_s"]})
    log("megapose_cli", run=tag, **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                    for k, v in rec.items()}, card=repr(smi))
    return rows, timing, rec


def phase_megapose(root: str, init_csv: str, dev, smi) -> dict:
    """14. MegaPose refinement on the card, in phase 10's dataset and phase
    11's meshes (19,800 and 99,904 faces): 14.1 refine_batch of REFINE_B at
    full width on both mesh sets (ms per batch, its host phases fetch /
    render / upload / update, the nets' device time alone, the device's
    busy share), every pose moved; the card against the CPU on
    MEGAPOSE_CPU_B hypotheses; 14.2 classify_coarse on the 576-grid for
    MEGAPOSE_CLASSIFY_DETS detections (s per detection, the same phases),
    its first detection's scores on the 72-grid on the card against the
    CPU; 14.3 the
    refine CLI with refiner_type=megapose on phase 10's MultiHypothesis csv
    (MEGAPOSE_CLI_IMAGES images, min_score 0) from checkpoints of 14.1's
    nets, its first image's rows against run_refinement with 14.1's
    refiner; 14.4 the refine CLI with coarse_mode=so3grid on
    MEGAPOSE_SO3_IMAGES images. No hand-written kernel launches: the nets
    are cuDNN's, the renders the host's."""
    from gigapose_tpu_torch.refiner.megapose_refiner import MegaposeRefiner, MegaposeRefinerConfig
    from gigapose_tpu_torch.refiner.runner import run_refinement

    t_phase = time.perf_counter()
    reset_counts()
    RZ.rasterize.launches = 0
    sets = {"dataset": refine_cli.mesh_paths_of(osp.join(root, "datasets", "tudl", "models")),
            "large": refine_cli.mesh_paths_of(osp.join(root, "large"))}
    cfg = MegaposeRefinerConfig()
    ref = MegaposeRefiner.create(sets["dataset"], seed=SEED, config=cfg, device=dev)
    perturb_megapose_(ref, SEED + 50)
    rng = np.random.default_rng(SEED + 51)
    images, Ks, labels, init, boxes = megapose_scene(ref, rng, REFINE_B)
    args = (images, Ks, labels, init)
    H_, W_ = cfg.render_size
    work = dict(refiner=megapose_net_work(ref.refiner_net, cfg.n_inputs, 1, cfg.render_size, dev),
                coarse=megapose_net_work(ref.coarse_net, 3 + cfg.n_render_channels, 1,
                                         cfg.render_size, dev))
    nets = megapose_nets_ms(ref, REFINE_B, dev)
    batch_ops = REFINE_B * (cfg.n_iterations * work["refiner"] + work["coarse"])
    rec = dict(work_gflop=dict(refiner=work["refiner"] / 1e9, coarse=work["coarse"] / 1e9),
               nets=nets, nets_bound_ms=bound(batch_ops, "f32", 0.0)["bound_ms"])
    log("megapose_nets", B=REFINE_B, size=f"{H_}x{W_}", refiner_gflop=f"{work['refiner'] / 1e9:.4g}",
        coarse_gflop=f"{work['coarse'] / 1e9:.4g}", **{k: f"{v:.4g}" for k, v in nets.items()},
        per_batch_bound_ms=f"{rec['nets_bound_ms']:.4g}", card=repr(smi))
    out, rec["dataset"] = time_megapose(ref, args, "dataset", smi)
    large = dataclasses.replace(ref, meshes=MeshStore(sets["large"], cfg.n_sample_points))
    _, rec["large"] = time_megapose(large, args, "large", smi)
    large.meshes.close()
    moved = [pose_gap(out[0][i:i + 1], init[i:i + 1]) for i in range(REFINE_B)]
    rec["moved_min"] = dict(R=min(m["R"] for m in moved), t_mm=min(m["t_mm"] for m in moved))
    cpu = dataclasses.replace(ref, refiner_net=copy.deepcopy(ref.refiner_net).cpu(),
                              coarse_net=copy.deepcopy(ref.coarse_net).cpu(),
                              device=torch.device("cpu"))
    t0 = time.perf_counter()
    cpu_out = cpu.refine_batch(*(x[:MEGAPOSE_CPU_B] for x in args))
    rec["cpu_s"] = time.perf_counter() - t0
    rec["cpu_gap"] = result_gap(tuple(x[:MEGAPOSE_CPU_B] for x in out), cpu_out)
    for q in ("R", "t_mm", "score"):
        check(rec["cpu_gap"][q] <= MEGAPOSE_CPU_BOUND[q],
              f"megapose card against CPU: {rec['cpu_gap']} > {MEGAPOSE_CPU_BOUND}")
    for q in ("R", "t_mm"):
        check(rec["moved_min"][q] > MEGAPOSE_CPU_BOUND[q],
              f"megapose: a pose moved {rec['moved_min']}, not more than {MEGAPOSE_CPU_BOUND}")
    log("megapose_parity", cpu_B=MEGAPOSE_CPU_B, cpu_s=f"{rec['cpu_s']:.2f}",
        **{f"cpu_{q}": f"{v:.4g}" for q, v in rec["cpu_gap"].items()},
        **{f"moved_min_{q}": f"{v:.4g}" for q, v in rec["moved_min"].items()})

    # 14.2 the SO(3)-grid classifier
    n = MEGAPOSE_CLASSIFY_DETS
    cls_args = tuple(x[:n] for x in args[:3]) + (boxes[:n],)
    # warm, and the card against the CPU on the first detection's 72-grid
    # (the CPU in chunks of 8: a sample's score does not depend on its chunk)
    _, card72 = ref.classify_coarse(*(x[:1] for x in cls_args), grid_size=72)
    t0 = time.perf_counter()
    _, cpu72 = cpu.classify_coarse(*(x[:1] for x in cls_args), chunk=8, grid_size=72)
    cpu_cls_s = time.perf_counter() - t0
    cls_gap = float(np.abs(cpu72 - card72).max())
    check(cls_gap <= MEGAPOSE_CPU_BOUND["score"],
          f"classify_coarse card against CPU: {cls_gap} > {MEGAPOSE_CPU_BOUND['score']}")
    ref.timing = {}
    t0 = time.perf_counter()
    best, scores = ref.classify_coarse(*cls_args, grid_size=576)
    cls_s = time.perf_counter() - t0
    cls_phases = {f"{k}_s_per_det": v / n for k, v in ref.timing.items()}
    ref.timing = None
    check(scores.shape == (n, 576) and bool(np.isfinite(scores).all())
          and bool(np.isfinite(best).all()) and bool((best[:, 0, 2, 3] > 0.1).all()),
          "classify_coarse: scores or poses not finite, or an object behind the camera")
    grid_ops = 576 * work["coarse"]
    rec["classify"] = dict(detections=n, s_per_det=cls_s / n, **cls_phases, cpu_gap_72=cls_gap,
                           cpu_s_72=cpu_cls_s, tflop_per_det=grid_ops / 1e12,
                           bound_s_per_det=bound(grid_ops, "f32", 0.0)["bound_ms"] / 1e3,
                           score_spread=float(scores.max() - scores.min()))
    log("megapose_classify", grid=576, **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                          for k, v in rec["classify"].items()}, card=repr(smi))

    # 14.3 / 14.4 the refine CLI from checkpoints of these nets
    rpath, cpath = write_megapose_checkpoints(ref, osp.join(root, "megapose_ckpt"))
    ckpts = [f"megapose_refiner_ckpt={rpath}", f"megapose_coarse_ckpt={cpath}"]
    rows, timing, rec["cli"] = megapose_cli(
        root, ckpts + ["refiner_type=megapose", f"init_loc_path={init_csv}", "min_score=0",
                       f"max_images={MEGAPOSE_CLI_IMAGES}"], "megapose", smi)
    check(timing["images"] == MEGAPOSE_CLI_IMAGES, "megapose CLI: images")
    direct = run_refinement(ref, DirSceneSource(osp.join(root, "datasets", "tudl", "test"),
                                                load_depth=False, load_masks=False),
                            init_csv, save_dir=osp.join(root, "results", "megapose_direct"),
                            dataset_name="tudl", run_id="direct", max_images=1, min_score=0)
    first = bop_io.load_bop_csv(direct[0])
    cli_first = [r for r in rows if (r["scene_id"], r["im_id"]) ==
                 (first[0]["scene_id"], first[0]["im_id"])]
    cli_gap = max(max(float(np.abs(a["R"] - b["R"]).max()), float(np.abs(a["t"] - b["t"]).max()),
                      abs(a["score"] - b["score"])) for a, b in zip(first, cli_first))
    check(len(first) == len(cli_first) and cli_gap <= 1e-5,
          f"megapose CLI from checkpoints against the refiner itself: {cli_gap}")
    rec["cli"]["gap_to_direct"] = cli_gap
    _, timing, rec["so3grid"] = megapose_cli(
        root, ckpts + ["coarse_mode=so3grid", "so3_grid_size=576",
                       f"max_images={MEGAPOSE_SO3_IMAGES}"], "megapose_so3", smi)
    check(timing["images"] == MEGAPOSE_SO3_IMAGES, "so3grid CLI: images")
    ref.meshes.close()
    check(counts() == expected_counts(0) and RZ.rasterize.launches == 0,
          "the MegaPose phase launched a hand-written kernel")
    rec["seconds"] = time.perf_counter() - t_phase
    log("megapose", seconds=f"{rec['seconds']:.1f}", launches=repr(counts()).replace(" ", ""),
        raster_launches=RZ.rasterize.launches)
    torch.cuda.empty_cache()
    return rec


# 16. refiner training on the card: scripts/train_refiner.py at its defaults
# (RefinerNet 64, scorer 32, 160 x 160, batch 8, lr 3e-4, the curriculum)
# for RT_STEPS steps, cut from its 2,000
RT_STEPS = 40
RT_B = 8
RT_LR = 3e-4
RT_HELD = 3  # steps under torch.profiler
RT_K = np.asarray(TEMPLATE_K)  # the camera of the script's observed views
RT_CPU_B = 2  # the card-against-CPU step's batch
# one step of each net, card against CPU, from the same weights on the same
# inputs (the crops and renders made once: made on each device, the crops sit
# an ulp apart, as in refinement, and flip render pixels, which moved the
# scorer's BCE by 1.35e-4 on an H100) (TF32 off): the losses (the forward
# before the update) to 1e-4 relative of the CPU's; each parameter's
# gradient (before the update) within RT_GRAD_ATOL + 2 x the CPU f32
# gradient's own gap of the CPU's f64 gradient (per tensor, in norm: a
# BatchNorm's f32 gradient can be ill-conditioned, and the CPU's f32 gap
# measures it; gigapose_tpu_torch/scripts/refiner_train_probe.py reads both
# devices' gaps, PERF.md §6); the
# BatchNorm statistics to 1e-3 of max(1, |x|). A gradient negated or zeroed
# reads 2 or 1, and the check is shown failing on both.
RT_CPU_BOUND = dict(loss=1e-4, stats=1e-3)
RT_GRAD_ATOL = 1e-2
# 16.3: held batches of the training distribution at the script's full
# perturbation, refined as refine.py does (5 iterations, keep_best_init).
# After 40 steps the refiner does not yet beat its init, and how far it moves
# away varies from run to run (cuDNN's backward is not deterministic:
# refiner_train_probe and this phase read 1.2 to 3.8 x the init's mean point
# distance, PERF.md §6), so the distance is reported, not bounded; every
# pose must stay in the scene: in front of the camera within 2 m, x and y
# within 0.5 m of the axis (the draws: z 0.35-0.7 m, x and y within 5 cm)
RT_HELD_BATCHES = 4  # of RT_B poses
RT_HELD_Z = (0.1, 2.0)
RT_HELD_XY = 0.5
RT_SERVE_IMAGES = 10  # phase 10's first images through refine.py with the checkpoint


def refiner_train_work(ref, B: int, dev) -> dict:
    """The f32 work of one refiner training step at batch B, counted from
    the nets (hooks on one forward, megapose_net_work): the refiner's
    forward at B and the scorer's at 3 B (its three classes), each with a
    backward of twice the forward. Bytes: each parameter, its gradient and
    both Adam moments read and written once, the B observed images (480 x
    640 f32) and the crops and renders read. -> per-step GFLOP of each net,
    the bound."""
    size = ref.config.render_size
    fwd = {"refiner": megapose_net_work(ref.refiner_net, 6, B, size, dev),
           "scorer": megapose_net_work(ref.scorer_net, 6, 3 * B, size, dev)}
    ops = 3 * sum(fwd.values())
    params = sum(p.numel() for net in (ref.refiner_net, ref.scorer_net) for p in net.parameters())
    nbytes = 4.0 * params * 8 + B * 3 * H * W * 4 + 4 * B * 6 * size[0] * size[1] * 4
    return dict(step_gflop={k: 3 * v / 1e9 for k, v in fwd.items()}, params=params,
                **bound(ops, "f32", nbytes))


def grad_gaps(got: dict, want: dict) -> dict:
    """Per tensor |got - want| / |want| (Frobenius norms) over {name:
    gradient}."""
    return {k: float((got[k].double() - w).norm() / w.norm().clamp(min=1e-30))
            for k, w in want.items()}


def grad_excess(card: dict, cpu: dict, f64: dict) -> tuple:
    """The card's gradient gaps to f64 against RT_GRAD_ATOL + 2 x the CPU
    f32 gradient's -> (largest gap / its bound, its tensor, the largest gap)."""
    g_card, g_cpu = grad_gaps(card, f64), grad_gaps(cpu, f64)
    ratio = {k: g / (RT_GRAD_ATOL + 2 * g_cpu[k]) for k, g in g_card.items()}
    worst = max(ratio, key=ratio.get)
    return ratio[worst], worst, max(g_card.values())


def refiner_train_parity(ref, dev) -> dict:
    """16.2: one refiner step and one scorer step from the trained weights
    on the same batch (a synthetic_refiner_batches batch, its crops and
    renders made once, on the CPU), on the card and on the CPU in f32, and
    on the CPU in f64 (the gradients' reference): the two losses, every
    parameter's gradient (before the update) and the BatchNorm statistics
    after it; then a planted fault, one gradient negated and one zeroed,
    against the same bound."""
    cpu = torch.device("cpu")
    copy_to = lambda net, where, dtype: copy.deepcopy(net).to(where, dtype)
    on_cpu = dataclasses.replace(ref, refiner_net=copy_to(ref.refiner_net, cpu, None),
                                 scorer_net=copy_to(ref.scorer_net, cpu, None), device=cpu,
                                 _device_pack=None)
    batch = next(RTRAIN.synthetic_refiner_batches(ref.meshes, RT_K, batch_size=RT_CPU_B,
                                                   seed=SEED + 60))
    with no_tf32():
        inputs = RTRAIN.step_inputs(on_cpu, batch)
    runs = {}
    for tag, where, dtype in (("card", dev, torch.float32), ("cpu", cpu, torch.float32),
                              ("f64", cpu, torch.float64)):
        r_net, s_net = copy_to(ref.refiner_net, where, dtype), copy_to(ref.scorer_net, where, dtype)
        r_opt, s_opt = Adam({"refiner": RT_LR}), Adam({"scorer": RT_LR})
        r_in, s_in = ([t.to(where, dtype) for t in ts] for ts in inputs)
        t0 = time.perf_counter()
        with no_tf32():
            aux = RTRAIN.refiner_step(r_net, r_opt, r_opt.init({"refiner": r_net}), *r_in)
            bce = RTRAIN.scorer_step(s_net, s_opt, s_opt.init({"scorer": s_net}), *s_in)
        nets = (("refiner_net", r_net), ("scorer_net", s_net))
        runs[tag] = dict(loss=float(aux["loss"]), bce=float(bce), s=time.perf_counter() - t0,
                         grads={f"{n}.{k}": p.grad.detach().cpu()
                                for n, net in nets for k, p in net.named_parameters()},
                         stats={f"{n}.{k}": v.detach().cpu() for n, net in nets
                                for k, v in net.state_dict().items()
                                if k.endswith(("running_mean", "running_var"))})
    card, cpu_run, f64 = runs["card"], runs["cpu"], runs["f64"]
    gap = dict(loss=abs(card["loss"] / cpu_run["loss"] - 1),
               bce=abs(card["bce"] / cpu_run["bce"] - 1),
               stats=max(float(((card["stats"][k] - v).abs() / v.abs().clamp(min=1.0)).max())
                         for k, v in cpu_run["stats"].items()))
    gap["grad_to_bound"], worst, gap["grad_f64"] = grad_excess(card["grads"], cpu_run["grads"],
                                                               f64["grads"])
    gap["cpu_grad_f64"] = max(grad_gaps(cpu_run["grads"], f64["grads"]).values())
    gap["grad_cpu"] = max(grad_gaps(card["grads"], cpu_run["grads"]).values())
    # planted faults: the first convolution's gradient negated, the last
    # block's second convolution's zeroed
    first = next(iter(card["grads"]))
    last = [k for k in card["grads"] if k.startswith("refiner_net.") and "conv2" in k][-1]
    planted = {}
    for fault, k, f in (("negated", first, -1.0), ("zeroed", last, 0.0)):
        g = dict(card["grads"], **{k: card["grads"][k] * f})
        planted[fault] = grad_excess(g, cpu_run["grads"], f64["grads"])[0]
    log("refiner_train_parity", B=RT_CPU_B, cpu_s=f"{cpu_run['s']:.2f}",
        card_s=f"{card['s']:.2f}", f64_s=f"{f64['s']:.2f}",
        **{f"{k}_gap": f"{v:.3g}" for k, v in gap.items()}, grad_worst=worst,
        **{f"planted_{k}_to_bound": f"{v:.3g}" for k, v in planted.items()},
        bound=repr(dict(RT_CPU_BOUND, grad_atol=RT_GRAD_ATOL)).replace(" ", ""))
    for q in ("loss", "bce"):
        check(gap[q] <= RT_CPU_BOUND["loss"], f"refiner training step, card against CPU: {gap}")
    check(gap["stats"] <= RT_CPU_BOUND["stats"], f"refiner training step, card against CPU: {gap}")
    check(gap["grad_to_bound"] <= 1.0, f"refiner training gradients, card against the CPU's "
          f"f64: {worst} at {gap['grad_to_bound']:.3g} of its bound ({gap})")
    check(min(planted.values()) > 1.0,
          f"a planted gradient fault passes the card-against-CPU check: {planted}")
    return dict(gap, planted=planted)


def point_dist_mm(TCO: np.ndarray, TCO_gt: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Per pose the mean distance of the object's points at TCO from the
    same points at TCO_gt, in mm."""
    at = lambda T: np.einsum("bij,bpj->bpi", T[:, :3, :3], pts) + T[:, None, :3, 3]
    return np.linalg.norm(at(TCO) - at(TCO_gt), axis=-1).mean(-1) * 1e3


def refiner_train_held(ref, cad: str, ckpt_dir: str, dev) -> dict:
    """16.3: the checkpoint loaded as refine.py loads it
    (load_refiner_checkpoint into a fresh refiner at the script's widths)
    on RT_HELD_BATCHES held batches of the training distribution at the full
    perturbation, their ground truth known, refined at refine.py's defaults: the same poses
    as the trainer's own nets, the fresh (random) nets' poses the init (the
    identity head), the served poses moved from it and in the scene; their
    mean point distance to the ground truth against the init's."""
    fresh = RenderCompareRefiner.create(refine_cli.mesh_paths_of(cad), config=ref.config,
                                        refiner_width=ref.refiner_net.backbone.width,
                                        scorer_width=ref.scorer_net.backbone.width, device=dev)
    trained = dataclasses.replace(ref, meshes=fresh.meshes)
    try:
        gen = RTRAIN.synthetic_refiner_batches(fresh.meshes, RT_K, batch_size=RT_B, seed=SEED + 62)
        batches = [next(gen) for _ in range(RT_HELD_BATCHES)]
        args = [(b["images"], b["K"], b["labels"], b["TCO_init"]) for b in batches]
        T_random = np.concatenate([fresh.refine_batch(*a)[0] for a in args])
        load_refiner_checkpoint(ckpt_dir, fresh)
        T_served = np.concatenate([fresh.refine_batch(*a)[0] for a in args])
        T_trained = np.concatenate([trained.refine_batch(*a)[0] for a in args])
        pts = np.stack([fresh.meshes.points[int(l)] for b in batches for l in b["labels"]])
    finally:
        fresh.meshes.close()
    TCO_gt, TCO_init = (np.concatenate([b[k] for b in batches]) for k in ("TCO_gt", "TCO_init"))
    d_init = point_dist_mm(TCO_init, TCO_gt, pts)
    d_served = point_dist_mm(T_served, TCO_gt, pts)
    t = T_served[:, :3, 3]
    rec = dict(poses=len(t), init_mm=float(d_init.mean()), served_mm=float(d_served.mean()),
               ratio=float(d_served.mean() / d_init.mean()),
               closer=int((d_served < d_init).sum()),
               gap_to_trainer=float(np.abs(T_served - T_trained).max()),
               random_gap_to_init=float(np.abs(T_random - TCO_init).max()),
               moved=float(np.abs(T_served - T_random).max()),
               z_min=float(t[:, 2].min()), z_max=float(t[:, 2].max()),
               xy_max=float(np.abs(t[:, :2]).max()))
    log("refiner_train_held", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                 for k, v in rec.items()},
        bound=f"z{RT_HELD_Z},xy<{RT_HELD_XY}".replace(" ", ""))
    check(rec["gap_to_trainer"] <= 1e-5, f"the checkpoint as refine.py loads it refines "
          f"otherwise than the trainer's nets: {rec['gap_to_trainer']}")
    check(rec["random_gap_to_init"] <= 1e-5 and rec["moved"] > 1e-4,
          f"held batch: the random nets moved the init or the trained ones did not: {rec}")
    check(np.isfinite(T_served).all() and RT_HELD_Z[0] <= rec["z_min"]
          and rec["z_max"] <= RT_HELD_Z[1] and rec["xy_max"] <= RT_HELD_XY,
          f"held batch: a served pose left the scene: {rec}")
    return rec


def refiner_train_serve(root: str, init_csv: str, ckpt_dir: str, smi) -> dict:
    """16.3: refine.py with refiner_checkpoint= on phase 10's first
    RT_SERVE_IMAGES images (the host renderer, as phase 11.5's run): every
    pose finite, not all equal to phase 11.5's random nets' run of the same
    images; per-image p50 / p90."""
    save_dir = osp.join(root, "results", "refine_trained")
    paths, timing = refine_cli.main([
        f"machine.root_dir={root}", "test_dataset_name=tudl", "model=large",
        "run_id=refine_trained", f"init_loc_path={init_csv}", f"save_dir={save_dir}",
        "min_score=0", f"max_images={RT_SERVE_IMAGES}", f"refiner_checkpoint={ckpt_dir}"])
    rows = bop_io.load_bop_csv(paths[0])
    key = lambda r: (r["scene_id"], r["im_id"], r["obj_id"])
    folder = osp.join(root, "results", "refine_host", "predictions_refined")
    random_rows = {key(r): r for f in sorted(os.listdir(folder)) if f.endswith(".csv")
                   for r in bop_io.load_bop_csv(osp.join(folder, f))}
    check(rows and all(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all() for r in rows),
          "refine with the trained checkpoint: empty or not finite")
    common = [k for k in map(key, rows) if k in random_rows]
    moved = max(max(float(np.abs(r["R"] - random_rows[key(r)]["R"]).max()),
                    float(np.abs(r["t"] - random_rows[key(r)]["t"]).max()))
                for r in rows if key(r) in random_rows)
    check(len(common) == len(rows) and moved > 1e-3,
          f"trained refine: {len(common)} of {len(rows)} rows in the random run, "
          f"largest difference {moved}")
    ms = np.asarray(timing["image_s"]) * 1e3
    # the random nets return their inits (phase 11.5: max_gap_to_coarse), so
    # their rows are the inits' translations
    t_init = np.stack([random_rows[key(r)]["t"] for r in rows])
    t_served = np.stack([r["t"] for r in rows])
    z_ratio = t_served[:, 2] / t_init[:, 2]
    rec = dict(images=timing["images"], rows=len(rows), image_ms_p50=float(np.percentile(ms, 50)),
               image_ms_p90=float(np.percentile(ms, 90)), max_gap_to_random=moved,
               init_z_mm_p50=float(np.median(t_init[:, 2])),
               init_z_mm_max=float(t_init[:, 2].max()),
               served_z_mm_p50=float(np.median(t_served[:, 2])),
               served_z_mm_min=float(t_served[:, 2].min()),
               served_z_mm_max=float(t_served[:, 2].max()),
               z_ratio_p50=float(np.median(z_ratio)), z_ratio_max=float(z_ratio.max()),
               rows_z_over_10x=int((np.abs(z_ratio) > 10).sum()))
    log("refiner_train_serve", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                  for k, v in rec.items()}, card=repr(smi))
    return rec


def phase_refiner_training(root: str, init_csv: str, dev, smi) -> dict:
    """16. Refiner training on the card: 16.1 the script at its defaults in
    phase 11's dataset (timed through train_refiner's `timing`), then
    RT_HELD more steps under the profiler; 16.2 card against CPU; 16.3 its
    checkpoint served by refine.py."""
    t_phase = time.perf_counter()
    cad = osp.join(root, "datasets", "tudl", "models")
    ckpt_dir = osp.join(root, "refiner_ckpt")
    timing: dict = {}
    reset_counts()
    RZ.rasterize.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ref = TRAIN_REFINER.main([f"cad_dir={cad}", f"out_dir={ckpt_dir}", f"steps={RT_STEPS}"],
                             timing=timing)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launched = counts()
    check(not any(launched.values()) and RZ.rasterize.launches == 0,
          f"refiner training launched hand-written kernels: {launched}, rasterizer "
          f"{RZ.rasterize.launches}")
    cfg = ref.config
    check(cfg.render_size == (160, 160) and ref.refiner_net.backbone.width == 64
          and ref.scorer_net.backbone.width == 32 and ref.refiner_net.backbone.blocks
          == (3, 4, 6, 3) and ref.scorer_net.backbone.blocks == (2, 2, 2, 2),
          "train_refiner's defaults changed")
    hist, bce = np.asarray(ref.loss_history), np.asarray(ref.scorer_loss_history)
    check(len(hist) == len(bce) == RT_STEPS and np.isfinite(hist).all()
          and np.isfinite(bce).all(), "refiner training: a loss is missing or not finite")
    steps = np.asarray(timing["step_s"][1:])  # the first step warms cuDNN up
    per_step = {k: timing[k] / RT_STEPS * 1e3 for k in ("batch", "crop", "render", "step")}
    # RT_HELD more steps under the profiler, on a mesh store with its pool
    # (on copies of the nets: the checkpoint holds the 40 steps' weights)
    held = dataclasses.replace(ref, refiner_net=copy.deepcopy(ref.refiner_net),
                               scorer_net=copy.deepcopy(ref.scorer_net),
                               meshes=MeshStore(refine_cli.mesh_paths_of(cad), 500))
    prof = device_profile(lambda: RTRAIN.train_refiner(held, RT_K, steps=1, batch_size=RT_B,
                                                       lr=RT_LR, seed=SEED + 61, log_every=10),
                          iters=RT_HELD)
    work = refiner_train_work(held, RT_B, dev)
    held.meshes.close()
    rec = dict(steps=RT_STEPS, batch=RT_B, run_s=run_s, first_step_s=timing["step_s"][0],
               step_s_p50=float(np.median(steps)), step_s_p90=float(np.percentile(steps, 90)),
               **{f"{k}_ms_per_step": v for k, v in per_step.items()},
               loss_first=float(hist[0]), loss_last=float(hist[-1]), bce_first=float(bce[0]),
               bce_last=float(bce[-1]), held_step_ms=prof["wall_ms"],
               held_busy_ms=prof["busy_ms"], busy_share=prof["busy_share"],
               peak_gib=peak / 2**30, **work)
    top = sorted(prof["kernels_us"].items(), key=lambda kv: -kv[1])[:8]
    log("refiner_train_kernels", **{f"k{i}": f"{us / 1e3:.2f}ms:{name[:60].replace(' ', '')}"
                                    for i, (name, us) in enumerate(top)})
    log("refiner_train", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                            for k, v in rec.items() if k != "step_gflop"},
        step_gflop=repr({k: round(v, 2) for k, v in work["step_gflop"].items()})
        .replace(" ", ""), card=repr(smi))
    rec["parity"] = refiner_train_parity(ref, dev)
    rec["held"] = refiner_train_held(ref, cad, ckpt_dir, dev)
    rec["serve"] = refiner_train_serve(root, init_csv, ckpt_dir, smi)
    rec["phase_s"] = time.perf_counter() - t_phase
    log("refiner_training_phase", seconds=f"{rec['phase_s']:.1f}")
    torch.cuda.empty_cache()
    return rec


# 15. int8 IST on the card, at model=large's default IST (initial_dim 128,
# stages 128 / 192 / 256 / 512, descriptor 256, the 224 crop resized to 256)
# and B = IST_B. Its convolutions, one entry per distinct (input, kernel,
# stride, epilogue): (name, input side, C, O, kernel, stride, pad, residual,
# relu, convolutions of a forward with this shape)
IST_B = 32
IST_CONVS = (
    ("stem", 256, 3, 128, 7, 2, 3, False, True, 1),
    ("l1_conv1", 128, 128, 128, 3, 1, 1, False, True, 2),
    ("l1_conv2", 128, 128, 128, 3, 1, 1, True, True, 2),
    ("l2_conv1_s2", 128, 128, 192, 3, 2, 1, False, True, 1),
    ("l2_down", 128, 128, 192, 1, 2, 0, False, False, 1),
    ("l2_conv1", 64, 192, 192, 3, 1, 1, False, True, 1),
    ("l2_conv2", 64, 192, 192, 3, 1, 1, True, True, 2),
    ("l3_conv1_s2", 64, 192, 256, 3, 2, 1, False, True, 1),
    ("l3_down", 64, 192, 256, 1, 2, 0, False, False, 1),
    ("l3_conv1", 32, 256, 256, 3, 1, 1, False, True, 1),
    ("l3_conv2", 32, 256, 256, 3, 1, 1, True, True, 2),
    ("l4_conv1_s2", 32, 256, 512, 3, 2, 1, False, True, 1),
    ("l4_down", 32, 256, 512, 1, 2, 0, False, False, 1),
    ("l4_conv1", 16, 512, 512, 3, 1, 1, False, True, 1),
    ("l4_conv2", 16, 512, 512, 3, 1, 1, True, True, 2),
    ("out", 16, 512, 256, 1, 1, 0, False, False, 1),
)
IST_CONVS_PER_FORWARD = sum(c[-1] for c in IST_CONVS)  # 21
# with static scales each block's conv1 writes conv2's int8 codes (out_scale):
# 8 quantize launches fewer a forward, on the conv2 inputs
IST_FUSED_PER_FORWARD = sum(c[-1] for c in IST_CONVS if "_conv1" in c[0])  # 8
# the JAX tests' mean per-descriptor cosine gates against the float IST
# (tests/test_ist_int8.py): dynamic scales, static scales on held-out inputs
IST_COS_MIN = {"dynamic": 0.995, "static": 0.99}
IST_CPU_CROPS = 4  # 15.3: crops of the request held card against CPU
IST_CLI_IMAGES = 20  # 15.4: phase 10's first images


def f32_ist(ist_net):
    """A copy of a float ISTNet computing in f32 (TF32 is off)."""
    net = copy.deepcopy(ist_net)
    for m in net.modules():
        if hasattr(m, "dtype"):
            m.dtype = None
    return net


def descriptor_cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.cosine_similarity(a.float(), b.float(), dim=-1)


def equal_or_fail(got, want, what: str) -> None:
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.equal(got, want)),
          f"{what}: {int((got != want).sum()) if got.shape == want.shape else got.shape} "
          "values differ from the plain version")


def im2col_int8(xq, ks, stride, pad) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B * OH * OW, K rounded up to 8) int8, for the
    torch._int_mm yardstick (the product alone)."""
    cols = F.unfold(xq.permute(0, 3, 1, 2).half(), ks, padding=pad, stride=stride)
    cols = cols.transpose(1, 2).reshape(-1, cols.shape[1])
    K8 = -(-cols.shape[1] // 8) * 8
    return F.pad(cols, (0, K8 - cols.shape[1])).to(torch.int8).contiguous()


def phase_ist_kernels(dev) -> dict:
    """15.1: each convolution shape of the default IST at B = IST_B: qconv
    (both epilogues where the IST has both; at each block's conv1 also the
    int8 output under a static scale, as the static forward calls it), and
    act_absmax and quantize on each distinct input, bit-equal to their
    plain versions (the stem's qconv pads its 3 channels to 16 inside the
    timed call); device ms (CUDA-graph replays), the N tile, the im2col route,
    bound, plain ms, and the yardsticks: bf16 cuDNN F.conv2d of the same
    shape (NCHW), torch._int_mm on a pre-built im2col (the product alone),
    torch.linalg.vector_norm(ord=inf) for the absmax. Per forward: the
    static forward (the main path: int8 out at the conv1s, 13 quantize, no
    absmax) and the per-image-scale one (f32 out, 21 of each)."""
    B = IST_B
    rec = {"qconv": [], "inputs": {}}
    for i, (name, S, C, O, ks, st, pad, res, relu, n) in enumerate(IST_CONVS):
        x = torch.relu(randn(dev, (B, S, S, C), SEED + 300 + i)) if name != "stem" \
            else randn(dev, (B, S, S, C), SEED + 300)
        sx = QC.act_scale(x)
        equal_or_fail(sx, QC.act_scale_plain(x), f"act_absmax {name}")
        xq = QC.quantize_act(x, sx)
        equal_or_fail(xq, QC.quantize_act_plain(x, sx), f"quantize {name}")
        sa = torch.tensor(float(x.abs().max()) * 0.5 / 127.0, dtype=torch.float32, device=dev)
        equal_or_fail(QC.quantize_act(x, sa), QC.quantize_act_plain(x, sa),
                      f"quantize {name}, a static scale that clips")
        key = f"{S}x{S}x{C}"
        if key not in rec["inputs"]:
            E = S * S * C
            rec["inputs"][key] = dict(
                act_absmax=dict(**graph_stats(lambda: QC.act_scale(x)),
                                plain_ms=cuda_ms(lambda: QC.act_scale_plain(x)),
                                partial_library_ms=graph_stats(lambda: torch.linalg.vector_norm(
                                    x, ord=float("inf"), dim=(1, 2, 3)))["ms"],
                                **bound(0.0, "f32", B * E * 4 + B * 4)),
                quantize=dict(**graph_stats(lambda: QC.quantize_act(x, sx)),
                              plain_ms=cuda_ms(lambda: QC.quantize_act_plain(x, sx)),
                              **bound(0.0, "f32", B * E * 5 + B * 4)))
        K = ks * ks * C
        rng = np.random.default_rng(SEED + 320 + i)
        wq = torch.as_tensor(rng.integers(-127, 128, (O, K)).astype(np.int8), device=dev)
        ws = torch.as_tensor(rng.uniform(1e-3, 2e-2, O).astype(np.float32), device=dev)
        b = torch.as_tensor(rng.normal(size=O).astype(np.float32), device=dev)
        OH = QC.out_size(S, ks, st, pad)
        M = B * OH * OH
        r = randn(dev, (B, OH, OH, O), SEED + 340 + i) if res else None
        kern = lambda so=None: QC.qconv(xq, sx, wq, ws, b, st, pad, r, relu, out_scale=so)
        plain = lambda: QC.qconv_plain(xq, sx, wq, ws, b, st, pad, r, relu)
        out, want = kern(), plain()
        equal_or_fail(out, want, f"qconv {name}")
        check(bool(torch.isfinite(out).all()) and float(out.abs().max()) > 0, f"qconv {name}")
        xb = x.permute(0, 3, 1, 2).contiguous().bfloat16()
        wb = torch.randn((O, C, ks, ks), device=dev, dtype=torch.bfloat16)
        cols = im2col_int8(xq, ks, st, pad)
        wcols = F.pad(wq, (0, cols.shape[1] - K)).contiguous().t()
        # the function's bytes: the unpadded int8 input, the weight, ws, b,
        # the scales, the output (f32, or int8 codes) and the residual
        nbytes = lambda out_bytes: (B * S * S * C + O * K + 8 * O + 4 * B
                                    + M * O * (out_bytes + (4 if res else 0)))
        entry = dict(name=name, count=n, M=M, K=K, N=O, n_tile=QC.n_tile(M, O),
                     im2col=QC.im2col_route(QC.padded_channels(C), OH, OH, st)[0],
                     residual=res,
                     **graph_stats(kern), wrapper_ms=cuda_ms(kern, iters=5),
                     plain_ms=cuda_ms(plain, warmup=1, iters=2),
                     bf16_conv_ms=graph_stats(lambda: F.conv2d(xb, wb, None, st, pad))["ms"],
                     int_mm_ms=graph_stats(lambda: torch._int_mm(cols, wcols))["ms"], input=key,
                     **bound(2.0 * M * K * O, "int8", nbytes(4)))
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        if "_conv1" in name:  # the static forward's call: conv2's codes out
            so = torch.tensor(float(want.abs().max()) * CALIB_MARGIN / 127.0, dtype=torch.float32,
                              device=dev)
            equal_or_fail(kern(so), QC.quantize_act_plain(want, so), f"qconv {name}, int8 out")
            int8_out = dict(**graph_stats(lambda: kern(so)),
                            **bound(2.0 * M * K * O, "int8", nbytes(1)))
            entry["int8_out"] = dict(int8_out, bound_share=int8_out["bound_ms"] / int8_out["ms"])
        log("ist_kernel", kernel="qconv", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                             for k, v in entry.items() if k != "int8_out"},
            **{f"int8_out_{k}": f"{v:.4g}" for k, v in entry.get("int8_out", {}).items()
               if isinstance(v, float)})
        rec["qconv"].append(entry)
        del x, xq, out, want, xb, cols, r
    for key, v in rec["inputs"].items():
        for kname, e in v.items():
            log("ist_kernel", kernel=kname, input=key,
                **{k: (f"{x:.4g}" if isinstance(x, float) else x) for k, x in e.items()})
    # per forward: each shape times its convolutions, in both forwards
    q = rec["qconv"]
    static = lambda r: r.get("int8_out", r)  # the conv1s write int8 under static scales
    fused = lambda r: "_conv2" in r["name"]  # their quantize went into conv1
    tot = lambda rows, f: float(sum(r["count"] * r[f] for r in rows))
    rec["forward"] = {"qconv": {f: tot(q, f) for f in ("ms", "plain_ms", "bf16_conv_ms",
                                                       "int_mm_ms")}}
    fq = rec["forward"]["qconv"]
    fq["bound_ms"] = float(sum(r["count"] * static(r)["bound_ms"] for r in q))
    fq["ms_dynamic"], fq["ms"] = fq["ms"], float(sum(r["count"] * static(r)["ms"] for r in q))
    fq["bound_ms_dynamic"] = tot(q, "bound_ms")
    fq["launches"] = fq["launches_dynamic"] = IST_CONVS_PER_FORWARD
    for kname in ("act_absmax", "quantize"):
        rows = [dict(count=r["count"], fused=fused(r), **rec["inputs"][r["input"]][kname])
                for r in q]
        f = {x: tot(rows, x) for x in ("ms", "plain_ms", "bound_ms")}
        if kname == "act_absmax":
            f["partial_library_ms"] = tot(rows, "partial_library_ms")
            f.update(ms_dynamic=f["ms"], bound_ms_dynamic=f["bound_ms"], launches=0,
                     launches_dynamic=IST_CONVS_PER_FORWARD)
        else:
            kept = [r for r in rows if not r["fused"]]
            f.update(ms_dynamic=f["ms"], bound_ms_dynamic=f["bound_ms"], ms=tot(kept, "ms"),
                     bound_ms=tot(kept, "bound_ms"), plain_ms=tot(kept, "plain_ms"),
                     launches=IST_CONVS_PER_FORWARD - IST_FUSED_PER_FORWARD,
                     launches_dynamic=IST_CONVS_PER_FORWARD)
        rec["forward"][kname] = f
    for kname, f in rec["forward"].items():
        log("ist_kernels_per_forward", kernel=kname, B=B,
            **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in f.items()},
            bound_share=f"{f['bound_ms'] / f['ms']:.3f}" if f["ms"] else "n/a")
    torch.cuda.empty_cache()
    return rec


def ist_forward_counts(net, crops) -> tuple:
    """One features() call with every kernel count set to 0 just before it
    and read just after -> (features, counts)."""
    reset_counts()
    with torch.inference_mode():
        feats = net.features(crops)
    torch.cuda.synchronize()
    return feats, counts()


def phase_ist_forward(est, est8, templates, scene, dev, smi) -> dict:
    """15.2 the whole int8 IST at B = IST_B on phase 9's request, dynamic and
    static (calibrated on the first object's first CALIB_VIEWS template
    crops), against the f32 IST: per-descriptor cosine (IST_COS_MIN),
    launches per forward, device ms of the bf16, f32, int8 dynamic and int8
    static IST; 15.3 the B = IST_B forward with the int8 AE and the static
    int8 IST (its own store), stages as phase 9, and the static int8 IST on
    the card against the CPU (the plain versions) on IST_CPU_CROPS crops."""
    rgb, masks, boxes, labels, K, _ = scene
    take = np.arange(IST_B) % len(labels)
    batch = prepare_batch(rgb, masks[take], boxes[take], labels[take], K, dev)
    crops = batch.crops
    ist32 = f32_ist(est.ist_net)
    calib = prepare_template_crops(templates[0][:CALIB_VIEWS], dev)
    nets = {"dynamic": ISTNetInt8.from_ist_net(ist32).eval(),
            "static": ISTNetInt8.from_ist_net(ist32, static_scales=True).eval()}
    nets["static"].calibrate(calib, margin=CALIB_MARGIN)
    with torch.inference_mode():
        ref = ist32.features(crops)
    rec = {}
    for tag, net in nets.items():
        feats, launched = ist_forward_counts(net, crops)
        want = expected_counts(0, int8_ist_calls=1, dynamic_ist_calls=int(tag == "dynamic"))
        check(launched == want, f"int8 IST {tag}: launches {launched}, expected {want}")
        cos = descriptor_cos(feats, ref)
        check(bool(torch.isfinite(feats).all()) and feats.shape == ref.shape,
              f"int8 IST {tag}: features {tuple(feats.shape)}")
        check(float(cos.mean()) > IST_COS_MIN[tag],
              f"int8 IST {tag}: mean descriptor cosine {float(cos.mean())}")
        rec[tag] = dict(cos_mean=float(cos.mean()), cos_min=float(cos.min()),
                        launches={k: launched[k] for k in ("qconv", "quantize", "act_absmax")})
    with torch.inference_mode():
        times = dict(bf16_ms=cuda_ms(lambda: est.ist_apply(crops)),
                     f32_ms=cuda_ms(lambda: ist32.features(crops)),
                     int8_dynamic_ms=cuda_ms(lambda: nets["dynamic"].features(crops)),
                     int8_static_ms=cuda_ms(lambda: nets["static"].features(crops)))
    rec["times"] = times
    log("ist_forward", B=IST_B, **{f"{t}_{k}": (f"{v:.6f}" if isinstance(v, float) else
                                                repr(v).replace(" ", ""))
                                   for t in ("dynamic", "static") for k, v in rec[t].items()},
        **{k: f"{v:.3f}" for k, v in times.items()}, card=repr(smi))

    # 15.3: the static int8 IST beside the int8 AE, calibrated as onboarding
    # calibrates it, then its own store and the B = IST_B forward
    est8s = dataclasses.replace(est8).quantize_serving(ist="static")
    est8s.ist_net.calibrate(calib, margin=CALIB_MARGIN)
    store8s = onboard(est8s, templates, dev, "int8+int8_ist_static")
    rec["forward_b32"] = phase_forward_b32([("int8_ist_static", est8s, store8s)], scene,
                                           dev)["int8_ist_static"]
    cpu_net = copy.deepcopy(est8s.ist_net).to(torch.device("cpu"))
    few = crops[:IST_CPU_CROPS]
    with torch.inference_mode():
        got = est8s.ist_apply(few).cpu()
        t0 = time.perf_counter()
        want = cpu_net.features(few.cpu())
        cpu_s = time.perf_counter() - t0
    diff = float((got - want).abs().max())
    # tolerance 0: every step of the card's kernels rounds as the plain
    # versions do (tests/test_torch_cuda_ist_int8.py)
    check(diff == 0.0, f"static int8 IST, card against CPU: max |diff| {diff}")
    rec["card_vs_cpu"] = dict(crops=IST_CPU_CROPS, max_abs_diff=diff, cpu_s=cpu_s)
    log("ist_card_vs_cpu", crops=IST_CPU_CROPS, max_abs_diff=diff, cpu_s=f"{cpu_s:.2f}")
    del est8s, store8s, nets, ist32, cpu_net
    torch.cuda.empty_cache()
    return rec


def phase_ist_cli(root: str, info, dev, smi) -> dict:
    """15.4: the coarse CLI with model.serving_quant=int8 and
    model.serving_quant_ist=int8-static on phase 10's dataset, its first
    IST_CLI_IMAGES images: cold (no onboarded store under this tag) and
    from the cache. Launches per run (calibration's one dynamic IST call at
    each onboarding, also a cached one, then the static calls of onboarding
    and of every forward), per-image p50 / p90, the cold run's csvs and
    npz batches against the estimator called directly, the cached run's
    csv equal to the cold one's."""
    args = ["model.serving_quant=int8", "model.serving_quant_ist=int8-static",
            f"max_images={IST_CLI_IMAGES}"]
    forwards = sum(-(-cli_detections(im) // CLI_CHUNK) for im in range(IST_CLI_IMAGES))
    onboard_calls = 2 * -(-NUM_VIEWS // 64)
    rec, csvs = {}, None
    for tag, cached in (("int8_ist", False), ("int8_ist_cached", True)):
        runner, launched, paths = cli_run(root, args, tag)
        est = runner.estimator
        check(runner.timing["onboard_cached"] == cached, f"{tag}: onboarding cache")
        check(isinstance(est.ist_net, ISTNetInt8) and est.ist_net.static_scales
              and not est.ist_net.static_pending, f"{tag}: IST {type(est.ist_net).__name__}")
        calls = forwards + (0 if cached else onboard_calls)
        want = expected_counts(forwards, len(est.ae_net.blocks), calls,
                               int8_ist_calls=calls + 1, dynamic_ist_calls=1)
        check(launched == want, f"{tag}: launches {launched}, expected {want}")
        if cached:
            for a, b in zip(csvs, paths):
                check(csv_rows(a) == csv_rows(b), f"{tag}: the cached run wrote another csv")
            stats = {}
        else:
            stats = check_cli_outputs(runner, paths, info[:IST_CLI_IMAGES], root, dev, tag)
            csvs = paths
        ms = np.array([npz_time_ms(osp.join(osp.dirname(paths[0]), f"{i:06d}.npz"))
                       for i in range(IST_CLI_IMAGES)])
        t = runner.timing
        rec[tag] = dict(onboard_s_per_object=t["onboard_s"] / t["objects"],
                        image_ms_p50=float(np.percentile(ms, 50)),
                        image_ms_p90=float(np.percentile(ms, 90)),
                        images_per_s=t["images"] / t["run_s"], run_s=t["run_s"],
                        images=t["images"], forwards=t["forwards"], **stats, launches=launched)
        log("ist_cli", run=tag, **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                   for k, v in rec[tag].items() if k != "launches"},
            launches=repr({k: launched[k] for k in ("qconv", "quantize", "act_absmax",
                                                    "qmm", "fused_matching")}).replace(" ", ""),
            card=repr(smi))
        del runner, est
        torch.cuda.empty_cache()
    return rec


def ist_kernel_records(ist_rec: dict, cli_rec: dict) -> list:
    """The kernels line's entries of csrc/qconv.cu: launches in 15.4's cold
    CLI run (the main path through the user's entry point), launches_cli
    per 15.4 run, launches_per_forward (static and per-image scales); ms,
    plain_ms, bound_ms and the yardsticks as totals over the launches of
    one static B = IST_B forward (device ms from CUDA-graph replays), the
    per-image-scale forward's beside them (ms_dynamic, bound_ms_dynamic),
    the shapes with their N tiles; max_abs_err 0: each checked bit-equal
    at every shape."""
    k = ist_rec["kernels"]["forward"]
    runs = {tag: r["launches"] for tag, r in cli_rec.items()}
    out = []
    for name, key, line in (("qconv", "qconv", 144), ("quantize", "quantize", 142),
                            ("act_absmax", "act_absmax", 140)):
        f = k[name]
        e = dict(name=f"ist_{name}", route="cuda", source="gigapose_tpu_torch/csrc/qconv.cu",
                 replaces=f"gigapose_tpu/models/ist_int8.py:{line} (XLA, no Pallas kernel)",
                 launches=runs["int8_ist"][key], on_main_path=True,
                 launches_per_forward=f["launches"],
                 launches_per_forward_dynamic=f["launches_dynamic"],
                 launches_cli={tag: n[key] for tag, n in runs.items()}, max_abs_err=0.0,
                 ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
                 ms_dynamic=f["ms_dynamic"], bound_ms_dynamic=f["bound_ms_dynamic"],
                 bound_by="bytes" if name != "qconv" else None, library_ms=None,
                 per="the sum over one static B=32 forward's launches" if name != "act_absmax"
                 else "the sum over one per-image-scale B=32 forward's launches (a static "
                 "forward makes none)")
        if name == "qconv":
            e["partial_library_ms"] = f["bf16_conv_ms"]
            e["partial_library"] = "bf16 cuDNN F.conv2d of each shape"
            e["int_mm_ms"] = f["int_mm_ms"]
            rows = ist_rec["kernels"]["qconv"]
            ops_ms = sum(r["count"] * r["bound_ms"] for r in rows
                         if r["bound_by"] == "operations")
            e["bound_by"] = "operations" if ops_ms > f["bound_ms"] / 2 else "bytes"
            e["shapes"] = {r["name"]: dict({x: r[x] for x in (
                "count", "M", "K", "N", "n_tile", "im2col", "ms", "ms_min", "ms_max", "plain_ms",
                "bound_ms", "bound_by", "bf16_conv_ms", "int_mm_ms")},
                **({"int8_out": r["int8_out"]} if "int8_out" in r else {})) for r in rows}
        elif name == "act_absmax":
            e["partial_library_ms"] = f["partial_library_ms"]
            e["partial_library"] = "torch.linalg.vector_norm(ord=inf) per image"
        e["bound_share"] = e["bound_ms"] / e["ms"] if e["ms"] else None
        log("kernel", **{x: (f"{v:.4g}" if isinstance(v, float) else v) for x, v in e.items()
                         if x not in ("shapes", "source", "route", "launches_cli")},
            launches_cli=repr(e["launches_cli"]).replace(" ", ""))
        out.append(e)
    return out


def raster_record(rec: dict) -> dict:
    """The rasterizer's entry of the kernels line, at the dataset's meshes:
    launches in phase 11.4's device runs on them (3 batches), launches_cli
    in each refine CLI run; ms the device time from CUDA-graph replays;
    bound_ms from the work the function needs, bound_ms_kernel from the
    tests the kernel makes (its cull boxes and row spans), with both counts,
    each launch's device time (launch_us) and the whole-view faces; the same
    at the largest meshes under "large" and on the adversarial set under
    "adversarial"; launches_templates: the launches of phase 12's template
    renders per mesh and of its eval_bop run's template set, and
    "templates": each 12.1 mesh's 162-view stack at 640 x 480 (faces,
    launches, device ms per launch and per object, bound)."""
    r = rec["raster_dataset"]
    keys = ("faces", "ms", "ms_min", "ms_max", "wrapper_ms", "plain_ms", "max_abs_err",
            "bound_ms", "bound_by", "bound_ms_kernel", "tests", "tests_kernel", "whole_faces",
            "widened_faces", "launch_us")
    entry = dict(name="rasterizer", route="cuda", source="gigapose_tpu_torch/csrc/rasterizer.cu",
                 replaces="gigapose_tpu/render/jax_renderer.py:200 (XLA, no Pallas kernel)",
                 launches=3 * rec["refine"]["device"]["launches_per_batch"], on_main_path=True,
                 library_ms=None, **{k: r[k] for k in keys},
                 launches_cli={f"refine_{k}": v["raster_launches"] for k, v in rec["cli"].items()},
                 **{s: {k: rec[f"raster_{s}"][k] for k in keys} for s in ("large", "adversarial")})
    tpl = {k: v for k, v in rec["templates"].items() if k != "eval_bop"}
    entry["launches_templates"] = dict({k: v["device"]["launches"] for k, v in tpl.items()},
                                       eval_bop=rec["templates"]["eval_bop"]["template_launches"])
    entry["templates"] = {k: {f: v[f] for f in ("faces", "views", "views_per_launch", "ms",
                                                "launch_ms", "bound_ms", "bound_by", "bound_share",
                                                "tests", "plain_ms_per_view", "mismatch")}
                          for k, v in tpl.items()}
    entry["bound_share"] = entry["bound_ms"] / entry["ms"]
    nested = ("source", "route", "launches_cli", "launches_templates", "large", "adversarial",
              "templates")
    log("kernel", **{f: (f"{v:.4g}" if isinstance(v, float) else v) for f, v in entry.items()
                     if f not in nested},
        launches_cli=repr(entry["launches_cli"]).replace(" ", ""),
        launches_templates=repr(entry["launches_templates"]).replace(" ", ""),
        **{s: repr({k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in entry[s].items()}).replace(" ", "") for s in nested[4:]})
    return entry


# 19. selfcheck_full cut to about 50 s (its full budget is the JAX gates'
# 900 + 400 steps); the JAX script's JSON keys (gigapose_tpu/scripts/
# selfcheck_full.py:229-246, int8_metrics :174-181)
SELFCHECK_STEPS, SELFCHECK_REFINER_STEPS = 50, 20
SELFCHECK_AE = "vit_deep_test"
SELFCHECK_KEYS = (
    "coarse_ar", "refined_ar", "int8_retrieval_agreement", "int8_t_err_mm", "int8_rot_err_deg",
    "int8_ar", "act_absmax_global", "act_absmax_blocks", "level", "seed", "curriculum",
    "coarse_steps", "refiner_steps", "coarse_t_err_mm", "coarse_rot_err_deg",
    "refined_t_err_mm", "refined_rot_err_deg", "gt_t", "coarse_t", "refined_t")


def finite_json(value) -> bool:
    if isinstance(value, dict):
        return all(finite_json(v) for v in value.values())
    if isinstance(value, list):
        return all(finite_json(v) for v in value)
    return not isinstance(value, float) or bool(np.isfinite(value))


def phase_selfcheck(dev, smi) -> dict:
    """19. The port's selfcheck_full on the card at a cut budget: the JSON
    line complete and finite, int8 agreement >= 0.99, every kernel's
    launches in the run (each count set to 0 just before it) as
    expected_counts gives them: the coarse runner's, the A/B's two and the
    int8 runner's forwards on a bf16 store, the int8 AE's onboarding
    chunk and two queries."""
    tmp = tempfile.mkdtemp(prefix="gp_selfcheck_")
    args = [f"root={tmp}", f"steps={SELFCHECK_STEPS}", f"refiner_steps={SELFCHECK_REFINER_STEPS}",
            "level=0", "seed=0", "curriculum=false", f"ae_model={SELFCHECK_AE}",
            f"device={dev}"]
    try:
        t0 = time.perf_counter()
        reset_counts()
        RZ.rasterize.launches = 0
        out = SELFCHECK.main(args)
        torch.cuda.synchronize()
        launched = dict(counts(), rasterizer=RZ.rasterize.launches)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [k for k in SELFCHECK_KEYS if k not in out]
    check(not missing, f"selfcheck_full's JSON line lacks {missing}")
    check(finite_json(out), f"selfcheck_full's JSON line is not finite: {out}")
    check(out["device"] == str(dev), f"selfcheck_full ran on {out['device']}")
    check(out["int8_retrieval_agreement"] >= INT8_AGREEMENT_MIN,
          f"int8 retrieval agreement {out['int8_retrieval_agreement']} < {INT8_AGREEMENT_MIN}")
    views = len(template_object_poses(0))
    # the refiner renders on the host, as the JAX package's does: no rasterizer launch
    want = dict(expected_counts(4, VIT_CONFIGS[SELFCHECK_AE].depth,
                                int8_ae_calls=-(-views // 64) + 2), rasterizer=0)
    check(launched == want, f"selfcheck launches {launched}, expected {want}")
    log("selfcheck", cut=f"steps={SELFCHECK_STEPS},refiner_steps={SELFCHECK_REFINER_STEPS}"
        f"(of_900+400),level=0,seed=0,ae_model={SELFCHECK_AE}", seconds=f"{seconds:.1f}",
        legs=repr(out["seconds"]).replace(" ", ""),
        **{k: out[k] for k in SELFCHECK_KEYS if k != "act_absmax_blocks"},
        launches=repr({k: v for k, v in launched.items() if v}).replace(" ", ""),
        nvidia_smi=repr(smi))
    return dict(result=out, launches=launched, seconds=seconds)


def add_selfcheck_launches(kernels: list, launched: dict) -> None:
    """Phase 19's launches beside each kernel's."""
    keys = {"fused_matching_bfloat16": "match_bf16", "fused_matching_float32": "match_f32",
            "ist_qconv": "qconv", "ist_quantize": "quantize", "ist_act_absmax": "act_absmax"}
    for k in kernels:
        key = keys.get(k["name"], k["name"])
        if key in launched:
            k["launches_selfcheck"] = launched[key]


def kernel_records(record, qrec, krec, main_stats, bf16_counts, int8_counts, forwards, cli_rec):
    """One entry per hand-written kernel (and per chain that ports a TPU
    kernel): launches in the main path's runs, error against the plain
    version, times, bound and yardstick ("library_ms" where one PyTorch call
    computes the same function, "partial_library_ms" where it computes only
    part of it); launches_cli: the launches in each CLI run of phase 10."""
    mean = lambda xs: float(np.mean(xs))
    kernels = []
    cli_runs = {run: r["launches"] for run, r in cli_rec["runs"].items()}

    def add(name, source, replaces, launches, key, fwd=forwards, **fields):
        entry = dict(name=name, route="cuda", source=f"gigapose_tpu_torch/csrc/{source}",
                     replaces=replaces, launches=launches,
                     launches_per_forward=launches / fwd, library_ms=None,
                     launches_cli={run: n[key] for run, n in cli_runs.items()})
        entry.update(fields)
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        kernels.append(entry)

    pallas, qmm_py = "gigapose_tpu/ops/pallas_matching.py:69", "gigapose_tpu/ops/qmm.py"
    r = record["serving_bfloat16"]
    add("fused_matching_bfloat16", "fused_matching.cu", pallas, bf16_counts["match_bf16"],
        "match_bf16", on_main_path=True,
        max_abs_err=max(r["max_abs_err"], main_stats["max_abs_err"]), ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        partial_library_ms=r["partial_library_ms"])
    # the f32 store's kernels: launches from phase 10's model.feature_dtype=f32 run
    f32_run = cli_rec["runs"][CLI_F32_RUN]
    r = record["serving_float32"]
    add("fused_matching_float32", "fused_matching.cu", pallas, f32_run["launches"]["match_f32"],
        "match_f32", fwd=f32_run["forwards"], on_main_path=False,
        path="model.feature_dtype=f32", max_abs_err=r["max_abs_err"], ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        bound_ms_cuda_cores=r["bound_ms_cuda_cores"], kernel_gap_f64=r["kernel_gap_f64"],
        plain_gap_f64=r["plain_gap_f64"], partial_library_ms=r["partial_library_ms"],
        partial_library_tf32_ms=r["partial_library_tf32_ms"])
    add("split_tf32", "fused_matching.cu", pallas, f32_run["launches"]["split_tf32"],
        "split_tf32", fwd=f32_run["forwards"], on_main_path=False,
        path="model.feature_dtype=f32", **record["split_tf32"])
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

# 18. multi-device runs. SHARDS: 18a's shard counts of the bf16 store (the f32
# store at the first); DP_STEPS: 18c's steps from the seeded init, with
# 13.3's warm-up (lr 0, 1/2, 1). 18c's tolerances, two processes against one
# on the same card and batches: 13.3's card-against-CPU ones for the
# metrics (each gap relative to its value or DP_METRIC_FLOOR, whichever is
# larger: pos_sim, a mean cosine of random features, sits near 1e-3; the
# H100 read 2.0e-4 at most, on the scale loss), the BatchNorm statistics
# (read 8.9e-5) and the AE's share of entries beyond a tenth of the summed
# lr; the IST's share is held to about twice the H100's reading, 11.0 %:
# its backbone's gradient at random init is ill-conditioned (the CPU
# tests' loosest tolerance, tests/test_torch_train_step.py), and cuDNN runs
# other convolution algorithms at 6 rows than at 12, so Adam moves the
# entries whose gradient sits near 0 either way. Every entry stays within
# 2 x the summed lr (read 1.7e-4 of 3.0e-4), and the CPU test of the same
# step reads 0 % (tests/test_torch_parallel.py)
SHARDS = (2, 4)
DP_STEPS = 3
DP_LOSS_RTOL, DP_STATS_ATOL = PARITY_LOSS_RTOL, PARITY_STATS_ATOL
DP_FAR_SHARE = dict(ae=PARITY_FAR_SHARE, ist=0.25)
DP_METRIC_FLOOR = 1e-2
REPO_DIR = osp.dirname(osp.abspath(__file__))
LEG_TIMEOUT_S = 420


def host_ms(fn, warmup: int = 2, reps: int = 5) -> list:
    """Host-clock ms of `fn` to a synchronize, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_sharded(est, store, store32, scene, dev, smi) -> dict:
    """18a. The view-sharded store on [cuda:0] * S against the whole store,
    on phase 9's request of 32 (see the module docstring)."""
    rgb, masks, boxes, labels, K, _ = scene
    take = np.arange(32) % len(labels)
    batch = prepare_batch(rgb, masks[take], boxes[take], labels[take], K, dev)
    rec = {}
    for tag, whole, shard_counts in (("bf16", store, SHARDS), ("f32", store32, SHARDS[:1])):
        want = est(whole, batch)
        whole_ms = host_ms(lambda: est(whole, batch))
        for S in shard_counts:
            sstore = shard_template_store(whole, [dev] * S)

            def run():
                with torch.inference_mode():
                    return coarse_forward_sharded(est.ae_net, est.ist_net, sstore, batch,
                                                  est.config)

            reset_counts()
            got = run()
            torch.cuda.synchronize()
            launched = counts()
            f32 = tag == "f32"
            want_counts = expected_counts(S, f32_store=f32)
            check(launched == want_counts, f"sharded {tag} S={S}: launches {launched}")
            for name in ("view_ids", "src_pts", "tar_pts", "ransac_valid", "failed", "M",
                         "poses"):
                check(torch.equal(getattr(got, name), getattr(want, name)),
                      f"sharded {tag} S={S}: {name} differs from the whole store's")
            gaps = {name: float((getattr(got, name).float() - getattr(want, name).float())
                                .abs().max()) for name in ("scores", "sim_scores")}
            ms = host_ms(run)
            rec[f"{tag}_S{S}"] = dict(
                shards=S, views_per_shard=sstore.views_per_shard, padded_views=sstore.num_views,
                match_launches_per_forward=launched["match_f32" if f32 else "match_bf16"],
                split_launches_per_forward=launched["split_tf32"],
                ms=float(np.mean(ms)), ms_min=min(ms), whole_ms=float(np.mean(whole_ms)),
                whole_ms_min=min(whole_ms), over_whole=float(np.mean(ms) / np.mean(whole_ms)),
                scores_gap=gaps["scores"], sim_scores_gap=gaps["sim_scores"],
                scores_bit_equal=torch.equal(got.scores, want.scores)
                and torch.equal(got.sim_scores, want.sim_scores))
            log("sharded", store=tag, **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                         for k, v in rec[f"{tag}_S{S}"].items()}, card=repr(smi))
            del sstore
    torch.cuda.empty_cache()
    return rec


def spawn_ranks(script: str, args: dict, tag: str, n: int = 2) -> list:
    """`script` (python -c, from the checkout's root) in n processes on this
    machine's card, joined through the GIGAPOSE_COORDINATOR contract with
    GIGAPOSE_DIST_BACKEND=gloo (NCCL refuses two ranks on one card); args
    reach them as LEG_ARGS (JSON). Their output goes to files; a process that
    fails or outlives LEG_TIMEOUT_S fails the leg (every process is killed
    and waited for). Returns each rank's JSON result (LEG_OUT/rank<i>.json)."""
    with tempfile.TemporaryDirectory(prefix=f"gigapose_{tag}_") as out:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        procs = []
        try:
            for pid in range(n):
                env = dict(os.environ, GIGAPOSE_COORDINATOR=f"127.0.0.1:{port}",
                           GIGAPOSE_NUM_PROCESSES=str(n), GIGAPOSE_PROCESS_ID=str(pid),
                           GIGAPOSE_DIST_BACKEND="gloo", LEG_OUT=out,
                           LEG_ARGS=json.dumps(args))
                log_f = open(osp.join(out, f"proc{pid}.log"), "w")
                procs.append((subprocess.Popen([sys.executable, "-c", script], env=env,
                                               cwd=REPO_DIR, stdout=log_f,
                                               stderr=subprocess.STDOUT), log_f))
            deadline = time.perf_counter() + LEG_TIMEOUT_S
            for p, _ in procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for p, log_f in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log_f.close()
        for pid, (p, _) in enumerate(procs):
            if p.returncode != 0:
                print(f"--- {tag} process {pid}:\n" +
                      open(osp.join(out, f"proc{pid}.log")).read()[-6000:], file=sys.stderr)
        for pid, (p, _) in enumerate(procs):
            check(p.returncode == 0, f"{tag}: process {pid} exited {p.returncode} "
                  f"(killed after {LEG_TIMEOUT_S} s where negative)")
        return [json.load(open(osp.join(out, f"rank{pid}.json"))) for pid in range(n)]


# 18b / 18d in two processes: the coarse CLI cold and cached, the refine CLI,
# then which collectives gloo takes on CUDA tensors (each checked for its
# values; a refused one raises at once on every process, before any message)
MP_CLI_SCRIPT = r"""
import json, os, time
import torch
import torch.distributed as dist
from gigapose_tpu_torch.parallel import multihost
rank, world = multihost.maybe_initialize()
import chip_smoke as CS
from gigapose_tpu_torch import cli, refine
args, out = json.loads(os.environ["LEG_ARGS"]), {"world": world}
for tag in ("cold", "cached"):
    CS.reset_counts()
    t0 = time.perf_counter()
    runner = cli.main(args["cli"] + [f"run_id=mp_{tag}"])
    torch.cuda.synchronize()
    out[tag] = dict(timing=runner.timing, wall_s=time.perf_counter() - t0,
                    launches=CS.counts(), device=str(runner.estimator.device))
    del runner
    torch.cuda.empty_cache()
CS.RZ.rasterize.launches = 0
t0 = time.perf_counter()
paths, timing = refine.main(args["refine"])
out["refine"] = dict(timing=timing, paths=paths, wall_s=time.perf_counter() - t0,
                     raster_launches=CS.RZ.rasterize.launches)
x = torch.full((4,), float(rank + 1), device=multihost.default_device())
parts = lambda: [torch.empty_like(x) for _ in range(world)]


def all_reduce():
    y = x.clone()
    dist.all_reduce(y)
    return float(y[0]) == 3.0


def broadcast():
    y = x.clone()
    dist.broadcast(y, 0)
    return float(y[0]) == 1.0


def all_gather():
    ys = parts()
    dist.all_gather(ys, x)
    return [float(v[0]) for v in ys] == [1.0, 2.0]


def all_to_all():
    ys = parts()
    dist.all_to_all(ys, [x.clone() for _ in range(world)])
    return [float(v[0]) for v in ys] == [1.0, 2.0]


out["gloo_cuda"] = {}
for probe in (all_reduce, broadcast, all_gather, all_to_all):
    try:
        out["gloo_cuda"][probe.__name__] = "right" if probe() else "wrong"
    except RuntimeError as e:
        out["gloo_cuda"][probe.__name__] = "refused: " + str(e).strip().splitlines()[0][:120]
    dist.barrier()
with open(os.path.join(os.environ["LEG_OUT"], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
"""


def npz_equal(a: str, b: str) -> bool:
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            np.array_equal(x[k], y[k]) for k in x.files)


def csvs_of(folder: str) -> list:
    return sorted(osp.join(folder, f) for f in os.listdir(folder) if f.endswith(".csv"))


def phase_multiprocess_cli(root: str, init_csv: str, smi) -> dict:
    """18b / 18d: the coarse and the refine CLI in two processes on cuda:0
    (see the module docstring), against phase 10's bf16 runs and phase 11's
    host refine run."""
    t_leg = time.perf_counter()
    tdir = osp.join(root, "datasets", "templates", "tudl")
    shutil.rmtree(osp.join(tdir, "preprocessed"), ignore_errors=True)  # cold as phase 10's
    args = dict(
        cli=[f"machine.root_dir={root}", "test_dataset_name=tudl", "model=large",
             "onboarding_cache=mp", "model.serving_quant=off"],
        refine=[f"machine.root_dir={root}", "test_dataset_name=tudl", "model=large",
                "run_id=refine", f"init_loc_path={init_csv}",
                f"save_dir={osp.join(root, 'results', 'refine_mp')}", "min_score=0",
                f"max_images={REFINE_CLI_IMAGES}", "refine_renderer=host"])
    ranks = spawn_ranks(MP_CLI_SCRIPT, args, "mp_cli")
    check([r["world"] for r in ranks] == [2, 2], "mp_cli: not two processes")
    check(npz_equal(osp.join(tdir, "onboarded_mp.npz"), osp.join(tdir, "onboarded_phase10.npz")),
          "mp_cli: the distributed onboarding's cache is not phase 10's bf16 cache")
    check(not osp.exists(osp.join(tdir, "onboarded_mp.npz.parts")), "mp_cli: parts left")
    forwards = sum(-(-cli_detections(im) // CLI_CHUNK) for im in range(CLI_IMAGES))
    one = csvs_of(osp.join(root, "results", "large_bf16", "predictions"))
    rec = {"ranks": 2, "gloo_cuda": ranks[0]["gloo_cuda"]}
    for tag in ("cold", "cached"):
        rs = [r[tag] for r in ranks]
        check([r["timing"]["onboard_cached"] for r in rs] == [tag == "cached"] * 2,
              f"mp_cli {tag}: onboarding cache")
        check([r["timing"]["images"] for r in rs] == [-(-CLI_IMAGES // 2), CLI_IMAGES // 2],
              f"mp_cli {tag}: images {[r['timing']['images'] for r in rs]}")
        check(sum(r["timing"]["forwards"] for r in rs) == forwards, f"mp_cli {tag}: forwards")
        for r in rs:
            want = expected_counts(r["timing"]["forwards"])
            check(r["launches"] == want and r["device"] == "cuda:0",
                  f"mp_cli {tag}: launches {r['launches']} on {r['device']}, expected {want}")
        merged = csvs_of(osp.join(root, "results", f"large_mp_{tag}", "predictions"))
        check(len(merged) == len(one) == 2 and all(csv_rows(a) == csv_rows(b)
                                                   for a, b in zip(merged, one)),
              f"mp_cli {tag}: the merged csvs are not phase 10's bf16 run's")
        run_s = [r["timing"]["run_s"] for r in rs]
        rec[tag] = dict(
            images=[r["timing"]["images"] for r in rs],
            images_per_s_per_rank=[r["timing"]["images"] / r["timing"]["run_s"] for r in rs],
            images_per_s_all=CLI_IMAGES / max(run_s), run_s=run_s,
            decode_share=[r["timing"]["decode_s"] / r["timing"]["run_s"] for r in rs],
            onboard_s=[r["timing"]["onboard_s"] for r in rs], wall_s=[r["wall_s"] for r in rs],
            match_bf16=[r["launches"]["match_bf16"] for r in rs])
        log("mp_cli", run=tag, **{k: (repr([round(x, 4) for x in v]).replace(" ", "")
                                      if isinstance(v, list) else f"{v:.4g}")
                                  for k, v in rec[tag].items()}, card=repr(smi))
    rr = [r["refine"] for r in ranks]
    check(bool(rr[0]["paths"]) and rr[1]["paths"] == [], "mp_refine: process 0 alone merges")
    check([r["timing"]["images"] for r in rr] == [-(-REFINE_CLI_IMAGES // 2),
                                                   REFINE_CLI_IMAGES // 2],
          f"mp_refine: images {[r['timing']['images'] for r in rr]}")
    one = csvs_of(osp.join(root, "results", "refine_host", "predictions_refined"))
    merged = csvs_of(osp.join(root, "results", "refine_mp", "predictions_refined"))
    check(len(merged) == len(one) >= 1 and all(csv_rows(a) == csv_rows(b)
                                               for a, b in zip(merged, one)),
          "mp_refine: the merged csv is not phase 11's host refine run's")
    check(all(r["raster_launches"] == 0 for r in rr), "mp_refine: host renderer launched")
    rec["refine"] = dict(images=[r["timing"]["images"] for r in rr],
                         images_per_s_per_rank=[r["timing"]["images"] / r["timing"]["run_s"]
                                                for r in rr],
                         images_per_s_all=REFINE_CLI_IMAGES / max(r["timing"]["run_s"]
                                                                  for r in rr),
                         wall_s=[r["wall_s"] for r in rr])
    log("mp_refine", **{k: (repr([round(x, 4) for x in v]).replace(" ", "")
                            if isinstance(v, list) else f"{v:.4g}")
                        for k, v in rec["refine"].items()}, card=repr(smi))
    # the collectives multihost uses on CUDA tensors rest on these readings
    for name, probe in rec["gloo_cuda"].items():
        want = "right" if name in multihost.GLOO_CUDA_COLLECTIVES else "refused"
        check(all(r["gloo_cuda"][name].startswith(want) for r in ranks),
              f"gloo on CUDA tensors: {name} {[r['gloo_cuda'][name] for r in ranks]}")
    log("gloo_cuda", **{k: repr(v).replace(" ", "_") for k, v in rec["gloo_cuda"].items()})
    rec["seconds"] = time.perf_counter() - t_leg
    log("mp_cli_leg", seconds=f"{rec['seconds']:.1f}")
    return rec


# 18c in two processes: DP_STEPS steps on halves of the held batches from the
# seeded init, held against the one-process run, then train.py itself
DP_TRAIN_SCRIPT = r"""
import json, os, time
import torch
import torch.distributed as dist
from gigapose_tpu_torch.parallel import multihost
rank, world = multihost.maybe_initialize()
from gigapose_tpu_torch import cli, train
from gigapose_tpu_torch.pipeline.estimator import set_f32_matmul_precision
from gigapose_tpu_torch.training.state import OptimConfig, TrainBatch, TrainState, train_step
args = json.loads(os.environ["LEG_ARGS"])
dev = multihost.default_device()
set_f32_matmul_precision()
cfg = cli.load_cli_config(["model=large", f"machine.root_dir={args['root']}"], ("device",),
                          name="train")
ae, ist = train.build_nets(cfg, tiny=False)
init_sum = sum(float(p.double().sum()) for m in (ae, ist) for p in m.state_dict().values())
state = TrainState(ae.to(dev), ist.to(dev), OptimConfig(warm_up_steps=args["warm"]))
batches = torch.load(args["batches"], weights_only=False)
timing, step_s, metrics = {}, [], []
for b in batches:
    n = len(b["src_img"]) // world
    mine = {k: (v[rank * n:(rank + 1) * n].to(dev) if v is not None else None) for k, v in b.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = train_step(state, TrainBatch(**mine), timing)
    torch.cuda.synchronize()
    step_s.append(time.perf_counter() - t0)
    metrics.append({k: float(v) for k, v in m.items()})

def same_on_every_rank(nets):
    for net in nets:
        for v in net.state_dict().values():
            w = v.clone()
            dist.broadcast(w, 0)
            if not torch.equal(w, v):
                return False
    return True

ref = torch.load(args["reference"], map_location=dev, weights_only=False)
gaps = {}
for name, net in (("ae", state.ae_net), ("ist", state.ist_net)):
    lr_sum = args["lr_sum"][name]
    far = moved = 0
    worst = stats = 0.0
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        d = (v.float() - ref[name][k].float()).abs()
        if k.endswith(("running_mean", "running_var")):
            stats = max(stats, float(d.max()))
            continue
        worst = max(worst, float(d.max()))
        moved += d.numel()
        far += int((d > 0.1 * lr_sum).sum())
    gaps[name] = dict(max_abs=worst, lr_sum=lr_sum, far_share=far / max(moved, 1), stats_max_abs=stats)
out = dict(world=world, device=str(dev), init_sum=init_sum, step_s=step_s,
           allreduce_s=timing.get("allreduce_s", []), metrics=metrics, gaps=gaps,
           same_weights=same_on_every_rank((state.ae_net, state.ist_net)),
           peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
del state, ref
torch.cuda.empty_cache()
t0 = time.perf_counter()
st = train.main([f"machine.root_dir={args['root']}", "train_dataset_name=tudl", "model=large",
                 f"machine.batch_size={args['batch']}", f"max_steps={len(batches)}",
                 f"checkpoint_every={len(batches)}", "log_every=1", "run_id=dp"])
torch.cuda.synchronize()
out["cli"] = dict(step=st.step, wall_s=time.perf_counter() - t0,
                  same_weights=same_on_every_rank((st.ae_net, st.ist_net)))
with open(os.path.join(os.environ["LEG_OUT"], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
"""


def phase_dp_training(e2e_root: str, nets, dev, smi) -> dict:
    """18c: two processes stepping as one global batch against one process,
    then train.py in two processes (see the module docstring)."""
    t_leg = time.perf_counter()
    recs = _held_batches(e2e_root, SEED + 44, TRAIN_B, DP_STEPS)
    cfg = OptimConfig(warm_up_steps=PARITY_WARM)
    with tempfile.TemporaryDirectory(prefix="gigapose_dp_") as tmp:
        batches = []
        for r in recs:
            tb = prepare_train_batch(r, dev)
            batches.append({f.name: (getattr(tb, f.name).cpu() if getattr(tb, f.name) is not None
                                     else None) for f in dataclasses.fields(tb)})
        torch.save(batches, osp.join(tmp, "batches.pt"))
        ae, ist = copy.deepcopy(nets)
        init_sum = sum(float(p.double().sum()) for m in (ae, ist) for p in m.state_dict().values())
        state = TrainState(ae.to(dev), ist.to(dev), cfg)
        one, one_s = [], []
        for b in batches:
            tb = TrainBatch(**{k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                               for k, v in b.items()})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one.append({k: float(v) for k, v in train_step(state, tb).items()})
            torch.cuda.synchronize()
            one_s.append(time.perf_counter() - t0)
        torch.save({"ae": state.ae_net.state_dict(), "ist": state.ist_net.state_dict()},
                   osp.join(tmp, "reference.pt"))
        del state, ae, ist
        torch.cuda.empty_cache()
        ranks = spawn_ranks(DP_TRAIN_SCRIPT, dict(
            root=e2e_root, batches=osp.join(tmp, "batches.pt"),
            reference=osp.join(tmp, "reference.pt"), batch=TRAIN_B // 2, warm=PARITY_WARM,
            lr_sum={net: float(sum(warmup_lr(lr, PARITY_WARM, c) for c in range(DP_STEPS)))
                    for net, lr in (("ae", cfg.ae_lr), ("ist", cfg.ist_lr))}), "dp_train")
    check([r["world"] for r in ranks] == [2, 2] and all(r["device"] == "cuda:0" for r in ranks),
          "dp_train: not two processes on cuda:0")
    check(all(r["init_sum"] == init_sum for r in ranks),
          f"dp_train: the processes' seeded init differs: {[r['init_sum'] for r in ranks]} "
          f"against {init_sum}")
    check(all(r["same_weights"] for r in ranks), "dp_train: the processes' weights differ")
    check(ranks[0]["metrics"] == ranks[1]["metrics"], "dp_train: the processes' metrics differ")
    gaps = {}
    for got, want in zip(ranks[0]["metrics"], one):
        check(set(got) == set(want) and all(np.isfinite(v) for v in got.values()),
              f"dp_train: metrics {got}")
        for k, v in want.items():
            gaps[k] = max(gaps.get(k, 0.0), abs(got[k] - v) / max(abs(v), DP_METRIC_FLOOR))
    worst_loss = max(gaps.values())
    log("dp_train_metric_gaps", **{k: f"{v:.3g}" for k, v in gaps.items()},
        steps=repr([(round(a["total"], 5), round(b["total"], 5))
                    for a, b in zip(ranks[0]["metrics"], one)]).replace(" ", ""))
    check(worst_loss <= DP_LOSS_RTOL, f"dp_train: metrics {gaps} apart (relative)")
    for name, g in ranks[0]["gaps"].items():
        check(g["max_abs"] <= 2 * g["lr_sum"] and g["far_share"] <= DP_FAR_SHARE[name]
              and g["stats_max_abs"] <= DP_STATS_ATOL, f"dp_train: {name} weights {g}")
    step_s = np.array(ranks[0]["step_s"][1:])  # the first step warms cuBLAS / cuDNN up
    ar_s = np.array(ranks[0]["allreduce_s"][1:])
    rec = dict(processes=2, batch_per_process=TRAIN_B // 2, steps=DP_STEPS,
               step_s_p50=float(np.median(step_s)), one_process_step_s_p50=float(
                   np.median(one_s[1:])), allreduce_s_p50=float(np.median(ar_s)),
               allreduce_share=float(ar_s.sum() / step_s.sum()), metrics_rel_gap=worst_loss,
               **{f"{n}_{k}": v for n, g in ranks[0]["gaps"].items() for k, v in g.items()
                  if k != "lr_sum"},
               peak_gib_per_process=max(r["peak_gib"] for r in ranks),
               final_total=ranks[0]["metrics"][-1]["total"])
    log("dp_train", **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec.items()},
        card=repr(smi))
    run = osp.join(e2e_root, "results", "large_dp")
    ckpts = sorted(os.listdir(osp.join(run, "checkpoints")))
    check(ckpts == ["last", f"step_{DP_STEPS:08d}.pt"], f"dp_train_cli: checkpoints {ckpts}")
    with open(osp.join(run, "logs", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    check(len(lines) == DP_STEPS, f"dp_train_cli: {len(lines)} metrics lines, one writer")
    check(all(r["cli"]["step"] == DP_STEPS and r["cli"]["same_weights"] for r in ranks),
          f"dp_train_cli: {[r['cli'] for r in ranks]}")
    rec["cli_wall_s"] = [r["cli"]["wall_s"] for r in ranks]
    rec["seconds"] = time.perf_counter() - t_leg
    log("dp_train_cli", steps=DP_STEPS, checkpoints=repr(ckpts).replace(" ", ""),
        wall_s=repr([round(x, 2) for x in rec["cli_wall_s"]]).replace(" ", ""),
        leg_seconds=f"{rec['seconds']:.1f}")
    return rec


def add_leg_launches(kernels: list, sharded: dict, mp: dict) -> None:
    """Phase 18's launches beside each matching kernel's: per sharded
    forward at each S (18a), and per process in 18b's multi-process runs."""
    for k in kernels:
        tag = {"fused_matching_bfloat16": "bf16", "fused_matching_float32": "f32",
               "split_tf32": "f32"}.get(k["name"])
        if tag is None:
            continue
        key = "split_launches_per_forward" if k["name"] == "split_tf32" else \
            "match_launches_per_forward"
        k["launches_sharded"] = {f"S{r['shards']}": r[key] for t, r in sharded.items()
                                 if t.startswith(tag)}
        if tag == "bf16":
            k["launches_multiprocess_cli"] = {run: mp[run]["match_bf16"]
                                              for run in ("cold", "cached")}


def cpu_model() -> str:
    """The host CPU's model: lscpu's "Model name", else /proc/cpuinfo's
    "model name", else (where both say "unknown", as a virtual machine may)
    the vendor, CPUID family and model numbers and the clock they give."""
    fields = {}
    try:
        texts = [subprocess.run(["lscpu"], capture_output=True, text=True, check=True).stdout]
    except (OSError, subprocess.CalledProcessError):
        texts = []
    if osp.exists("/proc/cpuinfo"):
        texts.append(open("/proc/cpuinfo").read())
    for text in texts:
        for line in text.splitlines():
            key, sep, value = line.partition(":")
            if sep and value.strip() and value.strip() != "unknown":
                fields.setdefault(key.strip().lower(), value.strip())
    if "model name" in fields:
        return fields["model name"]
    parts = [fields.get("vendor id", fields.get("vendor_id")),
             "family " + fields["cpu family"] if "cpu family" in fields else None,
             "model " + fields["model"] if "model" in fields else None,
             fields["cpu mhz"] + " MHz" if "cpu mhz" in fields else None]
    return " ".join(p for p in parts if p) or "unknown"


def p50_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def phase_codecs(smi) -> dict:
    """17. The image decoders on the host (csrc/codecs.cpp, dataloader/png.py),
    on the committed fixtures of tests/data/codecs (among them the
    progressive, smoothed, lossless, arithmetic, CMYK / YCCK, 4:1:1 and
    ratio 3 / 4 JPEGs and the planar, JPEG, zstd, LZMA, float, signed,
    CCITT, 1-4-bit, 16-bit, alpha, old LZW and BigTIFF TIFFs): each fixture
    through the reader's choice by signature (scene._decode_image) against
    the manifest that PIL wrote (shape, dtype, sha256 of the array: this
    host's build of codecs.cpp gives PIL's bytes); the ms per image, p50 of
    CODEC_REPS decodes, of the 480 x 640 q95 4:2:0 JPEG, of the 1280 x 960
    LZW TIFF, of the JPEG's image as a PNG with adaptive rows (the decoder
    that ran before) and of the 480 x 640 progressive JPEG; the JPEG's
    images/s on one thread and on the TrainLoader's worker count (train.yaml's machine.num_workers, capped at
    the cores - 1, as train.py caps it), whose ratio shows the GIL released
    during a decode; the host CPU's model ([codecs])."""
    t0 = time.perf_counter()
    data = {name: open(osp.join(CODEC_DIR, name), "rb").read() for name in sorted(CODEC_MANIFEST)}
    check(len(data) == CODEC_FIXTURES, f"the decoders' fixtures: {sorted(data)}")
    for name, blob in data.items():
        want = CODEC_MANIFEST[name]
        got = SCENE._decode_image(blob, name)
        check(list(got.shape) == want["shape"] and got.dtype.str == want["dtype"]
              and hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"],
              f"{name}: the port's decode is not PIL's ({got.shape}, {got.dtype})")
    jpg, tif = data["jpeg_q95_420.jpg"], data["tiff_lzw_pred2.tif"]
    png_bytes = encode_png(decode_jpeg(jpg), "adaptive")
    rec = {"fixtures": len(data), "cpu": cpu_model(), "cores": os.cpu_count()}
    for tag, blob in (("jpeg_480x640_q95_420", jpg), ("tiff_1280x960_lzw", tif),
                      ("png_480x640_adaptive", png_bytes),
                      ("jpeg_480x640_progressive", data["jpeg_progressive_480x640.jpg"])):
        rec[f"{tag}_ms_p50"] = p50_ms(lambda b=blob: SCENE._decode_image(b), CODEC_REPS)
    train_cfg = cli.load_cli_config([], ("device",), name="train")
    workers = max(1, min(int(train_cfg.machine.num_workers), (os.cpu_count() or 2) - 1))
    n = CODEC_THREAD_IMAGES
    t = time.perf_counter()
    for _ in range(n):
        decode_jpeg(jpg)
    rec["jpeg_images_per_s_1_thread"] = n / (time.perf_counter() - t)
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(lambda _: decode_jpeg(jpg), range(workers)))  # threads started
        t = time.perf_counter()
        list(pool.map(lambda _: decode_jpeg(jpg), range(n)))
        rec[f"jpeg_images_per_s_{workers}_threads"] = n / (time.perf_counter() - t)
    rec["workers"] = workers
    rec["thread_speedup"] = rec[f"jpeg_images_per_s_{workers}_threads"] / rec[
        "jpeg_images_per_s_1_thread"]
    rec["seconds"] = time.perf_counter() - t0
    log("codecs", **{k: (f"{v:.4g}" if isinstance(v, float) else
                         repr(v).replace(" ", "_") if isinstance(v, str) else v)
                     for k, v in rec.items()}, card=repr(smi))
    return rec


# 20. the last modules of the port: the JAX trainers' orbax checkpoints read
# without orbax (20a), tensor parallelism of the ViT (20b) and object-parallel
# onboarding (20c). The fixtures (tests/torch_orbax_fixtures.py wrote them and
# their manifest with the JAX package's save functions; GIGAPOSE_TINY's nets)
ORBAX_DIR = osp.join(osp.dirname(osp.abspath(__file__)), "tests", "data", "orbax")
ORBAX_TRAIN = "train/step_00000000"
ORBAX_REFINER = "train_refiner/refiner"
ORBAX_CLI_IMAGES = 6  # 20a: phase 10's first images through cli.main
TP_B, TP_MP, TP_REPS = 32, 2, 3  # 20b: ViT-L's batch, the mp split, timed forwards
TP_LAYERSCALE = 0.3  # as phase 7: LayerScale's 1e-5 init would hide the blocks
# tests/test_torch_models.py's bf16 agreement: every patch's cosine above it
BF16_COS = 0.999
ONBOARD_SHARDS = 2  # 20c: phase 4's two objects on [cuda:0] * 2


def flatten_tree(tree, prefix=()):
    """(dotted key path, array) of read_tree's tree, None leaves left out."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_tree(v, prefix + (str(k),))
    elif tree is not None:
        yield ".".join(prefix), tree


def array_record(a) -> dict:
    """tests/torch_orbax_fixtures.array_record: shape, dtype, sha256 of the
    C-order bytes."""
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": a.dtype.str,
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def phase_orbax(root: str, init_csv: str, smi) -> dict:
    """20a. The committed orbax fixtures read on this machine (no orbax,
    tensorstore or zarr here): every array against the manifest of orbax's
    own restore; the zstd library the reader took. The train state served
    by cli.main (GIGAPOSE_TINY=1, model.checkpoint_path= the step
    directory, the bf16 store: the matching kernel) on phase 10's first
    ORBAX_CLI_IMAGES images: the nets equal the bridge's state dicts bit for
    bit, the launches, finite csvs. The refiner served by refine.py
    (refiner_checkpoint= the JAX out_dir, the device renderer: the
    rasterizer kernel) on phase 10's first image: finite poses that moved
    from their inits (the fixture's pose head is not the identity)."""
    t_phase = time.perf_counter()
    manifest = json.load(open(osp.join(ORBAX_DIR, "manifest.json")))
    rec = {"zstd_version": ZSTD.version(), "zstd_library": ZSTD.library()._name}
    for name, arrays in manifest.items():
        t0 = time.perf_counter()
        got = dict(flatten_tree(ORBAX.read_tree(osp.join(ORBAX_DIR, name))))
        read_s = time.perf_counter() - t0
        check(sorted(got) == sorted(arrays), f"orbax {name}: other arrays than the manifest's")
        bad = [k for k, want in arrays.items() if array_record(got[k]) != want]
        check(not bad, f"orbax {name}: {len(bad)} arrays differ from orbax's restore: {bad[:3]}")
        rec[name] = dict(arrays=len(arrays), read_s=read_s,
                         array_bytes=int(sum(np.asarray(v).nbytes for v in got.values())))
        log("orbax_read", checkpoint=name, arrays=len(arrays), seconds=f"{read_s:.3f}",
            array_bytes=rec[name]["array_bytes"], zstd=rec["zstd_version"],
            library=rec["zstd_library"])
    train = osp.join(ORBAX_DIR, ORBAX_TRAIN)
    ae_sd, ist_sd, _ = serving_weights(train)
    tiny = os.environ.get("GIGAPOSE_TINY")
    os.environ["GIGAPOSE_TINY"] = "1"
    try:
        reset_counts()
        t0 = time.perf_counter()
        runner = cli.main([f"machine.root_dir={root}", "test_dataset_name=tudl", "model=large",
                           "run_id=orbax", "model.serving_quant=off",
                           f"max_images={ORBAX_CLI_IMAGES}", f"model.checkpoint_path={train}"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launched = counts()
        est = runner.estimator
        for net, want in ((est.ae_net, ae_sd), (est.ist_net, ist_sd)):
            sd = net.state_dict()
            check(sorted(sd) == sorted(want) and all(torch.equal(sd[k].cpu(), want[k])
                                                     for k in want),
                  f"orbax cli: the served {type(net).__name__} is not the checkpoint's")
        forwards = sum(-(-cli_detections(im) // CLI_CHUNK) for im in range(ORBAX_CLI_IMAGES))
        check(launched == expected_counts(forwards),
              f"orbax cli: launches {launched}, expected {expected_counts(forwards)}")
        rows = [r for p in csvs_of(osp.join(root, "results", "large_orbax", "predictions"))
                for r in bop_io.load_bop_csv(p, extra_column="instance_id" if "Multi" in p
                                             else None)]
        check(rows and all(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all()
                           for r in rows), "orbax cli: empty or non-finite csv")
        rec["cli"] = dict(images=runner.timing["images"], forwards=runner.timing["forwards"],
                          rows=len(rows), wall_s=cli_s, launches=launched)
        del runner, est
        RZ.rasterize.launches = 0
        paths, timing = refine_cli.main([
            f"machine.root_dir={root}", "test_dataset_name=tudl", "model=large",
            "run_id=orbax_refine", f"init_loc_path={init_csv}",
            f"save_dir={osp.join(root, 'results', 'orbax_refine')}", "min_score=0",
            "max_images=1", "refine_renderer=device",
            f"refiner_checkpoint={osp.join(ORBAX_DIR, osp.dirname(ORBAX_REFINER))}"])
        torch.cuda.synchronize()
    finally:
        if tiny is None:
            os.environ.pop("GIGAPOSE_TINY")
        else:
            os.environ["GIGAPOSE_TINY"] = tiny
    refined = bop_io.load_bop_csv(paths[0])
    key = lambda r: (r["scene_id"], r["im_id"], r["obj_id"])
    inits: dict = {}
    for r in bop_io.load_bop_csv(init_csv, extra_column="instance_id"):
        inits.setdefault(key(r), []).append(r["t"])
    check(refined and all(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all()
                          for r in refined), "orbax refine: empty or non-finite csv")
    # each refined pose's distance to the nearest init of its object in its image
    moved = max(min(float(np.abs(r["t"] - t).max()) for t in inits[key(r)]) for r in refined)
    check(moved > 1e-3 and RZ.rasterize.launches > 0,
          f"orbax refine: poses moved {moved} mm, rasterizer launches {RZ.rasterize.launches}")
    rec["refine"] = dict(images=timing["images"], rows=len(refined), max_t_moved_mm=moved,
                         raster_launches=RZ.rasterize.launches)
    rec["phase_s"] = time.perf_counter() - t_phase
    log("orbax_serve", cli_images=rec["cli"]["images"], cli_forwards=rec["cli"]["forwards"],
        cli_rows=rec["cli"]["rows"], cli_s=f"{cli_s:.2f}",
        match_bf16=launched["match_bf16"], refine_rows=len(refined),
        refine_t_moved_mm=f"{moved:.4g}", raster_launches=RZ.rasterize.launches,
        phase_s=f"{rec['phase_s']:.1f}", card=repr(smi))
    torch.cuda.empty_cache()
    return rec


# 20b in two processes on cuda:0 (gloo): ViT-L in bf16 split over mp = 2
# against the same net in one process (rank 0); ms per forward, the
# all-reduce's share, and GSPMD's rounding (each rank's partial rounded to
# bf16 before the sum) beside the port's (f32 sums, one rounding)
TP_SCRIPT = r"""
import json, os, time
import numpy as np
import torch
from gigapose_tpu_torch.parallel import multihost
rank, world = multihost.maybe_initialize()
import chip_smoke as CS
from gigapose_tpu_torch.models import vit as V
from gigapose_tpu_torch.models.ae_net import AENet
from gigapose_tpu_torch.parallel import tp as TPM
from gigapose_tpu_torch.pipeline.estimator import init_random_
args = json.loads(os.environ["LEG_ARGS"])
dev = multihost.default_device()
B, mp, reps, model = args["B"], args["mp"], args["reps"], args["model"]
x = torch.as_tensor(np.random.default_rng(args["seed"] + 70).normal(
    size=(B, 3, 224, 224)).astype(np.float32)).to(dev)
# seeded on the card (both ranks draw the same weights), faster than the CPU
full = init_random_(AENet(model, compute_dtype="bfloat16").to(dev),
                    torch.Generator(device=dev).manual_seed(args["seed"]))
with torch.no_grad():
    for name, p in full.named_parameters():
        if name.endswith("gamma"):
            p.fill_(args["layerscale"])
groups = TPM.make_dp_mp_groups(1, mp)
net = AENet(model, compute_dtype="bfloat16", tp=groups)
net.load_state_dict(TPM.shard_vit_tp(full.state_dict(), groups.mp_rank, mp,
                                     CS.VIT_CONFIGS[model].num_heads), strict=True)
net = net.to(dev).eval()
full.eval()
out = {"world": world, "mp_rank": groups.mp_rank,
       "local_params": sum(p.numel() for p in net.parameters()),
       "whole_params": sum(p.numel() for p in full.parameters())}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = fn()
    torch.cuda.synchronize()
    return y, (time.perf_counter() - t0) * 1e3


with torch.inference_mode():
    if rank == 0:  # the one-process forward, alone on the card
        ref = full(x)
        out["one_process_ms"] = [timed(lambda: full(x))[1] for _ in range(reps)]
    del full
    multihost.barrier()
    feats = net(x)
    out["tp_ms"] = [timed(lambda: net(x))[1] for _ in range(reps)]
    spent, plain_reduce = [], TPM.TPGroups.all_reduce

    def timed_reduce(self, y):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_reduce(self, y)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return y

    TPM.TPGroups.all_reduce = timed_reduce
    _, out["instrumented_ms"] = timed(lambda: net(x))
    TPM.TPGroups.all_reduce = plain_reduce
    out["all_reduces"], out["all_reduce_ms"] = len(spent), sum(spent) * 1e3
    plain_rp = V.row_parallel

    def bf16_partials(layer, x, dtype, tp):
        # GSPMD's bf16 all-reduce: each rank's partial rounded to bf16 first
        p = torch.nn.functional.linear(x.reshape(-1, x.shape[-1]).to(dtype),
                                       layer.weight.to(dtype))
        y = tp.all_reduce(p.float().contiguous()).to(dtype)
        return (y + layer.bias.to(dtype)).reshape(*x.shape[:-1], layer.out_features)

    V.row_parallel = bf16_partials
    gspmd = net(x)
    V.row_parallel = plain_rp
    if rank == 0:
        def gaps(a, b):  # per-patch cosine of unit features: 1 - its least and mean
            cos = (a.double() * b.double()).sum(-1)
            return dict(cos_gap=float(1 - cos.min()), cos_gap_mean=float(1 - cos.mean()),
                        max_abs=float((a - b).abs().max()))
        out["tp_vs_one"] = gaps(feats.float(), ref.float())
        out["gspmd_vs_one"] = gaps(gspmd.float(), ref.float())
        out["tp_vs_gspmd"] = gaps(feats.float(), gspmd.float())
        out["bit_equal_to_one"] = bool(torch.equal(feats, ref))
        out["shape"] = list(feats.shape)
with open(os.path.join(os.environ["LEG_OUT"], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
"""


def phase_tp(smi) -> dict:
    """20b. ViT-L bf16 split over TP_MP gloo processes on cuda:0 (NCCL
    refuses two ranks on one card) at B = TP_B, LayerScale TP_LAYERSCALE:
    every patch's cosine to the one-process forward's above BF16_COS, both
    ranks the whole batch; ms per forward (both ranks on one card: overhead,
    not scaling) against the one-process forward, the all-reduces' share of
    a forward with each of them synchronized and timed, and GSPMD's rounding
    of the partials beside the port's."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(TP_SCRIPT, dict(B=TP_B, mp=TP_MP, reps=TP_REPS, model=MODEL, seed=SEED,
                                        layerscale=TP_LAYERSCALE), "tp", n=TP_MP)
    r0 = ranks[0]
    check([r["world"] for r in ranks] == [TP_MP] * TP_MP, "tp: not TP_MP processes")
    check(r0["shape"] == [TP_B, 256, VIT_CONFIGS[MODEL].embed_dim], f"tp: shape {r0['shape']}")
    check(1 - r0["tp_vs_one"]["cos_gap"] > BF16_COS,
          f"tp: a patch's cosine to the one-process forward {1 - r0['tp_vs_one']['cos_gap']}")
    ms = [float(np.median(r["tp_ms"])) for r in ranks]
    rec = dict(mp=TP_MP, batch=TP_B, tp_ms=max(ms), one_process_ms=float(np.median(
        r0["one_process_ms"])), all_reduces=r0["all_reduces"],
        all_reduce_share=max(r["all_reduce_ms"] / r["instrumented_ms"] for r in ranks),
        local_over_whole_params=r0["local_params"] / r0["whole_params"],
        **{f"{k}_{m}": v for k in ("tp_vs_one", "gspmd_vs_one", "tp_vs_gspmd")
           for m, v in r0[k].items()}, bit_equal_to_one=r0["bit_equal_to_one"],
        leg_s=time.perf_counter() - t0)
    log("tp", **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec.items()},
        card=repr(smi))
    return rec


def phase_sharded_onboarding(est, store, templates, scene, dev, smi) -> dict:
    """20c. onboard_templates_sharded of phase 4's objects on
    [cuda:0] * ONBOARD_SHARDS with the bf16 AE: the store equal to phase 4's
    bit for bit; then phase 9's request of 32 on it: one matching launch,
    the forward's outputs equal to phase 4's store's."""
    poses = [template_object_poses(1).astype(np.float32)] * len(templates)
    secs = []
    for _ in range(2):  # the first call warms up as phase 4's cold call did
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sstore = onboard_templates_sharded(est.ae_apply, est.ist_apply, templates, poses,
                                           [dev] * ONBOARD_SHARDS, feature_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    fields = ("ae_features", "ist_features", "masks", "Ms", "poses", "K")
    for f in fields:
        check(torch.equal(getattr(sstore, f), getattr(store, f)),
              f"sharded onboarding: {f} differs from phase 4's store")
    rgb, masks, boxes, labels, K, _ = scene
    take = np.arange(32) % len(labels)
    batch = prepare_batch(rgb, masks[take], boxes[take], labels[take], K, dev)
    with torch.inference_mode():
        want = est(store, batch)
        reset_counts()
        got = est(sstore, batch)
        torch.cuda.synchronize()
    launched = counts()
    check(launched == expected_counts(1), f"sharded onboarding: launches {launched}")
    for name in ("view_ids", "scores", "M", "poses"):
        check(torch.equal(getattr(got, name), getattr(want, name)),
              f"sharded onboarding: the forward's {name} differs")
    rec = dict(shards=ONBOARD_SHARDS, objects=len(templates), views=NUM_VIEWS,
               s_per_object=secs[-1] / len(templates), cold_s=secs[0],
               match_bf16_launches=launched["match_bf16"])
    log("sharded_onboarding", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                 for k, v in rec.items()}, card=repr(smi))
    del sstore
    torch.cuda.empty_cache()
    return rec


def add_phase20_launches(kernels: list, orbax_rec: dict, onboard_rec: dict) -> None:
    """20a's and 20c's launches beside the matching kernel's and the
    rasterizer's."""
    for k in kernels:
        if k["name"] == "fused_matching_bfloat16":
            k["launches_orbax_cli"] = orbax_rec["cli"]["launches"]["match_bf16"]
            k["launches_sharded_onboarding_forward"] = onboard_rec["match_bf16_launches"]
        elif k["name"] == "rasterizer":
            k["launches_orbax_refine"] = orbax_rec["refine"]["raster_launches"]


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

    # 17. the image decoders on the host, against the fixtures' manifest
    phase_codecs(smi)

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
    store32 = dataclasses.replace(store, ae_features=store.ae_features.float())
    phase_forward_b32([("bf16", est, store), ("int8", est8, store8),
                       ("bf16_f32store", est, store32)], scenes[2], dev)
    # 18a. the view-sharded store on [cuda:0] * S, on phase 9's request
    sharded = phase_sharded(est, store, store32, scenes[2], dev, smi)
    del store32
    # 20c. object-parallel onboarding of phase 4's objects; 20b. the ViT split
    # over two processes
    onboard_rec = phase_sharded_onboarding(est, store, templates, scenes[2], dev, smi)
    phase_tp(smi)

    # 15.1-15.3: the int8 IST at B=32: its kernels at every convolution shape,
    # the whole int8 IST on phase 9's request, the forward with the int8 AE
    # and the static int8 IST, card against CPU (15.4 runs after phase 14)
    ist_rec = {"kernels": phase_ist_kernels(dev)}
    ist_rec.update(phase_ist_forward(est, est8, templates, scenes[2], dev, smi))
    del est, est8, store, store8, preds, preds8
    torch.cuda.empty_cache()

    # 10. the CLI on the card: a BOP dataset on disk through cli.main; 11.
    # refinement on the card, in that dataset;
    # 12. templates from CAD models and BOP scoring, beside that dataset;
    # 13. training on the card, in 12's dataset, served on 10's;
    # 14. MegaPose refinement on the card, in 10's dataset and 11's meshes;
    # 16. refiner training on the card, in 11's dataset, served on 10's
    # 15.4. the coarse CLI with the static int8 IST, in 10's dataset
    def after_cli(root, csv, info):
        rec = phase_refinement(root, csv, dev, smi)
        # 20a. the JAX trainers' orbax checkpoints, served (phase 11 wrote the meshes)
        rec["orbax"] = phase_orbax(root, csv, smi)
        # 18b / 18d. the coarse and the refine CLI in two processes
        rec["multiprocess"] = phase_multiprocess_cli(root, csv, smi)
        rec["templates"] = phase_templates(root, dev, smi)
        rec["training"] = phase_training(root, dev, smi)
        rec["megapose"] = phase_megapose(root, csv, dev, smi)
        rec["refiner_training"] = phase_refiner_training(root, csv, dev, smi)
        t0 = time.perf_counter()
        rec["ist_cli"] = phase_ist_cli(root, info, dev, smi)
        log("ist_cli_phase", seconds=f"{time.perf_counter() - t0:.1f}")
        return rec

    cli_rec = phase_cli(templates, dev, smi, then=after_cli)

    # 19. the port's selfcheck_full on the card, at a cut budget
    selfcheck = phase_selfcheck(dev, smi)

    kernels = kernel_records(record, qrec, krec, stats, bf16_counts, int8_counts, forwards,
                             cli_rec)
    add_leg_launches(kernels, sharded, cli_rec["then"]["multiprocess"])
    kernels.append(raster_record(cli_rec["then"]))
    kernels += ist_kernel_records(ist_rec, cli_rec["then"]["ist_cli"])
    add_selfcheck_launches(kernels, selfcheck["launches"])
    add_phase20_launches(kernels, cli_rec["then"]["orbax"], onboard_rec)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
