"""Refiner and scorer training from CAD models alone (port of
gigapose_tpu/refiner/training.py).

Render and perturb: sample a pose, render the observed 480 x 640 view at it,
perturb the pose, crop around the perturbed pose and render it through the
crop camera, and train RefinerNet to predict the update with the
disentangled loss of MegaPose (each head's output scored with the other two
set to their ground truth, as the mean L1 distance of the object's points).
CoarseScorerNet trains as a binary classifier on three classes per sample
(see `train_refiner`).

- The batches (`synthetic_refiner_batches`) draw from one
  np.random.Generator in the JAX package's order and render through the
  host rasterizer, so both packages give the same bytes for one seed; the
  observed views render on MeshStore's thread pool after every draw of the
  batch is made.
- The nets train in BatchNorm's training mode with flax's statistics
  (models/flax_bn.py), in f32 with TF32 off (refiner.no_tf32), as the JAX
  package runs them at precision "highest".
- Adam is optax.adam's arithmetic (training/state.py:Adam with no weight
  decay and no warm-up), one per net, each with its own optional
  global-norm clip, as the JAX package chains clip_by_global_norm before
  each adam.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from scipy.spatial.transform import Rotation
from torch.nn import functional as F

from gigapose_tpu_torch.refiner import ops as R
from gigapose_tpu_torch.refiner.refiner import MeshStore, RenderCompareRefiner, no_tf32
from gigapose_tpu_torch.training.state import Adam
from gigapose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def transform_points_batch(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4) poses, (B, N, 3) points -> (B, N, 3) R p + t."""
    return torch.einsum("bij,bnj->bni", T[:, :3, :3], pts) + T[:, None, :3, 3]


def refiner_disentangled_loss(TCO_gt: torch.Tensor, TCO_input: torch.Tensor,
                              net_out: torch.Tensor, K_crop: torch.Tensor,
                              points: torch.Tensor, tCR: torch.Tensor
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MegaPose disentangled loss on (B, 9) net outputs (ortho6d, vx vy
    vz): the orientation term (predicted dR, ground-truth translation heads),
    the xy term (predicted vx vy, ground-truth rotation and depth) and the z
    term (predicted vz, ground-truth rotation and xy), each the mean L1
    distance of `points` moved by the updated pose from the ground truth;
    -> (the mean of their sum, {loss_orn, loss_xy, loss_z, loss})."""
    dR = R.rotation_from_ortho6d(net_out[:, :6])
    vxvy, vz = net_out[:, 6:8], net_out[:, 8:9]
    fxfy = torch.stack([K_crop[:, 0, 0], K_crop[:, 1, 1]], dim=-1)

    dR_gt = torch.einsum("bij,bkj->bik", TCO_gt[:, :3, :3], TCO_input[:, :3, :3])
    tCR_out_gt = TCO_gt[:, :3, 3] - torch.einsum("bij,bj->bi", dR_gt, TCO_input[:, :3, 3] - tCR)
    vz_gt = tCR_out_gt[:, 2:3] / tCR[:, 2:3]
    vxvy_gt = fxfy * (tCR_out_gt[:, :2] / tCR_out_gt[:, 2:3] - tCR[:, :2] / tCR[:, 2:3])

    def upd(v, rot):
        return R.pose_update_with_reference_point(TCO_input, K_crop, v, rot, tCR)

    T_orn = TCO_gt.clone()
    T_orn[:, :3, :3] = upd(torch.cat([vxvy_gt, vz_gt], -1), dR)[:, :3, :3]
    T_xy = TCO_gt.clone()
    T_xy[:, :2, 3] = upd(torch.cat([vxvy, vz_gt], -1), dR_gt)[:, :2, 3]
    T_z = TCO_gt.clone()
    T_z[:, 2, 3] = upd(torch.cat([vxvy_gt, vz], -1), dR_gt)[:, 2, 3]

    gt_pts = transform_points_batch(TCO_gt, points)
    dist = lambda T: (transform_points_batch(T, points) - gt_pts).abs().mean((-1, -2))
    loss_orn, loss_xy, loss_z = dist(T_orn), dist(T_xy), dist(T_z)
    total = (loss_orn + loss_xy + loss_z).mean()
    return total, {"loss_orn": loss_orn.mean(), "loss_xy": loss_xy.mean(),
                   "loss_z": loss_z.mean(), "loss": total}


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy: -y log_sigmoid(x) - (1 - y)
    log_sigmoid(-x), per element."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


@dataclasses.dataclass
class PerturbConfig:
    """The pose perturbation of synthetic refiner training (MegaPose trains
    on noised ground-truth poses)."""

    rot_deg: float = 10.0
    trans_xy: float = 0.01  # metres
    trans_z: float = 0.02  # metres


def sample_perturbation(rng: np.random.Generator, cfg: PerturbConfig) -> np.ndarray:
    """A (4, 4) f64 perturbation: xyz Euler angles uniform in +-rot_deg, then
    the xy and z offsets uniform in their ranges."""
    T = np.eye(4)
    angles = rng.uniform(-cfg.rot_deg, cfg.rot_deg, 3)
    T[:3, :3] = Rotation.from_euler("xyz", angles, degrees=True).as_matrix()
    T[:2, 3] = rng.uniform(-cfg.trans_xy, cfg.trans_xy, 2)
    T[2, 3] = rng.uniform(-cfg.trans_z, cfg.trans_z)
    return T


Perturb = Union[PerturbConfig, Callable[[int], PerturbConfig]]


def synthetic_refiner_batches(meshes: MeshStore, K: np.ndarray, batch_size: int = 4,
                              image_hw: Tuple[int, int] = (480, 640),
                              z_range: Tuple[float, float] = (0.35, 0.7),
                              perturb: Perturb = PerturbConfig(), seed: int = 0
                              ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches of {images (B, 3, H, W) f32 in [0, 1], K (B, 3, 3),
    labels (B,), TCO_gt, TCO_init (B, 4, 4) f32 metres}: each observed image
    the host render of a random label at a random pose (a uniform rotation,
    x and y uniform in +-5 cm, z in z_range), the init pose its rotation
    perturbed about the object and its translation offset
    (`sample_perturbation` of `perturb`, or of `perturb(step)` from step 1).
    Every draw of a batch is made in the JAX package's order before its
    views render."""
    rng = np.random.default_rng(seed)
    labels_avail = sorted(meshes.rasterizers)
    H, W = image_hw
    perturb_fn = perturb if callable(perturb) else (lambda step: perturb)
    step_idx = 0
    while True:
        step_idx += 1
        cur_perturb = perturb_fn(step_idx)
        labels = rng.choice(labels_avail, batch_size)
        TCO_gt = np.tile(np.eye(4, dtype=np.float32), (batch_size, 1, 1))
        TCO_init = np.zeros_like(TCO_gt)
        Ks = np.tile(K[None], (batch_size, 1, 1)).astype(np.float32)
        for i in range(batch_size):
            TCO_gt[i, :3, :3] = Rotation.random(random_state=rng.integers(1 << 30)).as_matrix()
            TCO_gt[i, 0, 3] = rng.uniform(-0.05, 0.05)
            TCO_gt[i, 1, 3] = rng.uniform(-0.05, 0.05)
            TCO_gt[i, 2, 3] = rng.uniform(*z_range)
            # the rotation perturbed about the object, the translation
            # offset (MegaPose noises R and t independently)
            P = sample_perturbation(rng, cur_perturb)
            TCO_init[i] = TCO_gt[i]
            TCO_init[i, :3, :3] = P[:3, :3] @ TCO_gt[i, :3, :3]
            TCO_init[i, :3, 3] = TCO_gt[i, :3, 3] + P[:3, 3]
        images = meshes.render_batch(labels, TCO_gt, Ks, (H, W))
        yield dict(images=images, K=Ks, labels=labels, TCO_gt=TCO_gt, TCO_init=TCO_init)


def curriculum(steps: int, start: PerturbConfig, end: PerturbConfig
               ) -> Callable[[int], PerturbConfig]:
    """The linear curriculum: `start` at step 0, `end` from `steps` on."""
    n = max(steps, 1)

    def at(step: int) -> PerturbConfig:
        w = min(step / n, 1.0)
        lerp = lambda a, b: a + (b - a) * w
        return PerturbConfig(rot_deg=lerp(start.rot_deg, end.rot_deg),
                             trans_xy=lerp(start.trans_xy, end.trans_xy),
                             trans_z=lerp(start.trans_z, end.trans_z))

    return at


def refiner_step(net, opt: Adam, opt_state: Dict, crops, renders, TCO_in, K_crop, tCR,
                 TCO_gt, points) -> Dict[str, torch.Tensor]:
    """One Adam step of RefinerNet (training mode) on the disentangled loss;
    -> the loss terms before the update (detached)."""
    net.train()
    net.zero_grad(set_to_none=True)
    out = net(torch.cat([crops, renders], dim=1))
    loss, aux = refiner_disentangled_loss(TCO_gt, TCO_in, out, K_crop, points, tCR)
    loss.backward()
    opt.update(opt_state, {"refiner": net})
    return {k: v.detach() for k, v in aux.items()}


def scorer_step(net, opt: Adam, opt_state: Dict, crops, renders, labels01) -> torch.Tensor:
    """One Adam step of CoarseScorerNet (training mode) on the mean sigmoid
    cross-entropy; -> the loss before the update (detached)."""
    net.train()
    net.zero_grad(set_to_none=True)
    logits = net(torch.cat([crops, renders], dim=1))
    loss = sigmoid_binary_cross_entropy(logits, labels01).mean()
    loss.backward()
    opt.update(opt_state, {"scorer": net})
    return loss.detach()


def step_inputs(refiner: RenderCompareRefiner, batch: Dict[str, np.ndarray],
                train_scorer: bool = True, timing: Optional[dict] = None):
    """The inputs of one training step on the refiner's device, from a
    synthetic_refiner_batches batch -> (refiner_step's (crops, renders,
    TCO_in, K_crop, tCR, TCO_gt, points), scorer_step's (crops, renders,
    labels) or None). The crop around the init pose and, for the scorer,
    around the ground truth, with one fetch of both packs; then the input
    renders and the scorer's (the ground truth in its own crop and in the
    init crop's camera) in one call on the host pool, uploaded as uint8.
    The scorer's classes, in JAX's order: own-frame positives, shared-frame
    positives, negatives. `timing` gains "crop" (the uploads of the batch,
    the crop steps, the fetch) and "render" (the renders and their upload)."""
    t0 = time.perf_counter()
    put = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(refiner.device)
    labels = batch["labels"]
    B = len(labels)
    images, Ks, TCO_gt = put(batch["images"]), put(batch["K"]), put(batch["TCO_gt"])
    pts = put(np.stack([refiner.meshes.points[int(l)] for l in labels]))
    with torch.no_grad():
        TCO_in, tCR, K_crop, crops, pack = refiner._crop_step(images, Ks, put(batch["TCO_init"]),
                                                               pts)
        if train_scorer:
            _, _, _, crops_gt, pack_gt = refiner._crop_step(images, Ks, TCO_gt, pts)
            pack = torch.cat([pack, pack_gt])
    pack_h = pack.cpu().numpy()  # the one fetch of the step
    t0 = _lap(timing, "crop", t0)
    if train_scorer:
        init_h, gt_h = pack_h[:B], pack_h[B:]
        shared = np.concatenate([gt_h[:, :16], init_h[:, 16:]], axis=1)
        pack_h = np.concatenate([init_h, gt_h, shared])
    renders = refiner._upload(refiner._render_host(
        np.concatenate([labels] * (len(pack_h) // B)), pack_h, refiner.config.render_size))
    _lap(timing, "render", t0)
    r_in = (crops, renders[:B], TCO_in, K_crop, tCR, TCO_gt, pts)
    if not train_scorer:
        return r_in, None
    y = torch.cat([torch.ones(2 * B, device=refiner.device), torch.zeros(B, device=refiner.device)])
    return r_in, (torch.cat([crops_gt, crops, crops]),
                  torch.cat([renders[B:2 * B], renders[2 * B:], renders[:B]]), y)


def _lap(timing: Optional[dict], key: str, t0: float) -> float:
    t1 = time.perf_counter()
    if timing is not None:
        timing[key] = timing.get(key, 0.0) + (t1 - t0)
    return t1


def train_refiner(refiner: RenderCompareRefiner, K: np.ndarray, steps: int = 200,
                  batch_size: int = 4, lr: float = 3e-4, seed: int = 0, log_every: int = 20,
                  train_scorer: bool = True, perturb: PerturbConfig = PerturbConfig(),
                  final_perturb: Optional[PerturbConfig] = None, grad_clip: float = 0.0,
                  timing: Optional[dict] = None) -> RenderCompareRefiner:
    """Render-and-perturb training of the refiner (and the scorer), in place
    on `refiner`'s nets, on its device; -> the refiner, its nets back in eval
    mode, with `loss_history` (the refiner loss of every step) and
    `scorer_loss_history` (the scorer's BCE, with train_scorer).

    Per step: the crop around the perturbed pose and the input render
    through its crop camera, one refiner step; with train_scorer one scorer
    step on three classes per sample, as inference queries the scorer
    (refiner.py keep_best_init):
    1. the ground-truth pose rendered in its own crop (aligned, centred):
       positive;
    2. the ground-truth pose rendered with the init crop's intrinsics against
       the init crop (aligned, off-centre; the referee compares candidates
       in the init frame, so alignment must outrank centring): positive;
    3. the perturbed init pose in its own crop (centred, misaligned):
       negative.
    `final_perturb` turns on the linear curriculum from `perturb` at step 1
    to `final_perturb` at `steps`; grad_clip > 0 clips each net's gradient
    to that global norm first. `timing`, a dict, collects seconds: "batch"
    (the batch's draws and observed renders), "crop" and "render"
    (`step_inputs`), "step" (both optimizer steps, up to the losses' fetch)
    and "step_s" (each step's whole time)."""
    opt = Adam({"refiner": lr}, grad_clip=grad_clip)
    s_opt = Adam({"scorer": lr}, grad_clip=grad_clip)
    opt_state = opt.init({"refiner": refiner.refiner_net})
    s_opt_state = s_opt.init({"scorer": refiner.scorer_net})
    gen = synthetic_refiner_batches(
        refiner.meshes, K, batch_size=batch_size, seed=seed, image_hw=(480, 640),
        perturb=curriculum(steps, perturb, final_perturb) if final_perturb is not None
        else perturb)
    loss_history, scorer_history = [], []
    if timing is not None:
        timing.setdefault("step_s", [])
    with no_tf32():
        for step in range(1, steps + 1):
            t_step = t0 = time.perf_counter()
            batch = next(gen)
            t0 = _lap(timing, "batch", t0)
            r_in, s_in = step_inputs(refiner, batch, train_scorer, timing)
            t0 = time.perf_counter()
            aux = refiner_step(refiner.refiner_net, opt, opt_state, *r_in)
            if train_scorer:
                s_loss = scorer_step(refiner.scorer_net, s_opt, s_opt_state, *s_in)
                scorer_history.append(float(s_loss))
            loss_history.append(float(aux["loss"]))
            t0 = _lap(timing, "step", t0)
            if timing is not None:
                timing["step_s"].append(t0 - t_step)
            if step % log_every == 0 or step == 1:
                msg = {k: round(float(v), 5) for k, v in aux.items()}
                if train_scorer:
                    msg["scorer_bce"] = round(scorer_history[-1], 4)
                logger.info(f"refiner step {step}: {msg}")
    refiner.refiner_net.eval()
    refiner.scorer_net.eval()
    refiner.loss_history = loss_history
    refiner.scorer_loss_history = scorer_history
    return refiner
