"""The MegaPose refiner, scorer and SO(3)-grid coarse classifier with the
released checkpoints' architecture (port of
gigapose_tpu/refiner/megapose_refiner.py).

- `refine_batch`: per iteration, normalize TCO, crop the observed image
  around the projected object (deepim crop), render the object in V views
  (view 0 through the crop camera; V = n_rendered_views, the reference's
  make_TCO_multiview), and update the pose from the refiner net's output
  on (crop, renders); then `score_batch` at the final pose.
- `score_batch`: the coarse model's sigmoid logit on (crop, one render),
  whatever n_rendered_views is.
- `classify_coarse`: every rotation of the SO(3) grid per detection, at
  the depth that fits the detection box (autodepth), scored in chunks of
  64, the last chunk padded with identity rotations; the top-k by
  np.argsort(-scores) on host scores, as the JAX package picks among ties.
- `from_checkpoints`: the released torch checkpoints (checkpoint.pth.tar)
  with the reference's key migration for older models.

The released models: WideResNet-34 width 1.0, renders of 240 x 320,
inputs = 3 image channels + n_rendered_views x 6 render channels (RGB and
normals), n_rendered_views = 1. Renders come from the host C++ rasterizer
(MeshStore's thread pool), uploaded once per iteration as f32; the nets and
the crop, pose and intrinsics math run on the refiner's device in f32 with
TF32 off (no_tf32), one device -> host fetch of (TCO, K_crop) per render.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gigapose_tpu_torch.refiner import ops as R
from gigapose_tpu_torch.refiner.megapose_net import CONFIG, MegaposePoseHeadNet
from gigapose_tpu_torch.refiner.multiview import make_TCO_multiview
from gigapose_tpu_torch.refiner.network import POSE_HEAD_BIAS, init_like_flax_
from gigapose_tpu_torch.refiner.refiner import (
    MeshStore,
    crop_boxes_K,
    crop_prep,
    no_tf32,
    pose_update,
)
from gigapose_tpu_torch.refiner.so3_grid import load_so3_grid
from gigapose_tpu_torch.utils.device import resolve_device
from gigapose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class MegaposeRefinerConfig:
    n_iterations: int = 5
    render_size: Tuple[int, int] = (240, 320)
    lamb: float = 1.4
    n_rendered_views: int = 1
    multiview_type: str = "TCO+front_3views"
    render_normals: bool = True
    n_sample_points: int = 500
    so3_grid_size: int = 576

    @property
    def n_render_channels(self) -> int:
        return 3 + (3 if self.render_normals else 0)

    @property
    def n_inputs(self) -> int:
        return 3 + self.n_render_channels * self.n_rendered_views


def change_keys_of_older_models(sd: Dict) -> Dict:
    """The reference's key migration for released checkpoints
    (models_compat.py): backbone.backbone.* -> backbone.*,
    backbone.head.0.* -> views_logits_head.*."""
    out = {}
    for k, v in sd.items():
        if k.startswith("backbone.backbone."):
            k = "backbone." + k[len("backbone.backbone."):]
        elif k.startswith("backbone.head.0."):
            k = "views_logits_head." + k[len("backbone.head.0."):]
        out[k] = v
    return out


def load_released_(net: MegaposePoseHeadNet, sd: Dict) -> MegaposePoseHeadNet:
    """Load a (migrated) PosePredictor state dict into `net`: every key the
    JAX converter reads, that is the backbone's and the net's own head's
    (pose_fc or views_logits_head). A missing key raises KeyError; other
    keys are ignored (a released model may carry the other head too)."""
    wanted = [k for k in net.state_dict() if not k.endswith("num_batches_tracked")]
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys of the {net.head} net, "
                       f"first {missing[0]!r}")
    net.load_state_dict({k: torch.as_tensor(sd[k]) for k in wanted}, strict=False)
    return net


@dataclasses.dataclass
class MegaposeRefiner:
    """The refiner and coarse nets on `device`, the meshes on the host."""

    refiner_net: MegaposePoseHeadNet
    coarse_net: MegaposePoseHeadNet
    meshes: MeshStore
    config: MegaposeRefinerConfig = MegaposeRefinerConfig()
    device: torch.device = torch.device("cpu")
    # optional phase-time accumulator (seconds) over every render pass
    # (iterations and scoring): set to a dict to collect {"fetch": device
    # crop step + the (TCO, K_crop) fetch, "render": host raster, "upload":
    # the renders' copy to the device, "update": the net's dispatch, and
    # the pose update's or the sigmoid's}
    timing: Optional[dict] = None

    # ---------------------------------------------------------- constructors

    @classmethod
    def create(cls, mesh_paths: Dict[int, str], seed: int = 0,
               config: MegaposeRefinerConfig = MegaposeRefinerConfig(), layers=CONFIG[34],
               width: float = 1.0, device=None) -> "MegaposeRefiner":
        """Seeded random nets with the released architecture, in flax's init
        scheme (refiner/network.py:init_like_flax_), the pose head the
        identity update (weight 0, bias POSE_HEAD_BIAS), so that an untrained
        refiner returns its init poses (a random head, as the JAX package
        draws it, throws poses behind the camera and to NaN), on `device`
        (default cuda:0; no card raises). The coarse net sees one render:
        3 + n_render_channels inputs."""
        device = resolve_device(device, "the MegaPose refiner")
        gen = torch.Generator().manual_seed(seed)
        rnet = MegaposePoseHeadNet(layers, width, "pose", n_inputs=config.n_inputs)
        cnet = MegaposePoseHeadNet(layers, width, "renderings_logits", n_rendered_views=1,
                                   n_inputs=3 + config.n_render_channels)
        rnet, cnet = (init_like_flax_(n, gen) for n in (rnet, cnet))
        with torch.no_grad():
            rnet.pose_fc.weight.zero_()
            rnet.pose_fc.bias.copy_(torch.tensor(POSE_HEAD_BIAS))
        return cls(rnet.to(device), cnet.to(device),
                   MeshStore(mesh_paths, config.n_sample_points), config, device)

    @classmethod
    def from_checkpoints(cls, refiner_ckpt: Optional[str], coarse_ckpt: Optional[str],
                         mesh_paths: Dict[int, str],
                         config: MegaposeRefinerConfig = MegaposeRefinerConfig(),
                         layers=CONFIG[34], width: float = 1.0, device=None
                         ) -> "MegaposeRefiner":
        """The nets of the released checkpoints (checkpoint.pth.tar: a dict
        of tensors, under "state_dict" or at the top); either path may be
        None, and that net keeps create()'s seeded weights. Read with
        torch.load(weights_only=True): tensors and plain containers only."""
        out = cls.create(mesh_paths, config=config, layers=layers, width=width, device=device)
        for path, net, what in ((refiner_ckpt, out.refiner_net, "refiner"),
                                (coarse_ckpt, out.coarse_net, "coarse")):
            if path:
                ckpt = torch.load(path, map_location="cpu", weights_only=True)
                load_released_(net, change_keys_of_older_models(ckpt.get("state_dict", ckpt)))
                logger.info(f"Loaded MegaPose {what} weights from {path}")
        return out

    # ------------------------------------------------------------- helpers

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def _points(self, labels: np.ndarray) -> np.ndarray:
        return np.stack([self.meshes.points[int(l)] for l in labels])

    def _lap(self, key: str, t0: float) -> float:
        t1 = time.perf_counter()
        if self.timing is not None:
            self.timing[key] = self.timing.get(key, 0.0) + (t1 - t0)
        return t1

    def _crop_fetch(self, imgs, Kd, TCO, pts):
        """crop_prep on the device, then the one fetch of (TCO_n, K_crop)
        that the host renders need."""
        TCO_n, tCR, K_crop, crops = crop_prep(imgs, Kd, TCO, pts, self.config.render_size,
                                              self.config.lamb)
        B = TCO.shape[0]
        pack = torch.cat([TCO_n.reshape(B, 16), K_crop.reshape(B, 9)], dim=1).cpu().numpy()
        return (TCO_n, tCR, K_crop, crops), pack[:, :16].reshape(B, 4, 4), pack[:, 16:].reshape(
            B, 3, 3)

    def _render_views(self, labels, TCO_n: np.ndarray, K: np.ndarray, K_crop: np.ndarray,
                      points: np.ndarray, im_size) -> np.ndarray:
        """Multi-view renders per hypothesis: (B, V * n_render_channels, H, W)
        f32. View 0 renders through the crop camera; with V > 1 the other
        views through their own deepim crop of the original camera K."""
        cfg = self.config
        TCO64 = np.asarray(TCO_n, np.float64)
        TCV_O = make_TCO_multiview(TCO64, TCO64[:, :3, 3], cfg.multiview_type,
                                   cfg.n_rendered_views)  # (B, V, 4, 4)
        B, V = TCV_O.shape[:2]
        if V != cfg.n_rendered_views:
            raise ValueError(f"multiview_type {cfg.multiview_type!r} yields {V} views but "
                             f"n_rendered_views={cfg.n_rendered_views} (the count includes "
                             f"the TCO view)")
        if V == 1:
            KV = np.asarray(K_crop, np.float32)[:, None]
        else:
            rep = lambda a: self._put(a).repeat_interleave(V, dim=0)
            _, KV = crop_boxes_K(rep(K), self._put(TCV_O.reshape(B * V, 4, 4)), rep(points),
                                 tuple(im_size), cfg.render_size, cfg.lamb)
            KV = KV.cpu().numpy().reshape(B, V, 3, 3)
            KV[:, 0] = K_crop
        return self.meshes.render_multiview_batch(labels, TCV_O.astype(np.float32), KV,
                                                  cfg.render_size,
                                                  render_normals=cfg.render_normals)

    def _score(self, imgs, Kd, pts, TCO, labels) -> torch.Tensor:
        """The coarse net's sigmoid at TCO on one render per hypothesis ->
        (B,) scores on the device."""
        t0 = time.perf_counter()
        (_, _, _, crops), TCO_n, K_crop = self._crop_fetch(imgs, Kd, TCO, pts)
        t0 = self._lap("fetch", t0)
        renders = self.meshes.render_batch(labels, TCO_n.astype(np.float64), K_crop,
                                           self.config.render_size,
                                           render_normals=self.config.render_normals)
        t0 = self._lap("render", t0)
        renders = self._put(renders)
        t0 = self._lap("upload", t0)
        scores = torch.sigmoid(self.coarse_net(torch.cat([crops, renders], dim=1))[:, 0])
        self._lap("update", t0)
        return scores

    # --------------------------------------------------------- entry points

    def refine_batch(self, images: np.ndarray, K: np.ndarray, labels: np.ndarray,
                     TCO_init: np.ndarray, n_iterations: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, 3, H, W) float [0, 1] full images, (B, 3, 3) K, (B,) labels,
        (B, 4, 4) init poses in metres -> (refined TCO (B, 4, 4), scores
        (B,)), numpy."""
        cfg = self.config
        n_it = cfg.n_iterations if n_iterations is None else n_iterations
        points = self._points(labels)
        im_size = images.shape[-2:]
        with no_tf32(), torch.inference_mode():
            imgs, Kd, pts, TCO = (self._put(a) for a in (images, K, points, TCO_init))
            for _ in range(n_it):
                t0 = time.perf_counter()
                (TCO, tCR, K_crop, crops), TCO_h, K_crop_h = self._crop_fetch(imgs, Kd, TCO, pts)
                t0 = self._lap("fetch", t0)
                renders = self._render_views(labels, TCO_h, K, K_crop_h, points, im_size)
                t0 = self._lap("render", t0)
                renders = self._put(renders)
                t0 = self._lap("upload", t0)
                TCO = pose_update(self.refiner_net, crops, renders, TCO, K_crop, tCR)
                self._lap("update", t0)
            scores = self._score(imgs, Kd, pts, TCO, labels)
            return TCO.cpu().numpy(), scores.cpu().numpy()

    def score_batch(self, images: np.ndarray, K: np.ndarray, labels: np.ndarray,
                    TCO: np.ndarray) -> np.ndarray:
        """The coarse model's pose score at TCO, sigmoid(logit) in [0, 1],
        (B,) numpy: one render per hypothesis whatever n_rendered_views."""
        points = self._points(labels)
        with no_tf32(), torch.inference_mode():
            args = (self._put(a) for a in (images, K, points, TCO))
            return self._score(*args, labels).cpu().numpy()

    def classify_coarse(self, images: np.ndarray, K: np.ndarray, labels: np.ndarray,
                        boxes: np.ndarray, top_k: int = 1, chunk: int = 64,
                        grid_size: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Score every rotation of the SO(3) grid per detection: (B, 3, H, W)
        full images, (B, 3, 3) K, (B,) labels, (B, 4) xyxy detection boxes
        -> (the top_k hypotheses' TCO (B, top_k, 4, 4), all scores (B, M))."""
        grid = load_so3_grid(grid_size or self.config.so3_grid_size)  # (M, 3, 3) f64
        M, B = grid.shape[0], len(labels)
        points = self._points(labels)
        all_scores = np.zeros((B, M), np.float32)
        all_TCO = np.zeros((B, M, 4, 4), np.float32)
        with no_tf32(), torch.inference_mode():
            for b in range(B):
                rep = lambda a: self._put(a[b:b + 1]).expand(chunk, *a.shape[1:])
                img, Kb, pts, box = rep(images), rep(K), rep(points), rep(boxes)
                lbl = np.repeat(labels[b:b + 1], chunk, 0)
                scores, TCOs = [], []
                for s in range(0, M, chunk):
                    n = min(chunk, M - s)
                    Rm = np.tile(np.eye(3, dtype=np.float32), (chunk, 1, 1))
                    Rm[:n] = grid[s:s + n]
                    TCO_h = R.TCO_init_from_boxes_autodepth_with_R(box, pts, Kb, self._put(Rm))
                    scores.append(self._score(img, Kb, pts, TCO_h, lbl)[:n])
                    TCOs.append(TCO_h[:n])
                all_scores[b] = torch.cat(scores).cpu().numpy()
                all_TCO[b] = torch.cat(TCOs).cpu().numpy()
        order = np.argsort(-all_scores, axis=1)[:, :top_k]
        best = np.take_along_axis(all_TCO, order[:, :, None, None], axis=1)
        return best, all_scores
