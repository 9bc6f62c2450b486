"""Render-and-compare refinement (port of gigapose_tpu/refiner/refiner.py).

Per iteration (n_iterations, default 5 as the reference's refiner config):
normalize TCO and take the object origin as reference point; crop the
observed image around the projected object (deepim crop); render the object
at TCO through the crop camera; run RefinerNet on the concatenated crops;
update the pose about the reference point. Then CoarseScorerNet scores the
render at the final pose (sigmoid of its logit), and with keep_best_init the
init pose is kept where the scorer, in the init pose's crop frame, ranks it
strictly above the refined one.

Two forms of the loop, one result per sample whatever the form:
- host (`renderer="host"`): renders on the host with the C++ rasterizer
  (MeshStore's thread pool), one device -> host fetch per iteration (pose
  and crop intrinsics as one (B, 25) pack), uint8 renders uploaded and
  converted on the device; the whole batch in one chunk (the JAX package's
  pipelined form, chunks of the batch on 2 threads, is not ported: on an
  H100 it took 3.8x the time of one chunk);
- device (`renderer="device"`): every render rasterized on the device
  (render/rasterize.py: the CUDA kernel on the card), no host round trip
  until the result.

The nets and the crop run in f32 with TF32 off for their convolutions and
matmuls (scoped to each refine_batch call), as the JAX package runs them at
precision="highest".
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gigapose_tpu_torch.refiner import device_render as DR
from gigapose_tpu_torch.refiner import ops as R
from gigapose_tpu_torch.refiner.network import CoarseScorerNet, RefinerNet, init_like_flax_
from gigapose_tpu_torch.render.mesh_io import load_vertices
from gigapose_tpu_torch.render.rasterizer import Rasterizer
from gigapose_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RefinerConfig:
    n_iterations: int = 5
    render_size: Tuple[int, int] = (160, 160)  # megapose render / crop size
    lamb: float = 1.4
    n_sample_points: int = 500
    # "host": C++ raster on the host, one fetch per iteration; "device": the
    # whole loop on the device with the device rasterizer
    renderer: str = "host"
    # device renderer only: per-mesh face budget (vertex-clustering
    # decimation); None renders the exact mesh. The host raster always
    # renders the exact mesh.
    device_max_faces: Optional[int] = None
    # score the init pose too, in the init pose's crop frame, and keep it
    # where it scores strictly higher than the refined pose; reported scores
    # stay own-frame
    keep_best_init: bool = True


@contextlib.contextmanager
def no_tf32():
    """f32 convolutions and matmuls without TF32 for the duration (cuDNN
    allows TF32 by default); the flags are process-wide, so the context
    wraps whole refine_batch calls."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = old


def crop_boxes_K(K, TCO, points, im_size, render_size, lamb):
    """The deepim crop box around the object's projection at TCO and the
    crop camera's intrinsics -> (boxes (B, 4), K_crop (B, 3, 3))."""
    boxes_rend = R.boxes_from_uv(R.project_points_robust(points, K, TCO))
    center_uv = R.project_points_robust(points.new_zeros((TCO.shape[0], 1, 3)), K, TCO)
    boxes_crop = R.deepim_boxes(center_uv, boxes_rend, boxes_rend, im_size=im_size, lamb=lamb)
    return boxes_crop, R.get_K_crop_resize(K, boxes_crop, im_size, render_size)


def crop_prep(images, K, TCO, points, render_size, lamb):
    """The per-iteration crop math (deepim crop around the projected object,
    ref: pose_rigid.py:221-260) -> (TCO_n, tCR, K_crop, crops)."""
    TCO_n = R.normalize_T(TCO)
    tCR = TCO_n[:, :3, 3]
    im_size = tuple(images.shape[-2:])
    boxes_crop, K_crop = crop_boxes_K(K, TCO_n, points, im_size, render_size, lamb)
    crops = R.crop_images_to_boxes(images, boxes_crop, render_size, sampling_ratio=4)
    return TCO_n, tCR, K_crop, crops


def pose_update(net, crops, renders, TCO, K_crop, tCR):
    """One refiner step: the net's 9-d output on (crops, renders) as an
    ortho6d rotation and (vx, vy, vz), applied about the reference point."""
    out = net(torch.cat([crops, renders], dim=1))
    dR = R.rotation_from_ortho6d(out[:, :6])
    return R.pose_update_with_reference_point(TCO, K_crop, out[:, 6:9], dR, tCR)


class MeshStore:
    """Per-label host rasterizers and sampled surface points (the
    reference's MeshDataBase.batched()). Renders run on a thread pool: the
    C++ render releases the GIL."""

    def __init__(self, mesh_paths: Dict[int, str], n_points: int = 500):
        self.rasterizers: Dict[int, Rasterizer] = {}
        self.points: Dict[int, np.ndarray] = {}
        self.unit_to_m: Dict[int, float] = {}
        workers = max(1, (os.cpu_count() or 1) - 1)
        self._pool = ThreadPoolExecutor(workers) if workers > 1 else None
        for label, path in mesh_paths.items():
            r = Rasterizer(path)
            self.rasterizers[label] = r
            self.unit_to_m[label] = 1e-3 if r.diameter > 5.0 else 1.0  # mm vs m meshes
            self.points[label] = self._sample_points(path, n_points) * self.unit_to_m[label]

    @staticmethod
    def _sample_points(path: str, n: int) -> np.ndarray:
        """Deterministic vertex subsample (ref: pose_rigid.py:221)."""
        verts = load_vertices(path)
        if len(verts) >= n:
            return verts[np.linspace(0, len(verts) - 1, n).astype(int)]
        reps = int(np.ceil(n / max(len(verts), 1)))
        return np.tile(verts, (reps, 1))[:n]

    def render_batch(self, labels: np.ndarray, TCO: np.ndarray, K: np.ndarray,
                     size: Tuple[int, int], out_dtype=np.float32,
                     render_normals: bool = False) -> np.ndarray:
        """(B,) labels, (B, 4, 4) poses in metres, (B, 3, 3) K -> (B, C, H, W)
        renders: f32 in [0, 1], or with out_dtype=np.uint8 the raw bytes
        (a quarter of the upload; the device converts them exactly). C = 3,
        or 6 with render_normals (f32 only): RGB and the camera-space normal
        encoded as frac(nx, nz, -ny) on the object, 0 elsewhere (the
        reference's eye-space normal, wrapped as a repeating 3D texture in
        Panda3D's z-up frame). Each pose's translation is divided by the
        mesh unit in the pose's own dtype."""
        H, W = size
        if render_normals and out_dtype != np.float32:
            raise ValueError("normals are rendered as f32 only")
        out = np.zeros((len(labels), 6 if render_normals else 3, H, W), out_dtype)

        def render_one(i: int):
            label = int(labels[i])
            pose = TCO[i].copy()
            pose[:3, 3] /= self.unit_to_m[label]  # metres -> mesh units
            rgba, _, nrm = self.rasterizers[label].render_full(K[i], pose, W, H,
                                                               normals=render_normals)
            if render_normals:
                enc = np.stack([nrm[..., 0], nrm[..., 2], -nrm[..., 1]], axis=-1)
                enc = np.where((rgba[..., 3] > 0)[..., None], enc - np.floor(enc), 0.0)
                out[i, 3:] = enc.transpose(2, 0, 1)
            rgb = rgba[..., :3].transpose(2, 0, 1)
            out[i, :3] = rgb if out_dtype == np.uint8 else rgb.astype(np.float32) / 255.0

        if self._pool is not None and len(labels) > 1:
            list(self._pool.map(render_one, range(len(labels))))
        else:
            for i in range(len(labels)):
                render_one(i)
        return out

    def render_multiview_batch(self, labels: np.ndarray, TCV_O: np.ndarray, KV: np.ndarray,
                               size: Tuple[int, int], render_normals: bool = False
                               ) -> np.ndarray:
        """(B,) labels, (B, V, 4, 4) poses, (B, V, 3, 3) K -> (B, V * C, H,
        W) f32: each hypothesis rendered from V viewpoints, the views'
        channels concatenated (the layout the MegaPose refiner's backbone
        reads)."""
        B, V = TCV_O.shape[:2]
        flat = self.render_batch(np.repeat(labels, V), TCV_O.reshape(B * V, 4, 4),
                                 KV.reshape(B * V, 3, 3), size, render_normals=render_normals)
        return flat.reshape(B, V * flat.shape[1], *size)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


@dataclasses.dataclass
class RenderCompareRefiner:
    """The nets and the mesh store; refines batches of (image, K, label, TCO)."""

    refiner_net: RefinerNet
    scorer_net: CoarseScorerNet
    meshes: MeshStore
    config: RefinerConfig = RefinerConfig()
    device: torch.device = torch.device("cpu")
    # optional phase-time accumulator (seconds), host renderer only: set to a
    # dict to collect {"fetch": device step + the pack's fetch, "render":
    # host raster, "upload_update": render upload + net dispatch}
    timing: Optional[dict] = None
    _device_pack: Optional[DR.DeviceMeshes] = dataclasses.field(default=None, repr=False)

    @classmethod
    def create(cls, mesh_paths: Dict[int, str], seed: int = 0,
               config: RefinerConfig = RefinerConfig(), refiner_width: int = 64,
               scorer_width: int = 32, device=None) -> "RenderCompareRefiner":
        """Seeded random nets in flax's init scheme (the pose head the
        identity update) on `device` (default cuda:0; no card raises)."""
        device = resolve_device(device, "the refiner")
        gen = torch.Generator().manual_seed(seed)
        rnet = init_like_flax_(RefinerNet(width=refiner_width), gen).to(device)
        snet = init_like_flax_(CoarseScorerNet(width=scorer_width), gen).to(device)
        return cls(rnet, snet, MeshStore(mesh_paths, config.n_sample_points), config, device)

    # ------------------------------------------------------------ device steps

    def _crop_step(self, images, K, TCO, points):
        TCO_n, tCR, K_crop, crops = crop_prep(images, K, TCO, points, self.config.render_size,
                                              self.config.lamb)
        B = TCO.shape[0]
        pack = torch.cat([TCO_n.reshape(B, 16), K_crop.reshape(B, 9)], dim=1)
        return TCO_n, tCR, K_crop, crops, pack

    def _update_step(self, crops, renders, TCO, K_crop, tCR):
        return pose_update(self.refiner_net, crops, renders, TCO, K_crop, tCR)

    def _score(self, crops, renders):
        return torch.sigmoid(self.scorer_net(torch.cat([crops, renders], dim=1)))

    # ------------------------------------------------------------- entry point

    def refine_batch(self, images: np.ndarray, K: np.ndarray, labels: np.ndarray,
                     TCO_init: np.ndarray, n_iterations: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, 3, H, W) float [0, 1] full images, (B, 3, 3) K, (B,) labels,
        (B, 4, 4) init poses in metres -> (refined TCO (B, 4, 4), scores (B,)),
        numpy. config.renderer picks the device loop or the host loop."""
        n_it = n_iterations or self.config.n_iterations
        args = (images, K, labels, TCO_init, n_it)
        with no_tf32(), torch.inference_mode():
            if self.config.renderer == "device":
                return self._refine_batch_device(*args)
            if self.config.renderer != "host":
                raise ValueError(f"renderer must be host or device, not {self.config.renderer!r}")
            return self._refine_batch_host(*args)

    def _inputs(self, images, K, labels, TCO_init):
        put = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(self.device)
        points = np.stack([self.meshes.points[int(l)] for l in labels])
        return put(images), put(K), put(points), put(TCO_init)

    def _lap(self, key: str, t0: float) -> float:
        t1 = time.perf_counter()
        if self.timing is not None:
            self.timing[key] = self.timing.get(key, 0.0) + (t1 - t0)
        return t1

    def _render_host(self, labels, pack_h, size):
        B = len(labels)
        return self.meshes.render_batch(labels, pack_h[:, :16].reshape(B, 4, 4),
                                        pack_h[:, 16:].reshape(B, 3, 3), size,
                                        out_dtype=np.uint8)

    def _upload(self, renders: np.ndarray) -> torch.Tensor:
        return DR.as_f01(torch.from_numpy(renders).to(self.device))

    def _refine_batch_host(self, images, K, labels, TCO_init, n_it):
        imgs, Kd, pts, TCO0 = self._inputs(images, K, labels, TCO_init)
        size = self.config.render_size
        TCO = TCO0
        for _ in range(n_it):
            t0 = time.perf_counter()
            TCO, tCR, K_crop, crops, pack = self._crop_step(imgs, Kd, TCO, pts)
            pack_h = pack.cpu().numpy()  # the one fetch of the iteration
            t0 = self._lap("fetch", t0)
            renders = self._render_host(labels, pack_h, size)
            t0 = self._lap("render", t0)
            TCO = self._update_step(crops, self._upload(renders), TCO, K_crop, tCR)
            self._lap("upload_update", t0)
        # scoring at the final pose (ref: forward_scoring_model)
        _, _, _, crops, pack = self._crop_step(imgs, Kd, TCO, pts)
        pack_h = pack.cpu().numpy()
        scores = self._score(crops, self._upload(self._render_host(labels, pack_h, size)))
        scores = scores.cpu().numpy()
        B = len(labels)
        TCO_out = pack_h[:, :16].reshape(B, 4, 4)
        if self.config.keep_best_init:
            # referee init against refined in the init pose's crop frame:
            # both rendered with the init crop's intrinsics against the
            # init-frame observed crop
            _, _, _, crops0, pack0 = self._crop_step(imgs, Kd, TCO0, pts)
            pack0_h = pack0.cpu().numpy()
            s0 = self._score(crops0, self._upload(self._render_host(labels, pack0_h, size)))
            shared = np.concatenate([TCO_out.reshape(B, 16), pack0_h[:, 16:]], axis=1)
            s_ref = self._score(crops0, self._upload(self._render_host(labels, shared, size)))
            s0, s_ref = s0.cpu().numpy(), s_ref.cpu().numpy()
            keep = s0 > s_ref
            TCO_out = np.where(keep[:, None, None], pack0_h[:, :16].reshape(B, 4, 4), TCO_out)
            scores = np.where(keep, s0, scores)  # s0 is the init's own-frame score
        return TCO_out, scores

    # ----------------------------------------------------------- device path

    def _pack(self) -> DR.DeviceMeshes:
        """The meshes packed on the device (built at first use)."""
        if self._device_pack is None:
            paths = {l: r.mesh_path for l, r in self.meshes.rasterizers.items()}
            self._device_pack = DR.build_device_meshes(
                paths, self.meshes.unit_to_m, self.device, max_faces=self.config.device_max_faces)
        return self._device_pack

    def _refine_batch_device(self, images, K, labels, TCO_init, n_it):
        cfg = self.config
        pack = self._pack()
        rows = torch.as_tensor(pack.rows_for(labels)).to(self.device)
        verts, faces, colors = pack.verts[rows], pack.faces[rows], pack.colors[rows]
        imgs, Kd, pts, TCO0 = self._inputs(images, K, labels, TCO_init)
        render = lambda TCO_n, K_crop: DR.render_rgb(verts, faces, colors, K_crop, TCO_n,
                                                     cfg.render_size)
        TCO = TCO0
        for _ in range(n_it):
            TCO, tCR, K_crop, crops = crop_prep(imgs, Kd, TCO, pts, cfg.render_size, cfg.lamb)
            TCO = self._update_step(crops, render(TCO, K_crop), TCO, K_crop, tCR)
        TCO_n, _, K_crop, crops = crop_prep(imgs, Kd, TCO, pts, cfg.render_size, cfg.lamb)
        scores = self._score(crops, render(TCO_n, K_crop))
        if cfg.keep_best_init:
            TCO_0, _, K_crop0, crops0 = crop_prep(imgs, Kd, TCO0, pts, cfg.render_size, cfg.lamb)
            s0 = self._score(crops0, render(TCO_0, K_crop0))
            s_ref = self._score(crops0, render(TCO_n, K_crop0))
            keep = s0 > s_ref
            TCO_n = torch.where(keep[:, None, None], TCO_0, TCO_n)
            scores = torch.where(keep, s0, scores)
        return TCO_n.cpu().numpy(), scores.cpu().numpy()
