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
  converted on the device. The batch is refined in
  `config.pipeline_chunks` chunks (1 by default), split as the JAX
  package's pipelined loop splits it. One thread queues all device work,
  each chunk on its own CUDA stream; each pack is copied into pinned host
  memory without blocking, and one render thread waits on that copy's
  event, then renders. While it renders one chunk, the main thread queues
  the next steps of the others, so that one chunk's host renders overlap
  another's device work (on an H100 two chunks win only where the raster
  outweighs the eager dispatch that each chunk repeats; PERF.md). On the
  CPU the same schedule runs without streams;
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
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

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
    # host renderer only: refine the batch in this many chunks (bounds
    # np.linspace(0, B, n + 1), n = min(chunks, B)), each on its own CUDA
    # stream; the JAX package defaults to 2, the port to 1 (ROADMAP C)
    pipeline_chunks: int = 1


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
                     render_normals: bool = False, out: Optional[np.ndarray] = None
                     ) -> np.ndarray:
        """(B,) labels, (B, 4, 4) poses in metres, (B, 3, 3) K -> (B, C, H, W)
        renders: f32 in [0, 1], or with out_dtype=np.uint8 the raw bytes
        (a quarter of the upload; the device converts them exactly). C = 3,
        or 6 with render_normals (f32 only): RGB and the camera-space normal
        encoded as frac(nx, nz, -ny) on the object, 0 elsewhere (the
        reference's eye-space normal, wrapped as a repeating 3D texture in
        Panda3D's z-up frame). Each pose's translation is divided by the
        mesh unit in the pose's own dtype. `out`, when given, is the array
        of that shape and dtype to fill (every entry is written)."""
        H, W = size
        if render_normals and out_dtype != np.float32:
            raise ValueError("normals are rendered as f32 only")
        shape = (len(labels), 6 if render_normals else 3, H, W)
        if out is None:
            out = np.zeros(shape, out_dtype)
        elif out.shape != shape or out.dtype != out_dtype:
            raise ValueError(f"out is {out.dtype} {out.shape}, not {np.dtype(out_dtype)} {shape}")

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
    # None: the device of refiner_net's parameters
    device: Optional[torch.device] = None
    # optional phase-time accumulator (seconds), host renderer only: set to a
    # dict to collect the main thread's time in three parts, which sum to
    # the host loop's wall time: "fetch" waits for a chunk's pack (device
    # work not yet done), "render" for the host raster, "upload_update"
    # queues device work (the inputs, a render's upload, the net, the next
    # crop and the pack's copy). With one chunk, fetch and render are the
    # device step and the raster; with more, the parts of them left exposed
    timing: Optional[dict] = None
    _device_pack: Optional[DR.DeviceMeshes] = dataclasses.field(default=None, repr=False)
    # the host loop's CUDA streams, one per chunk (made at first use)
    _streams: List = dataclasses.field(default_factory=list, repr=False)
    # set by refiner/training.py:train_refiner: the refiner loss and the
    # scorer's BCE of every step
    loss_history: Optional[list] = dataclasses.field(default=None, repr=False)
    scorer_loss_history: Optional[list] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.device is None:
            self.device = next(self.refiner_net.parameters()).device

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
                if self.config.pipeline_chunks != 1:
                    raise ValueError("pipeline_chunks: the device renderer refines the batch "
                                     "in one chunk")
                return self._refine_batch_device(*args)
            if self.config.renderer != "host":
                raise ValueError(f"renderer must be host or device, not {self.config.renderer!r}")
            return self._refine_batch_host(*args)

    def _inputs(self, images, K, labels, TCO_init):
        points = np.stack([self.meshes.points[int(l)] for l in labels])
        return tuple(self._put(a) for a in (images, K, points, TCO_init))

    def _put(self, a) -> torch.Tensor:
        """Host array -> f32 on the device; to the card from pinned memory
        without blocking, on the current stream."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _fetch(self, pack: torch.Tensor) -> tuple:
        """Start the copy of a device tensor to the host -> (host tensor, the
        CUDA event that marks the copy done, or None off the card)."""
        if self.device.type != "cuda":
            return pack.cpu(), None
        host = torch.empty(pack.shape, dtype=pack.dtype, pin_memory=True)
        host.copy_(pack, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _upload(self, renders) -> torch.Tensor:
        renders = torch.as_tensor(renders)
        return DR.as_f01(renders.to(self.device, non_blocking=renders.is_pinned()))

    def _chunk_streams(self, n: int) -> list:
        """n CUDA streams for the host loop's chunks (None off the card)."""
        if self.device.type != "cuda":
            return [None] * n
        while len(self._streams) < n:
            self._streams.append(torch.cuda.Stream(self.device))
        return self._streams[:n]

    def _serve(self, request) -> tuple:
        """The render thread's work for one request (event, job): wait for
        the event (the pack on the host), then render the job's poses into
        pinned uint8 on the card's host (plain numpy off it) -> (renders or
        None, when the pack was ready)."""
        event, job = request
        if event is not None:
            event.synchronize()
        ready = time.perf_counter()
        if job is None:
            return None, ready
        labels, pack_h = job
        shape = (len(labels), 3, *self.config.render_size)
        out = torch.empty(shape, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        self._render_host(labels, np.asarray(pack_h), self.config.render_size, out=out.numpy())
        return out, ready

    def _render_host(self, labels, pack_h, size, out=None) -> np.ndarray:
        """uint8 renders of (B, 25) packs (pose, crop intrinsics) on the host."""
        B = len(labels)
        return self.meshes.render_batch(labels, pack_h[:, :16].reshape(B, 4, 4),
                                        pack_h[:, 16:].reshape(B, 3, 3), size,
                                        out_dtype=np.uint8, out=out)

    def _host_chunk(self, images, K, labels, TCO_init, n_it):
        """One chunk of the host loop, as a generator: it queues device
        work, yields a request for the render thread (see _serve) and is
        sent the renders back; it returns (poses, scores), numpy."""
        imgs, Kd, pts, TCO0 = self._inputs(images, K, labels, TCO_init)
        TCO = TCO0
        for _ in range(n_it):
            TCO, tCR, K_crop, crops, pack = self._crop_step(imgs, Kd, TCO, pts)
            pack_h, event = self._fetch(pack)  # the one fetch of the iteration
            renders = yield event, (labels, pack_h)
            TCO = self._update_step(crops, self._upload(renders), TCO, K_crop, tCR)
        # scoring at the final pose (ref: forward_scoring_model)
        _, _, _, crops, pack = self._crop_step(imgs, Kd, TCO, pts)
        pack_h, event = self._fetch(pack)
        scores = [self._score(crops, self._upload((yield event, (labels, pack_h))))]
        if self.config.keep_best_init:
            # referee init against refined in the init pose's crop frame:
            # both rendered with the init crop's intrinsics against the
            # init-frame observed crop
            _, _, _, crops0, pack0 = self._crop_step(imgs, Kd, TCO0, pts)
            pack0_h, event = self._fetch(pack0)
            scores.append(self._score(crops0, self._upload((yield event, (labels, pack0_h)))))
            shared = torch.cat([pack_h[:, :16], pack0_h[:, 16:]], dim=1)
            scores.append(self._score(crops0, self._upload((yield None, (labels, shared)))))
        scores_h, event = self._fetch(torch.stack(scores))
        yield event, None
        B = len(labels)
        TCO_out = pack_h[:, :16].numpy().reshape(B, 4, 4)
        scores = scores_h.numpy()
        if not self.config.keep_best_init:
            return TCO_out, scores[0]
        s, s0, s_ref = scores
        keep = s0 > s_ref
        TCO_out = np.where(keep[:, None, None], pack0_h[:, :16].numpy().reshape(B, 4, 4), TCO_out)
        return TCO_out, np.where(keep, s0, s)  # s0 is the init's own-frame score

    def _refine_batch_host(self, images, K, labels, TCO_init, n_it):
        """The host loop's schedule: the chunks' generators advanced in
        turn on the main thread, each inside its own stream; the render
        thread serves their requests in that order, and the next request
        goes to it before the main thread queues the steps that follow the
        one just served."""
        B = len(labels)
        n = max(1, min(int(self.config.pipeline_chunks), B))
        bounds = np.linspace(0, B, n + 1).astype(int)
        streams = self._chunk_streams(n)
        in_stream = lambda s: torch.cuda.stream(s) if s is not None else contextlib.nullcontext()
        if streams[0] is not None:  # work queued before the call comes first
            for s in streams:
                s.wait_stream(torch.cuda.current_stream(self.device))
        t0 = time.perf_counter()
        queue, results = deque(), [None] * n
        for i, s in enumerate(streams):
            part = slice(bounds[i], bounds[i + 1])
            gen = self._host_chunk(images[part], K[part], labels[part], TCO_init[part], n_it)
            with in_stream(s):
                queue.append((i, gen, s, next(gen)))
        with ThreadPoolExecutor(1) as worker:
            pending = worker.submit(self._serve, queue[0][3])
            while queue:
                i, gen, s, _ = queue.popleft()
                t0 = self._lap("upload_update", t0)
                renders, ready = pending.result()
                t1 = time.perf_counter()
                self._add("fetch", max(0.0, min(ready, t1) - t0))
                t0 = self._lap("render", max(t0, min(ready, t1)))
                pending = worker.submit(self._serve, queue[0][3]) if queue else None
                try:
                    with in_stream(s):
                        request = gen.send(renders)
                except StopIteration as stop:
                    results[i] = stop.value
                    continue
                queue.append((i, gen, s, request))
                if pending is None:
                    pending = worker.submit(self._serve, request)
        self._lap("upload_update", t0)
        return tuple(np.concatenate([r[k] for r in results]) for k in range(2))

    def _add(self, key: str, seconds: float) -> None:
        if self.timing is not None:
            self.timing[key] = self.timing.get(key, 0.0) + seconds

    def _lap(self, key: str, t0: float) -> float:
        t1 = time.perf_counter()
        self._add(key, t1 - t0)
        return t1

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
