"""Generator and driver of coarse-pose serving traffic (traffic `kind`
"coarse_images"): one client in a closed loop hands `CoarseRunner.run` one
camera image at a time with all of its detections, as the port's CLI does,
from an in-memory iterable that stops at the deadline.

All inputs come from the seed, on the card: each object's V template
renders (RGBA, an elliptic silhouette over a smooth random texture, black
outside it; random template poses at the template distance), and a pool of
scene images whose detections are template views of the labelled object
pasted, nearest-resized, at a random place and size over a smooth random
background. The detection counts follow the traffic file's cycle for every
seed, so every run offers the same work; the seed draws pixels, boxes,
labels and views.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import weights as W
from benchmark.reference import coarse as R
from benchmark.reference import nets as RN
from benchmark.reference.quant import make_quant
from benchmark.synth import make_templates, texture


@dataclasses.dataclass
class Scene:
    """One pool image: what the program is handed, and what the reference
    needs beside it (the same arrays)."""

    rgb: np.ndarray  # (H, W, 3) uint8
    masks: np.ndarray  # (N, H, W) uint8 {0, 1}
    boxes: np.ndarray  # (N, 4) int xyxy
    labels: np.ndarray  # (N,) 1-based store index
    obj_ids: np.ndarray  # (N,) dataset object ids


def make_scene(g: torch.Generator, t: dict, n: int, templates: list, device) -> Scene:
    H, W_ = t["image_hw"]
    O = len(t["object_ids"])
    img = (texture(g, 1, H, W_, device)[0] * 255).round().to(torch.uint8)  # (3, H, W)
    labels = torch.randint(0, O, (n,), generator=g, device=device)
    V = templates[0][0].shape[0]
    views = torch.randint(0, V, (n,), generator=g, device=device)
    u = torch.rand(n, 3, generator=g, device=device)
    lo, hi = t["box_px"]
    masks = torch.zeros(n, H, W_, dtype=torch.uint8, device=device)
    boxes = torch.zeros(n, 4, dtype=torch.int64, device=device)
    for i in range(n):  # one paste per detection, later ones on top
        rgba, tb, _ = templates[int(labels[i])]
        x0, y0, x1, y1 = (int(v) for v in tb[int(views[i])])
        src = rgba[int(views[i]), :, y0:y1, x0:x1]
        L = lo + (hi - lo) * float(u[i, 0])
        s = L / max(x1 - x0, y1 - y0)
        w, h = max(1, round((x1 - x0) * s)), max(1, round((y1 - y0) * s))
        px = int(float(u[i, 1]) * (W_ - w))
        py = int(float(u[i, 2]) * (H - h))
        patch = F.interpolate(src[None].float(), size=(h, w), mode="nearest")[0]
        a = patch[3] > 0
        img[:, py:py + h, px:px + w] = torch.where(a, patch[:3].to(torch.uint8),
                                                   img[:, py:py + h, px:px + w])
        masks[i, py:py + h, px:px + w] = a.to(torch.uint8)
        boxes[i] = torch.tensor([px, py, px + w, py + h])
    lab = labels.cpu().numpy()
    return Scene(rgb=img.permute(1, 2, 0).contiguous().cpu().numpy(),
                 masks=masks.cpu().numpy(), boxes=boxes.cpu().numpy(),
                 labels=lab + 1, obj_ids=np.asarray(t["object_ids"])[lab])


class Driver:
    """setup() builds the inputs and the program and warms it; window()
    drives the measured loop; judge() compares what the window wrote with
    the reference."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, tracer, control=None):
        self.cfg, self.t, self.seed, self.device = cfg, traffic, int(seed), torch.device(device)
        self.m = cfg["model"]
        self.tracer = tracer
        self.control = control or {}
        self.counters = {}
        self.tmp = tempfile.TemporaryDirectory(prefix="gigapose_bench_")

    # -- set-up ----------------------------------------------------------------
    def _weights(self, device):
        vit, ist = RN.build_nets(self.cfg, device)
        W.draw({"vit": vit, "ist": ist}, self.seed, self.cfg["assumed"])
        return vit, ist

    def _inputs(self):
        dev, t, m = self.device, self.t, self.m
        g = torch.Generator(device=dev).manual_seed((self.seed + 1) % (2 ** 63))
        self.templates = [make_templates(g, t, m["templates"], dev) for _ in t["object_ids"]]
        counts = list(t["detections_cycle"]) * t["pool_cycles"]
        self.pool = [make_scene(g, t, n, self.templates, dev) for n in counts]
        fx, fy, cx, cy = t["K"]
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    def _program(self):
        from gigapose_tpu_torch.pipeline.estimator import (
            EstimatorConfig,
            GigaPoseEstimator,
            set_f32_matmul_precision,
        )
        from gigapose_tpu_torch.models.ae_net import AENet
        from gigapose_tpu_torch.models.ist_net import ISTBackbone, ISTNet, Regressor

        m = dict(self.m, **self.control.get("program", {}))
        set_f32_matmul_precision()
        vit, ist = self._weights(self.device)
        cdt = "bfloat16" if m["compute_dtype"] == "bf16" else None
        with torch.device(self.device):
            ae_net = AENet(m["backbone"], compute_dtype=cdt)
            D = m["ist_descriptor"]
            ist_net = ISTNet(ISTBackbone(m["ist_initial_dim"], tuple(m["ist_block_dims"]), D,
                                         m["ist_input_size"], compute_dtype=cdt),
                             Regressor(2 * D, hidden_dim=D))
        ae_net.vit.load_state_dict(vit.state_dict(), strict=True)
        ist_net.load_state_dict(ist.state_dict(), strict=True)
        del vit, ist
        est = GigaPoseEstimator(ae_net.eval(), ist_net.eval(), EstimatorConfig(
            k=m["k"], sim_threshold=m["sim_threshold"], patch_threshold=m["patch_threshold"],
            pixel_threshold=m["pixel_threshold"],
            use_pallas_matching=self.device.type == "cuda"))
        if m["serving_quant"] == "int8":
            est.quantize_serving(ist={"off": False, "int8": True}[m.get("serving_quant_ist", "off")])
        return est

    def setup(self) -> None:
        from gigapose_tpu_torch.pipeline.runner import CoarseRunner
        from gigapose_tpu_torch.pipeline.templates import onboard_templates

        if self.t.get("host_threads"):  # the client process's intra-op threads
            torch.set_num_threads(int(self.t["host_threads"]))
        self._inputs()
        est = self._program()
        fdt = torch.bfloat16 if self.m["feature_dtype"] == "bf16" else torch.float32
        rgbas = [r.cpu().numpy() for r, _, _ in self.templates]
        poses = [p.cpu().numpy() for _, _, p in self.templates]
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        store = onboard_templates(est.ae_apply, est.ist_apply, rgbas, poses, self.device,
                                  Ks_per_object=[self._template_K()] * len(rgbas),
                                  feature_dtype=fdt)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.counters.update(onboard_s=time.perf_counter() - t0, objects=len(rgbas))
        del rgbas
        self.runner = CoarseRunner(est, store, save_dir=self.tmp.name, dataset_name="lmo")
        self.sel: List[np.ndarray] = []
        filt = self.runner.filter_localization

        def keep_sel(image, scores):
            out = filt(image, scores)
            self.sel.append(out[0])
            return out

        self.runner.filter_localization = keep_sel
        self._install_capture(est)
        self.tracer.install(self)
        # warm every shape bucket the cycle uses, once
        from gigapose_tpu_torch.pipeline.runner import pad_bucket

        first = {}
        for i, sc in enumerate(self.pool):
            first.setdefault(pad_bucket(len(sc.labels)), i)
        self.runner.run([self._image(i, i) for i in sorted(first.values())])
        self.tracer.warm_profiler()

    def _judged(self) -> List[int]:
        """The window images judged after the window, drawn from the seed
        among the first pass over the pool (every window reaches them): the
        longest image of the cycle and judged_images - 1 others."""
        rng = np.random.default_rng(self.seed % (2 ** 63))
        cyc = self.t["detections_cycle"]
        longest = int(np.argmax(cyc))
        cand = [int(c) for c in rng.permutation(len(self.pool))]
        pick = [c for c in cand if c % len(cyc) == longest][:1]
        return pick + [c for c in cand if c not in pick][:self.t["judged_images"] - 1]

    def _install_capture(self, est) -> None:
        """Keep, on the card, the AE and IST features that the window's
        forward computes for the judged images (a copy each: the judge
        compares them with the reference's)."""
        self.judged, self.captured, self.capturing = self._judged(), {}, False

        def keep(kind, out):
            im = self.tracer.current
            if self.capturing and im is not None and im.im_id in self.judged:
                self.captured.setdefault(im.im_id, {})[kind] = out.detach().clone()

        est.ae_net.register_forward_hook(lambda mod, a, out: keep("ae", out))
        features = est.ist_net.features

        def ist_features(x):
            out = features(x)
            keep("ist", out)
            return out

        est.ist_net.features = ist_features

    def _template_K(self) -> np.ndarray:
        fx, fy, cx, cy = self.t["template_K"]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    def _image(self, idx: int, pool_idx: int):
        from gigapose_tpu_torch.dataloader.test_set import ImageDetections

        sc = self.pool[pool_idx]
        tl = [{"obj_id": int(o), "inst_count": int((sc.obj_ids == o).sum())}
              for o in np.unique(sc.obj_ids)]
        return ImageDetections(scene_id=1, im_id=idx, rgb=sc.rgb, K=self.K, labels=sc.labels,
                               obj_ids=sc.obj_ids, boxes_xyxy=sc.boxes, masks=sc.masks,
                               scores=np.ones(len(sc.labels), np.float32),
                               detection_time=0.0, test_list=tl)

    # -- the window --------------------------------------------------------------
    def window(self, seconds: float) -> None:
        self.sel.clear()
        images = [self._image(i, i) for i in range(len(self.pool))]
        # the profiled sub-window of a traced run: whole cycles after the first
        cyc = len(self.t["detections_cycle"])
        prof = range(cyc, cyc * (1 + self.t["profiled_cycles"])) if self.tracer.enabled else range(0)
        times, dets, state = [], [], {}

        def feed():
            i = 0
            t_start = time.perf_counter()
            deadline = t_start + seconds
            while True:
                if i in prof and i == prof.start:
                    self.tracer.profile_on()
                if i >= 1 and i == prof.stop:
                    self.tracer.profile_off()
                now = time.perf_counter()
                if now >= deadline and i > 0 and not self.tracer.profiling:
                    state.update(t_start=t_start, t_end=now, images=i)
                    return
                im = images[i % len(images)]
                n = len(im.labels)
                key = "traced" if self.tracer.profiling else "plain"
                self.tracer.counters[f"dets_{key}"] += n
                self.tracer.counters[f"padded_{key}"] += _bucket(n)
                self.tracer.counters[f"images_{key}"] += 1
                im.im_id = i
                self.tracer.current = im
                t_take = time.perf_counter()
                yield im
                times.append(time.perf_counter() - t_take)
                dets.append(n)
                i += 1

        self.capturing = True
        self.tracer.start_window()
        self.runner.run(feed(), test_setting=self.t["test_setting"])
        self.capturing = False
        self.times, self.dets, self.state = times, dets, state

    def end_to_end(self) -> dict:
        s = self.state
        self.counters["image_ms_p50"] = float(np.percentile(np.asarray(self.times) * 1e3, 50))
        return {"dets_per_s": sum(self.dets) / (s["t_end"] - s["t_start"]),
                "image_ms_p95": float(np.percentile(np.asarray(self.times) * 1e3, 95)),
                "attempted": s["images"]}

    def free_program(self) -> None:
        self.runner = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------------------
    def _served(self, idx: int):
        """(rows -> detection index, view ids, scores, poses) the window
        wrote for window image idx."""
        with np.load(os.path.join(self.tmp.name, "predictions", f"{idx:06d}.npz")) as z:
            return self.sel[idx], z["view_ids"], z["scores"], z["poses"]

    @torch.no_grad()
    def judge(self) -> dict:
        """The reference, after the window, on a sample of the window's
        images drawn from the seed (each distinct pool image at most once,
        the longest among them): each gap of R.judge_detection over their
        detections, as its widest (the bare name), mean, median and 90th
        percentile; the configuration's limits pick which are compared."""
        dev, m, t = self.device, self.m, self.t
        if self.state["images"] < len(self.pool):
            raise RuntimeError(f"the window served {self.state['images']} images, fewer than "
                               f"the pool's {len(self.pool)}: nothing to judge")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        vit, ist = self._weights(dev)
        ref_quant = self.control.get("reference")
        qa = make_quant(ref_quant["ae"]) if ref_quant else None
        qi = make_quant(ref_quant["ist"]) if ref_quant else None
        qs = make_quant(ref_quant["store"]) if ref_quant else None
        size, n = m["crop_size"], m["crop_size"] // m["patch_size"]
        feats = lambda x, q, qb: (
            torch.cat([vit.features(x[i:i + 32], q) for i in range(0, len(x), 32)]),
            torch.cat([ist.backbone(x[i:i + 32], qb) for i in range(0, len(x), 32)]))
        store, cstore = [], []
        for rgba, boxes, poses in self.templates:
            crops, pm, tM = R.crops_of(rgba.float() / 255, boxes, size, n)
            ae, ist_f = feats(crops, None, None)
            entry = dict(ae=ae, ist=ist_f, mask=pm, M=tM, poses=poses)
            store.append(entry)
            if ref_quant:
                cae, cist = feats(crops, qa, qi)
                cstore.append(dict(entry, ae=qs(cae, "act"), ist=cist))
        t_K = torch.as_tensor(self._template_K(), device=dev)
        q_K = torch.as_tensor(self.K, device=dev)
        gaps = {k: [] for k in ("view_gap", "score_gap", "score_excess", "pose_gap", "ae_cos",
                                "ist_err")}
        rel = lambda a, b: float(torch.linalg.vector_norm(a.float() - b) / torch.linalg.vector_norm(b))
        cos = lambda a, b: float((1 - F.cosine_similarity(a.float(), b, dim=-1)).mean())
        cfg = dict(sim_threshold=m["sim_threshold"], patch_threshold=m["patch_threshold"], n=n)
        hyp_args = dict(pixel_threshold=m["pixel_threshold"], patch_size=m["patch_size"], n=n)
        for idx in self.judged:
            sc = self.pool[idx % len(self.pool)]
            img = torch.as_tensor(sc.rgb, device=dev).permute(2, 0, 1).float() / 255
            mk = torch.as_tensor(sc.masks, device=dev).float()
            rgba = torch.cat([img[None] * mk[:, None], mk[:, None]], 1)
            boxes = torch.as_tensor(sc.boxes, device=dev)
            crops, pm, qM = R.crops_of(rgba, boxes, size, n)
            del rgba
            ae, ist_f = feats(crops, None, None)
            if ref_quant:
                cae, cist = feats(crops, qa, qi)
            rows, views, scores, poses = (None,) * 4
            if not ref_quant:
                rows, views, scores, poses = self._served(idx)
            for r in range(len(sc.labels)):
                d = int(rows[r]) if rows is not None else r
                o = int(sc.labels[d]) - 1
                st = store[o]
                ret = R.retrieve(ae[d], pm[d], st["ae"], st["mask"], **cfg)
                hyp = lambda rr, v, tar, src, s: R.hypotheses(
                    rr, v, tar, src[v], ist.regressor, None if s is st else qi, qM[d], q_K,
                    s["M"][v], t_K, s["poses"][v], **hyp_args)
                if ref_quant:
                    cs = cstore[o]
                    cret = R.retrieve(cae[d], pm[d], cs["ae"], cs["mask"], **cfg)
                    v_srv, s_srv, p_srv = serve(cret, lambda v: hyp(cret, v, cist[d], cs["ist"], cs),
                                                m["k"])
                else:
                    v_srv = torch.as_tensor(views[r], device=dev)
                    s_srv = torch.as_tensor(scores[r], device=dev, dtype=torch.float32)
                    p_srv = torch.as_tensor(poses[r][0], device=dev, dtype=torch.float32)
                hyps = {int(v): hyp(ret, int(v), ist_f[d], st["ist"], st) for v in v_srv}
                if ref_quant:
                    gaps["ae_cos"].append(cos(cae[d], ae[d]))
                    gaps["ist_err"].append(rel(cist[d], ist_f[d]))
                else:
                    got = self.captured[idx]
                    gaps["ae_cos"].append(cos(got["ae"][d], ae[d]))
                    gaps["ist_err"].append(rel(got["ist"][d], ist_f[d]))
                for k, val in R.judge_detection(ret.sim_avg, hyps, v_srv, s_srv, p_srv,
                                                tie=1.0 / n ** 2).items():
                    gaps[k].append(val)
        self.counters["judged_detections"] = len(gaps["view_gap"])
        out = {k: max(v) for k, v in gaps.items()}
        for k, v in gaps.items():
            out[f"{k}_mean"] = float(np.mean(v))
            out[f"{k}_p50"] = float(np.median(v))
            out[f"{k}_p90"] = float(np.percentile(v, 90))
        # the detections whose score gap is an inlier flipped at the pixel
        # threshold (a weight of 0.5 / P or more) and not rounding alone
        out["score_flip_share"] = float(np.mean(np.asarray(gaps["score_gap"]) > 0.25 / n ** 2))
        return out


def serve(ret: "R.Retrieval", hyp, k: int):
    """What a server computing as the reference does would serve: the top-k
    views by score (ties to the lower id), each view's best proposal (first
    on ties), the views ordered by that score (stable); -> (views, scores,
    the top view's pose)."""
    vals, ids = torch.sort(ret.sim_avg, descending=True, stable=True)
    ids = ids[:k]
    hs = [hyp(int(v)) for v in ids]
    best = torch.tensor([h.best for h in hs])
    order = torch.sort(best, descending=True, stable=True)[1]
    h0 = hs[int(order[0])]
    pose0 = h0.poses[int(torch.argmax(h0.scores))]
    return ids[order.to(ids.device)], best[order].to(ids.device), pose0


def _bucket(n: int) -> int:
    from gigapose_tpu_torch.pipeline.runner import pad_bucket

    return pad_bucket(n)
