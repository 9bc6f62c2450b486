"""What refiner training's checks can hold on a CUDA device: how far its f32
gradients sit from f64, and whether a short run's checkpoint refines toward
the ground truth. Needs a CUDA device.

    python -m gigapose_tpu_torch.scripts.refiner_train_probe cad_dir=<models> \\
        [steps=40,200] [out=<json file>]

For each entry of `steps`, trains scripts/train_refiner.py at its defaults
(RefinerNet 64, scorer 32, 160 x 160, batch 8, lr 3e-4, the curriculum) on
the meshes of `cad_dir` into a temporary directory, then prints:

- [probe_grad]: one refiner step and one scorer step (TF32 off) from the
  trained weights on a batch of 2 (its crops and renders made once, on the
  CPU), on the card in f32, on the CPU in f32 and on the CPU in f64: per
  tensor |a - b| / |b| (Frobenius norms) of every parameter's gradient, the
  largest and the median of card / f64, CPU / f64 and card / CPU, with the
  tensors that reach the largest, and the losses;
- [probe_held]: refine_batch of 8 held poses of the training distribution
  (its ground truth known), at the full perturbation and at the
  curriculum's last quarter, with 1 and 5 iterations, keep_best_init on and
  off: the mean point distance to the ground truth in mm, and how many
  poses came closer than their init, for the trainer's nets, for the same
  checkpoint loaded into a fresh refiner (load_refiner_checkpoint, as
  refine.py loads it) and for the fresh refiner's random nets; then the
  trained nets with the init moved 8 cm off the object and on an image of
  uniform noise.

Then the same gradient readings at a random init (pose head N(0, 0.01),
uniform 64 x 64 crops and renders, B = 4, widths 8 and 64), and the card's
name and power limit. `out`, when given, gets every reading as JSON.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import os.path as osp
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from gigapose_tpu_torch.pipeline.templates import TEMPLATE_K
from gigapose_tpu_torch.refine import mesh_paths_of
from gigapose_tpu_torch.refiner import training as RT
from gigapose_tpu_torch.refiner.checkpoint import load_refiner_checkpoint
from gigapose_tpu_torch.refiner.network import CoarseScorerNet, RefinerNet, init_like_flax_
from gigapose_tpu_torch.refiner.refiner import MeshStore, RenderCompareRefiner, no_tf32
from gigapose_tpu_torch.scripts import train_refiner as TR
from gigapose_tpu_torch.training.state import Adam

K = np.asarray(TEMPLATE_K)
SEED_GRAD, SEED_HELD = 60, 12345
QUARTER = RT.PerturbConfig(rot_deg=2.5, trans_xy=0.0025, trans_z=0.005)


def _steps(nets, inputs, where, dtype) -> dict:
    """One refiner_step and one scorer_step on copies of (refiner, scorer)
    -> the losses and every parameter's gradient (f64, on the CPU)."""
    r, s = (copy.deepcopy(n).to(where, dtype) for n in nets)
    r_in, s_in = ([t.to(where, dtype) for t in ts] for ts in inputs)
    o_r, o_s = Adam({"refiner": 3e-4}), Adam({"scorer": 3e-4})
    with no_tf32():
        aux = RT.refiner_step(r, o_r, o_r.init({"refiner": r}), *r_in)
        bce = RT.scorer_step(s, o_s, o_s.init({"scorer": s}), *s_in)
    grads = {f"{n}.{k}": p.grad.detach().to("cpu", torch.float64)
             for n, net in (("r", r), ("s", s)) for k, p in net.named_parameters()}
    return dict(loss=float(aux["loss"]), bce=float(bce), grads=grads)


def _gaps(a: dict, b: dict, top: int = 4) -> dict:
    gaps = {k: float((a[k] - w).norm() / w.norm().clamp(min=1e-30)) for k, w in b.items()}
    worst = sorted(gaps, key=gaps.get, reverse=True)[:top]
    return dict(max=gaps[worst[0]], median=float(np.median(list(gaps.values()))),
                top=[(k, gaps[k], float(b[k].norm())) for k in worst])


def grad_readings(tag: str, nets, inputs, dev) -> dict:
    cpu = torch.device("cpu")
    card = _steps(nets, inputs, dev, torch.float32)
    c32 = _steps(nets, inputs, cpu, torch.float32)
    f64 = _steps(nets, inputs, cpu, torch.float64)
    rec = {"card_f64": _gaps(card["grads"], f64["grads"]),
           "cpu_f64": _gaps(c32["grads"], f64["grads"]),
           "card_cpu": _gaps(card["grads"], c32["grads"]),
           "loss": [card["loss"], c32["loss"], f64["loss"]],
           "bce": [card["bce"], c32["bce"], f64["bce"]]}
    print(f"[probe_grad] {tag} " + " ".join(
        f"{k}_max={v['max']:.3g} {k}_median={v['median']:.3g} {k}_worst={v['top'][0][0]}"
        for k, v in rec.items() if isinstance(v, dict)), flush=True)
    return rec


def point_dist_mm(TCO, TCO_gt, pts) -> np.ndarray:
    at = lambda T: np.einsum("bij,bpj->bpi", T[:, :3, :3], pts) + T[:, None, :3, 3]
    return np.linalg.norm(at(TCO) - at(TCO_gt), axis=-1).mean(-1) * 1e3


def held_readings(tag: str, ref, batches: dict) -> dict:
    rec = {}
    for name, b in batches.items():
        pts = np.stack([ref.meshes.points[int(l)] for l in b["labels"]])
        d0 = point_dist_mm(b["TCO_init"], b["TCO_gt"], pts)
        row = {"init_mm": float(d0.mean())}
        for n_it in (1, 5):
            for kbi in (True, False):
                r = dataclasses.replace(ref, config=dataclasses.replace(ref.config,
                                                                        keep_best_init=kbi))
                T, _ = r.refine_batch(b["images"], b["K"], b["labels"], b["TCO_init"], n_it)
                d = point_dist_mm(T, b["TCO_gt"], pts)
                row[f"it{n_it}_kbi{int(kbi)}_mm"] = float(d.mean())
                row[f"it{n_it}_kbi{int(kbi)}_closer"] = int((d < d0).sum())
        rec[name] = row
        print(f"[probe_held] {tag} {name} " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()),
            flush=True)
    return rec


def random_init_inputs(B: int = 4):
    """Uniform 64 x 64 crops and renders and a pose 0.5 m away, seeded."""
    rng = np.random.default_rng(10)
    crops = rng.uniform(size=(B, 3, 64, 64)).astype(np.float32)
    renders = rng.uniform(size=(B, 3, 64, 64)).astype(np.float32)
    TCO_gt = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO_gt[:, :3, :3] = Rotation.random(B, random_state=1).as_matrix()
    TCO_gt[:, :3, 3] = rng.normal(0, 0.02, (B, 3)) + [0, 0, 0.5]
    TCO_in = TCO_gt.copy()
    TCO_in[:, :3, 3] += rng.normal(0, 0.01, (B, 3))
    Kc = np.tile(np.array([[200, 0, 32], [0, 200, 32], [0, 0, 1.0]], np.float32), (B, 1, 1))
    pts = rng.normal(0, 0.04, (B, 8, 3)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    r_in = [t(a) for a in (crops, renders, TCO_in, Kc, TCO_in[:, :3, 3].copy(), TCO_gt, pts)]
    s_in = [torch.cat([t(crops), t(crops)]), torch.cat([t(renders), t(renders[::-1])]),
            torch.tensor([1.0] * B + [0.0] * B)]
    return r_in, s_in


def main(argv=None) -> dict:
    kv = dict(a.split("=", 1) for a in (argv if argv is not None else sys.argv[1:]))
    cad = kv["cad_dir"]
    out_path = kv.get("out")
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    out = {}
    root = tempfile.mkdtemp(prefix="refiner_train_probe_")
    for steps in (int(s) for s in kv.get("steps", "40,200").split(",")):
        ckpt = osp.join(root, f"ckpt{steps}")
        ref = TR.main([f"cad_dir={cad}", f"out_dir={ckpt}", f"steps={steps}"])
        rec = out[f"steps{steps}"] = dict(loss=ref.loss_history, bce=ref.scorer_loss_history)
        print(f"[probe_train] steps={steps} loss={ref.loss_history[0]:.4g}->"
              f"{ref.loss_history[-1]:.4g} bce={ref.scorer_loss_history[0]:.4g}->"
              f"{ref.scorer_loss_history[-1]:.4g}", flush=True)
        ref = dataclasses.replace(ref, meshes=MeshStore(mesh_paths_of(cad), 500))
        batch = next(RT.synthetic_refiner_batches(ref.meshes, K, batch_size=2, seed=SEED_GRAD))
        on_cpu = dataclasses.replace(ref, refiner_net=copy.deepcopy(ref.refiner_net).to(cpu),
                                     scorer_net=copy.deepcopy(ref.scorer_net).to(cpu),
                                     device=cpu, _device_pack=None)
        with no_tf32():
            inputs = RT.step_inputs(on_cpu, batch)
        rec["grad"] = grad_readings(f"steps={steps}", (ref.refiner_net, ref.scorer_net),
                                    inputs, dev)
        batches = {p: next(RT.synthetic_refiner_batches(ref.meshes, K, batch_size=8,
                                                        seed=SEED_HELD, perturb=cfg))
                   for p, cfg in (("full", RT.PerturbConfig()), ("quarter", QUARTER))}
        rec["trained"] = held_readings(f"steps={steps} trained", ref, batches)
        fresh = RenderCompareRefiner.create(mesh_paths_of(cad), config=ref.config, device=dev)
        rec["random"] = held_readings(f"steps={steps} random", fresh, batches)
        load_refiner_checkpoint(ckpt, fresh)
        rec["loaded"] = held_readings(f"steps={steps} loaded", fresh, batches)
        off = dict(batches["full"], TCO_init=batches["full"]["TCO_init"].copy())
        off["TCO_init"][:, 0, 3] += 0.08
        noise = dict(batches["full"], images=np.random.default_rng(0).uniform(
            size=batches["full"]["images"].shape).astype(np.float32))
        rec["odd"] = held_readings(f"steps={steps} trained", ref,
                                   {"init_8cm_off": off, "noise_image": noise})
        ref.meshes.close()
        fresh.meshes.close()
    for width in (8, 64):
        gen = torch.Generator().manual_seed(0)
        r = init_like_flax_(RefinerNet(width=width), gen)
        s = init_like_flax_(CoarseScorerNet(width=width // 2), gen)
        with torch.no_grad():
            r.pose_head.weight.normal_(0, 0.01, generator=torch.Generator().manual_seed(1))
        out[f"random_init_w{width}"] = grad_readings(f"random_init width={width}", (r, s),
                                                     random_init_inputs(), dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out["card"] = smi
    print(smi)
    shutil.rmtree(root, ignore_errors=True)
    if out_path:
        os.makedirs(osp.dirname(osp.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, default=float)
    return out


if __name__ == "__main__":
    main()
