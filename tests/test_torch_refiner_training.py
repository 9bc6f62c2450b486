"""Refiner training of the port (gigapose_tpu_torch/refiner/training.py,
scripts/train_refiner.py) against the JAX package's, CPU, at tiny sizes:
RefinerNet and scorer width 8, 64 x 64 renders, batches of 2, the cube mesh,
observed views at 120 x 160 (train_refiner's own 480 x 640).

- refiner_disentangled_loss and its three terms: within 1e-6 of JAX's on
  seeded inputs, and under 1e-6 at the ground-truth update;
- sample_perturbation and synthetic_refiner_batches (a fixed range and a
  curriculum): bit-equal over 3 batches;
- flax's training-mode BatchNorm (models/flax_bn.py): the running variance
  moves to the biased batch variance, as flax's does;
- 3 refiner and 3 scorer steps from one set of seeded flax variables
  (tests/test_torch_refiner.py:jax_vars), carried over by
  refiner_flax_to_torch, with and without grad_clip: the first step's
  losses within 1e-4 relative (BatchNorm over a batch of 2 turns the
  convolutions' f32 sums in another order into 1.3e-5); the first refiner gradient within 1e-4 (in
  norm, per tensor) of the JAX package's computed in f64, while JAX's own
  f32 gradient sits up to 4 % from it: at this random init the backbone's
  gradient is ill-conditioned (crops moved by 1e-5 of their size move it by
  9 % in the port alone), so the two f32 packages leave each other after the
  first Adam step, which moves every entry by about lr whatever its
  gradient's size: the later refiner losses are held to 10 % (readings up
  to 3.4 %, a term; 1.4 %, the total), the scorer's to 1e-4 at every step
  (readings up to 1.2e-5), every parameter to 2 x the summed lr (Adam's
  bound; readings up to 0.56 of it) and 95 % of the entries to a tenth of
  it (readings 97.9 % and more), the BatchNorm statistics to 5e-2 of
  max(1, |x|) (readings up to 1.4e-2: they move with the parameters);
- train_refiner for 2 steps: loss_history within 2e-4 absolute of JAX's
  train_refiner (the crops' 1-ulp gap and the render pixel it flips, as in
  refinement, tests/test_torch_refiner.py);
- the CLI round trip: train_refiner's script saves, a fresh refiner loads
  the file (equal state dicts), refine.py's refiner_checkpoint= writes the
  csv on tests/synthetic_bop.py's fixture; an orbax directory and a width
  mismatch raise;
- the depth-noise family and replace_background: bit-equal to JAX's
  augment.py on the same generator state (tests/test_aux.py's inputs and a
  larger image with larger ellipses), and the Pillow operations the port
  rebuilds (the filled ellipse, the bilinear rotation of an L mask, the
  bicubic resizes of F and RGB images) bit-equal to Pillow;
- the refiners built from their fields take their device from the nets.

tests/test_torch_cuda_refiner_training.py runs the steps on the card.
"""

import functools
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image, ImageDraw
from scipy.spatial.transform import Rotation

from gigapose_tpu.dataloader import augment as JA
from gigapose_tpu.refiner import training as JT
from gigapose_tpu.refiner.network import CoarseScorerNet as JScorer
from gigapose_tpu.refiner.network import RefinerNet as JRefiner
from gigapose_tpu.refiner.refiner import MeshStore as JMeshStore
from gigapose_tpu.refiner.refiner import RefinerConfig as JConfig
from gigapose_tpu.refiner.refiner import RenderCompareRefiner as JRefinerLoop
from gigapose_tpu_torch import refine
from gigapose_tpu_torch.dataloader import augment as A
from gigapose_tpu_torch.dataloader import bop_io
from gigapose_tpu_torch.models.convert import refiner_flax_to_torch
from gigapose_tpu_torch.models.flax_bn import FlaxBatchNorm2d
from gigapose_tpu_torch.refiner import training as TT
from gigapose_tpu_torch.refiner.megapose_refiner import MegaposeRefiner
from gigapose_tpu_torch.refiner.network import CoarseScorerNet, RefinerNet
from gigapose_tpu_torch.refiner.refiner import (
    MeshStore,
    RefinerConfig,
    RenderCompareRefiner,
    no_tf32,
)
from gigapose_tpu_torch.refiner import checkpoint as CK
from gigapose_tpu_torch.scripts import train_refiner as TR
from gigapose_tpu_torch.training.state import Adam
from tests import synthetic_bop
from tests.test_rasterizer import _write_cube_ply
from tests.test_torch_refine_cli import _coarse_csv
from tests.test_torch_refiner import jax_vars
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (a fixture)

K = np.array([[572.4114, 0, 80], [0, 573.57043, 60], [0, 0, 1.0]], np.float32)
K_FULL = np.array([[572.4114, 0, 320], [0, 573.57043, 240], [0, 0, 1.0]], np.float32)
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def cube(tmp_path):
    path = str(tmp_path / "cube.ply")
    _write_cube_ply(path, size=0.08)
    return path


def _loss_inputs(B=4, seed=0):
    """The inputs of tests/test_refiner_training.py:_setup."""
    rng = np.random.default_rng(seed)
    TCO_gt = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO_gt[:, :3, :3] = Rotation.random(B, random_state=1).as_matrix()
    TCO_gt[:, :3, 3] = rng.normal(0, 0.02, (B, 3))
    TCO_gt[:, 2, 3] += 0.5
    TCO_in = TCO_gt.copy()
    TCO_in[:, :3, 3] += rng.normal(0, 0.01, (B, 3))
    d = Rotation.from_euler("xyz", rng.normal(0, 5, (B, 3)), degrees=True).as_matrix()
    TCO_in[:, :3, :3] = np.einsum("bij,bjk->bik", d, TCO_in[:, :3, :3])
    Ks = np.tile(np.array([[500, 0, 80], [0, 500, 80], [0, 0, 1.0]], np.float32), (B, 1, 1))
    points = rng.normal(0, 0.04, (B, 64, 3)).astype(np.float32)
    return TCO_gt, TCO_in, Ks, points, TCO_in[:, :3, 3].copy()


def test_disentangled_loss_matches_jax():
    TCO_gt, TCO_in, Ks, points, tCR = _loss_inputs()
    rng = np.random.default_rng(5)
    net_out = (np.array([1, 0, 0, 0, 1, 0, 0, 0, 1], np.float32)
               + rng.normal(0, 0.1, (4, 9))).astype(np.float32)
    args = (TCO_gt, TCO_in, net_out, Ks, points, tCR)
    want_total, want = JT.refiner_disentangled_loss(*(jnp.asarray(a) for a in args))
    with no_tf32():
        got_total, got = TT.refiner_disentangled_loss(*(_t(a) for a in args))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
        assert float(want[k]) > 1e-3, k  # every term is exercised
    assert float(got_total) == float(got["loss"])
    # the ground-truth update: every term vanishes
    dR_gt = np.einsum("bij,bkj->bik", TCO_gt[:, :3, :3], TCO_in[:, :3, :3])
    tCR_out = TCO_gt[:, :3, 3] - np.einsum("bij,bj->bi", dR_gt, TCO_in[:, :3, 3] - tCR)
    fxfy = np.stack([Ks[:, 0, 0], Ks[:, 1, 1]], -1)
    vz = tCR_out[:, 2:3] / tCR[:, 2:3]
    vxvy = fxfy * (tCR_out[:, :2] / tCR_out[:, 2:3] - tCR[:, :2] / tCR[:, 2:3])
    gt_out = np.concatenate([dR_gt[:, :, 0], dR_gt[:, :, 1], vxvy, vz], -1).astype(np.float32)
    _, zero = TT.refiner_disentangled_loss(*(_t(a) for a in (TCO_gt, TCO_in, gt_out, Ks,
                                                              points, tCR)))
    assert all(float(v) < 1e-6 for v in zero.values()), zero


def test_sample_perturbation_matches_jax():
    for cfg in ((10.0, 0.01, 0.02), (2.5, 0.0025, 0.005), (0.0, 0.0, 0.0)):
        r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(3):
            want = JT.sample_perturbation(r1, JT.PerturbConfig(*cfg))
            got = TT.sample_perturbation(r2, TT.PerturbConfig(*cfg))
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("schedule", ["fixed", "curriculum"])
def test_synthetic_batches_match_jax(cube, schedule):
    """Two labels (rng.choice draws among them), 3 batches of 2."""
    meshes = {1: cube, 2: cube}
    if schedule == "fixed":
        jp, tp = JT.PerturbConfig(rot_deg=20.0), TT.PerturbConfig(rot_deg=20.0)
    else:
        lerp = lambda cls: (lambda s: cls(rot_deg=10.0 - 3 * s, trans_xy=0.01 / s,
                                          trans_z=0.02 - 0.005 * s))
        jp, tp = lerp(JT.PerturbConfig), lerp(TT.PerturbConfig)
    kw = dict(batch_size=2, image_hw=(120, 160), seed=3)
    want = JT.synthetic_refiner_batches(JMeshStore(meshes, 8), K, perturb=jp, **kw)
    store = MeshStore(meshes, 8)
    got = TT.synthetic_refiner_batches(store, K, perturb=tp, **kw)
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        assert w["images"].any()
    store.close()


def test_curriculum_matches_train_refiners_lerp():
    """The JAX train_refiner's perturb_arg: a + (b - a) * min(step / n, 1)."""
    start, end = TT.PerturbConfig(), TT.PerturbConfig(2.5, 0.0025, 0.005)
    at = TT.curriculum(40, start, end)
    for step in (0, 1, 10, 39, 40, 80):
        w = min(step / 40, 1.0)
        assert at(step) == TT.PerturbConfig(*(a + (b - a) * w for a, b in (
            (10.0, 2.5), (0.01, 0.0025), (0.02, 0.005))))
    assert at(0) == start and abs(at(40).rot_deg - 2.5) < 1e-12


def test_flax_batch_norm_running_variance_is_biased():
    """FlaxBatchNorm2d in training mode against flax's nn.BatchNorm(momentum
    0.9): output and both running statistics; nn.BatchNorm2d would store
    the unbiased variance."""
    import flax.linen as nn

    x = np.random.default_rng(0).normal(1.0, 2.0, (2, 3, 4, 5)).astype(np.float32)
    bn = FlaxBatchNorm2d(3).train()
    y = bn(_t(x))
    fbn = nn.BatchNorm(use_running_average=False, momentum=0.9)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = fbn.init(jax.random.PRNGKey(0), xj)
    want, mut = fbn.apply(variables, xj, mutable=["batch_stats"])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    for mine, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, mine).numpy(),
                                   np.asarray(mut["batch_stats"][theirs]), rtol=1e-6, atol=1e-7)
    biased = x.transpose(1, 0, 2, 3).reshape(3, -1).var(axis=1)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * biased, rtol=1e-6)
    torch_bn = torch.nn.BatchNorm2d(3).train()
    torch_bn(_t(x))
    assert not np.allclose(torch_bn.running_var.numpy(), bn.running_var.numpy(), rtol=1e-4)


def _step_inputs(rng, B=2):
    crops = rng.uniform(size=(B, 3, 64, 64)).astype(np.float32)
    renders = rng.uniform(size=(B, 3, 64, 64)).astype(np.float32)
    TCO_gt = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO_gt[:, :3, :3] = Rotation.random(B, random_state=int(rng.integers(1 << 30))).as_matrix()
    TCO_gt[:, :3, 3] = rng.normal(0, 0.02, (B, 3)) + [0, 0, 0.5]
    TCO_in = TCO_gt.copy()
    TCO_in[:, :3, 3] += rng.normal(0, 0.01, (B, 3))
    d = Rotation.from_euler("xyz", rng.normal(0, 5, (B, 3)), degrees=True).as_matrix()
    TCO_in[:, :3, :3] = np.einsum("bij,bjk->bik", d, TCO_in[:, :3, :3])
    Kc = np.tile(np.array([[200, 0, 32], [0, 200, 32], [0, 0, 1.0]], np.float32), (B, 1, 1))
    pts = rng.normal(0, 0.04, (B, 8, 3)).astype(np.float32)
    return crops, renders, TCO_in, Kc, TCO_in[:, :3, 3].copy(), TCO_gt, pts


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """The JAX package's refiner and scorer steps at width 8
    (refiner/training.py: train_refiner's refiner_step and scorer_step),
    compiled once for both clip settings: the clip is an argument, and
    clip_by_global_norm at inf is the plain optax.adam."""
    rnet, snet = JRefiner(width=8), JScorer(width=8)
    tx = lambda clip: optax.chain(optax.clip_by_global_norm(clip), optax.adam(LR))

    @jax.jit
    def refiner_step(clip, params, stats, opt_state, crops, renders, TCO_in, K_crop, tCR,
                     TCO_gt, points):
        def loss_fn(p):
            out, mut = rnet.apply({"params": p, "batch_stats": stats},
                                  jnp.concatenate([crops, renders], axis=1), train=True,
                                  mutable=["batch_stats"])
            loss, aux = JT.refiner_disentangled_loss(TCO_gt, TCO_in, out, K_crop, points, tCR)
            return loss, (aux, mut["batch_stats"])

        grads, (aux, new_stats) = jax.grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx(clip).update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, aux

    @jax.jit
    def scorer_step(clip, params, stats, opt_state, crops, renders, labels01):
        def loss_fn(p):
            logits, mut = snet.apply({"params": p, "batch_stats": stats},
                                     jnp.concatenate([crops, renders], axis=1), train=True,
                                     mutable=["batch_stats"])
            return optax.sigmoid_binary_cross_entropy(logits, labels01).mean(), \
                mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx(clip).update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss

    return rnet, snet, tx(np.inf), refiner_step, scorer_step


def _close_to_jax(net, variables, steps):
    """Parameters within 2 x the summed lr of Adam (95 % of the entries
    within a tenth of it), BatchNorm statistics within 5e-2 of max(1, |x|)."""
    want = refiner_flax_to_torch(jax.tree_util.tree_map(np.asarray, variables))
    got = net.state_dict()
    bound, near, total = 2 * LR * steps, 0, 0
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w.numpy())
        if k.endswith(("running_mean", "running_var")):
            assert (d / np.maximum(np.abs(w.numpy()), 1.0)).max() <= 5e-2, k
            continue
        assert d.max() <= bound, (k, d.max())
        near += int((d <= 0.1 * bound).sum())
        total += d.size
    assert near >= 0.95 * total, (near, total)


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_refiner_and_scorer_steps_match_jax(clip):
    rnet, snet, tx, jr, js = _jax_steps()
    rv, sv = jax_vars(rnet, 1), jax_vars(snet, 4)
    c = jnp.float32(clip if clip else np.inf)
    params, stats, opt = rv["params"], rv["batch_stats"], tx.init(rv["params"])
    sparams, sstats, sopt = sv["params"], sv["batch_stats"], tx.init(sv["params"])
    port_r, port_s = RefinerNet(width=8), CoarseScorerNet(width=8)
    port_r.load_state_dict(refiner_flax_to_torch(rv), strict=True)
    port_s.load_state_dict(refiner_flax_to_torch(sv), strict=True)
    o_r, o_s = Adam({"refiner": LR}, grad_clip=clip), Adam({"scorer": LR}, grad_clip=clip)
    st_r, st_s = o_r.init({"refiner": port_r}), o_s.init({"scorer": port_s})
    rng = np.random.default_rng(10)
    y = np.array([1, 1, 1, 1, 0, 0], np.float32)
    for i in range(3):
        args = _step_inputs(rng)
        params, stats, opt, aux = jr(c, params, stats, opt, *(jnp.asarray(a) for a in args))
        with no_tf32():
            got = TT.refiner_step(port_r, o_r, st_r, *(_t(a) for a in args))
        crops, renders = args[0], args[1]
        x_c = np.concatenate([crops, crops, crops])
        x_r = np.concatenate([renders, renders[::-1], rng.uniform(size=renders.shape)
                              .astype(np.float32)])
        sparams, sstats, sopt, s_loss = js(c, sparams, sstats, sopt, jnp.asarray(x_c),
                                           jnp.asarray(x_r), jnp.asarray(y))
        with no_tf32():
            s_got = TT.scorer_step(port_s, o_s, st_s, _t(x_c), _t(x_r), _t(y))
        rtol = 1e-4 if i == 0 else 0.1
        for k in aux:
            np.testing.assert_allclose(float(got[k]), float(aux[k]), rtol=rtol, err_msg=f"{i} {k}")
        np.testing.assert_allclose(float(s_got), float(s_loss), rtol=1e-4, err_msg=f"{i}")
    assert port_r.training and port_s.training
    assert st_r["refiner"]["count"] == st_s["scorer"]["count"] == 3
    _close_to_jax(port_r, {"params": params, "batch_stats": stats}, 3)
    _close_to_jax(port_s, {"params": sparams, "batch_stats": sstats}, 3)


def test_first_refiner_gradient_matches_jax_in_f64():
    """The port's f32 gradient against the JAX package's at f64 (x64 on for
    the call): within 1e-4 in norm per tensor, where JAX's own f32 gradient
    is up to 4 % away (the ill-conditioning above)."""
    rnet = JRefiner(width=8)
    rv = jax_vars(rnet, 1)
    args = _step_inputs(np.random.default_rng(10))
    crops, renders, TCO_in, Kc, tCR, TCO_gt, pts = args

    def loss_fn(p, stats, *a):
        out, _ = rnet.apply({"params": p, "batch_stats": stats},
                            jnp.concatenate([a[0], a[1]], axis=1), train=True,
                            mutable=["batch_stats"])
        return JT.refiner_disentangled_loss(a[5], a[2], out, a[3], a[6], a[4])[0]

    jax.config.update("jax_enable_x64", True)
    try:
        f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        g64 = jax.jit(jax.grad(loss_fn))(f64(rv["params"]), f64(rv["batch_stats"]),
                                *(jnp.asarray(a, jnp.float64) for a in args))
        g64 = jax.tree_util.tree_map(np.asarray, g64)
    finally:
        jax.config.update("jax_enable_x64", False)
    want = refiner_flax_to_torch({"params": g64, "batch_stats": rv["batch_stats"]})
    net = RefinerNet(width=8)
    net.load_state_dict(refiner_flax_to_torch(rv), strict=True)
    net.train()
    with no_tf32():
        out = net(torch.cat([_t(crops), _t(renders)], dim=1))
        TT.refiner_disentangled_loss(_t(TCO_gt), _t(TCO_in), out, _t(Kc), _t(pts),
                                     _t(tCR))[0].backward()
    for k, p in net.named_parameters():
        w = want[k].numpy()
        assert np.linalg.norm(p.grad.numpy() - w) <= 1e-4 * np.linalg.norm(w), k


def _jax_refiner(mesh, cfg):
    rnet, snet = JRefiner(width=8), JScorer(width=8)
    return JRefinerLoop(rnet, jax_vars(rnet, 1), snet, jax_vars(snet, 4),
                        JMeshStore({1: mesh}, cfg.n_sample_points), cfg)


def _port_refiner(mesh, **cfg):
    port = RenderCompareRefiner.create({1: mesh}, config=RefinerConfig(**cfg), refiner_width=8,
                                       scorer_width=8, device="cpu")
    port.refiner_net.load_state_dict(refiner_flax_to_torch(jax_vars(JRefiner(width=8), 1)))
    port.scorer_net.load_state_dict(refiner_flax_to_torch(jax_vars(JScorer(width=8), 4)))
    return port


def test_train_refiner_matches_jax(cube):
    """2 steps of train_refiner at batch 2 with the curriculum: loss_history
    within 2e-4 of JAX's; the nets return in eval mode."""
    kw = dict(n_iterations=1, render_size=(64, 64), n_sample_points=8)
    jref = _jax_refiner(cube, JConfig(**kw))
    port = _port_refiner(cube, **kw)
    final = dict(rot_deg=2.5, trans_xy=0.0025, trans_z=0.005)
    JT.train_refiner(jref, K_FULL, steps=2, batch_size=2, lr=LR, log_every=1,
                     final_perturb=JT.PerturbConfig(**final))
    timing = {}
    TT.train_refiner(port, K_FULL, steps=2, batch_size=2, lr=LR, log_every=1,
                     final_perturb=TT.PerturbConfig(**final), timing=timing)
    np.testing.assert_allclose(port.loss_history, jref.loss_history, atol=2e-4, rtol=0)
    assert len(port.scorer_loss_history) == 2 and np.isfinite(port.scorer_loss_history).all()
    assert not port.refiner_net.training and not port.scorer_net.training
    assert sorted(timing) == ["batch", "crop", "render", "step", "step_s"]
    assert len(timing["step_s"]) == 2
    port.meshes.close()


def test_train_refiner_cli_round_trip(tmp_path, monkeypatch):
    """The script trains on the fixture's models (2 steps) and saves; a
    fresh refiner loads the file; refine.py serves it with
    refiner_checkpoint=. The JAX package's train_refiner checkpoint (an
    orbax directory, its save_refiner_checkpoint) loads bit for bit as the
    bridge gives its variables, and refine.py serves it too; a width or
    render size other than the refiner's, a directory with no checkpoint,
    an unknown key and (without a card) no device raise."""
    root = synthetic_bop.build(str(tmp_path))
    cad = osp.join(root, "datasets", "tudl", "models")
    out = str(tmp_path / "ckpt")
    args = [f"cad_dir={cad}", f"out_dir={out}", "steps=2", "batch_size=2", "render=64",
            "width=8", "scorer_width=8"]
    timing = {}
    trained = TR.main(args + ["device=cpu"], timing=timing)
    path = osp.join(out, CK.CKPT_NAME)
    assert osp.isfile(path) and len(trained.loss_history) == 2
    assert len(timing["step_s"]) == 2 and {"batch", "crop", "render", "step"} <= set(timing)
    fresh = RenderCompareRefiner.create(refine.mesh_paths_of(cad),
                                        config=RefinerConfig(render_size=(64, 64)),
                                        refiner_width=8, scorer_width=8, device="cpu")
    for src in (out, path):
        CK.load_refiner_checkpoint(src, fresh)
        for a, b in ((fresh.refiner_net, trained.refiner_net),
                     (fresh.scorer_net, trained.scorer_net)):
            sa, sb = a.state_dict(), b.state_dict()
            assert all(torch.equal(sa[k], sb[k]) for k in sb)
    fresh.meshes.close()
    # refine.py with the checkpoint: the csv, refined with the trained nets
    monkeypatch.setenv("GIGAPOSE_TINY", "1")
    base = [f"machine.root_dir={root}", "test_dataset_name=tudl", "n_refine_iterations=1",
            "min_score=0", f"init_loc_path={_coarse_csv(root)}", "device=cpu"]
    paths, _ = refine.main(base + ["run_id=ckpt", f"save_dir={root}/ckpt",
                                   f"refiner_checkpoint={out}"])
    rows = bop_io.load_bop_csv(paths[0])
    assert len(rows) == 2 and all(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all()
                                  for r in rows)
    # the JAX trainer's orbax directory, then other widths or render size
    from types import SimpleNamespace

    from gigapose_tpu.scripts.train_refiner import save_refiner_checkpoint as jax_save

    orbax = str(tmp_path / "orbax")
    jvars = SimpleNamespace(refiner_vars=jax_vars(JRefiner(width=8), 2),
                            scorer_vars=jax_vars(JScorer(width=8), 5))
    jax_save(orbax, jvars)
    CK.load_refiner_checkpoint(orbax, fresh)
    for net, v in ((fresh.refiner_net, jvars.refiner_vars), (fresh.scorer_net, jvars.scorer_vars)):
        want, got = refiner_flax_to_torch(jax.tree_util.tree_map(np.asarray, v)), net.state_dict()
        assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    served, _ = refine.main(base + ["run_id=orbax", f"save_dir={root}/orbax",
                                    f"refiner_checkpoint={orbax}"])
    orbax_rows = bop_io.load_bop_csv(served[0])
    assert len(orbax_rows) == 2 and all(np.isfinite(r["R"]).all() for r in orbax_rows)
    assert max(np.abs(a["R"] - b["R"]).max() for a, b in zip(orbax_rows, rows)) > 1e-4
    wide = str(tmp_path / "orbax_wide")
    jax_save(wide, SimpleNamespace(refiner_vars=jax_vars(JRefiner(width=16), 2),
                                   scorer_vars=jvars.scorer_vars))
    with pytest.raises(ValueError, match="refiner_vars.*width"):
        CK.load_refiner_checkpoint(wide, fresh)
    (tmp_path / "empty" / "refiner").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="no refiner.pt and no orbax"):
        refine.main(base + ["run_id=empty", f"refiner_checkpoint={tmp_path / 'empty'}"])
    for kw in (dict(refiner_width=16, scorer_width=8), dict(refiner_width=8, scorer_width=4)):
        other = RenderCompareRefiner.create(refine.mesh_paths_of(cad),
                                            config=RefinerConfig(render_size=(64, 64)),
                                            device="cpu", **kw)
        with pytest.raises(ValueError, match="width"):
            CK.load_refiner_checkpoint(path, other)
        other.meshes.close()
    with pytest.raises(ValueError, match="render_size"):
        CK.load_refiner_checkpoint(path, RenderCompareRefiner(
            trained.refiner_net, trained.scorer_net, trained.meshes, RefinerConfig()))
    with pytest.raises(ValueError, match="unknown keys"):
        TR.main(args + ["device=cpu", "widht=8"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TR.main(args)


def test_refiners_take_their_device_from_the_nets(cube):
    """A refiner built from its fields (as a checkpoint loader does) runs
    where its nets are, unless given a device."""
    store = MeshStore({1: cube}, 8)
    rnet, snet = RefinerNet(width=8).to("meta"), CoarseScorerNet(width=8).to("meta")
    assert RenderCompareRefiner(rnet, snet, store).device == torch.device("meta")
    assert RenderCompareRefiner(rnet, snet, store, device=torch.device("cpu")).device.type == "cpu"
    assert MegaposeRefiner(rnet, snet, store).device == torch.device("meta")
    store.close()


# ------------------------------------------------------------ augmentations

DEPTH = np.zeros((48, 64), np.float32)
DEPTH[10:40, 20:50] = 0.5
BIG = np.zeros((120, 160), np.float32)
BIG[20:100, 30:140] = 1.0
DEPTH_CASES = [
    ("depth_gaussian_noise", DEPTH, dict(std_dev=0.01)),
    ("depth_correlated_gaussian_noise", DEPTH, {}),
    ("depth_correlated_gaussian_noise", BIG, dict(gp_rescale_factor=(3.0, 9.0))),
    ("depth_missing", DEPTH, dict(max_missing_fraction=0.5)),
    ("depth_ellipse_dropout", DEPTH, dict(mean=8.0)),
    ("depth_ellipse_dropout", BIG, dict(mean=10.0, gamma_scale=3.0)),
    ("depth_ellipse_noise", DEPTH, dict(mean=8.0, std_dev=0.05)),
    ("depth_blur", DEPTH, dict(factor_interval=(3, 7))),
]


@pytest.mark.parametrize("name,depth,kw", DEPTH_CASES,
                         ids=[f"{n}-{d.shape[0]}" for n, d, _ in DEPTH_CASES])
def test_depth_noise_matches_jax(name, depth, kw):
    """The same generator state gives the same bytes and leaves the
    generators in the same state, over 12 seeds."""
    for seed in range(12):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        want = getattr(JA, name)(depth, r1, **kw)
        got = getattr(A, name)(depth, r2, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), seed
        assert r1.bit_generator.state == r2.bit_generator.state
    assert not np.array_equal(got, depth)


def test_depth_dropouts_and_background_match_jax():
    seg = (DEPTH > 0).astype(np.int32)
    assert np.array_equal(A.depth_dropout(DEPTH), JA.depth_dropout(DEPTH))
    seg2 = seg.copy()
    seg2[15:20] = 0
    assert np.array_equal(A.depth_background_dropout(DEPTH, seg2),
                          JA.depth_background_dropout(DEPTH, seg2))
    rgb = np.random.default_rng(3).integers(0, 256, (48, 64, 3)).astype(np.uint8)
    r = np.random.default_rng(4)
    bgs = [r.integers(0, 256, (30, 50, 3)).astype(np.uint8),
           r.integers(0, 256, (20, 20)).astype(np.uint8),
           r.integers(0, 256, (48, 64, 4)).astype(np.uint8),
           np.full((8, 8, 3), 200, np.uint8)]
    for seed in range(12):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        want = JA.replace_background(rgb, seg, bgs, r1)
        got = A.replace_background(rgb, seg, bgs, r2)
        assert np.array_equal(got, want), seed
        assert np.array_equal(got[seg > 0], rgb[seg > 0])


def test_pillow_rebuilds_are_exact():
    """The filled ellipse at every size up to 60 x 60 (inside and across the
    canvas edges), the bilinear rotation of L masks at integer and real
    angles, the bicubic resizes of F and RGB images up and down."""
    for x0, y0 in ((2, 3), (-3, 5), (30, -7)):
        for a in range(0, 61, 3):
            for b in range(0, 61):
                m = Image.new("L", (50, 50), 0)
                ImageDraw.Draw(m).ellipse((x0, y0, x0 + a, y0 + b), fill=255)
                got = np.zeros((50, 50), np.uint8)
                A.draw_ellipse(got, (x0, y0, x0 + a, y0 + b), 255)
                assert np.array_equal(got, np.asarray(m)), (x0, y0, a, b)
    rng = np.random.default_rng(0)
    for n in range(60):
        s = int(rng.integers(3, 40))
        img = (rng.uniform(size=(s, s)) * 255).astype(np.uint8)
        angle = -float(rng.integers(0, 360)) if n % 2 else float(rng.uniform(-400, 400))
        want = np.asarray(Image.fromarray(img, "L").rotate(angle, resample=Image.BILINEAR))
        assert np.array_equal(A.rotate_bilinear_l(img, angle), want), (s, angle)
    for n in range(40):
        h, w, H, W = (int(v) for v in rng.integers(1, 40, 4))
        small = rng.normal(0, 0.01, (h, w)).astype(np.float32)
        want = np.asarray(Image.fromarray(small).resize((2 * W, 2 * H), Image.BICUBIC))
        assert np.array_equal(A.resize_bicubic_f32(small, (2 * W, 2 * H)), want)
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        assert np.array_equal(A.resize_bicubic_u8(rgb, (W, H)),
                              np.asarray(Image.fromarray(rgb).resize((W, H))))
