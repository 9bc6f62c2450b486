"""The port's training pieces == the JAX package's on the same inputs (CPU,
f32): the losses and their gradients, flax's train-mode BatchNorm
statistics, the lr schedule and the AdamW update, the loss switch at
warm_up_steps, and the validation metrics.

Tolerances: the losses agree to rtol 1e-5 and their gradients to atol 1e-6
(f32 reductions summed in another order); the lr schedule exactly; the
AdamW update, fed the same gradients, to 1.2e-7 absolute, 1 ulp at 1.0
(optax's bias corrections and the clip's global norm round in another
order; the updates are lr-sized, 1e-5 to 1e-4), the moments to 1e-6 of
their largest entry; the BatchNorm running
statistics to atol 1e-5 after two backbone calls (means of convolution
outputs over up to 2 x 128 x 128 positions, each convolution summed in
another order: about 3e-6 apart on this net); compute_losses and the
validation metrics, which run the tiny nets, to rtol 1e-4 (the IST's
training-mode forward differs by about 2e-5 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gigapose_tpu.models import losses as JL
from gigapose_tpu.training import state as JS
from gigapose_tpu.training.validate import validation_metrics as j_validation_metrics
from gigapose_tpu_torch.models import convert
from gigapose_tpu_torch.models import losses as TL
from gigapose_tpu_torch.training import state as TS
from gigapose_tpu_torch.training.validate import validation_metrics
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (a fixture)
from tests.torch_train_fixtures import (
    jax_batch, jax_nets, jax_train_state, port_batch, port_state_dicts, port_train_state,
    random_batch, to_numpy,
)

T = torch.as_tensor


def _loss_inputs(seed, N=96, C=16):
    r = np.random.default_rng(seed)
    valid = r.uniform(size=N) < 0.7
    return dict(q=r.normal(size=(N, C)).astype(np.float32),
                k=r.normal(size=(N, C)).astype(np.float32),
                valid=valid,
                scale=r.uniform(-0.2, 3.0, N).astype(np.float32),  # some below the 1e-6 clip
                gt_scale=r.uniform(0.3, 3.0, N).astype(np.float32),
                cs=r.normal(size=(N, 2)).astype(np.float32),
                gt_cs=np.stack([np.cos(a := r.uniform(0, 6.3, N)), np.sin(a)], -1).astype(np.float32))


def _cases():
    """(name, jax fn, port fn, argument names) of each loss."""
    return [
        ("info_nce", lambda q, k, v: JL.info_nce_loss(q, k, v, tau=0.1),
         lambda q, k, v: TL.info_nce_loss(q, k, v, tau=0.1), ("q", "k", "valid")),
        ("scale_log_l2", lambda p, g, v: JL.scale_loss(p, g, v, log=True),
         lambda p, g, v: TL.scale_loss(p, g, v, log=True), ("scale", "gt_scale", "valid")),
        ("scale_l1", lambda p, g, v: JL.scale_loss(p, g, v, log=False, loss="l1"),
         lambda p, g, v: TL.scale_loss(p, g, v, log=False, loss="l1"),
         ("scale", "gt_scale", "valid")),
        ("inplane_geodesic", lambda p, g, v: JL.inplane_loss(p / jnp.linalg.norm(p, axis=-1,
                                                                                    keepdims=True), g, v),
         lambda p, g, v: TL.inplane_loss(p / torch.linalg.vector_norm(p, dim=-1, keepdim=True), g, v),
         ("cs", "gt_cs", "valid")),
        ("inplane_l2_normalized", lambda p, g, v: JL.inplane_loss(p, g, v, loss="l2", normalize=True),
         lambda p, g, v: TL.inplane_loss(p, g, v, loss="l2", normalize=True),
         ("cs", "gt_cs", "valid")),
        ("l2_warmup", lambda s, c, gs, gc, v: sum(JL.l2_warmup_losses(s, c, gs, gc, v)),
         lambda s, c, gs, gc, v: sum(TL.l2_warmup_losses(s, c, gs, gc, v)),
         ("scale", "cs", "gt_scale", "gt_cs", "valid")),
    ]


@pytest.mark.parametrize("case", range(6), ids=[c[0] for c in _cases()])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradient_match_jax(case, seed):
    name, jfn, tfn, names = _cases()[case]
    x = _loss_inputs(seed)
    args = [x[n] for n in names]
    want, jgrad = jax.value_and_grad(lambda a: jfn(a, *map(jnp.asarray, args[1:])))(
        jnp.asarray(args[0]))
    first = T(args[0]).clone().requires_grad_(True)
    got = tfn(first, *map(T, args[1:]))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(first.grad.numpy(), np.asarray(jgrad), atol=1e-6)
    assert np.isfinite(first.grad.numpy()).all()


def test_info_nce_ignores_invalid_rows_and_columns():
    """An invalid pair changes nothing: neither its row (the mean) nor its
    column (a negative) enters the loss."""
    x = _loss_inputs(3)
    q, k, v = T(x["q"]), T(x["k"]), T(x["valid"])
    base = TL.info_nce_loss(q, k, v)
    q2, k2 = q.clone(), k.clone()
    q2[~v] = 100.0
    k2[~v] = -7.0
    assert torch.equal(TL.info_nce_loss(q2, k2, v), base)


def test_batch_norm_statistics_match_flax_after_two_backbone_calls():
    """One training-mode forward of the IST (the shared backbone on src,
    then on tar): flax's running statistics (biased variance, momentum 0.9,
    two updates) against the port's."""
    jae, jist = jax_nets()
    cfg = JS.OptimConfig()
    jstate, _ = jax_train_state(cfg, seed=5)
    b = random_batch(5)
    variables = {"params": jstate.ist_params, "batch_stats": jstate.ist_batch_stats}
    out, mut = jist.apply(variables, b["src_img"], b["tar_img"], b["src_pts"], b["tar_pts"],
                          train=True, mutable=["batch_stats"])
    ist = port_train_state(jstate, TS.OptimConfig()).ist_net.train()
    got = ist(T(b["src_img"]), T(b["tar_img"]), T(b["src_pts"]), T(b["tar_pts"]))
    want = convert.ist_flax_to_torch({"params": to_numpy(jstate.ist_params),
                                      "batch_stats": to_numpy(mut["batch_stats"])})
    before = port_state_dicts(jstate)[1]
    sd = ist.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 20  # stem, 2 per block, 3 downsamples
    for k in stats:
        assert not torch.equal(sd[k], before[k]), f"{k} did not move"
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got.scale.detach().numpy(), np.asarray(out.scale), rtol=1e-3,
                               atol=1e-3)


def test_batch_norm_uses_the_biased_batch_variance():
    """On one layer: the output is normalized by the biased variance and the
    running variance moves to it (torch's nn.BatchNorm2d stores the unbiased
    one)."""
    from gigapose_tpu_torch.models.ist_net import batch_norm

    layer = torch.nn.BatchNorm2d(3).train()
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    y = batch_norm(layer, x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(layer.running_var.numpy(), (0.9 + 0.1 * var).numpy(), rtol=1e-6)
    np.testing.assert_allclose(layer.running_mean.numpy(), (0.1 * x.mean(dim=(0, 2, 3))).numpy(),
                               atol=1e-7)
    np.testing.assert_allclose(y.detach().var(dim=(0, 2, 3), unbiased=False).numpy(), 1.0,
                               rtol=1e-4)
    layer.eval()
    before = layer.running_var.clone()
    batch_norm(layer, x)
    assert torch.equal(layer.running_var, before)


@pytest.mark.parametrize("warm", [1, 7, 200])
def test_lr_schedule_matches_optax(warm):
    """The warm-up lr at every count around the switch, and lr 0 at the
    first update."""
    for lr in (1e-5, 1e-4):
        sched = optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warm), optax.constant_schedule(lr)], [warm])
        for count in list(range(0, min(warm + 3, 12))) + [warm - 1, warm, warm + 1, 500]:
            if count < 0:
                continue
            assert TS.warmup_lr(lr, warm, count) == np.float32(sched(count)), (lr, warm, count)
        assert TS.warmup_lr(lr, warm, 0) == 0.0


@pytest.mark.parametrize("nets", ["all", "ae", "ist"])
@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_adamw_update_matches_optax_on_the_same_gradients(nets, clip):
    """Three updates of make_optimizer's AdamW fed the same gradients as
    optax's: parameters within 1.2e-7, moments and counts equal, the first
    update a no-op (lr 0) but for its moments, the frozen net untouched."""
    cfg_j = JS.OptimConfig(nets_to_train=nets, warm_up_steps=2, grad_clip=clip)
    cfg_t = TS.OptimConfig(nets_to_train=nets, warm_up_steps=2, grad_clip=clip)
    jstate, tx = jax_train_state(cfg_j, seed=2)
    state = port_train_state(jstate, cfg_t)
    params = {"ae": jstate.ae_params, "ist": jstate.ist_params}
    opt = jstate.opt_state
    r = np.random.default_rng(9)
    init = {net: dict(m.named_parameters()) for net, m in state.nets.items()}
    init = {net: {k: p.detach().clone() for k, p in ps.items()} for net, ps in init.items()}
    update = jax.jit(tx.update)
    for step in range(3):
        # the frozen net gets no gradient, as in compute_losses
        grads = {net: jax.tree_util.tree_map(
            lambda p: jnp.asarray(r.normal(scale=1e-2, size=p.shape).astype(np.float32)
                                  * cfg_t.trains(net)), tree) for net, tree in params.items()}
        updates, opt = update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        for net, module in state.nets.items():
            g = convert.params_flax_to_torch(net, to_numpy(grads[net]))
            for k, p in module.named_parameters():
                p.grad = g[k].clone() if cfg_t.trains(net) else None
        state.tx.update(state.opt_state, state.nets)
        for net, module in state.nets.items():
            want = convert.params_flax_to_torch(net, to_numpy(params[net]))
            for k, p in module.named_parameters():
                got = p.detach().numpy()
                if step == 0 or not cfg_t.trains(net):
                    assert np.array_equal(got, init[net][k].numpy()), (step, net, k)
                np.testing.assert_allclose(got, want[k].numpy(), rtol=0, atol=1.2e-7)
    inner = opt[1] if clip else opt  # optax.chain(clip, multi_transform)
    for net in ("ae", "ist"):
        if not cfg_t.trains(net):
            assert net not in state.opt_state
            continue
        adam = inner.inner_states[net].inner_state[0]
        st = state.opt_state[net]
        assert st["count"] == int(adam.count) == 3
        for m in ("mu", "nu"):
            want = convert.params_flax_to_torch(net, to_numpy(getattr(adam, m)[net]))
            for k, v in st[m].items():
                w = want[k].numpy()
                np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("offset", [-1, 0])
def test_loss_switch_at_warm_up_steps_matches_jax(offset):
    """compute_losses one step before warm_up_steps (the l2 warm-up losses)
    and at it (log scale and geodesic), on both sides."""
    warm = 5
    step = warm + offset
    cfg_j = JS.OptimConfig(warm_up_steps=warm)
    jstate, _ = jax_train_state(cfg_j, seed=3)
    jae, jist = jax_nets()
    b = random_batch(3)
    params = {"ae": jstate.ae_params, "ist": jstate.ist_params}
    _, (want, _) = JS.compute_losses(jae, jist, params, jstate.ist_batch_stats, jax_batch(b),
                                     jnp.asarray(step, jnp.int32), cfg_j)
    state = port_train_state(jstate, TS.OptimConfig(warm_up_steps=warm))
    for net in state.nets.values():
        net.train()
    _, got = TS.compute_losses(state.ae_net, state.ist_net, port_batch(b), step, state.cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, err_msg=k)
    b2 = dict(b, rel_scale=b["rel_scale"] * 0 + 1.0, rel_inplane=b["rel_inplane"] * 0)
    # the warm-up losses are plain MSE, the main ones log / geodesic: they differ
    _, other = TS.compute_losses(state.ae_net, state.ist_net, port_batch(b2),
                                 warm - 1 - offset, state.cfg)
    _, same = TS.compute_losses(state.ae_net, state.ist_net, port_batch(b2), step, state.cfg)
    assert float(other["scale"]) != pytest.approx(float(same["scale"]), rel=1e-3)


def test_optim_config_refuses_the_tpu_knobs():
    """The JAX package's memory knobs are ported (tests/test_torch_train_knobs.py);
    an nce_dtype other than bf16 and an unknown nets_to_train are refused."""
    assert TS.OptimConfig(fuse_ist_pair=True).fuse_ist_pair
    assert TS.OptimConfig(nce_dtype="bf16").nce_dtype == "bf16"
    with pytest.raises(ValueError, match="bf16"):
        TS.OptimConfig(nce_dtype="fp8")
    with pytest.raises(ValueError):
        TS.OptimConfig(nets_to_train="both")


def test_validation_metrics_match_jax():
    jae, jist = jax_nets()
    jstate, _ = jax_train_state(JS.OptimConfig(), seed=4)
    b = random_batch(4, invalid=0.2)
    want = j_validation_metrics(
        jae, jist, {"params": jstate.ae_params},
        {"params": jstate.ist_params, "batch_stats": jstate.ist_batch_stats}, jax_batch(b))
    state = port_train_state(jstate, TS.OptimConfig())
    for net in state.nets.values():
        net.eval()
    got = validation_metrics(state.ae_net, state.ist_net, port_batch(b))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-6, err_msg=k)


def test_remat_gives_the_same_loss_and_gradients():
    """model.ae_net.remat=true: each ViT block checkpointed
    (torch.utils.checkpoint, use_reentrant=False) recomputes the same
    operations in the backward pass, so the loss and every gradient are
    bit-equal on the CPU; a name that is no jax.checkpoint_policies entry
    the port maps raises (the policies: tests/test_torch_train_knobs.py)."""
    from gigapose_tpu_torch.models.ae_net import AENet

    x = torch.as_tensor(random_batch(6)["src_img"])
    grads = []
    for remat in (False, True):
        ae = AENet("vit_tiny_test", remat=remat)
        torch.manual_seed(0)
        for p in ae.parameters():
            torch.nn.init.normal_(p, std=0.05)
        loss = (ae(x) ** 3).sum()
        loss.backward()
        grads.append((loss.detach(), {k: p.grad for k, p in ae.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for k, g in grads[0][1].items():  # the final LayerNorm (after x_prenorm) has none
        assert (g is None and grads[1][1][k] is None) or torch.equal(g, grads[1][1][k]), k
    with pytest.raises(ValueError, match="dots_saveable"):
        AENet("vit_tiny_test", remat="offload_dot_with_no_batch_dims")
