"""train_step of the port == the JAX package's over three steps (CPU, f32),
for nets_to_train in {all, ae, ist}, from the same state (the weight
bridge) on the same seeded batches, with warm_up_steps=2: lr 0 at the first
update, half the lr at the second, the full lr and the switch from the l2
warm-up losses to the log / geodesic losses at the third.

Tolerances, from the two packages' f32 arithmetic on the tiny nets:
- the losses of every step to rtol 5e-4 (the IST's training-mode forward
  differs by about 2e-5 relative at the first step; the random nets' scale
  loss grows to O(100) by the third);
- gradients in norm, relative to each tensor's norm (the readings in
  brackets): the first step's of the AE to 1e-4 (3e-6), of the IST's
  regressor to 1e-3 (4e-4) and of its backbone to 0.1 (0.048); the Adam
  moments after three steps of the AE to 1e-4 (3e-6), of the IST's
  regressor to 1e-2 (4.5e-3, its inputs have diverged) and of its backbone
  to 0.15 (0.057). The IST backbone's gradient at this random init is
  ill-conditioned: in the port alone, the input crops moved by 1e-5 of
  their size move it by more than 1 %
  (test_ist_backbone_gradient_is_ill_conditioned); the packages'
  convolutions and bilinear sample positions round differently (1 ulp),
  which compounds through ten convolutions and BatchNorm over a batch of 2;
- after three steps, the AE's parameters to 1e-6 absolute (their updates
  are 1.5e-5 in all); the IST's to 2 x the summed lr (1.5e-4) everywhere and
  to a tenth of it for 98 % of the entries: Adam moves every entry by about
  lr whatever its gradient's size, so an entry whose gradient sits within
  the packages' gap of 0 may move the other way (0.3 % of the IST's
  entries here);
- the BatchNorm running statistics to 1e-4 absolute; the step counts and
  the frozen net exactly.
"""

import jax
import numpy as np
import pytest
import torch

from gigapose_tpu.training import state as JS
from gigapose_tpu_torch.models import convert
from gigapose_tpu_torch.training import state as TS
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (a fixture)
from tests.torch_train_fixtures import (
    jax_batch, jax_nets, jax_train_state, port_batch, port_state_dicts, port_train_state,
    random_batch, to_numpy,
)

STEPS, WARM = 3, 2


def _close(got, want, net, key, after_steps=False):
    """Gradient-like tensors: |got - want| <= tol |want| in norm."""
    if net == "ae":
        tol = 1e-4
    elif key.startswith("backbone."):
        tol = 0.15 if after_steps else 0.1
    else:
        tol = 1e-2 if after_steps else 1e-3
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want), (key, tol)


def _adam(opt_state, net):
    return opt_state.inner_states[net].inner_state[0]


@pytest.mark.parametrize("nets", ["all", "ae", "ist"])
def test_train_step_matches_jax(nets):
    cfg_j = JS.OptimConfig(nets_to_train=nets, warm_up_steps=WARM)
    cfg_t = TS.OptimConfig(nets_to_train=nets, warm_up_steps=WARM)
    jstate, tx = jax_train_state(cfg_j, seed=11)
    jae, jist = jax_nets()
    step = jax.jit(lambda s, b: JS.train_step(jae, jist, tx, cfg_j, s, b))
    state = port_train_state(jstate, cfg_t)
    init = {net: {k: v.clone() for k, v in m.state_dict().items()} for net, m in state.nets.items()}

    grads0 = None
    for i in range(STEPS):
        b = random_batch(100 + i)
        jstate, jm = step(jstate, jax_batch(b))
        tm = TS.train_step(state, port_batch(b))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=5e-4, err_msg=f"{i} {k}")
        assert state.step == int(jstate.step) == i + 1
        if i == 0:
            grads0 = {net: {k: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
                            for k, p in m.named_parameters()}
                      for net, m in state.nets.items() if cfg_t.trains(net)}
            for net, g in grads0.items():  # optax's first mu is 0.1 g
                want = convert.params_flax_to_torch(
                    net, to_numpy(_adam(jstate.opt_state, net).mu[net]))
                for k, v in g.items():
                    _close(v.numpy(), want[k].numpy() / np.float32(0.1), net, k)
                    # the final LayerNorm lies after x_prenorm: no gradient, in both
                    assert float(v.abs().max()) > 0 or k.startswith("vit.norm."), k

    ae_sd, ist_sd = port_state_dicts(jstate)
    lr_sum = {"ae": 1e-5 * 1.5, "ist": 1e-4 * 1.5}
    for net, want_sd in (("ae", ae_sd), ("ist", ist_sd)):
        got_sd = state.nets[net].state_dict()
        moved, far = 0, 0
        for k, want in want_sd.items():
            got, w = got_sd[k].numpy(), want.numpy()
            if k.endswith("num_batches_tracked"):
                continue
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got, w, atol=1e-4, rtol=0, err_msg=k)
                assert cfg_t.trains("ist") != np.array_equal(got, init[net][k].numpy()), k
                continue
            if not cfg_t.trains(net):
                assert np.array_equal(got, init[net][k].numpy()) and np.array_equal(w, got), k
                continue
            d = np.abs(got - w)
            moved += d.size
            if net == "ae":
                np.testing.assert_allclose(got, w, rtol=0, atol=1e-6, err_msg=k)
            else:
                assert d.max() <= 2 * lr_sum[net], k
                far += int((d > 0.1 * lr_sum[net]).sum())
            # the final LayerNorm has no gradient; its decay (lr wd p) is below an ulp
            assert k.startswith("vit.norm.") or not np.array_equal(got, init[net][k].numpy()), k
        assert far <= 0.02 * max(moved, 1), (net, far, moved)
        if not cfg_t.trains(net):
            assert net not in state.opt_state
            continue
        adam = _adam(jstate.opt_state, net)
        assert state.opt_state[net]["count"] == int(adam.count) == STEPS
        for m in ("mu", "nu"):
            want = convert.params_flax_to_torch(net, to_numpy(getattr(adam, m)[net]))
            for k, v in state.opt_state[net][m].items():
                _close(v.numpy(), want[k].numpy(), net, k, after_steps=True)


def test_ist_backbone_gradient_is_ill_conditioned():
    """Why the IST backbone's tolerance above is loose: in the port alone,
    the same step twice gives the same gradient, but the input crops moved
    by 1e-5 of their size move the backbone's gradient by more than 1 % in
    norm (ReLUs near 0 flip, and BatchNorm over a batch of 2 carries it),
    the regressor's by under a third of that."""
    cfg = TS.OptimConfig(nets_to_train="ist")
    jstate, _ = jax_train_state(JS.OptimConfig(nets_to_train="ist"), seed=11)
    b = random_batch(100)

    def grads(eps):
        state = port_train_state(jstate, cfg)
        bb = dict(b)
        noise = np.random.default_rng(1).normal(size=b["src_img"].shape)
        bb["src_img"] = (b["src_img"] * (1 + eps * noise)).astype(np.float32)
        total, _ = TS.compute_losses(state.ae_net, state.ist_net.train(), port_batch(bb), 0, cfg)
        total.backward()
        return {k: p.grad.double() for k, p in state.ist_net.named_parameters()}

    base = grads(0.0)
    again, moved = grads(0.0), grads(1e-5)
    rel = lambda g, k: float((g[k] - base[k]).norm() / base[k].norm())
    assert all(torch.equal(again[k], base[k]) for k in base)
    backbone = max(rel(moved, k) for k in base if k.startswith("backbone."))
    head = max(rel(moved, k) for k in base if k.startswith("regressor."))
    assert backbone > 1e-2 and head < backbone / 3, (backbone, head)
