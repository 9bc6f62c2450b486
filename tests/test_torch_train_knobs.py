"""The AE trainer's memory knobs of the port against the JAX package's, CPU,
at tests/test_models.py:test_train_forward_knobs_smoke's set-up (the tiny
AE and IST of train.py, B = 2, P = 16 valid correspondences, N(0, 1)
crops), with the numpy-made variables of tests/torch_train_fixtures.py:

- compute_losses with OptimConfig(fuse_ist_pair=True) (one IST backbone pass
  over the interleaved 2B pair, BatchNorm on joint statistics), with
  nce_dtype="bf16" (the logit matrix in bf16) and with
  ISTBackbone(norm_dtype="bfloat16") (BatchNorm outputs in bf16), each
  against JAX's compute_losses with the same knob: every metric to rtol
  5e-4 (tests/test_torch_train_step.py's loss tolerance; readings at most
  2.6e-5), the moved BatchNorm statistics to 1e-4 absolute (readings 6e-6);
  with norm_dtype to rtol 3e-2 and 3e-3 (readings 7.9e-3, the scale loss,
  and 5.8e-4): the two packages' f32 convolutions, a last bit apart, put
  0.07 % of the first block's BatchNorm outputs on the other side of a bf16
  rounding; each such step moves the next BatchNorm's batch statistics, and
  by the last block 54 % of the outputs sit a bf16 step apart (1 % mean
  relative); and each knob moves the total away from the default path's,
  as it does in JAX;
- ViTConfig.remat: with each jax.checkpoint_policies name the port maps,
  and True, the gradients of vit_tiny_test equal (bit for bit) those
  without remat, and the policy decides which matmuls the backward pass
  runs again; an unknown name raises and names the five;
- train.py's model.ae_net.remat=dots_saveable reaches the ViT as that name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gigapose_tpu.models.ae_net import AENet as JAENet
from gigapose_tpu.models.ist_net import ISTBackbone as JISTBackbone
from gigapose_tpu.models.ist_net import ISTNet as JISTNet
from gigapose_tpu.models.ist_net import Regressor as JRegressor
from gigapose_tpu.training import state as JS
from gigapose_tpu_torch import train as port_train
from gigapose_tpu_torch.cli import load_cli_config
from gigapose_tpu_torch.models.ae_net import AENet
from gigapose_tpu_torch.models.ist_net import ISTBackbone, ISTNet, Regressor
from gigapose_tpu_torch.models.vit import REMAT_POLICIES, ViT, VIT_CONFIGS, ViTConfig
from gigapose_tpu_torch.training import state as TS
from tests.torch_train_fixtures import IST_KW, jax_train_state, port_state_dicts
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (a fixture)

B, P = 2, 16


def _batch():
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 4, size=(B, P, 2)).astype(np.float32)
    return dict(src_img=rng.normal(size=(B, 3, 224, 224)).astype(np.float32),
                tar_img=rng.normal(size=(B, 3, 224, 224)).astype(np.float32),
                src_pts=pts, tar_pts=pts, rel_scale=np.ones(B, np.float32),
                rel_inplane=np.zeros(B, np.float32))


def _losses(knob):
    """(JAX total, metrics, new statistics), (the port's): compute_losses at
    step 0 with `knob` on both sides."""
    cfg_kw = {"fuse": dict(fuse_ist_pair=True), "nce": dict(nce_dtype="bf16")}.get(knob, {})
    norm = "bfloat16" if knob == "norm" else None
    jstate, _ = jax_train_state(JS.OptimConfig(), seed=0)
    jae = JAENet(model_name="vit_tiny_test")
    jist = JISTNet(backbone=JISTBackbone(**IST_KW, norm_dtype=norm),
                   regressor=JRegressor(hidden_dim=16))
    b = _batch()
    cfg = JS.OptimConfig(**cfg_kw)
    total, (metrics, stats) = jax.jit(
        lambda p, s, batch: JS.compute_losses(jae, jist, p, s, batch, jnp.int32(0), cfg))(
        {"ae": jstate.ae_params, "ist": jstate.ist_params}, jstate.ist_batch_stats,
        JS.TrainBatch(**{k: jnp.asarray(v) for k, v in b.items()}))
    ae, ist = AENet("vit_tiny_test"), ISTNet(ISTBackbone(**IST_KW, norm_dtype=norm),
                                            Regressor(32, hidden_dim=16))
    ae_sd, ist_sd = port_state_dicts(jstate)
    ae.load_state_dict(ae_sd, strict=True)
    ist.load_state_dict(ist_sd, strict=True)
    ae.train(), ist.train()
    got_total, got = TS.compute_losses(ae, ist, TS.TrainBatch(
        **{k: torch.as_tensor(v) for k, v in b.items()}), 0, TS.OptimConfig(**cfg_kw))
    want_stats = port_state_dicts(jstate._replace(ist_batch_stats=stats))[1]
    return (float(total), metrics, want_stats), (got_total.item(),
                                                 {k: v.detach() for k, v in got.items()},
                                                 ist.state_dict())


@pytest.mark.parametrize("knob", ["fuse", "nce", "norm"])
def test_compute_losses_with_each_knob_matches_jax(knob):
    (want, wm, wstats), (got, gm, gstats) = _losses(knob)
    rtol, atol = (3e-2, 3e-3) if knob == "norm" else (5e-4, 1e-4)
    assert sorted(gm) == sorted(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=rtol, err_msg=k)
    for k, w in wstats.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(gstats[k].numpy(), w.numpy(), atol=atol, rtol=0,
                                       err_msg=k)
    (base, _, _), _ = _losses("none")
    assert abs(got - base) > 1e-6 * abs(base), (knob, got, base)


def _remat_grads(remat):
    """vit_tiny_test's parameter gradients of a fixed scalar of its
    features, and the aten matmuls that the backward pass runs."""
    torch.manual_seed(0)
    net = ViT(ViTConfig(**{**VIT_CONFIGS["vit_tiny_test"].__dict__, "remat": remat}))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    x = torch.randn(2, 3, 56, 56, generator=gen)
    y = net(x)["x_prenorm"]
    ops = {"mm": 0, "addmm": 0, "bmm": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ops:
                ops[name] += 1
            return func(*args, **(kwargs or {}))

    weights = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) / y.numel()
    with Count():
        (y * y * weights).sum().backward()
    return {k: p.grad for k, p in net.named_parameters() if p.grad is not None}, ops


def test_remat_policies_keep_the_gradients():
    base, base_ops = _remat_grads(False)
    runs = {r: _remat_grads(r) for r in [True, *REMAT_POLICIES]}
    for remat, (grads, ops) in runs.items():
        assert sorted(grads) == sorted(base) and all(torch.equal(grads[k], base[k])
                                                     for k in base), remat
    forward_dots = {k: runs[True][1][k] - base_ops[k] for k in base_ops}
    assert forward_dots["bmm"] > 0 and forward_dots["mm"] + forward_dots["addmm"] > 0
    # what the backward pass computes again, by policy
    assert runs["nothing_saveable"][1] == runs[True][1]
    for saved in ("everything_saveable", "dots_saveable", "checkpoint_dots"):
        assert runs[saved][1] == base_ops, saved
    assert runs["dots_with_no_batch_dims_saveable"][1] == {
        "mm": base_ops["mm"], "addmm": base_ops["addmm"],
        "bmm": base_ops["bmm"] + forward_dots["bmm"]}


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="dots_with_no_batch_dims_saveable"):
        AENet("vit_tiny_test", remat="save_anything_except_these_names")


def test_train_cli_passes_the_remat_name_to_the_vit():
    """model.ae_net.remat=dots_saveable reaches the ViT as that name (it was
    once read as bool, which turned every name into a full checkpoint)."""
    for value, want in (("dots_saveable", "dots_saveable"), ("true", True), ("false", False)):
        cfg = load_cli_config(["model.ae_net.backbone=vit_tiny_test",
                               f"model.ae_net.remat={value}"], port_train.OPTIONAL_KEYS,
                              name="train")
        ae, _ = port_train.build_nets(cfg, tiny=False)
        assert ae.vit.cfg.remat == want and type(ae.vit.cfg.remat) is type(want)
