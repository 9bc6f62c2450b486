"""One refiner step and one scorer step of refiner training
(gigapose_tpu_torch/refiner/training.py) on the card against the same step
on the CPU, from the same weights on the same inputs, TF32 off.

Marked `cuda`: each test skips where torch.cuda.is_available() is false (the
decision is taken in the fixture, never at import). Imports no jax, so it
runs where the port runs.

The losses agree within 1e-4 relative (an H100 read 1.1e-5 at width 64, two
f32 ulps of the loss: cuDNN's and the CPU's convolutions sum in other
orders); each parameter's gradient (before the update) on the card within
GRAD_ATOL + 2 x the CPU f32 gradient's own gap of the CPU's f64 gradient,
per tensor in norm: at this random init the BatchNorms' f32 gradients are
ill-conditioned, on the card and on the CPU alike, and the CPU's gap
measures it (gigapose_tpu_torch/scripts/refiner_train_probe.py reads both
at these inputs; an H100's host put both f32 gradients about 0.1 from f64
at width 8, on the same tensor, where another CPU read 3e-5); a gradient
negated or zeroed reads 2 or 1 and fails the check (planted here); the
BatchNorm statistics within 1e-3 absolute.
"""

import numpy as np
import pytest
import torch

from gigapose_tpu_torch.refiner import training as TT
from gigapose_tpu_torch.refiner.network import CoarseScorerNet, RefinerNet, init_like_flax_
from gigapose_tpu_torch.refiner.refiner import no_tf32
from gigapose_tpu_torch.training.state import Adam

pytestmark = pytest.mark.cuda

LR = 1e-3
GRAD_ATOL = 1e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(B: int = 4):
    from scipy.spatial.transform import Rotation

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
    return crops, renders, TCO_in, Kc, TCO_in[:, :3, 3].copy(), TCO_gt, pts


def _grad_gaps(got, want):
    return {k: float((got[k].double() - w).norm() / w.norm().clamp(min=1e-30))
            for k, w in want.items()}


def _grad_excess(card, cpu, f64):
    """The card's per-tensor gap to f64 over its bound (GRAD_ATOL + 2 x the
    CPU f32 gradient's gap): the largest ratio and its tensor."""
    g_cpu = _grad_gaps(cpu, f64)
    ratio = {k: g / (GRAD_ATOL + 2 * g_cpu[k]) for k, g in _grad_gaps(card, f64).items()}
    worst = max(ratio, key=ratio.get)
    return ratio[worst], worst


@pytest.mark.parametrize("width", [8, 64])
def test_refiner_and_scorer_steps_on_the_card_match_the_cpu(card, width):
    args = _inputs()
    cpu = torch.device("cpu")
    out = {}
    for tag, dev, dtype in (("cpu", cpu, torch.float32), ("cuda", card, torch.float32),
                            ("f64", cpu, torch.float64)):
        gen = torch.Generator().manual_seed(0)
        r = init_like_flax_(RefinerNet(width=width), gen)
        s = init_like_flax_(CoarseScorerNet(width=width // 2), gen).to(dev, dtype)
        with torch.no_grad():  # a random pose head: the identity head's update is 0
            r.pose_head.weight.normal_(0, 0.01, generator=torch.Generator().manual_seed(1))
        r = r.to(dev, dtype)
        o_r, o_s = Adam({"refiner": LR}), Adam({"scorer": LR})
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
        with no_tf32():
            aux = TT.refiner_step(r, o_r, o_r.init({"refiner": r}), *(put(a) for a in args))
            y = put(np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32))
            x_c = torch.cat([put(args[0]), put(args[0])])
            x_r = torch.cat([put(args[1]), put(args[1][::-1])])
            s_loss = TT.scorer_step(s, o_s, o_s.init({"scorer": s}), x_c, x_r, y)
        nets = (("r", r), ("s", s))
        out[tag] = dict(loss=float(aux["loss"]), bce=float(s_loss),
                        grads={f"{n}.{k}": p.grad.cpu() for n, net in nets
                               for k, p in net.named_parameters()},
                        stats={f"{n}.{k}": v.cpu() for n, net in nets
                               for k, v in net.state_dict().items()
                               if k.endswith(("running_mean", "running_var"))})
    c, g, f64 = out["cpu"], out["cuda"], out["f64"]
    np.testing.assert_allclose(g["loss"], c["loss"], rtol=1e-4)
    np.testing.assert_allclose(g["bce"], c["bce"], rtol=1e-4)
    for k, v in c["stats"].items():
        assert float((g["stats"][k] - v).abs().max()) <= 1e-3, k
    excess, worst = _grad_excess(g["grads"], c["grads"], f64["grads"])
    assert excess <= 1.0, (worst, excess)
    first = next(iter(g["grads"]))
    last = [k for k in g["grads"] if k.startswith("r.") and "conv2" in k][-1]
    for k, f in ((first, -1.0), (last, 0.0)):
        planted = dict(g["grads"], **{k: g["grads"][k] * f})
        assert _grad_excess(planted, c["grads"], f64["grads"])[0] > 1.0, k
