"""selfcheck_e2e's coarse chain on the card against the same chain on the CPU,
on the same trained weights (gigapose_tpu_torch/scripts/selfcheck_e2e.py).

The nets train STEPS steps on the card (the pasted-texture fixture, the
selfcheck recipe); then the coarse chain (onboarding into a bf16 store, the
fused matching kernel, the IST, RANSAC, recovery, the csv) runs with them on
the card and with a CPU copy of them on the CPU (the plain version of the
matching kernel). Both must retrieve the same template and give the same
pose: translation within 1 mm, rotation within 0.5°, RANSAC score within
0.02 (the f32 features differ by the devices' sums; a bf16 store may round
one feature the other way). A gap above these separates a fault of the
card's chain from the training's sensitivity to rounding (ROADMAP §C).

Beside it, the recipe's first steps (grad clip 1.0, InfoNCE temperature
warm-up) on the card against the CPU from the same init and batches: every
metric of steps 1-3 within 1e-3 relative (the CPU against the JAX package
reads 3e-6 to 6e-5 there; chaos parts two runs by 1e-3 only from step 4,
tests/torch_selfcheck_divergence.py).

Marked `cuda`: each test skips where torch.cuda.is_available() is false (decided
in the test, never at import). Imports no jax.
"""

import copy

import numpy as np
import pytest
import torch

from gigapose_tpu_torch.pipeline.estimator import set_f32_matmul_precision
from gigapose_tpu_torch.scripts import selfcheck_e2e

pytestmark = pytest.mark.cuda

STEPS = 150


def _rot_gap_deg(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def test_selfcheck_e2e_chain_on_trained_weights_card_equals_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_f32_matmul_precision()
    root = str(tmp_path)
    state = selfcheck_e2e.train({"steps": str(STEPS)}, torch.device("cuda", 0), root)
    cpu_nets = [copy.deepcopy(n).to("cpu") for n in (state.ae_net, state.ist_net)]
    card = selfcheck_e2e.estimate(state.ae_net, state.ist_net, root, run_id="card")
    cpu = selfcheck_e2e.estimate(*cpu_nets, root, run_id="cpu")
    print({k: card[k] for k in ("view_id", "score")}, card["t"].ravel(),
          {k: cpu[k] for k in ("view_id", "score")}, cpu["t"].ravel())
    assert card["view_id"] == cpu["view_id"]
    assert np.linalg.norm(card["t"] - cpu["t"]) <= 1.0
    assert _rot_gap_deg(card["R"], cpu["R"]) <= 0.5
    assert abs(card["score"] - cpu["score"]) <= 0.02


def test_selfcheck_e2e_first_steps_card_match_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_f32_matmul_precision()
    metrics = {}
    for dev in ("cpu", "cuda"):
        got = metrics.setdefault(dev, {})
        selfcheck_e2e.train({"steps": "3"}, torch.device(dev), str(tmp_path / dev),
                            metrics_hook=lambda step, m, got=got: got.setdefault(step, m))
    assert sorted(metrics["cpu"]) == sorted(metrics["cuda"]) == [1, 2, 3]
    for step, want in metrics["cpu"].items():
        for k, v in want.items():
            np.testing.assert_allclose(metrics["cuda"][step][k], v, rtol=1e-3, atol=1e-6,
                                       err_msg=f"step {step} {k}")
