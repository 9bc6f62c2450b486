"""The port's acceptance chain on the CPU, at tiny budgets:

- scripts/synthetic_bop.py against tests/synthetic_bop.py at the same seed:
  the same file tree, every JSON and npy file byte-equal, every PNG equal
  once decoded (the JAX fixture's with PIL, the port's with
  dataloader/png.py), pixel for pixel, and the same test pose;
- selfcheck_e2e and selfcheck_full with device=cpu at a few steps: every key
  of the JAX scripts' JSON line (read from their sources), all numbers
  finite, and the int8 A/B's retrieval agreement at least 0.99 (the gate of
  tests/test_selfcheck_e2e.py) on the plain versions of the int8 kernels;
- selfcheck_e2e's InfoNCE temperature warm-up (tau 0.5 -> 0.1 over 50
  steps, with its gradient clip) in compute_losses against the JAX
  package's at steps 20 (tau 0.34) and 80, rtol 1e-4 (the f32 losses of
  tests/test_torch_train_losses.py);
- parity mode=dryrun: the steps and files that tests/test_parity_runbook.py
  asserts of the JAX runbook, and every top-1 csv scored; mode=real on an
  empty root raises one error that names every missing file.
The budgets are far below the JAX gates' (600 / 900 + 400 steps); the
accuracy gates are held on the card (PERF.md, the acceptance runs).
"""

import ast
import filecmp
import math
import os
import os.path as osp
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from gigapose_tpu.training import state as JS
from gigapose_tpu_torch.dataloader.png import decode_png
from gigapose_tpu_torch.scripts import parity, selfcheck_e2e, selfcheck_full
from gigapose_tpu_torch.scripts import synthetic_bop as port_fixture
from tests import synthetic_bop as jax_fixture
from gigapose_tpu_torch.training import state as TS
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (a fixture)
from tests.torch_train_fixtures import (
    jax_batch, jax_nets, jax_train_state, port_batch, port_train_state, random_batch,
)

REPO = Path(__file__).resolve().parents[1]


def _files(root):
    return sorted(osp.relpath(osp.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _assert_same_tree(a, b):
    names = _files(a)
    assert names == _files(b)
    for name in names:
        pa, pb = osp.join(a, name), osp.join(b, name)
        if name.endswith(".png"):
            want = np.asarray(Image.open(pa))
            with open(pb, "rb") as f:
                got = decode_png(f.read())
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert np.array_equal(got, want), name
        else:
            assert filecmp.cmp(pa, pb, shallow=False), name
    return names


def test_build_matches_jax_fixture(tmp_path):
    a = jax_fixture.build(str(tmp_path / "jax"), n_test_images=2, insts_per_image=3)
    b = port_fixture.build(str(tmp_path / "port"), n_test_images=2, insts_per_image=3)
    names = _assert_same_tree(a, b)
    assert "datasets/tudl/models/obj_000002.ply" in names


@pytest.mark.parametrize("seed", [0, 1])
def test_build_rendered_matches_jax_fixture(tmp_path, seed):
    _, want = jax_fixture.build_rendered(str(tmp_path / "jax"), n_train=3, level=0, seed=seed)
    _, got = port_fixture.build_rendered(str(tmp_path / "port"), n_train=3, level=0, seed=seed)
    assert np.array_equal(got, want)
    names = _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert sum(n.startswith("datasets/templates/tudl/000001/") for n in names) == 2 * 42


def _result_keys(path, names):
    """The string keys of the dict literals assigned to `names` in a JAX
    script (its JSON line)."""
    keys = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id in names for t in node.targets):
            keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
    return keys


def _finite(value):
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, list):
        return all(_finite(v) for v in value)
    return not isinstance(value, float) or math.isfinite(value)


def test_selfcheck_e2e_cpu(tmp_path):
    out = selfcheck_e2e.main([f"root={tmp_path}", "steps=3", "device=cpu"])
    want = _result_keys(REPO / "gigapose_tpu/scripts/selfcheck_e2e.py", {"result"})
    assert want == {"steps", "t_err_mm", "rot_err_deg", "score", "gt_t", "pred_t"}
    assert want <= set(out) and out["device"] == "cpu" and out["steps"] == 3
    assert _finite(out) and out["seconds"]["train"] > 0
    with pytest.raises(ValueError, match="stepz"):
        selfcheck_e2e.main([f"root={tmp_path}", "stepz=3", "device=cpu"])


def test_selfcheck_full_cpu(tmp_path):
    out = selfcheck_full.main([f"root={tmp_path}", "steps=3", "refiner_steps=2", "n_train=4",
                               "device=cpu"])
    want = _result_keys(REPO / "gigapose_tpu/scripts/selfcheck_full.py",
                        {"result", "int8_metrics"})
    assert "int8_retrieval_agreement" in want and "refined_ar" in want and len(want) == 20
    assert want <= set(out) and out["device"] == "cpu" and out["ae_model"] == "vit_tiny_test"
    assert _finite(out)
    assert out["int8_retrieval_agreement"] >= 0.99, out
    assert 0 <= out["coarse_ar"] <= 1 and 0 <= out["refined_ar"] <= 1
    # the per-block profile: every module of both blocks, hooked
    blocks = out["act_absmax_blocks"]
    assert {"vit.blocks.0.attn.qkv", "vit.blocks.1.mlp.fc2"} <= set(blocks)
    assert out["act_absmax_global"] >= max(blocks.values()) > 0
    assert set(out["seconds"]) == {"fixture", "coarse_train", "coarse", "int8",
                                   "refiner_train", "refine", "total"}


@pytest.mark.parametrize("step", [20, 80])
def test_selfcheck_tau_warmup_matches_jax(step):
    kw = dict(warm_up_steps=10, grad_clip=1.0, tau_start=0.5, tau_warmup_steps=50)
    cfg_j = JS.OptimConfig(**kw)
    jstate, _ = jax_train_state(cfg_j, seed=4)
    jae, jist = jax_nets()
    b = random_batch(4)
    params = {"ae": jstate.ae_params, "ist": jstate.ist_params}
    _, (want, _) = JS.compute_losses(jae, jist, params, jstate.ist_batch_stats, jax_batch(b),
                                     np.int32(step), cfg_j)
    state = port_train_state(jstate, TS.OptimConfig(**kw))
    for net in state.nets.values():
        net.train()
    _, got = TS.compute_losses(state.ae_net, state.ist_net, port_batch(b), step, state.cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, err_msg=k)
    if step == 20:  # the warm-up moves InfoNCE: tau 0.34 here, not the final 0.1
        _, final = TS.compute_losses(state.ae_net, state.ist_net, port_batch(b), 80, state.cfg)
        assert float(got["infoNCE"]) != pytest.approx(float(final["infoNCE"]), rel=1e-3)


def test_parity_dryrun_cpu(tmp_path):
    out = parity.main([f"root_dir={tmp_path}", "mode=dryrun", "run_id=ci", "device=cpu"])
    assert out["mode"] == "dryrun"
    assert out["steps"] == ["test", "test:serving_quant=off", "refine:top1", "refine:top5",
                            "score"]
    names = " ".join(out["csvs"])
    assert "predictions/" in names and "predictions_refined/" in names
    for rel in out["csvs"]:
        assert os.path.getsize(os.path.join(out["root"], "results", "large_ci", rel)) > 0
    assert sorted(out["scores"]) == [
        "large_ci/predictions/large-pbrreal-rgb-mmodel_tudl-test_ci.csv",
        "large_ci/predictions_refined/large-pbrreal-rgb-mmodel_tudl-test_ci.csv",
        "large_ci_fp/predictions/large-pbrreal-rgb-mmodel_tudl-test_ci_fp.csv"]
    for score in out["scores"].values():
        assert score["n_targets"] == 2 and 0 <= score["bop19_average_recall"] <= 1


def test_parity_real_names_every_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError) as e:
        parity.main([f"root_dir={tmp_path}", "mode=real", "dataset=lmo", "device=cpu"])
    for path in parity.required_files(str(tmp_path), "lmo"):
        assert path in str(e.value)
    assert not os.listdir(tmp_path)  # nothing downloaded, nothing written
