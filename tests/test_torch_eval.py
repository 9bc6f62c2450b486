"""The port's evaluation (gigapose_tpu_torch/eval/, scripts/eval_bop.py)
against the JAX package's (gigapose_tpu/eval/, scripts/eval_bop.py), CPU.

- MSSD, MSPD, ADD and ADD-S (f32 torch on the CPU) against JAX's jitted
  f32 functions on seeded pose pairs, with no symmetry, a discrete one and
  a continuous one (314 discretized rotations): rtol 1e-5 (each side sums
  its f32 products in its own order; the errors are 1-300 mm or px).
- symmetry_set, depth_im_to_dist_im, vsd_error, _greedy_recall and
  auc_posecnn (numpy on both sides): equal.
- score_bop on tests/test_eval.py's one-cube dataset, with the gt, a
  symmetry-equivalent and a far-off csv, with and without VSD: every AR
  within 1e-9 of JAX's.
- eval_bop.main against the JAX eval_bop on tests/synthetic_bop.py (tiny nets
  with the JAX init, an f32 store, 8 templates, refine=false): the same
  csv rows, to test_torch_cli.py's f32 tolerances, and the same scores.
"""

import json
import os
import os.path as osp

import numpy as np
import pytest

from gigapose_tpu.eval import errors as JE
from gigapose_tpu.eval import scorer as JS
from gigapose_tpu_torch.eval import errors as PE
from gigapose_tpu_torch.eval import scorer as PS
from test_eval import K, _build_bop_dataset, _rot, _write_csv
from tests import synthetic_bop
from tests.test_torch_cli import _compare, _csv, jax_weights  # noqa: F401 (a fixture)

CONT = {"diameter": 90.0, "symmetries_continuous": [{"axis": [0, 0.3, 1], "offset": [1, -2, 3]}]}
DISC = {"diameter": 90.0, "symmetries_discrete": [
    np.concatenate([np.concatenate([_rot([0, 0, 1], 180.0), [[4.0], [0.0], [-2.0]]], 1),
                    [[0, 0, 0, 1]]]).flatten().tolist()]}


def _pairs(seed, n=4):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        R_g = _rot(rng.normal(size=3), rng.uniform(0, 180))
        t_g = np.array([rng.uniform(-50, 50), rng.uniform(-50, 50), rng.uniform(300, 700)])
        R_e = _rot(rng.normal(size=3), rng.uniform(1, 40)) @ R_g
        yield R_e, t_g + rng.normal(0, 15, 3), R_g, t_g


@pytest.mark.parametrize("info", [None, DISC, CONT], ids=["none", "discrete", "continuous"])
def test_pose_errors_match_jax(info):
    pts = (np.random.default_rng(3).normal(size=(300, 3)) * 30.0).astype(np.float32)
    syms = () if info is None else JS.symmetry_set(info)
    if info is not None:
        np.testing.assert_array_equal(PS.symmetry_set(info)[0], syms[0])
    for R_e, t_e, R_g, t_g in _pairs(11):
        for name, args in (("mssd_error", (pts, *syms)), ("mspd_error", (pts, K, *syms)),
                           ("add_error", (pts,)), ("adds_error", (pts,))):
            want = getattr(JE, name)(R_e, t_e, R_g, t_g, *args)
            got = getattr(PE, name)(R_e, t_e, R_g, t_g, *args, device="cpu")
            assert want > 0.5
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        assert PE.angular_error_deg(R_e, R_g) == JE.angular_error_deg(R_e, R_g)


def test_host_errors_and_matching_equal_jax():
    rng = np.random.default_rng(5)
    for info in (CONT, DISC, {"diameter": 1.0},
                 {"diameter": 1.0, "symmetries_continuous": [{"axis": [1, 0, 0]}],
                  "symmetries_discrete": DISC["symmetries_discrete"]}):
        for a, b in zip(PS.symmetry_set(info), JS.symmetry_set(info)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    depth = rng.uniform(300, 500, (24, 32)) * (rng.uniform(size=(24, 32)) > 0.3)
    Kc = np.array([[40.0, 0, 15.5], [0, 41.0, 11.5], [0, 0, 1]])
    np.testing.assert_array_equal(PE.depth_im_to_dist_im(depth, Kc),
                                  JE.depth_im_to_dist_im(depth, Kc))
    d_gt = depth * (rng.uniform(size=depth.shape) > 0.2)
    d_est = np.where(d_gt > 0, d_gt + rng.normal(0, 20, depth.shape), 0)
    for Kv in (None, Kc):
        np.testing.assert_array_equal(
            PE.vsd_error(d_est, d_gt, depth, 15.0, (10.0, 20.0, 50.0), Kv),
            JE.vsd_error(d_est, d_gt, depth, 15.0, (10.0, 20.0, 50.0), Kv))
    np.testing.assert_array_equal(PE.vsd_error(d_est * 0, d_gt * 0, depth),
                                  JE.vsd_error(d_est * 0, d_gt * 0, depth))
    mats = [rng.uniform(0, 0.3, (3, 2)), rng.uniform(0, 0.3, (1, 3)), np.zeros((0, 2))]
    scores = [rng.uniform(size=3), rng.uniform(size=1), np.zeros(0)]
    for th in (0.02, 0.1, 0.25):
        assert PS._greedy_recall(mats, scores, 7, th) == JS._greedy_recall(mats, scores, 7, th)
    for errs in (rng.uniform(0, 0.2, 20), rng.uniform(0, 0.05, 7), np.array([0.1]),
                 rng.uniform(0.11, 1.0, 5), np.zeros(0)):
        got, want = PE.auc_posecnn(errs), JE.auc_posecnn(errs)
        assert got == want or (np.isnan(got) and np.isnan(want))


def test_score_bop_equals_jax(tmp_path):
    root = str(tmp_path)
    R_g, t_g = _rot([1, 0.2, 0], 30.0), [5.0, -10.0, 400.0]
    _build_bop_dataset(root, R_g, t_g)
    csvs = {"gt": (R_g, t_g), "sym": (R_g @ _rot([0, 0, 1], 180.0), t_g),
            "near": (_rot([0, 1, 0], 4.0) @ R_g, [9.0, -10.0, 410.0]),
            "bad": (_rot([0, 1, 0], 90.0) @ R_g, [150.0, 80.0, 700.0])}
    for name, (R, t) in csvs.items():
        csv = osp.join(root, f"{name}.csv")
        _write_csv(csv, R, t)
        for errors in (("vsd", "mssd", "mspd"), ("mssd", "mspd")):
            want = JS.score_bop(csv, root, "tudl", error_types=errors)
            timing = {}
            got = PS.score_bop(csv, root, "tudl", error_types=errors, device="cpu", timing=timing)
            assert sorted(got) == sorted(want) and timing["images"] == 1, name
            for k, v in want.items():
                if isinstance(v, float):
                    assert abs(got[k] - v) <= 1e-9, (name, errors, k, got[k], v)
                else:
                    assert got[k] == v
            if name in ("gt", "sym"):
                assert got["bop19_average_recall"] == 1.0
            if name == "bad":
                assert got["bop19_average_recall"] < 0.25
    assert PS.main([f"csv={osp.join(root, 'gt.csv')}", f"root={root}", "dataset=tudl",
                    "errors=mssd", "device=cpu"])["bop19_average_recall"] == 1.0


def test_modelnet_meter_and_coco_boxes_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(30, 3)).astype(np.float32) * 40.0
    port, ref = PS.ModelNetMeter(pts, device="cpu"), JS.ModelNetMeter(pts)
    for R_e, t_e, R_g, t_g in _pairs(4, n=5):
        T_e, T_g = np.eye(4), np.eye(4)
        T_e[:3, :3], T_e[:3, 3], T_g[:3, :3], T_g[:3, 3] = R_e, t_e / 20, R_g, t_g
        port.add(T_e, T_g, K)
        ref.add(T_e, T_g, K)
    got, want = port.summary(), ref.summary()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    root = str(tmp_path)
    _build_bop_dataset(root, _rot([1, 0.2, 0], 30.0), [5.0, -10.0, 400.0])
    csv = osp.join(root, "est.csv")
    _write_csv(csv, _rot([0, 1, 0], 20.0), [0.0, 10.0, 420.0], score=0.7)
    assert PS.convert_results_to_coco(csv, osp.join(root, "p.json"), root, "tudl") == \
        JS.convert_results_to_coco(csv, osp.join(root, "j.json"), root, "tudl") == 1
    assert json.load(open(osp.join(root, "p.json"))) == json.load(open(osp.join(root, "j.json")))
    assert PS.load_models_info(osp.join(root, "datasets", "tudl", "models")) == \
        JS.load_models_info(osp.join(root, "datasets", "tudl", "models"))


def _add_test_gt(root):
    """A scene_gt for the fixture's test image (it ships none), so that both
    eval_bop scripts score their csvs."""
    sdir = osp.join(root, "datasets", "tudl", "test", "000001")
    gt = [{"obj_id": o, "cam_R_m2c": np.eye(3).reshape(-1).tolist(),
           "cam_t_m2c": [0.0, 0.0, 400.0]} for o in (1, 2)]
    with open(osp.join(sdir, "scene_gt.json"), "w") as f:
        json.dump({"0": gt}, f)


def test_eval_bop_equals_jax(tmp_path, jax_weights):
    from gigapose_tpu.scripts.eval_bop import main as jax_main
    from gigapose_tpu_torch.scripts.eval_bop import main as port_main

    root = synthetic_bop.build(str(tmp_path))
    _add_test_gt(root)
    common = [f"machine.root_dir={root}", "datasets=tudl", "refine=false",
              "data.template.num_templates=8", "model.feature_dtype=f32"]
    jax_main(common + ["run_id=jax"])
    got = port_main(common + ["run_id=port", "device=cpu"])
    for multi in (False, True):
        assert _compare(_csv(root, "port", multi), _csv(root, "jax", multi), (1e-4, 1e-4)) == set()
    score = got["tudl"]["score_predictions"]
    assert got["tudl"]["status"] == "csv_written" and score["scorer"] == "native"
    pred = osp.join(root, "results", "large_jax", "predictions")
    top1 = [f for f in os.listdir(pred) if f.endswith(".csv") and "Multi" not in f][0]
    ref = JS.score_bop(osp.join(pred, top1), root, "tudl")
    assert sorted(score) == sorted(ref)
    for k, v in ref.items():
        assert score[k] == pytest.approx(v, abs=1e-9) if isinstance(v, float) else score[k] == v
    assert score["n_targets"] == 2


def test_score_csv_raises_where_jax_swallows(tmp_path):
    """Deliberate divergence: the port's score_csv lets a scorer failure
    raise (on the card a swallowed error could be a CUDA fault); the JAX
    script returns it as native_scorer_error. Here the fixture's test
    split has no scene_gt.json."""
    from gigapose_tpu.scripts.eval_bop import score_csv as jax_score_csv
    from gigapose_tpu_torch.scripts.eval_bop import score_csv

    root = synthetic_bop.build(str(tmp_path))
    csv = osp.join(root, "est.csv")
    _write_csv(csv, np.eye(3), [0.0, 0.0, 400.0])
    assert "FileNotFoundError" in jax_score_csv(csv, root, "tudl")["native_scorer_error"]
    with pytest.raises(FileNotFoundError, match="scene_gt.json"):
        score_csv(csv, root, "tudl", device="cpu")
