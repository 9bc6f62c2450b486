"""CPU tests of the benchmark harness at tiny sizes (benchmark/tests/tiny.py):
traffic, work arithmetic, the result line, the import check, the plan's
discovery of files by name, and the reference against the port.

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests -q
"""

import json
import os.path as osp
import shutil
import sys

import numpy as np
import pytest
import torch

from benchmark import run, work
from benchmark.plan import Plan, load_module, make_plan
from benchmark.tests import tiny
from benchmark.trace import Tracer

BENCH = tiny.BENCH
ROOT = osp.dirname(BENCH)
SEED = 2 ** 31 + 977  # past 32 signed bits, as the driver's seeds are


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def driver_module():
    return load_module(osp.join(BENCH, "drivers", "coarse_images.py"), "bench_driver_test")


def tiny_plan(config="gigapose-large", **changes) -> Plan:
    cfg = tiny.config(config)
    cfg["model"].update(changes)
    plan = make_plan(ROOT, "large.bop_lmo")
    return Plan(plan.workload, cfg, tiny.traffic(), driver_module(), plan.end_to_end, [], {})


def test_traffic_same_seed_same_inputs_and_counts_fixed():
    D = driver_module()
    t, cfg = tiny.traffic(), tiny.config()

    def inputs(seed):
        d = D.Driver(cfg, t, seed, "cpu", Tracer(False))
        d._inputs()
        return d

    a, b, c = inputs(SEED), inputs(SEED), inputs(SEED + 1)
    for x, y in zip(a.pool, b.pool):
        for f in ("rgb", "masks", "boxes", "labels", "obj_ids"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    for (r1, b1, p1), (r2, b2, p2) in zip(a.templates, b.templates):
        assert torch.equal(r1, r2) and torch.equal(b1, b2) and torch.equal(p1, p2)
    counts = list(t["detections_cycle"]) * t["pool_cycles"]
    for d in (a, c):
        assert [len(s.labels) for s in d.pool] == counts
    assert any(not np.array_equal(x.rgb, y.rgb) for x, y in zip(a.pool, c.pool))


def test_traffic_buckets_fixed_by_the_cycle():
    from gigapose_tpu_torch.pipeline.runner import pad_bucket

    with open(osp.join(BENCH, "traffic", "bop_lmo.json")) as f:
        t = json.load(f)
    assert [pad_bucket(n) for n in t["detections_cycle"]] == [16, 32, 64, 64, 64]
    useful = sum(t["detections_cycle"]) / sum(pad_bucket(n) for n in t["detections_cycle"])
    assert abs(useful - 200 / 240) < 1e-12


def test_vit_l_forward_ops_by_hand():
    with open(osp.join(BENCH, "configs", "gigapose-large.json")) as f:
        m = json.load(f)["model"]
    N, C = 257, 1024
    hand = 2 * 256 * 588 * C + 24 * (2 * N * C * (3 * C + C + 2 * 4096) + 4 * N * N * C)
    assert work.vit_forward_ops(m) == hand
    ops, nbytes = work.matching_work(m, 32, 8)
    assert ops == 2 * 32 * 162 * 256 * 256 * 1024
    assert nbytes == (8 * 162 * 256 * 1024 + 32 * 256 * 1024) * 2 \
        + (8 * 162 * 256 + 32 * 256 + 32) * 4 + (32 * 162 + 3 * 32 * 162 * 256) * 4


def test_work_matches_chip_smoke_hook_counts():
    """The shape arithmetic against chip_smoke.py's count by forward hooks
    on the port's own nets (tiny widths, 224 crops)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from gigapose_tpu_torch.models.ae_net import AENet
    from gigapose_tpu_torch.models.ist_net import ISTBackbone, ISTNet, Regressor

    m = tiny.config()["model"]
    ae = AENet(m["backbone"])
    ist = ISTNet(ISTBackbone(m["ist_initial_dim"], tuple(m["ist_block_dims"]),
                             m["ist_descriptor"], m["ist_input_size"]),
                 Regressor(2 * m["ist_descriptor"], hidden_dim=m["ist_descriptor"]))
    got = chip_smoke.train_step_work(ae, ist, 1, "cpu")["fwd_gflop_per_crop"]
    assert got["ae"] * 1e9 == pytest.approx(work.vit_forward_ops(m), rel=1e-12)
    assert got["ist"] * 1e9 == pytest.approx(work.ist_backbone_ops(m), rel=1e-12)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    for name in ("gigapose_tpu_torch_extra", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == []
    for name in ("gigapose_tpu.models", "jax", "jaxlib.xla", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == ["flax.linen", "gigapose_tpu.models", "jax", "jaxlib.xla"]


def test_result_line_schema_and_compared_last():
    out = run.measure(tiny_plan(), SEED, 1.0, False, "", torch.device("cpu"))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "compared"
    assert set(out["metrics"]) == {"dets_per_s", "image_ms_p95", "setup_s"}
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["compared"]) == set(tiny.config()["checks"]["coarse_images"]["limits"])
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_reference_agrees_with_the_port_in_f32():
    """The port's f32 path (no int8, f32 store) against the plain reference
    on the CPU: the same features and the same served answers."""
    out = run.measure(tiny_plan("gigapose-large-bf16", compute_dtype="f32", feature_dtype="f32"),
                      SEED, 1.0, False, "", torch.device("cpu"))
    c = {k: v["value"] for k, v in out["compared"].items()} | out["info"]
    assert c["ae_cos"] < 1e-9 and c["ist_err"] < 1e-5
    assert c["view_gap"] == 0.0 and c["score_excess"] == 0.0 and c["pose_gap"] < 1e-5
    assert out["correct"]


@pytest.mark.parametrize("config,control", [("gigapose-large", "int4_fp8"),
                                            ("gigapose-large-bf16", "int8_program")])
def test_control_fails_the_limits(config, control):
    """The configuration's lower-precision control in the program's place
    fails at least one limit (tiny sizes: the limits of tiny.py)."""
    out = run.measure(tiny_plan(config), SEED, 4.0, False, control, torch.device("cpu"))
    assert not out["correct"], out["compared"]


def _faulty(monkeypatch, fault: str):
    from gigapose_tpu_torch.pipeline import estimator as E

    if fault == "answer_altered":
        orig = E.recover_poses

        def recover(*a):
            poses = orig(*a).clone()
            poses[..., :3, 3] *= 1.05
            return poses

        monkeypatch.setattr(E, "recover_poses", recover)
    elif fault == "half_batch_left_out":
        orig = E.finish_coarse

        def finish(ist_net, tar_ist, match, src_ist, store, batch, cfg):
            pred = orig(ist_net, tar_ist, match, src_ist, store, batch, cfg)
            n = int(batch.valid.sum())
            h = n // 2
            for f in ("poses", "scores", "view_ids"):
                t = getattr(pred, f)
                t[h:n] = t[:n - h].clone()
            return pred

        monkeypatch.setattr(E, "finish_coarse", finish)
    elif fault == "last_third_altered":  # the high slots of each forward alone
        orig = E.finish_coarse

        def finish(ist_net, tar_ist, match, src_ist, store, batch, cfg):
            pred = orig(ist_net, tar_ist, match, src_ist, store, batch, cfg)
            n = int(batch.valid.sum())
            pred.poses[n - n // 3:n, ..., :3, 3] *= 1.05
            pred.scores[n - n // 3:n] *= 0.9
            return pred

        monkeypatch.setattr(E, "finish_coarse", finish)
    elif fault == "views_ranked_backwards":  # the k worst views retrieved
        from gigapose_tpu_torch.ops import matching

        def bottom_k(x, k):
            vals, ids = torch.sort(x, dim=-1, descending=False, stable=True)
            return vals[..., :k], ids[..., :k]

        monkeypatch.setattr(matching, "top_k_stable", bottom_k)
    elif fault == "hypotheses_ranked_backwards":  # the worst view's pose served on top
        orig = E.finish_coarse

        def finish(ist_net, tar_ist, match, src_ist, store, batch, cfg):
            pred = orig(ist_net, tar_ist, match, src_ist, store, batch, cfg)
            for f in ("poses", "scores", "view_ids"):
                getattr(pred, f).copy_(getattr(pred, f).flip(1))
            return pred

        monkeypatch.setattr(E, "finish_coarse", finish)
    elif fault == "state_unchanged":
        from gigapose_tpu_torch.models import vit_int8

        orig = vit_int8.AENetInt8.forward
        last = {}

        def stale(self, images):  # each call returns the first call's features
            out = orig(self, images)
            first = last.setdefault("out", out)
            n = min(len(first), len(out))
            out = out.clone()
            out[:n] = first[:n]
            return out

        monkeypatch.setattr(vit_int8.AENetInt8, "forward", stale)


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out", "state_unchanged",
                                   "last_third_altered", "views_ranked_backwards",
                                   "hypotheses_ranked_backwards"])
def test_faults_make_correct_false(monkeypatch, fault):
    _faulty(monkeypatch, fault)
    out = run.measure(tiny_plan(), SEED, 1.0, False, "", torch.device("cpu"))
    assert not out["correct"], out["compared"]


def test_plan_finds_new_files_by_name(tmp_path):
    """A dummy mix and a dummy metric added as files and entries, in a copy:
    the plan finds them by name and no existing file is edited."""
    root = tmp_path / "copy"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(osp.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: open(p, "rb").read() for p in map(str, (root / "benchmark").rglob("*.*"))}
    with open(root / "benchmark" / "traffic" / "bop_lmo.json") as f:
        mix = json.load(f)
    mix["detections_cycle"] = [8, 8]
    with open(root / "benchmark" / "traffic" / "dummy_mix.json", "w") as f:
        json.dump(mix, f)
    with open(root / "benchmark" / "metrics" / "dummy.metric.py", "w") as f:
        f.write("def read(tr, driver):\n    return 42.0\n")
    with open(root / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "large.dummy_mix", "config": "gigapose-large",
                              "traffic": "dummy_mix", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "dummy.metric", "unit": "%", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "dets_per_s", "workloads": ["large.dummy_mix"]})
    for m in spec["end_to_end"]:
        if "large.bop_lmo" in m.get("workloads", ()):
            m["workloads"].append("large.dummy_mix")
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)
    plan = make_plan(str(root), "large.dummy_mix")
    assert plan.traffic["detections_cycle"] == [8, 8]
    assert [m["name"] for m in plan.per_layer] == ["dummy.metric"]
    assert plan.metric_modules["dummy.metric"].read(None, None) == 42.0
    assert {m["name"] for m in plan.end_to_end} == {"dets_per_s", "image_ms_p95", "setup_s"}
    assert plan.driver.__file__.startswith(str(root))
    for p, data in before.items():
        assert open(p, "rb").read() == data


def test_benchmark_json_contract():
    with open(osp.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for c in spec["configs"]:
        assert osp.isfile(osp.join(ROOT, c["file"])) and c["file"].startswith("benchmark/")
    for w in spec["workloads"]:
        assert osp.isfile(osp.join(BENCH, "traffic", w["traffic"] + ".json"))
    for m in spec["per_layer"]:
        assert osp.isfile(osp.join(BENCH, "metrics", m["name"] + ".py"))
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert all(m["moves"] in e2e for m in spec["per_layer"])
    kinds = {}
    for w in spec["workloads"]:
        with open(osp.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            kinds.setdefault(w["config"], set()).add(json.load(f)["kind"])
    for c in spec["configs"]:
        with open(osp.join(ROOT, c["file"])) as f:
            checks = json.load(f)["checks"]
        for kind in kinds[c["name"]]:
            limits = checks[kind]["limits"]
            assert limits and all(v is not None and v > 0 for v in limits.values()), c["name"]


# -- the training cell ---------------------------------------------------------


def tiny_train_plan() -> Plan:
    plan = make_plan(ROOT, "large.train")
    return Plan(plan.workload, tiny.config(), tiny.train_traffic(), plan.driver,
                plan.end_to_end, [], {})


def test_train_traffic_same_seed_same_records():
    plan = tiny_train_plan()

    def pool(seed):
        d = plan.driver.Driver(plan.config, plan.traffic, seed, "cpu", Tracer(False))
        d._inputs()
        return d.pool

    a, b, c = pool(SEED), pool(SEED), pool(SEED + 1)
    for x, y, z in zip(a, b, c):
        for f in vars(x):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
            assert getattr(x, f).shape == getattr(z, f).shape
    assert any(not np.array_equal(x.q_rgb, z.q_rgb) for x, z in zip(a, c))


def test_train_reference_agrees_with_the_port():
    """The port's f32 training step against the plain reference on the CPU,
    held to the configuration's limits; every pair has correspondences."""
    out = run.measure(tiny_train_plan(), SEED, 1.0, False, "", torch.device("cpu"))
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert out["info"]["leaves_compared"] > 0.9 * out["info"]["leaves"]


@pytest.mark.parametrize("control", ["half_batch", "loss_altered"])
def test_train_controls_fail_the_limits(control):
    out = run.measure(tiny_train_plan(), SEED, 1.0, False, control, torch.device("cpu"))
    assert not out["correct"], out["compared"]


def _faulty_train(monkeypatch, fault: str):
    from gigapose_tpu_torch.dataloader import train_set
    from gigapose_tpu_torch.training import state as S

    if fault == "state_unchanged":
        def step(state, batch, timing=None):  # the losses, and no update
            for net in state.nets.values():
                net.train()
            return {k: v.detach() for k, v in S.compute_losses(
                state.ae_net, state.ist_net, batch, state.step, state.cfg)[1].items()}

        monkeypatch.setattr(S, "train_step", step)
    elif fault == "half_batch_left_out":
        orig = train_set.prepare_train_batch

        def prepare(rec, device, *a, **kw):
            b = orig(rec, device, *a, **kw)
            h = b.src_img.shape[0] // 2
            return S.TrainBatch(**{k: (v[:h] if v is not None else None)
                                   for k, v in vars(b).items()})

        monkeypatch.setattr(train_set, "prepare_train_batch", prepare)
    elif fault == "loss_altered":
        orig = S.compute_losses

        def losses(*a, **kw):
            total, metrics = orig(*a, **kw)
            return total * 1.01, dict(metrics, total=metrics["total"] * 1.01)

        monkeypatch.setattr(S, "compute_losses", losses)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_left_out", "loss_altered"])
def test_train_faults_make_correct_false(monkeypatch, fault):
    _faulty_train(monkeypatch, fault)
    out = run.measure(tiny_train_plan(), SEED, 1.0, False, "", torch.device("cpu"))
    assert not out["correct"], out["compared"]


@pytest.mark.cuda
def test_train_tf32_control_fails_on_the_card():
    """TF32 in the reference's place fails the limits (the card alone has
    TF32): the ViT-L and the IST at their published widths, 4 pairs."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    plan = make_plan(ROOT, "large.train")
    t = dict(plan.traffic, batch_size=4, pool_batches=3)
    plan = Plan(plan.workload, plan.config, t, plan.driver, plan.end_to_end, [], {})
    dev = torch.device("cuda", 0)
    assert run.measure(plan, SEED, 1.0, False, "", dev)["correct"]
    assert not run.measure(plan, SEED, 1.0, False, "tf32", dev)["correct"]
