"""The port's CLI (gigapose_tpu_torch.cli) == the JAX test.py on the synthetic
BOP fixture (tests/synthetic_bop.py), CPU, with GIGAPOSE_TINY nets: the JAX
tiny estimator's random init enters the port through the weight bridge.

Both CLIs read the same files (templates, CNOS detections, targets), onboard,
run and merge; their top-1 and MultiHypothesis csvs must hold the same rows
in the same order with scene_id, im_id and obj_id exact, scores within 1e-4,
R within 1e-4 and t within rtol 1e-4 / atol 1e-3 mm (the time column is each
run's own clock).

With a bf16 template store (model.feature_dtype=bf16, the configs' default)
R and t agree within 1e-3 and rtol 2e-3. The two packages' f32 store
features differ only by the order of their sums: the AE's by at most 2e-6
of their largest magnitude, the IST's (ten convolutions) by at most 2e-5
(measured 8.9e-7 and 1.5e-5). Rounded to bf16, such a difference now and
then lands on the other side of a rounding boundary, so the bf16 stores
are one rounding step (2^-7 relative) apart at a few hundred values. On
this fixture that moves one detection, image 0's object 2, whose regressed
in-plane rotation changes R by 5.2e-4 and t by 0.57 mm in all five of its
hypotheses; every other row, the retrieval and the scores hold the 1e-4
tolerances, and the f32 store holds them everywhere. The test checks each
of these statements.
"""

import os
import os.path as osp
import shutil

import jax
import numpy as np
import pytest
import torch

import test as jax_cli
from gigapose_tpu.utils.config import load_config as jax_load_config
from gigapose_tpu_torch import cli
from gigapose_tpu_torch.dataloader import bop_io
from gigapose_tpu_torch.models import convert
from gigapose_tpu_torch.pipeline.estimator import GigaPoseEstimator
from gigapose_tpu_torch.utils.config import load_config
from tests import synthetic_bop
from tests.torch_image_formats import reencode_rgb

NAME = "large-pbrreal-rgb-mmodel_tudl-test_{}{}.csv"


def _csv(root, run_id, multi):
    path = osp.join(root, "results", f"large_{run_id}", "predictions",
                    NAME.format(run_id, "MultiHypothesis" if multi else ""))
    return bop_io.load_bop_csv(path, extra_column="instance_id" if multi else None)


def _jax_tiny_state_dicts():
    est = jax_cli.build_estimator(jax_load_config("test"), tiny=True)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return convert.ae_flax_to_torch(tree(est.ae_params)), convert.ist_flax_to_torch(tree(est.ist_vars))


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's build_estimator, with the JAX tiny init loaded into its nets."""
    build = cli.build_estimator
    ae_sd, ist_sd = _jax_tiny_state_dicts()

    def build_with_jax_weights(cfg, tiny=False):
        assert tiny
        est = build(cfg, tiny=True)
        est.ae_net.load_state_dict(ae_sd, strict=True)
        est.ist_net.load_state_dict(ist_sd, strict=True)
        return est

    monkeypatch.setattr(cli, "build_estimator", build_with_jax_weights)
    monkeypatch.setenv("GIGAPOSE_TINY", "1")


def _compare(got, want, loose):
    """Rows equal in their ids and scores, poses within `loose` (R atol, t
    rtol) -> the (im_id, obj_id) of the rows outside the 1e-4 tolerances."""
    assert len(got) == len(want) > 0
    r_atol, t_rtol = loose
    outside = set()
    for g, w in zip(got, want):
        for key in ("scene_id", "im_id", "obj_id", "instance_id"):
            assert g.get(key) == w.get(key), key
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-4)
        np.testing.assert_allclose(g["R"], w["R"], atol=r_atol, rtol=0)
        np.testing.assert_allclose(g["t"], w["t"], rtol=t_rtol, atol=1e-3)
        if not (np.allclose(g["R"], w["R"], atol=1e-4, rtol=0)
                and np.allclose(g["t"], w["t"], rtol=1e-4, atol=1e-3)):
            outside.add((g["im_id"], g["obj_id"]))
    return outside


def _check_stores(root, bf16):
    """The two CLIs' onboarded stores (their npz caches, features as f32):
    apart by the sums' order, and on a bf16 store by one rounding step."""
    tdir = osp.join(root, "datasets", "templates", "tudl")
    port, ref = (np.load(osp.join(tdir, f"onboarded_{tag}.npz")) for tag in ("port", "jax"))
    step = 2.0 ** -7 if bf16 else 0.0
    for f, limit in (("ae_features", 2e-6), ("ist_features", 2e-5)):
        diff, want = np.abs(port[f] - ref[f]), np.abs(ref[f])
        assert (diff <= step * want + limit * want.max()).all(), f
        assert bf16 or diff.max() > 0, f  # two programs, not one
        if bf16:
            assert 0 < (diff > 0).sum() < 1e-2 * diff.size, f


@pytest.mark.parametrize("setting,store,rgb", [
    pytest.param("localization", "bf16", "png", id="localization-bf16"),
    pytest.param("detection", "bf16", "png", id="detection-bf16"),
    pytest.param("localization", "f32", "png", id="localization-f32"),
    pytest.param("localization", "f32", "jpg", id="localization-f32-jpg")])
def test_cli_writes_the_jax_csvs(tmp_path, jax_weights, setting, store, rgb):
    """The last case re-encodes the test image as a JPEG (PIL, quality 95):
    both CLIs decode it, each with its own decoder."""
    root = synthetic_bop.build(str(tmp_path))
    if rgb != "png":
        assert reencode_rgb(osp.join(root, "datasets", "tudl", "test"), rgb) == 1
    common = [f"machine.root_dir={root}", "test_dataset_name=tudl",
              "data.template.num_templates=8", f"test_setting={setting}",
              f"model.feature_dtype={store}"]
    jax_cli.main(common + ["run_id=jax", "onboarding_cache=jax"])
    runner = cli.main(common + ["run_id=port", "device=cpu", "onboarding_cache=port"])
    assert runner.timing["images"] == 1 and runner.timing["forwards"] == 1
    assert runner.store.ae_features.dtype == (torch.bfloat16 if store == "bf16" else torch.float32)
    _check_stores(root, store == "bf16")
    loose = (1e-4, 1e-4) if store == "f32" else (1e-3, 2e-3)
    moved = {(0, 2)} if store == "bf16" else set()
    for multi in (False, True):
        assert _compare(_csv(root, "port", multi), _csv(root, "jax", multi), loose) == moved
    assert len(_csv(root, "port", True)) == 5 * len(_csv(root, "port", False)) == 10


def test_onboarding_cache_second_run(tmp_path, jax_weights):
    """A second run with the same onboarding_cache tag loads the store from
    <template_dir>/onboarded_<tag>.npz and writes the same csvs."""
    root = synthetic_bop.build(str(tmp_path))
    args = [f"machine.root_dir={root}", "test_dataset_name=tudl", "device=cpu",
            "data.template.num_templates=8", "onboarding_cache=fixture"]
    first = cli.main(args + ["run_id=a"])
    second = cli.main(args + ["run_id=b"])
    cache = osp.join(root, "datasets", "templates", "tudl", "onboarded_fixture.npz")
    assert osp.exists(cache) and not first.timing["onboard_cached"]
    assert second.timing["onboard_cached"]
    for f in ("ae_features", "ist_features", "masks", "Ms", "poses", "K"):
        assert torch.equal(getattr(first.store, f), getattr(second.store, f)), f
    assert first.store.ae_features.dtype == torch.bfloat16
    drop_time = lambda path: [line.split(",")[:6] + line.split(",")[7:]
                              for line in open(path).read().splitlines()]
    pred = lambda rid: osp.join(root, "results", f"large_{rid}", "predictions")
    for multi in ("", "MultiHypothesis"):
        assert drop_time(osp.join(pred("a"), NAME.format("a", multi))) == \
            drop_time(osp.join(pred("b"), NAME.format("b", multi)))
    assert not [f for f in os.listdir(osp.dirname(cache)) if ".tmp" in f]


def test_tiny_build_has_the_jax_tiny_shapes(monkeypatch):
    """GIGAPOSE_TINY builds test.py's tiny nets (vit_tiny_test AE; IST with
    initial_dim 16, block_dims 16/16/24/32, descriptor 32, input 256,
    regressor hidden 32), seeded, on the requested device, with the
    CPU's choices: match_templates and no int8."""
    cfg = load_config("test", ["device=cpu"])
    est = cli.build_estimator(cfg, tiny=True)
    ae_sd, ist_sd = _jax_tiny_state_dicts()
    for net, want in ((est.ae_net, ae_sd), (est.ist_net, ist_sd)):
        got = net.state_dict()
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
    assert est.device == torch.device("cpu")
    assert not est.config.use_pallas_matching
    assert type(est.ae_net).__name__ == "AENet"
    again = cli.build_estimator(cfg, tiny=True)
    w = "vit.blocks.0.attn.qkv.weight"
    assert torch.equal(est.ae_net.state_dict()[w], again.ae_net.state_dict()[w])


def test_cli_refuses_what_it_does_not_serve(tmp_path, monkeypatch):
    """No card and no device= raises; so do the options that are not ported,
    the overrides of keys the CLI does not read and an unknown
    model.serving_quant_ist (test.py serves it as off). int8 serving with
    the int8 IST runs. store_shards=2 serves a view-sharded store with the
    csvs of the whole store (time column aside), and a launch environment
    with GIGAPOSE_COORDINATOR alone raises, naming what it lacks (two
    processes: tests/test_torch_parallel.py)."""
    root = synthetic_bop.build(str(tmp_path))
    base = [f"machine.root_dir={root}", "test_dataset_name=tudl"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=cpu"):
            cli.main(base)
    with pytest.raises(NotImplementedError, match="vis_every"):
        cli.main(base + ["device=cpu", "vis_every=5"])
    for unread in ("model.ist_net.num_attn_heads=4", "model.optim.ae_lr=1.0e-4",
                   "machine.batch_size=8", "machine.num_workers=2",
                   "data.template.level_templates=2"):
        with pytest.raises(ValueError, match=unread.split("=")[0]):
            cli.main(base + ["device=cpu", unread])
    monkeypatch.setenv("GIGAPOSE_TINY", "1")
    with pytest.raises(ValueError, match="off, int8, int8-static"):
        cli.main(base + ["device=cpu", "model.serving_quant=int8",
                         "model.serving_quant_ist=int4"])
    runner = cli.main(base + ["device=cpu", "model.serving_quant=int8",
                              "model.serving_quant_ist=int8", "data.template.num_templates=8"])
    assert type(runner.estimator.ist_net).__name__ == "ISTNetInt8"
    assert not runner.estimator.ist_net.static_scales and runner.timing["images"] == 1
    assert torch.isfinite(runner.store.ist_features.float()).all()
    csvs = {}
    for shards in (1, 2):
        runner = cli.main(base + ["device=cpu", f"store_shards={shards}", f"run_id=s{shards}",
                                  "data.template.num_templates=8", "model.testing_metric.k=4"])
        assert type(runner.store).__name__ == ("ShardedStore" if shards > 1 else "TemplateStore")
        pred = osp.join(root, "results", f"large_s{shards}", "predictions")
        csvs[shards] = [[line.split(",")[:6] for line in open(osp.join(pred, f))]
                        for f in sorted(os.listdir(pred)) if f.endswith(".csv")]
    assert len(csvs[2]) == 2 and csvs[2] == csvs[1]
    monkeypatch.setenv("GIGAPOSE_COORDINATOR", "localhost:1234")
    with pytest.raises(ValueError, match="GIGAPOSE_NUM_PROCESSES, GIGAPOSE_PROCESS_ID"):
        cli.main(base + ["device=cpu"])


def test_cli_renders_missing_templates_as_test_py(tmp_path, jax_weights):
    """With no template set and the dataset's CAD models on disk, both CLIs
    render the 162 views of level 1 (each into its own data.template.dir)
    and onboard them: the port's host renders decode to test.py's pixels,
    the pose npys are equal, and the csvs hold test.py's rows to the f32
    store's tolerances."""
    from PIL import Image

    from gigapose_tpu_torch.dataloader.png import decode_png

    root = synthetic_bop.build(str(tmp_path))
    shutil.rmtree(osp.join(root, "datasets", "templates"))
    common = [f"machine.root_dir={root}", "test_dataset_name=tudl",
              "data.template.num_templates=8", "model.feature_dtype=f32"]
    jax_cli.main(common + ["run_id=jax", f"data.template.dir={root}/tpl_jax"])
    cli.main(common + ["run_id=port", "device=cpu", f"data.template.dir={root}/tpl_port"])
    for obj in ("000001", "000002"):
        views = sorted(os.listdir(osp.join(root, "tpl_port", obj)))
        assert views == sorted(os.listdir(osp.join(root, "tpl_jax", obj)))
        assert len(views) == 2 * 162
        for name in views[::23]:
            with open(osp.join(root, "tpl_port", obj, name), "rb") as f:
                got = decode_png(f.read())
            np.testing.assert_array_equal(got, np.asarray(Image.open(
                osp.join(root, "tpl_jax", obj, name))))
        np.testing.assert_array_equal(np.load(osp.join(root, "tpl_port", "object_poses",
                                                       f"{obj}.npy")),
                                      np.load(osp.join(root, "tpl_jax", "object_poses",
                                                       f"{obj}.npy")))
    for multi in (False, True):
        assert _compare(_csv(root, "port", multi), _csv(root, "jax", multi), (1e-4, 1e-4)) == set()


def test_cli_renders_the_configured_template_level(tmp_path, monkeypatch):
    """Deliberate divergence: the port renders level data.template.level
    (its configs hold level: 1); test.py reads data.template.level_templates,
    which no config file holds, and so renders level 1 whatever
    data.template.level says. Both CLIs are stopped at the render call."""
    from gigapose_tpu.scripts import render_templates as jax_render
    from gigapose_tpu_torch.scripts import render_templates as port_render

    class Stop(Exception):
        pass

    calls = {}

    def capture(tag):
        def main(argv):
            calls[tag] = dict(a.split("=", 1) for a in argv)
            raise Stop
        return main

    monkeypatch.setattr(jax_render, "main", capture("jax"))
    monkeypatch.setattr(port_render, "main", capture("port"))
    monkeypatch.setenv("GIGAPOSE_TINY", "1")
    root = synthetic_bop.build(str(tmp_path))
    shutil.rmtree(osp.join(root, "datasets", "templates"))
    base = [f"machine.root_dir={root}", "test_dataset_name=tudl", "data.template.level=0"]
    with pytest.raises(Stop):
        jax_cli.main(base)
    with pytest.raises(Stop):
        cli.main(base + ["device=cpu"])
    assert calls["jax"]["level"] == "1" and calls["port"]["level"] == "0"
    assert calls["port"]["renderer"] == "native"
    with pytest.raises(Stop):
        cli.main([f"machine.root_dir={root}", "test_dataset_name=tudl", "device=cpu"])
    assert calls["port"]["level"] == "1"
    assert load_config("test").data.template.level == 1


def test_cli_renders_templates_on_the_estimators_device(tmp_path, monkeypatch):
    """Deliberate divergence: test.py always renders a missing template set
    with the host C++ renderer; the port renders it with the device
    renderer when the estimator is on the card and with the host one (the
    same files as test.py's) elsewhere, and takes no option for it."""
    from gigapose_tpu_torch.scripts import render_templates as port_render

    assert cli.template_renderer(torch.device("cuda", 0)) == "device"
    assert cli.template_renderer(torch.device("cpu")) == "native"

    def stop(argv):
        raise RuntimeError(" ".join(argv))

    monkeypatch.setattr(port_render, "main", stop)
    monkeypatch.setenv("GIGAPOSE_TINY", "1")
    root = synthetic_bop.build(str(tmp_path))
    shutil.rmtree(osp.join(root, "datasets", "templates"))
    base = [f"machine.root_dir={root}", "test_dataset_name=tudl", "device=cpu"]
    with pytest.raises(RuntimeError, match="renderer=native") as info:
        cli.main(base)
    assert "device=" not in str(info.value)
    with pytest.raises(ValueError, match="template_renderer"):
        cli.main(base + ["template_renderer=device"])


def _reference_ckpt(path, est, extra=None, drop=None):
    """A lightning-style {"state_dict": ...} checkpoint with the reference's
    key prefixes, from the port's nets."""
    sd = {"ae_net.dinov2_model.mask_token": torch.zeros(1, 64)}
    for prefix, (net, to) in (("vit.", (est.ae_net, "ae_net.dinov2_model.")),
                              ("backbone.", (est.ist_net, "ist_net.backbone.")),
                              ("regressor.", (est.ist_net, "ist_net.regressor."))):
        for k, v in net.state_dict().items():
            if k.startswith(prefix):
                sd[to + k[len(prefix):]] = v.clone()
    sd.update(extra or {})
    for k in drop or ():
        del sd[k]
    torch.save({"state_dict": sd, "epoch": 3}, path)
    return path


def _random_nets(seed):
    """The nets build_estimator makes for model.ae_net.backbone=vit_tiny_test
    and model.ist_net.descriptor_size=32, with every tensor random
    (BatchNorm statistics and LayerScale included)."""
    est = GigaPoseEstimator.create("vit_tiny_test", seed=seed, ist_descriptor_size=32,
                                   device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for net in (est.ae_net, est.ist_net):
            for k, v in net.state_dict().items():
                if v.is_floating_point() and not k.endswith("weight"):
                    v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    return est


def test_reference_checkpoint_loads_as_through_jax(tmp_path):
    """The port's gigapose_ckpt_to_torch gives the state dicts of the JAX
    path (gigapose_ckpt_to_flax, then the flax -> torch bridge), and
    build_estimator loads model.checkpoint_path=*.ckpt; a missing or an
    unknown key raises."""
    from gigapose_tpu.models.convert import gigapose_ckpt_to_flax

    est = _random_nets(7)
    path = _reference_ckpt(str(tmp_path / "ref.ckpt"), est)
    ae_sd, ist_sd = convert.gigapose_ckpt_to_torch(path)
    flax = gigapose_ckpt_to_flax(path, depth=2)
    want_ae = convert.ae_flax_to_torch({"params": flax["ae"]})
    want_ist = convert.ist_flax_to_torch({"params": flax["ist"][0], "batch_stats": flax["ist"][1]})
    for got, want in ((ae_sd, want_ae), (ist_sd, want_ist)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k].to(want[k].dtype), want[k]), k

    tiny = ["device=cpu", "model.ae_net.backbone=vit_tiny_test", "model.ist_net.descriptor_size=32",
            "model.serving_quant=off"]
    loaded = cli.build_estimator(load_config("test", tiny + [f"model.checkpoint_path={path}"]))
    for got, want in ((loaded.ae_net, est.ae_net), (loaded.ist_net, est.ist_net)):
        want_sd = want.state_dict()
        for k, v in got.state_dict().items():
            assert torch.equal(v, want_sd[k]), k
    for bad in (dict(extra={"ist_net.backbone.bogus.weight": torch.zeros(1)}),
                dict(extra={"ist_net.other.weight": torch.zeros(1)}),
                dict(drop=["ist_net.backbone.bn1.running_var"]),
                dict(drop=["ae_net.dinov2_model.blocks.1.ls2.gamma"])):
        bad_path = _reference_ckpt(str(tmp_path / "bad.ckpt"), est, **bad)
        with pytest.raises((RuntimeError, ValueError)):
            cli.build_estimator(load_config("test", tiny + [f"model.checkpoint_path={bad_path}"]))
    with pytest.raises(FileNotFoundError):
        cli.build_estimator(load_config("test", tiny + ["model.checkpoint_path=/nonexistent.ckpt"]))
    with pytest.raises(NotImplementedError, match="A12"):
        cli.build_estimator(load_config("test", tiny + [f"model.checkpoint_path={tmp_path}"]))
