"""The port's training loop and CLI (CPU, the synthetic BOP fixture):

- fit for 3 steps from the JAX init against the JAX package's fit on the
  same fixture and seed (the loaders' records are equal,
  tests/test_torch_train_data.py): the metrics of every step to rtol 5e-4,
  as train_step (tests/test_torch_train_step.py);
- a resume (2 steps, a checkpoint, a new process's worth of objects, 1
  more step) bit-equal to 3 steps straight: parameters, BatchNorm
  statistics, Adam moments and the last step's metrics;
- the train CLI (python -m gigapose_tpu_torch.train) and its IST warm
  start, as tests/test_train_cli.py runs train.py;
- the coarse CLI serving the checkpoint of the port's fit: the same csvs as
  the CLI with those weights put into its nets directly;
- the train config against the JAX package's.
"""

import json
import os.path as osp

import numpy as np
import pytest
import torch

from gigapose_tpu.dataloader.scene import DirSceneSource as JDirSceneSource
from gigapose_tpu.dataloader.train_set import TrainLoader as JTrainLoader
from gigapose_tpu.training import loop as jloop
from gigapose_tpu.training import state as JS
from gigapose_tpu.utils.config import load_config as jax_load_config
from gigapose_tpu_torch import cli
from gigapose_tpu_torch import train as train_cli
from gigapose_tpu_torch.dataloader import bop_io
from gigapose_tpu_torch.dataloader.scene import DirSceneSource
from gigapose_tpu_torch.dataloader.train_set import TrainLoader
from gigapose_tpu_torch.training import checkpoint as ckpt_lib
from gigapose_tpu_torch.training import state as TS
from gigapose_tpu_torch.training.loop import FitConfig, fit
from gigapose_tpu_torch.utils.config import load_config
from tests import synthetic_bop
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (a fixture)
from tests.torch_train_fixtures import jax_nets, jax_train_state, port_nets, port_state_dicts

WARM = 2


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return synthetic_bop.build(str(tmp_path_factory.mktemp("train_fit")))


def _split(root):
    return (osp.join(root, "datasets", "tudl", "train_pbr"),
            osp.join(root, "datasets", "templates", "tudl"))


def _port_loader(root, seed=5):
    split, tdir = _split(root)
    return TrainLoader(scene_source=DirSceneSource(split), template_dir=tdir, batch_size=2,
                       seed=seed)


def _port_nets_from(jstate):
    ae, ist = port_nets()
    ae_sd, ist_sd = port_state_dicts(jstate)
    ae.load_state_dict(ae_sd, strict=True)
    ist.load_state_dict(ist_sd, strict=True)
    return ae, ist


def test_fit_matches_jax_fit(root, monkeypatch):
    cfg_j = JS.OptimConfig(warm_up_steps=WARM)
    jstate, tx = jax_train_state(cfg_j, seed=21)
    ae, ist = _port_nets_from(jstate)  # before JAX's fit donates jstate's buffers
    monkeypatch.setattr(jloop, "create_train_state",
                        lambda *args, **kw: (jstate, tx))
    split, tdir = _split(root)
    want = {}
    jae, jist = jax_nets()
    jloop.fit(jae, jist, JTrainLoader(scene_source=JDirSceneSource(split), template_dir=tdir,
                                      batch_size=2, seed=5),
              optim_cfg=cfg_j, fit_cfg=jloop.FitConfig(max_steps=3, log_every=1),
              metrics_hook=lambda step, m: want.setdefault(step, m))
    got = {}
    state = fit(ae, ist, _port_loader(root), "cpu", TS.OptimConfig(warm_up_steps=WARM),
                FitConfig(max_steps=3, log_every=1),
                metrics_hook=lambda step, m: got.setdefault(step, m))
    assert state.step == 3 and sorted(got) == sorted(want) == [1, 2, 3]
    for step in want:
        assert sorted(got[step]) == sorted(want[step])
        for k, v in want[step].items():
            np.testing.assert_allclose(got[step][k], v, rtol=5e-4, err_msg=f"{step} {k}")


def test_resume_equals_a_straight_run(root, tmp_path):
    cfg = TS.OptimConfig(warm_up_steps=WARM)
    jstate, _ = jax_train_state(JS.OptimConfig(), seed=22)

    def run(max_steps, ckpt_dir, resume=False):
        metrics = {}
        ae, ist = _port_nets_from(jstate)
        state = fit(ae, ist, _port_loader(root), "cpu", cfg,
                    FitConfig(max_steps=max_steps, log_every=1, checkpoint_every=2,
                              ckpt_dir=str(ckpt_dir)),
                    metrics_hook=lambda step, m: metrics.setdefault(step, m), resume=resume)
        return state, metrics

    straight, m_straight = run(3, tmp_path / "straight")
    run(2, tmp_path / "resumed")
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "resumed")).endswith("step_00000002.pt")
    resumed, m_resumed = run(3, tmp_path / "resumed", resume=True)
    assert resumed.step == straight.step == 3
    assert sorted(m_resumed) == [3] and m_resumed[3] == m_straight[3]
    for net in ("ae", "ist"):
        a, b = straight.nets[net].state_dict(), resumed.nets[net].state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), net
        for m in ("mu", "nu"):
            sa, sb = straight.opt_state[net][m], resumed.opt_state[net][m]
            assert all(torch.equal(sa[k], sb[k]) for k in sa), (net, m)
        assert straight.opt_state[net]["count"] == resumed.opt_state[net]["count"] == 3
    # the checkpoint file holds the whole state
    sd = ckpt_lib.load_checkpoint(str(tmp_path / "straight" / "step_00000003.pt"))
    assert sd["step"] == 3 and sorted(sd) == ["ae", "ist", "optimizer", "step"]
    assert torch.equal(sd["ist"]["backbone.bn1.running_var"],
                       straight.ist_net.backbone.bn1.running_var)


def _train_args(root, run_id, steps, extra=()):
    return [f"machine.root_dir={root}", "train_dataset_name=tudl", "machine.batch_size=2",
            f"max_steps={steps}", "checkpoint_every=2", "log_every=1", f"run_id={run_id}",
            "device=cpu", *extra]


def test_train_cli_smoke(root, monkeypatch):
    monkeypatch.setenv("GIGAPOSE_TINY", "1")
    state = train_cli.main(_train_args(root, "fixture", 3, [
        "val_dataset_name=tudl", "val_split=train_pbr", "val_every=2"]))
    assert state.step == 3
    ckpt_dir = osp.join(root, "results", "large_fixture", "checkpoints")
    assert ckpt_lib.latest_checkpoint(ckpt_dir).endswith("step_00000003.pt")
    with open(osp.join(root, "results", "large_fixture", "logs", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert any("total" in line for line in lines)
    assert any("val/matching" in line for line in lines)
    assert all(np.isfinite(v) for line in lines for v in line.values())
    for bad, err in (("max_step=3", ValueError), ("model.optim.nce_dtype=bf16", ValueError)):
        with pytest.raises(err):
            train_cli.main(_train_args(root, "bad", 1, [bad]))
    monkeypatch.setenv("GIGAPOSE_COORDINATOR", "localhost:1234")  # without its companions
    with pytest.raises(ValueError, match="GIGAPOSE_NUM_PROCESSES, GIGAPOSE_PROCESS_ID"):
        train_cli.main(_train_args(root, "bad", 1))


def test_train_cli_ist_warm_start(root, tmp_path, monkeypatch, capsys):
    """pretrained_ist_path= loads a torch state dict into the IST by name
    before the first step (whose lr is 0, so the weights survive it)."""
    monkeypatch.setenv("GIGAPOSE_TINY", "1")
    rng = np.random.default_rng(0)
    sd = {
        "backbone.conv1.weight": torch.from_numpy(rng.normal(size=(8, 3, 7, 7)).astype(np.float32)),
        "backbone.bn1.weight": torch.ones(8),
        "backbone.bn1.bias": torch.zeros(8),
        "backbone.bn1.running_mean": torch.zeros(8),
        "backbone.bn1.running_var": torch.ones(8),
        "backbone.layer1.0.conv1.weight": torch.zeros(3, 3),  # wrong shape: skipped
    }
    ckpt = str(tmp_path / "loftr_like.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    state = train_cli.main(_train_args(root, "warmstart", 1, [f"pretrained_ist_path={ckpt}"]))
    assert ": 5 tensors loaded" in capsys.readouterr().out
    assert torch.equal(state.ist_net.backbone.conv1.weight, sd["backbone.conv1.weight"])


def _csvs(root, run_id):
    pred = osp.join(root, "results", f"large_{run_id}", "predictions")
    name = f"large-pbrreal-rgb-mmodel_tudl-test_{run_id}"
    return [bop_io.load_bop_csv(osp.join(pred, name + s + ".csv"), extra_column=e)
            for s, e in (("", None), ("MultiHypothesis", "instance_id"))]


def test_coarse_cli_serves_a_checkpoint_of_fit(root, tmp_path, monkeypatch):
    """fit trains the coarse CLI's tiny nets for 2 steps; the CLI with
    model.checkpoint_path=<the checkpoint dir> (and =<its step_*.pt>) writes
    the csvs that the CLI writes with those weights loaded straight into its
    nets (time column aside)."""
    monkeypatch.setenv("GIGAPOSE_TINY", "1")
    base = [f"machine.root_dir={root}", "test_dataset_name=tudl", "device=cpu",
            "data.template.num_templates=8"]
    est = cli.build_estimator(load_config("test", ["device=cpu"]), tiny=True)
    ckpt_dir = str(tmp_path / "ckpt")
    state = fit(est.ae_net, est.ist_net, _port_loader(root), "cpu",
                TS.OptimConfig(warm_up_steps=1, ae_lr=1e-3, ist_lr=1e-3),
                FitConfig(max_steps=2, log_every=1, ckpt_dir=ckpt_dir))
    trained = {net: {k: v.clone() for k, v in m.state_dict().items()}
               for net, m in state.nets.items()}
    fresh = cli.build_estimator(load_config("test", ["device=cpu"]), tiny=True)
    assert not torch.equal(fresh.ae_net.vit.blocks[0].attn.qkv.weight,
                           trained["ae"]["vit.blocks.0.attn.qkv.weight"])

    cli.main(base + ["run_id=ckptdir", f"model.checkpoint_path={ckpt_dir}"])
    cli.main(base + ["run_id=ckptfile",
                     f"model.checkpoint_path={osp.join(ckpt_dir, 'step_00000002.pt')}"])
    build = cli.build_estimator

    def build_with_trained(cfg, tiny=False):
        e = build(cfg, tiny=tiny)
        e.ae_net.load_state_dict(trained["ae"], strict=True)
        e.ist_net.load_state_dict(trained["ist"], strict=True)
        return e

    monkeypatch.setattr(cli, "build_estimator", build_with_trained)
    cli.main(base + ["run_id=direct"])
    drop_time = lambda rows: [{k: v for k, v in r.items() if k != "time"} for r in rows]
    want = _csvs(root, "direct")
    assert len(want[0]) > 0
    for run in ("ckptdir", "ckptfile"):
        for got, w in zip(_csvs(root, run), want):
            assert len(got) == len(w)
            for a, b in zip(drop_time(got), drop_time(w)):
                assert sorted(a) == sorted(b)
                for k in a:
                    assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (run, k)


def test_train_config_matches_jax():
    """Every key of the JAX package's train config keeps its value in the
    port's (with the machine and model groups), and the port's extra keys
    are the ones train.py reads with cfg.get."""
    got, want = load_config("train"), jax_load_config("train")
    flat = lambda d, pre="": {k: v for n, x in d.items() for k, v in (
        flat(x, pre + n + ".").items() if isinstance(x, dict) else [(pre + n, x)])}
    g, w = flat(got), flat(want)
    train_keys = [k for k in w if not k.startswith(("model.", "machine.", "data."))] + [
        "machine.batch_size", "machine.num_workers", "model.ae_net.backbone",
        "model.ist_net.descriptor_size", "model.ist_net.pretrained_weights",
        "model.ist_net.checkpoint_key", "model.ist_net.pretrained_prefix",
        "data.depth_scale", "data.template.scale_factor", "model.model_name",
    ] + [k for k in w if k.startswith("model.optim.")]
    for k in train_keys:
        assert g[k] == w[k], k
    assert sorted(set(g) - set(w)) == [
        "log_tensorboard", "model.ae_net.remat", "pretrained_ist_path", "resume",
        "train_dataset_name", "train_split", "val_every", "val_split"]
    # keys that neither train.py reads
    assert sorted(set(w) - set(g)) == [
        "machine.name", "model.ist_net.hidden_dim", "model.ist_net.num_attn_heads"]


def test_prefetch_stops_early_and_raises_the_loader_error():
    """The loop's prefetch thread: close() stops it when the consumer leaves
    early (its loader generator closed too), and a loader exception is
    raised in the consumer after the items before it."""
    import threading

    from gigapose_tpu_torch.utils.prefetch import prefetch

    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    it = prefetch(endless(), buffer_size=2)
    assert [next(it) for _ in range(5)] == [0, 1, 2, 3, 4]
    it.close()
    assert closed.wait(5) and not it._thread.is_alive()

    def failing():
        yield 1
        raise RuntimeError("broken shard")

    it = prefetch(failing())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="broken shard"):
        next(it)
