"""Multi-device runs of the port (gigapose_tpu_torch/parallel/), CPU:

- the view-sharded store: `sharded_match_and_gather` against the JAX
  package's on its (1, S) mesh of virtual CPU devices, S in {2, 4}, V = 13
  (padded to 14 / 16), on tests/test_sharded_store.py's random store: ids,
  validity and correspondences equal, scores to rtol 1e-6 (JAX's own test's
  tolerance), the winning views' IST features equal; with the fused
  matcher's plain version, the same against the port's whole-store
  `fused_match_templates`; the tie across shards of
  tests/test_sharded_store.py (view 9 a copy of view 1: the lower id
  first); `coarse_forward_sharded` against JAX's on the same bridged nets
  (tests/test_torch_pipeline.py: ids, failures, inlier masks and
  correspondences equal; scores, M and poses to that test's tolerances,
  since the two packages' nets differ by float rounding) and against the
  port's own whole-store forward (every output equal);
- two processes through the GIGAPOSE_COORDINATOR contract
  (GIGAPOSE_DIST_BACKEND=gloo), output to files as in
  tests/test_multihost.py: (1) the coarse CLI cold (distributed
  onboarding), then cached, then the refine CLI, GIGAPOSE_TINY nets on a
  3-image fixture: the cache equals the one-process cache array for array,
  the merged csvs equal one process's row for row (time column aside),
  the images split round-robin, and only process 0 returns paths; (2) the
  training step: each process steps on its half of a batch of 2 (b = 1)
  for 2 steps, against one process stepping on the whole batch and against
  the JAX package's train_step on it, for InfoNCE in f32 and bf16 and both
  fuse_ist_pair settings, with tests/test_torch_train_step.py's tolerances
  (metrics to rtol 5e-4; AE parameters to 1e-6 absolute; IST parameters
  within 2 x the summed lr, 98 % of them within a tenth of it; BatchNorm
  statistics to 1e-4 absolute), except that with InfoNCE in bf16 the AE is
  held as the IST is (within 2 x its summed lr, 98 % within a tenth: a bf16
  logit rounds after a sum whose order depends on the process's block of
  rows, and a flipped rounding moves an entry whose gradient is near 0;
  reading: 1 entry of 16,448 of pos_embed 1.6e-6 apart), and against JAX
  the IST share
  beyond a tenth may be that of the one-process port (0.58 %, fused 5.28 %:
  the IST backbone's ill-conditioned gradient, tests/test_torch_train_step.py)
  plus 0.2 % (readings: two processes 0 % from one, 4e-6 / 9e-6 at most;
  from JAX 0.58 % / 5.29 %); the two processes' weights and BatchNorm
  statistics equal bit for bit; then train.py for 2 steps in both
  processes: checkpoints and metrics written once (by process 0), the
  same weights on both;
- the helpers in one process, the launch contract's refusals, and the
  one-process-per-card refusal of parallel/mesh.py.
"""

import dataclasses
import json
import os
import os.path as osp
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapose_tpu.parallel import sharded_store as jss
from gigapose_tpu.pipeline import estimator as jest
from gigapose_tpu.pipeline import templates as jtemplates
from gigapose_tpu.training import state as JS
from gigapose_tpu_torch import cli
from gigapose_tpu_torch import refine
from gigapose_tpu_torch.ops.fused_matching import fused_match_templates
from gigapose_tpu_torch.parallel import mesh, multihost
from gigapose_tpu_torch.parallel import sharded_store as tss
from gigapose_tpu_torch.pipeline import estimator as test
from gigapose_tpu_torch.pipeline import templates as ttemplates
from gigapose_tpu_torch.training import state as TS
from tests import synthetic_bop
from tests.test_sharded_store import _random_store_and_queries
from tests.test_torch_pipeline import _nets, _slice_world
from tests.torch_train_fixtures import jax_batch, jax_train_state, port_state_dicts, random_batch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CPU = torch.device("cpu")
T = torch.as_tensor
STEPS = 2
# (nce_dtype, fuse_ist_pair) of the training cases
TRAIN_CASES = {"f32": (None, False), "f32_fused": (None, True), "bf16": ("bf16", False),
               "bf16_fused": ("bf16", True)}


def _port_store(store) -> ttemplates.TemplateStore:
    return ttemplates.TemplateStore(**{f.name: T(np.asarray(getattr(store, f.name)))
                                       for f in dataclasses.fields(ttemplates.TemplateStore)})


def _jax_sharded_match(store, tar, tar_masks, labels, S, cfg):
    m = jss.make_dp_tv_mesh(1, S)
    return jax.jit(lambda t, mk, lb, s: jss.sharded_match_and_gather(t, mk, lb, s, m, cfg))(
        tar, tar_masks, labels, jss.shard_template_store(store, m))


def _assert_match_equal(got, got_ist, want, want_ist):
    for name in ("ids", "valid", "src_pts", "tar_pts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got.score_pts.numpy(), np.asarray(want.score_pts), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(got_ist.numpy(), np.asarray(want_ist))


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_match_matches_jax(S):
    """V = 13 over S shards (padding views); the stock matcher on both sides."""
    cfg_j = jest.EstimatorConfig(k=2, num_patches=4)
    store, tar, tar_masks, labels = _random_store_and_queries()
    want, want_ist = _jax_sharded_match(store, tar, tar_masks, labels, S, cfg_j)
    sstore = tss.shard_template_store(_port_store(store), [CPU] * S)
    assert sstore.num_views == -(-13 // S) * S and sstore.Ms.shape[1] == 13
    assert float(sstore.shards[-1].masks[:, -1].abs().sum()) == 0  # a padding view
    cfg = test.EstimatorConfig(k=2, num_patches=4)
    got, got_ist = tss.sharded_match_and_gather(T(np.asarray(tar)), T(np.asarray(tar_masks)),
                                                T(np.asarray(labels)), sstore, cfg)
    _assert_match_equal(got, got_ist, want, want_ist)


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_fused_match_equals_the_whole_store(S):
    """The fused matcher (its plain version on the CPU) per shard, merged,
    against fused_match_templates on the whole store: unit features, as the
    kernel takes them."""
    store, tar, tar_masks, labels = _random_store_and_queries(seed=5)
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    store = dataclasses.replace(store, ae_features=jnp.asarray(unit(np.asarray(store.ae_features))))
    tar = T(unit(np.asarray(tar)))
    whole = _port_store(store)
    kw = dict(k=3, sim_threshold=0.5, patch_threshold=3, num_patches=4)
    want = fused_match_templates(tar, whole.ae_features, T(np.asarray(tar_masks)), whole.masks,
                                 T(np.asarray(labels)), **kw)
    V = whole.ist_features.shape[1]
    flat = whole.ist_features.reshape((-1,) + whole.ist_features.shape[2:])
    want_ist = flat[T(np.asarray(labels)).long()[:, None] * V + want.ids.long()]
    cfg = test.EstimatorConfig(k=3, num_patches=4, use_pallas_matching=True)
    got, got_ist = tss.sharded_match_and_gather(tar, T(np.asarray(tar_masks)),
                                                T(np.asarray(labels)),
                                                tss.shard_template_store(whole, [CPU] * S), cfg)
    assert (want.scores[:, 0] > 0).all()
    _assert_match_equal(got, got_ist, want, want_ist)


def test_sharded_merge_tie_breaks_like_topk():
    """tests/test_sharded_store.py's tie: view 9 (shard 3 of 4) is a copy of
    view 1 (shard 0); every query is view 1: both packages put 1 first, 9
    second."""
    cfg_j = jest.EstimatorConfig(k=2, num_patches=4)
    store, tar, tar_masks, labels = _random_store_and_queries(B=4, V=12, seed=3)
    copy = lambda a: np.concatenate([a[:, :9], a[:, 1:2], a[:, 10:]], axis=1)
    store = dataclasses.replace(
        store, ae_features=jnp.asarray(copy(np.asarray(store.ae_features))),
        masks=jnp.asarray(copy(np.asarray(store.masks))),
        ist_features=jnp.asarray(copy(np.asarray(store.ist_features))))
    labels = jnp.zeros_like(labels)
    tar = store.ae_features[0, 1][None].repeat(tar.shape[0], 0)
    tar_masks = jnp.ones_like(tar_masks)
    want, want_ist = _jax_sharded_match(store, tar, tar_masks, labels, 4, cfg_j)
    assert (np.asarray(want.ids) == [1, 9]).all(), "the tie is not set up"
    got, got_ist = tss.sharded_match_and_gather(
        T(np.asarray(tar)), T(np.asarray(tar_masks)), T(np.asarray(labels)),
        tss.shard_template_store(_port_store(store), [CPU] * 4),
        test.EstimatorConfig(k=2, num_patches=4))
    _assert_match_equal(got, got_ist, want, want_ist)


@pytest.mark.parametrize("S", [2, 4])
def test_coarse_forward_sharded_matches_jax(S):
    """13 views of one object over S shards, through both packages' nets."""
    est_j, (ae, ist) = _nets(56, 64)
    store, batch, v_star = _slice_world(est_j, B=3, V=13)
    jae, ae_vars, jist, ist_vars = est_j
    m = jss.make_dp_tv_mesh(1, S)
    jstore = jtemplates.TemplateStore(**{k: jnp.asarray(v) for k, v in store.items()})
    want = jax.jit(lambda s, b: jss.coarse_forward_sharded(
        jae, jist, ae_vars, ist_vars, s, b, m,
        cfg=jest.EstimatorConfig(k=2, num_patches=4, patch_size=14)))(
        jss.shard_template_store(jstore, m),
        jest.DetectionBatch(**{k: jnp.asarray(v) for k, v in batch.items()}))
    tstore = ttemplates.TemplateStore(**{k: T(v) for k, v in store.items()})
    tbatch = test.DetectionBatch(**{k: T(v) for k, v in batch.items()})
    for fused in (False, True):
        cfg = test.EstimatorConfig(k=2, num_patches=4, patch_size=14, use_pallas_matching=fused)
        with torch.no_grad():
            got = tss.coarse_forward_sharded(ae, ist, tss.shard_template_store(tstore, [CPU] * S),
                                             tbatch, cfg)
            whole = test.coarse_forward(ae, ist, tstore, tbatch, cfg)
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          getattr(whole, f.name).numpy(), err_msg=f.name)
        for name in ("view_ids", "failed", "ransac_valid", "src_pts", "tar_pts"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
        for name in ("scores", "sim_scores"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), atol=1e-4, err_msg=name)
        np.testing.assert_allclose(got.M.numpy(), np.asarray(want.M), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), rtol=1e-4,
                                   atol=1e-3)
        assert all(v_star in got.view_ids[b].tolist() for b in range(2))


def test_sharded_store_needs_k_views_per_shard():
    store, tar, tar_masks, labels = _random_store_and_queries(V=5)
    sstore = tss.shard_template_store(_port_store(store), [CPU] * 4)  # 2 views a shard
    with pytest.raises(ValueError, match="k=3"):
        tss.sharded_match_and_gather(T(np.asarray(tar)), T(np.asarray(tar_masks)),
                                     T(np.asarray(labels)), sstore,
                                     test.EstimatorConfig(k=3, num_patches=4))


# ---------------------------------------------------------------- processes

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(script: str, out: str, env_extra: dict, n_proc: int = 2):
    """`script` in n_proc processes joined through the GIGAPOSE_COORDINATOR
    contract (gloo); each one's output goes to a file (pipes could fill and
    stall a process at a collective)."""
    port = _free_port()
    procs = []
    for pid in range(n_proc):
        env = dict(os.environ, GIGAPOSE_COORDINATOR=f"127.0.0.1:{port}",
                   GIGAPOSE_NUM_PROCESSES=str(n_proc), GIGAPOSE_PROCESS_ID=str(pid),
                   GIGAPOSE_DIST_BACKEND="gloo", OUT=out, PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1", **env_extra)
        log = open(osp.join(out, f"proc_{pid}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, "-c", script], env=env, cwd=REPO,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, out: str, timeout: int = 300) -> None:
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for pid, (p, _) in enumerate(procs):
        assert p.returncode == 0, open(osp.join(out, f"proc_{pid}.log")).read()[-4000:]


CLI_SCRIPT = textwrap.dedent("""
    import json, os
    from gigapose_tpu_torch import cli, refine
    from gigapose_tpu_torch.parallel import multihost
    out, root = os.environ["OUT"], os.environ["FIXTURE"]
    common = [f"machine.root_dir={root}", "test_dataset_name=tudl", "device=cpu",
              "data.template.num_templates=8", "run_id=mp", "onboarding_cache=mp"]
    cold = cli.main(common)
    cached = cli.main(common)
    paths, rtiming = refine.main([f"machine.root_dir={root}", "test_dataset_name=tudl",
                                  "device=cpu", "run_id=mp", "min_score=0",
                                  "n_refine_iterations=1"])
    rank = multihost.process_index()
    with open(os.path.join(out, f"cli_{rank}.json"), "w") as f:
        json.dump(dict(cold=cold.timing, cached=cached.timing, refine_images=rtiming["images"],
                       refine_paths=paths, world=multihost.process_count()), f)
""")

TRAIN_SCRIPT = textwrap.dedent("""
    import os
    import torch
    from gigapose_tpu_torch import train
    from gigapose_tpu_torch.models.ae_net import AENet
    from gigapose_tpu_torch.models.ist_net import ISTBackbone, ISTNet, Regressor
    from gigapose_tpu_torch.parallel import multihost
    from gigapose_tpu_torch.training import state as TS
    rank, world = multihost.maybe_initialize()
    torch.set_num_threads(1)
    out = os.environ["OUT"]
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    for name, kw in inputs["cases"].items():
        ae = AENet("vit_tiny_test")
        ist = ISTNet(ISTBackbone(initial_dim=8, block_dims=(8, 8, 12, 16), descriptor_size=16,
                                 input_size=256), Regressor(32, hidden_dim=16))
        ae.load_state_dict(inputs["ae"])
        ist.load_state_dict(inputs["ist"])
        state = TS.TrainState(ae, ist, TS.OptimConfig(**kw))
        metrics = []
        for b in inputs["batches"]:
            n = len(b["src_img"]) // world
            mine = {k: torch.as_tensor(v[rank * n:(rank + 1) * n]) for k, v in b.items()}
            m = TS.train_step(state, TS.TrainBatch(**mine))
            metrics.append({k: float(v) for k, v in m.items()})
        torch.save(dict(metrics=metrics, ae=state.ae_net.state_dict(),
                        ist=state.ist_net.state_dict()), os.path.join(out, f"{name}_{rank}.pt"))
    root = os.environ["FIXTURE"]
    st = train.main([f"machine.root_dir={root}", "train_dataset_name=tudl",
                     "machine.batch_size=1", "max_steps=2", "checkpoint_every=1", "log_every=1",
                     "run_id=dp", "device=cpu"])
    torch.save(dict(ae=st.ae_net.state_dict(), ist=st.ist_net.state_dict(), step=st.step),
               os.path.join(out, f"train_{rank}.pt"))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both two-process runs, started together; the tests below wait for
    the one they read."""
    root = synthetic_bop.build(str(tmp_path_factory.mktemp("parallel_fixture")),
                               n_test_images=3)
    cli_out = str(tmp_path_factory.mktemp("cli_runs"))
    cli_procs = _start(CLI_SCRIPT, cli_out, dict(FIXTURE=root, GIGAPOSE_TINY="1"))
    train_out = str(tmp_path_factory.mktemp("train_runs"))
    jstate, _ = jax_train_state(JS.OptimConfig(), seed=11)
    ae_sd, ist_sd = port_state_dicts(jstate)
    batches = [random_batch(200 + i) for i in range(STEPS)]
    cases = {name: dict(nce_dtype=nce, fuse_ist_pair=fuse, warm_up_steps=0)
             for name, (nce, fuse) in TRAIN_CASES.items()}
    torch.save(dict(ae=ae_sd, ist=ist_sd, batches=batches, cases=cases),
               osp.join(train_out, "inputs.pt"))
    train_procs = _start(TRAIN_SCRIPT, train_out, dict(FIXTURE=root, GIGAPOSE_TINY="1"))
    state = dict(root=root, cli=(cli_procs, cli_out), train=(train_procs, train_out),
                 jstate=jstate, batches=batches, cases=cases, waited=set())

    def wait(which):
        procs, out = state[which]
        if which not in state["waited"]:
            state["waited"].add(which)
            _wait(procs, out)
        return out

    state["wait"] = wait
    yield state
    for which in ("cli", "train"):
        for p, log in state[which][0]:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def _csv_lines(path):
    """The csv's rows without the time column (the 7th)."""
    with open(path) as f:
        return [line.strip().split(",")[:6] + line.strip().split(",")[7:] for line in f]


def _results(root, run_id, refined=False):
    sub = "predictions_refined" if refined else "predictions"
    d = osp.join(root, "results", f"large_{run_id}", sub)
    return {f: _csv_lines(osp.join(d, f))
            for f in sorted(os.listdir(d)) if f.endswith(".csv")}


def test_multi_process_clis_equal_one_process(runs, monkeypatch):
    """The coarse CLI cold (distributed onboarding) and cached, then the
    refine CLI, in two processes, against one process on the same fixture."""
    root = runs["root"]
    monkeypatch.setenv("GIGAPOSE_TINY", "1")
    common = [f"machine.root_dir={root}", "test_dataset_name=tudl", "device=cpu",
              "data.template.num_templates=8", "run_id=sp", "onboarding_cache=sp"]
    one = cli.main(common)
    paths, _ = refine.main([f"machine.root_dir={root}", "test_dataset_name=tudl", "device=cpu",
                            "run_id=sp", "min_score=0", "n_refine_iterations=1"])
    assert one.timing["images"] == 3 and paths
    out = runs["wait"]("cli")
    ranks = [json.load(open(osp.join(out, f"cli_{r}.json"))) for r in range(2)]
    assert [r["world"] for r in ranks] == [2, 2]
    # round-robin: images 0 and 2 on process 0, image 1 on process 1
    assert [r["cold"]["images"] for r in ranks] == [2, 1]
    assert [r["cached"]["images"] for r in ranks] == [2, 1]
    assert [r["cold"]["onboard_cached"] for r in ranks] == [False, False]
    assert [r["cached"]["onboard_cached"] for r in ranks] == [True, True]
    assert [r["refine_images"] for r in ranks] == [2, 1]
    assert ranks[0]["refine_paths"] and ranks[1]["refine_paths"] == []
    tdir = osp.join(root, "datasets", "templates", "tudl")
    assert not osp.exists(osp.join(tdir, "onboarded_mp.npz.parts"))
    with np.load(osp.join(tdir, "onboarded_mp.npz")) as mp, \
            np.load(osp.join(tdir, "onboarded_sp.npz")) as sp:
        assert sorted(mp.files) == sorted(sp.files)
        for k in sp.files:
            np.testing.assert_array_equal(mp[k], sp[k], err_msg=k)
    for refined in (False, True):
        mp_csv, sp_csv = _results(root, "mp", refined), _results(root, "sp", refined)
        assert [f.replace("_mp", "") for f in mp_csv] == [f.replace("_sp", "") for f in sp_csv]
        for (fm, a), (fs, b) in zip(mp_csv.items(), sp_csv.items()):
            assert len(a) > 1 and a == b, (fm, fs)


def _far_share(got, want, lr_sum):
    """tests/test_torch_train_step.py's IST checks: BatchNorm statistics to
    1e-4 absolute, every parameter within 2 x the summed lr; returns the
    share of parameter entries more than a tenth of it apart."""
    moved = far = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g = got[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w.numpy(), atol=1e-4, rtol=0, err_msg=k)
            continue
        d = np.abs(g - w.numpy())
        assert d.max() <= 2 * lr_sum, k
        moved += d.size
        far += int((d > 0.1 * lr_sum).sum())
    return far / moved


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_two_ranks_step_as_one_global_batch(runs, case):
    """Two processes x 1 row against one process x 2 rows (the port) and the
    JAX package's train_step on the 2 rows, STEPS steps."""
    out = runs["wait"]("train")
    kw = runs["cases"][case]
    ranks = [torch.load(osp.join(out, f"{case}_{r}.pt"), weights_only=False) for r in range(2)]
    for part in ("ae", "ist"):  # every rank holds the same weights and statistics
        for k, v in ranks[0][part].items():
            assert torch.equal(v, ranks[1][part][k]), (part, k)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]

    cfg_j = JS.OptimConfig(warm_up_steps=0, fuse_ist_pair=kw["fuse_ist_pair"],
                           nce_dtype=kw["nce_dtype"])
    jstate, tx = jax_train_state(cfg_j, seed=11)
    from tests.torch_train_fixtures import jax_nets, port_train_state

    jae, jist = jax_nets()
    step = jax.jit(lambda s, b: JS.train_step(jae, jist, tx, cfg_j, s, b))
    one = port_train_state(jstate, TS.OptimConfig(**kw))
    for i, b in enumerate(runs["batches"]):
        jstate, jm = step(jstate, jax_batch(b))
        om = TS.train_step(one, TS.TrainBatch(**{k: T(v) for k, v in b.items()}))
        got = ranks[0]["metrics"][i]
        assert sorted(got) == sorted(om) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(got[k], om[k].item(), rtol=5e-4, err_msg=f"{i} {k}")
            np.testing.assert_allclose(got[k], float(jm[k]), rtol=5e-4, err_msg=f"{i} {k}")
    ae_j, ist_j = port_state_dicts(jstate)
    for want_ae in (one.ae_net.state_dict(), ae_j):
        if kw["nce_dtype"]:  # bf16 logits: held as the IST is (see the docstring)
            assert _far_share(ranks[0]["ae"], want_ae, 1e-5 * STEPS) <= 0.02
            continue
        for k, w in want_ae.items():
            np.testing.assert_allclose(ranks[0]["ae"][k].numpy(), w.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
    lr_sum = 1e-4 * STEPS
    assert _far_share(ranks[0]["ist"], one.ist_net.state_dict(), lr_sum) <= 0.02
    # the one-process port is itself this far from JAX (fused: 5.28 % of the
    # entries, the IST backbone's ill-conditioned gradient); two processes
    # must be as close to JAX as one
    one_far = _far_share(one.ist_net.state_dict(), ist_j, lr_sum)
    assert _far_share(ranks[0]["ist"], ist_j, lr_sum) <= max(0.02, one_far + 0.002)


def test_train_cli_two_processes_write_once(runs):
    """train.py in two processes: one set of checkpoints and one metrics
    file, both processes' final weights equal."""
    out = runs["wait"]("train")
    a, b = (torch.load(osp.join(out, f"train_{r}.pt"), weights_only=False) for r in range(2))
    assert a["step"] == b["step"] == 2
    for part in ("ae", "ist"):
        assert all(torch.equal(v, b[part][k]) for k, v in a[part].items()), part
    run = osp.join(runs["root"], "results", "large_dp")
    assert sorted(os.listdir(osp.join(run, "checkpoints"))) == [
        "last", "step_00000001.pt", "step_00000002.pt"]
    with open(osp.join(run, "logs", "metrics.jsonl")) as f:
        steps = [json.loads(line).get("step") for line in f]
    assert len(steps) == len(set(steps)) == 2, steps


def test_helpers_in_one_process():
    assert multihost.maybe_initialize(env={}) == (0, 1)
    assert multihost.split_work(list(range(5))) == [0, 1, 2, 3, 4]
    assert multihost.broadcast_object({"a": 1}) == {"a": 1}
    multihost.barrier()
    x = torch.ones(3, requires_grad=True)
    assert multihost.all_gather_rows(x) is x and multihost.all_reduce_sum(x) is x
    assert mesh.pad_to_multiple(13, 4) == 16
    with pytest.raises(ValueError, match="GIGAPOSE_NUM_PROCESSES, GIGAPOSE_PROCESS_ID"):
        multihost.maybe_initialize(env={"GIGAPOSE_COORDINATOR": "127.0.0.1:1"})
    with pytest.raises(ValueError, match="nccl or gloo"):
        multihost.maybe_initialize(env={"GIGAPOSE_COORDINATOR": "127.0.0.1:1",
                                        "GIGAPOSE_DIST_BACKEND": "mpi"})


def test_one_process_per_card(monkeypatch):
    """Where the JAX package would shard a batch over several cards of one
    process, the port raises and says to launch one process per card; a
    named device, or a store whose shards take every card, passes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="one process per card"):
        mesh.refuse_batch_mesh(device_given=False)
    mesh.refuse_batch_mesh(device_given=True)
    mesh.refuse_batch_mesh(device_given=False, store_shards=2)
    assert cli.shard_devices(torch.device("cuda", 1), 2) == [torch.device("cuda", 1),
                                                             torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="store_shards=3 needs 3 cards"):
        cli.shard_devices(torch.device("cuda", 0), 3)
    assert cli.shard_devices(CPU, 3) == [CPU] * 3 and cli.shard_devices(CPU, 1) is None
