"""The port's refine CLI (gigapose_tpu_torch.refine) == the JAX refine.py on
the synthetic BOP fixture (tests/synthetic_bop.py), CPU, GIGAPOSE_TINY nets.

A coarse MultiHypothesis csv is written with bop_io.save_bop_csv (two
instances, three hypotheses each, the cubes of the fixture's models/ near
its two pasted objects); both CLIs refine it with n_refine_iterations=2 and
min_score=0, with the same seeded variables (tests/test_torch_refiner.py:
jax_vars, a random pose head and BatchNorm statistics) in both packages'
nets. Their refined csvs hold the same rows in the same order, scene_id,
im_id and obj_id exact, R within 2e-4, t within 2e-4 relative (and 0.01
mm), scores within 2e-4: the refiner's own tolerance
(tests/test_torch_refiner.py), whose cause is the crops' last bits. Both
CLIs refine each batch in one chunk (refine.py:95).

The MegaPose refiner (refiner_type=megapose, GIGAPOSE_TINY: WideResNet-34
width 0.125, 60x80, 8 points) on the same csv, and coarse_mode=so3grid
(the fixture's CNOS detections, the 576-rotation grid, one refine
iteration) with the same numpy-made variables in both packages
(tests/test_torch_megapose.py:tiny_megapose_nets): the same rows, R and
scores within 2e-4, t within 2e-4 relative (the MegaPose refiner's
tolerance there).
"""

import os
import os.path as osp
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import refine as jax_refine
from gigapose_tpu.refiner import megapose_refiner as jax_megapose
from gigapose_tpu.refiner import refiner as jax_refiner
from gigapose_tpu.refiner.network import CoarseScorerNet as JScorer
from gigapose_tpu.refiner.network import RefinerNet as JRefiner
from gigapose_tpu.scripts.train_refiner import save_refiner_checkpoint as jax_save_refiner
from gigapose_tpu_torch import refine
from gigapose_tpu_torch.dataloader import bop_io
from gigapose_tpu_torch.models.convert import refiner_flax_to_torch
from tests import synthetic_bop
from tests.test_torch_megapose import load_bridged_, tiny_megapose_nets
from tests.test_torch_refiner import jax_vars

K = np.array([[572.4114, 0, 320], [0, 573.57043, 240], [0, 0, 1.0]])
NAME = "large-pbrreal-rgb-mmodel_tudl-test_{}.csv"
TOL = 2e-4


def _coarse_csv(root, obj_ids=(1, 2), scores=((0.6, 0.5, 0.4), (0.2, 0.15, 0.1)),
                name="coarse.csv"):
    """The fixture's image 0: per instance three hypotheses (rotations a few
    degrees apart, the cube 0.5 m away behind its pasted square's centre)."""
    rng = np.random.default_rng(0)
    rows = []
    for iid, ((cy, cx), obj_id, sc) in enumerate(zip(((160, 440), (340, 140)), obj_ids, scores)):
        t = np.array([(cx - K[0, 2]) * 500 / K[0, 0], (cy - K[1, 2]) * 500 / K[1, 1], 500.0])
        for h, s in enumerate(sc):
            R = Rotation.from_euler("xyz", rng.uniform(-0.3, 0.3, 3) + [0.4, 0.2 * h, 0.1])
            rows.append(dict(scene_id=1, im_id=0, obj_id=obj_id, score=s, time=0.5,
                             R=R.as_matrix(), t=t + rng.normal(0, 5, 3), instance_id=iid))
    path = osp.join(root, name)
    bop_io.save_bop_csv(path, rows, extra_column="instance_id")
    return path


def _jax_create(mesh_paths, seed=0, config=jax_refiner.RefinerConfig(), refiner_width=64,
                scorer_width=32):
    rnet, snet = JRefiner(width=refiner_width), JScorer(width=scorer_width)
    return jax_refiner.RenderCompareRefiner(
        rnet, jax_vars(rnet, 1), snet, jax_vars(snet, 4),
        jax_refiner.MeshStore(mesh_paths, config.n_sample_points), config)


@pytest.fixture
def weights(monkeypatch):
    """The same seeded variables in both CLIs' refiners (the JAX create
    skips flax's init, which takes tens of seconds on the CPU)."""
    build = refine.build_refiner

    def port_build(cfg, mesh_paths, tiny=False):
        ref = build(cfg, mesh_paths, tiny)
        ref.refiner_net.load_state_dict(refiner_flax_to_torch(jax_vars(JRefiner(width=8), 1)))
        ref.scorer_net.load_state_dict(refiner_flax_to_torch(jax_vars(JScorer(width=8), 4)))
        return ref

    monkeypatch.setattr(jax_refiner.RenderCompareRefiner, "create", staticmethod(_jax_create))
    monkeypatch.setattr(refine, "build_refiner", port_build)
    monkeypatch.setenv("GIGAPOSE_TINY", "1")


@pytest.fixture
def megapose_weights(monkeypatch):
    """The same numpy-made MegaPose variables in both CLIs' refiners."""
    def jax_create(cls, mesh_paths, seed=0, config=jax_megapose.MegaposeRefinerConfig(),
                   layers=None, width=1.0):
        rnet, rv, cnet, cv = tiny_megapose_nets(config, width)
        return cls(rnet, rv, cnet, cv, jax_refiner.MeshStore(mesh_paths, config.n_sample_points),
                   config)

    build = refine.build_megapose_refiner

    def port_build(cfg, mesh_paths, tiny=False):
        port = build(cfg, mesh_paths, tiny)
        _, rv, _, cv = tiny_megapose_nets(port.config)
        return load_bridged_(port, rv, cv)

    monkeypatch.setattr(jax_megapose.MegaposeRefiner, "create", classmethod(jax_create))
    monkeypatch.setattr(refine, "build_megapose_refiner", port_build)
    monkeypatch.setenv("GIGAPOSE_TINY", "1")


def _refined(root, tag):
    return bop_io.load_bop_csv(osp.join(root, tag, "predictions_refined", NAME.format(tag)))


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("scene_id", "im_id", "obj_id"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["score"], w["score"], atol=TOL)
        np.testing.assert_allclose(g["R"], w["R"], atol=TOL, rtol=0)
        np.testing.assert_allclose(g["t"], w["t"], rtol=TOL, atol=1e-2)
        assert np.abs(g["R"] @ g["R"].T - np.eye(3)).max() < 1e-5


@pytest.mark.parametrize("mode", ["csv", "so3grid"])
def test_megapose_refine_cli_writes_the_jax_csv(tmp_path, megapose_weights, mode):
    """refiner_type=megapose on the coarse csv (2 iterations), and
    coarse_mode=so3grid so3_grid_size=576 (1 iteration; the JAX package's
    tests/test_cli.py:test_cli_so3grid_coarse_refine): the rows of
    refine.py."""
    root = synthetic_bop.build(str(tmp_path))
    common = [f"machine.root_dir={root}", "test_dataset_name=tudl"]
    if mode == "csv":
        common += ["refiner_type=megapose", "n_refine_iterations=2", "min_score=0",
                   f"init_loc_path={_coarse_csv(root)}"]
    else:
        common += ["coarse_mode=so3grid", "so3_grid_size=576", "n_refine_iterations=1"]
    jax_refine.main(common + ["run_id=jax", f"save_dir={root}/jax"])
    paths, timing = refine.main(common + ["run_id=port", f"save_dir={root}/port", "device=cpu"])
    assert paths == [osp.join(root, "port", "predictions_refined", NAME.format("port"))]
    got, want = _refined(root, "port"), _refined(root, "jax")
    assert len(got) >= 1
    _same_rows(got, want)
    if mode == "csv":
        assert timing["images"] == 1 and timing["hypotheses"] == 6 and len(got) == 2
    else:
        assert timing["images"] >= 1 and timing["detections"] == len(got)


def test_refine_cli_writes_the_jax_csv(tmp_path, weights):
    root = synthetic_bop.build(str(tmp_path))
    coarse = _coarse_csv(root)
    common = [f"machine.root_dir={root}", "test_dataset_name=tudl", "n_refine_iterations=2",
              "min_score=0", f"init_loc_path={coarse}"]
    jax_refine.main(common + ["run_id=jax", f"save_dir={root}/jax"])
    paths, timing = refine.main(common + ["run_id=port", f"save_dir={root}/port", "device=cpu"])
    assert paths == [osp.join(root, "port", "predictions_refined", NAME.format("port"))]
    assert timing["images"] == 1 and timing["hypotheses"] == 6
    got, want = _refined(root, "port"), _refined(root, "jax")
    assert len(got) == len(want) == 2  # one row per instance
    _same_rows(got, want)
    # the refiner moved a pose: a refined row that is none of its coarse
    # hypotheses (keep_best_init may keep a hypothesis as it was)
    hyps = bop_io.load_bop_csv(coarse, extra_column="instance_id")
    gaps = [min(np.abs(g["R"] - h["R"]).max() for h in hyps if h["obj_id"] == g["obj_id"])
            for g in got]
    assert max(gaps) > 1e-2, gaps


def test_refine_cli_drops_weak_instances_and_refuses(tmp_path, monkeypatch):
    """min_score (default 0.25) drops an instance whose best hypothesis is
    weaker; refine_pipeline_chunks=2 writes the rows of one chunk, and
    raises with the device renderer or the MegaPose refiner; the MegaPose
    options no longer raise; a hypothesis of an object without a mesh
    raises ValueError naming both. refiner_checkpoint= serves the JAX
    refiner trainer's orbax checkpoint (its save_refiner_checkpoint of
    other seeded nets than the CLIs build): the rows of refine.py serving
    the same directory."""
    root = synthetic_bop.build(str(tmp_path))
    monkeypatch.setenv("GIGAPOSE_TINY", "1")
    base = [f"machine.root_dir={root}", "test_dataset_name=tudl",
            f"init_loc_path={_coarse_csv(root)}", "n_refine_iterations=1"]
    paths, timing = refine.main(base + ["device=cpu", "run_id=weak", f"save_dir={root}/weak"])
    rows = bop_io.load_bop_csv(paths[0])
    assert [r["obj_id"] for r in rows] == [1] and timing["hypotheses"] == 3
    if not torch.cuda.is_available():
        for megapose in ([], ["refiner_type=megapose"], ["coarse_mode=so3grid"]):
            with pytest.raises(RuntimeError, match="device=cpu"):
                refine.main(base + megapose)
    # the pipelined host loop: each batch in two chunks, the same rows
    chunked, _ = refine.main(base + ["device=cpu", "run_id=weak", f"save_dir={root}/chunks",
                                     "refine_pipeline_chunks=2"])
    got = bop_io.load_bop_csv(chunked[0])
    assert len(got) == len(rows) == 1
    for g, w in zip(got, rows):
        assert (g["scene_id"], g["im_id"], g["obj_id"]) == (w["scene_id"], w["im_id"], w["obj_id"])
        for key in ("score", "R", "t"):
            np.testing.assert_allclose(g[key], w[key], atol=1e-6, rtol=1e-6)
    for option in ("refine_renderer=device", "refiner_type=megapose"):
        with pytest.raises(ValueError, match="refine_pipeline_chunks"):
            refine.main(base + ["device=cpu", "refine_pipeline_chunks=2", option])
    orbax = osp.join(root, "orbax")
    jax_save_refiner(orbax, SimpleNamespace(refiner_vars=jax_vars(JRefiner(width=8), 2),
                                            scorer_vars=jax_vars(JScorer(width=8), 5)))
    monkeypatch.setattr(jax_refiner.RenderCompareRefiner, "create", staticmethod(_jax_create))
    served = base + ["min_score=0", f"refiner_checkpoint={orbax}"]
    jax_refine.main(served + ["run_id=jax", f"save_dir={root}/jax"])
    refine.main(served + ["device=cpu", "run_id=port", f"save_dir={root}/port"])
    got, want = _refined(root, "port"), _refined(root, "jax")
    assert len(got) == 2
    _same_rows(got, want)
    with pytest.raises(FileNotFoundError, match="ckpt"):  # the port's checkpoint is read
        refine.main(base + ["device=cpu", f"refiner_checkpoint={root}/ckpt.pt"])
    for option in ("megapose_refiner_ckpt=x", "megapose_coarse_ckpt=x",
                   "refiner_type=megapose", "coarse_mode=so3grid"):
        with pytest.raises(ValueError, match="renders on the host"):  # not "A13b"
            refine.main(base + ["device=cpu", option, "refine_renderer=device"])
    with pytest.raises(FileNotFoundError, match="x"):  # the checkpoint is read
        refine.main(base + ["device=cpu", "megapose_refiner_ckpt=x"])
    for unread in ("vis_every=5", "model.optim.ae_lr=1.0e-4", "coarse_mode=grid"):
        with pytest.raises(ValueError, match=unread.split("=")[0]):
            refine.main(base + ["device=cpu", unread])
    missing = _coarse_csv(root, obj_ids=(1, 3), name="missing.csv")
    models = osp.join(root, "datasets", "tudl", "models")
    with pytest.raises(ValueError, match=f"obj_id 3 .*{models}"):
        refine.main(base + ["device=cpu", f"init_loc_path={missing}", "min_score=0"])
    monkeypatch.setenv("GIGAPOSE_COORDINATOR", "localhost:1234")  # without its companions
    with pytest.raises(ValueError, match="GIGAPOSE_NUM_PROCESSES, GIGAPOSE_PROCESS_ID"):
        refine.main(base + ["device=cpu"])
    assert not os.environ.get("GIGAPOSE_DISTRIBUTED")
