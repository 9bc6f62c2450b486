"""The port imports neither jax nor the JAX package.

The GPU machine that runs the port has PyTorch and the CUDA toolkit but no
jax, flax, PIL or yaml, and every gigapose_tpu sub-package pulls jax in
through its __init__. A fresh interpreter imports every gigapose_tpu_torch
module and chip_smoke, then reports which of those names reached sys.modules.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "PIL", "yaml", "gigapose_tpu")

SCRIPT = r"""
import importlib, json, pkgutil, sys
import gigapose_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(gigapose_tpu_torch.__path__, "gigapose_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
forbidden = %r
leaked = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
print(json.dumps({"modules": mods, "leaked": leaked}))
"""


def test_port_imports_no_jax_pil_yaml_or_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT % (FORBIDDEN,)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["leaked"] == [], result["leaked"]
    for expected in ("gigapose_tpu_torch.ops.fused_matching", "gigapose_tpu_torch.kernels.build",
                     "gigapose_tpu_torch.pipeline.estimator", "gigapose_tpu_torch.models.convert",
                     "gigapose_tpu_torch.ops.qmm", "gigapose_tpu_torch.models.vit_int8",
                     "gigapose_tpu_torch.cli", "gigapose_tpu_torch.pipeline.runner",
                     "gigapose_tpu_torch.dataloader.png", "gigapose_tpu_torch.dataloader.bop_io",
                     "gigapose_tpu_torch.dataloader.jpeg", "gigapose_tpu_torch.dataloader.tiff",
                     "gigapose_tpu_torch.scripts.convert_to_shards",
                     "gigapose_tpu_torch.dataloader.scene", "gigapose_tpu_torch.dataloader.test_set",
                     "gigapose_tpu_torch.dataloader.templates_disk",
                     "gigapose_tpu_torch.utils.config", "gigapose_tpu_torch.utils.logging",
                     "gigapose_tpu_torch.utils.timer", "gigapose_tpu_torch.render.mesh_io",
                     "gigapose_tpu_torch.render.rasterizer", "gigapose_tpu_torch.render.rasterize",
                     "gigapose_tpu_torch.refiner.ops", "gigapose_tpu_torch.refiner.network",
                     "gigapose_tpu_torch.refiner.device_render",
                     "gigapose_tpu_torch.refiner.refiner", "gigapose_tpu_torch.refiner.runner",
                     "gigapose_tpu_torch.refine", "gigapose_tpu_torch.render.templates",
                     "gigapose_tpu_torch.scripts.render_templates",
                     "gigapose_tpu_torch.scripts.eval_bop", "gigapose_tpu_torch.eval.errors",
                     "gigapose_tpu_torch.eval.scorer", "gigapose_tpu_torch.train",
                     "gigapose_tpu_torch.training.state", "gigapose_tpu_torch.training.loop",
                     "gigapose_tpu_torch.training.validate",
                     "gigapose_tpu_torch.training.checkpoint",
                     "gigapose_tpu_torch.dataloader.augment",
                     "gigapose_tpu_torch.dataloader.keypoints",
                     "gigapose_tpu_torch.dataloader.train_set",
                     "gigapose_tpu_torch.models.losses", "gigapose_tpu_torch.lib3d.geometry",
                     "gigapose_tpu_torch.utils.prefetch", "gigapose_tpu_torch.utils.metrics",
                     "gigapose_tpu_torch.utils.weight", "gigapose_tpu_torch.refiner.megapose_net",
                     "gigapose_tpu_torch.refiner.megapose_refiner",
                     "gigapose_tpu_torch.refiner.multiview", "gigapose_tpu_torch.refiner.so3_grid",
                     "gigapose_tpu_torch.refiner.depth_refiner",
                     "gigapose_tpu_torch.parallel.multihost", "gigapose_tpu_torch.parallel.mesh",
                     "gigapose_tpu_torch.parallel.sharded_store",
                     "gigapose_tpu_torch.models.flax_bn"):
        assert expected in result["modules"]


CLI_SCRIPT = r"""
import json, os, sys
jax_dir = os.path.join(%r, "gigapose_tpu") + os.sep
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0])) if event == "open" else None)
from gigapose_tpu_torch import %s as entry
entry.main(sys.argv[1:])
forbidden = %r
leaked = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
print(json.dumps({"leaked": leaked,
                  "jax_files": sorted({p for p in opened if os.path.abspath(p).startswith(jax_dir)}),
                  "port_configs": sorted({os.path.basename(p) for p in opened if "configs" in p})}))
"""


def test_port_cli_run_reads_nothing_of_the_jax_package(tmp_path):
    """A whole CLI run (GIGAPOSE_TINY, CPU) on the synthetic fixture opens no
    file under gigapose_tpu/ (the port has its own config files) and loads
    no forbidden module."""
    from tests import synthetic_bop

    root = synthetic_bop.build(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["GIGAPOSE_TINY"] = "1"
    out = subprocess.run(
        [sys.executable, "-c", CLI_SCRIPT % (str(REPO), "cli", FORBIDDEN), f"machine.root_dir={root}",
         "test_dataset_name=tudl", "device=cpu", "data.template.num_templates=8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"leaked": [], "jax_files": [],  # the hook saw the port's own files:
                      "port_configs": ["bop.yaml", "large.yaml", "local.yaml", "test.yaml"]}


def test_port_train_run_reads_nothing_of_the_jax_package(tmp_path):
    """A tiny training run (GIGAPOSE_TINY, CPU, 2 steps with validation and
    checkpoints) opens no file under gigapose_tpu/ and loads no forbidden
    module: the loader decodes with dataloader/png.py, not PIL."""
    from tests import synthetic_bop

    root = synthetic_bop.build(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(GIGAPOSE_TINY="1", OMP_NUM_THREADS="1")  # tiny nets; the suite runs in parallel
    out = subprocess.run(
        [sys.executable, "-c", CLI_SCRIPT % (str(REPO), "train", FORBIDDEN),
         f"machine.root_dir={root}", "train_dataset_name=tudl", "machine.batch_size=2",
         "max_steps=2", "val_dataset_name=tudl", "val_split=train_pbr", "val_every=2",
         "device=cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"leaked": [], "jax_files": [],
                      "port_configs": ["bop.yaml", "large.yaml", "local.yaml", "train.yaml"]}


def test_port_so3grid_refine_run_reads_nothing_of_the_jax_package(tmp_path):
    """The refine CLI with coarse_mode=so3grid (GIGAPOSE_TINY, CPU, the
    72-rotation grid) reads the SO(3) grid from the port's own assets and
    opens nothing under gigapose_tpu/."""
    from tests import synthetic_bop

    root = synthetic_bop.build(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(GIGAPOSE_TINY="1", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", CLI_SCRIPT % (str(REPO), "refine", FORBIDDEN),
         f"machine.root_dir={root}", "test_dataset_name=tudl", "coarse_mode=so3grid",
         "so3_grid_size=72", "n_refine_iterations=1", "device=cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"leaked": [], "jax_files": [],
                      "port_configs": ["bop.yaml", "large.yaml", "local.yaml", "test.yaml"]}
    grid = REPO / "gigapose_tpu_torch" / "assets" / "so3_grid_72.qua"
    assert grid.read_bytes() == (REPO / "gigapose_tpu" / "assets" / "so3_grid_72.qua").read_bytes()


def test_port_sources_never_import_jax():
    for path in (REPO / "gigapose_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in FORBIDDEN, f"{path}: {line}"
    for line in (REPO / "chip_smoke.py").read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            assert words[1].split(".")[0] not in FORBIDDEN, line
