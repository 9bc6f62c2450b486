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
                     "gigapose_tpu_torch.ops.qmm", "gigapose_tpu_torch.models.vit_int8"):
        assert expected in result["modules"]


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
