"""The port's MetricsLogger: the JSONL stream, log_image's PNGs (read back
by the port's own decoder) and the opt-in wandb sink, driven through a stub
`wandb` module (the package is not installed here); without the package
the sink is disabled and the rest still works."""

import json
import os.path as osp
import sys
import types

import numpy as np
import pytest

from gigapose_tpu_torch.dataloader.png import decode_png
from gigapose_tpu_torch.utils.metrics import MetricsLogger


def _images():
    r = np.random.default_rng(0)
    return {"gray": r.integers(0, 256, (7, 9), dtype=np.uint8),
            "train/rgb": r.integers(0, 256, (12, 5, 3), dtype=np.uint8),
            "val/a/rgba": r.integers(0, 256, (4, 6, 4), dtype=np.uint8)}


@pytest.mark.parametrize("name", sorted(_images()))
def test_log_image_writes_a_png_that_reads_back(tmp_path, name):
    image = _images()[name]
    log = MetricsLogger(str(tmp_path))
    path = log.log_image(42, name, image)
    assert path == osp.join(str(tmp_path), "vis", f"{name.replace('/', '_')}_00000042.png")
    np.testing.assert_array_equal(decode_png(open(path, "rb").read()), image)
    with pytest.raises(ValueError, match="uint8"):
        log.log_image(1, name, image.astype(np.float32))
    log.close()


class _StubRun:
    def __init__(self, **kwargs):
        self.init = kwargs
        self.logged, self.finished = [], 0

    def log(self, data, step=None):
        self.logged.append((step, data))

    def finish(self):
        self.finished += 1


def test_wandb_sink_gets_scalars_and_images_and_finishes(tmp_path, monkeypatch):
    runs = []
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: runs.append(_StubRun(**kw)) or runs[-1]
    stub.Image = lambda a: ("image", a.shape)
    monkeypatch.setitem(sys.modules, "wandb", stub)
    log = MetricsLogger(str(tmp_path), use_wandb=True, wandb_project="p", wandb_run_name="r")
    (run,) = runs
    assert run.init == dict(project="p", name="r", dir=str(tmp_path), resume="allow")
    log.log_scalars(3, {"loss": 0.5})
    log.log_image(3, "vis/x", np.zeros((2, 3, 3), np.uint8))
    assert run.logged == [(3, {"loss": 0.5}), (3, {"vis/x": ("image", (2, 3, 3))})]
    assert run.finished == 0
    log.close()
    assert run.finished == 1
    rows = [json.loads(l) for l in open(osp.join(str(tmp_path), "metrics.jsonl"))]
    assert [(r["step"], r["loss"]) for r in rows] == [(3, 0.5)]


def test_wandb_sink_is_disabled_without_the_package(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    log = MetricsLogger(str(tmp_path), use_wandb=True)
    assert log._wandb is None
    log.log_scalars(1, {"loss": 1.0})
    assert osp.exists(log.log_image(1, "x", np.zeros((2, 2), np.uint8)))
    log.close()
    assert [json.loads(l)["loss"] for l in open(osp.join(str(tmp_path), "metrics.jsonl"))] == [1.0]
