"""prep.ms_per_det: host milliseconds of request prep (`CoarseRunner.
prepare_batch`: the uploads, crops, normalisation and masks of
`pipeline/runner.py:prepare_batch` and `ops/crop.py`) per real detection,
from a span around the runner's method, over the window's images outside
the profiled sub-window. Moves dets_per_s."""


def install(tr, driver):
    tr.wrap(driver.runner, "prepare_batch", "bench.prep")


def read(tr, driver):
    dets = tr.counters.get("dets_plain", 0)
    if not dets or "bench.prep" not in tr.host:
        return None
    return tr.host["bench.prep"] / dets * 1e3
