"""matching_roofline: the matching kernel's share of its roofline (%), in
the profiled sub-window: the least time of each launch's work (benchmark/
work.py:matching_work at the padded batch, V, P and C, over the labelled
objects' views; bf16 products for a bf16 store) over the device time of the
kernels launched inside the span around the estimator's call of
`fused_match_templates`. Moves dets_per_s."""

import numpy as np

from benchmark import work


def install(tr, driver):
    from gigapose_tpu_torch.pipeline import estimator

    fn = estimator.fused_match_templates
    m = driver.cfg["model"]
    kind = "bf16" if m["feature_dtype"] == "bf16" else "tf32"

    def wrapped(tar, *a, **kw):
        if tr.profiling:
            objects = len(np.unique(tr.current.labels))
            ops, nbytes = work.matching_work(m, tar.shape[0], objects)
            tr.counters["match_least_s"] += work.least_seconds(
                ops * (3 if kind == "tf32" else 1), kind, nbytes)
        with tr.span("bench.match"):
            return fn(tar, *a, **kw)

    estimator.fused_match_templates = wrapped


def read(tr, driver):
    t = tr.device.get("bench.match")
    if not t or not tr.counters.get("match_least_s"):
        return None
    return 100.0 * tr.counters["match_least_s"] / t
