"""train.prep_ms_per_step: milliseconds of training batch prep
(`dataloader/train_set.py:prepare_train_batch`: the upload of the host
records, crops, correspondences) per step, by the host clock around the
driver's call of it between two synchronizes: the previous step's kernels
end before the span opens (the pageable upload would wait for them inside
it) and the prep's own kernels end inside it. Over the traced run's steps
outside the profiled sub-window, which runs the call untouched so that the
synchronizes do not idle the card there. Moves train_pairs_per_s."""

import torch


def install(tr, driver):
    fn = driver.prepare

    def prepare(*a, **kw):
        if tr.profiling:
            return fn(*a, **kw)
        torch.cuda.synchronize()
        with tr.span("bench.train_prep"):
            out = fn(*a, **kw)
            torch.cuda.synchronize()
        return out

    driver.prepare = prepare


def read(tr, driver):
    steps = tr.counters.get("steps_plain", 0)
    if not steps or "bench.train_prep" not in tr.host:
        return None
    return tr.host["bench.train_prep"] / steps * 1e3
