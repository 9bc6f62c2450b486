"""ist.device_ms_per_det: device milliseconds of the IST (`models/
ist_net.py`: the backbone's features and the per-correspondence
regression) per real detection, from spans around `ist_net.features` and
`ist_net.regress`, in the profiled sub-window. Moves dets_per_s."""


def install(tr, driver):
    ist = driver.runner.estimator.ist_net
    tr.wrap(ist, "features", "bench.ist")
    tr.wrap(ist, "regress", "bench.ist")


def read(tr, driver):
    t, dets = tr.device.get("bench.ist"), tr.counters.get("dets_traced", 0)
    if not t or not dets:
        return None
    return t / dets * 1e3
