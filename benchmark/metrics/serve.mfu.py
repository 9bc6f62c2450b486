"""serve.mfu: the whole coarse step's share of the card's bf16 dense peak
(%), for both serving precisions: the useful operations of the real
detections of the profiled sub-window (AE and IST forwards, regression of
k x P correspondences, matching against every view; benchmark/work.py;
padding is not useful work) over that sub-window's time x 989e12. Moves
dets_per_s."""

from benchmark import work


def read(tr, driver):
    dets = tr.counters.get("dets_traced", 0)
    if not dets or not tr.window_s:
        return None
    ops = dets * work.serve_ops_per_detection(driver.cfg["model"])
    return 100.0 * ops / (tr.window_s * work.PEAK_OPS["bf16"])
