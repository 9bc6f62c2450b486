"""train.mfu: the training step's share of the card's f32 peak (%), TF32
being off: the f32 operations of the AE and IST backbone forwards on the
2 x batch crops, x 3 for forward and backward (benchmark/work.py), per step,
over the profiled sub-window's time per step x 67e12. Moves
train_pairs_per_s."""

from benchmark import work


def read(tr, driver):
    steps = tr.counters.get("steps_traced", 0)
    if not steps or not tr.window_s:
        return None
    m = driver.cfg["model"]
    ops = 3 * 2 * driver.t["batch_size"] * (work.vit_forward_ops(m) + work.ist_backbone_ops(m))
    return 100.0 * ops * steps / (tr.window_s * work.PEAK_OPS["f32"])
