"""train.ist_ms_per_step: device milliseconds of the IST's forward and
backward (`models/ist_net.py`, cuDNN f32, training-mode BatchNorm) at the
step's shapes: the IST loss of `training/state.py:compute_losses` (only the
IST trained) and its backward on the window's last batch, timed alone with
CUDA events after the window of the traced run (3 runs after one
warm-up). A layer timed from outside until the program has spans inside
its step. Moves train_pairs_per_s."""

import dataclasses

import torch


def after_window(tr, driver):
    from gigapose_tpu_torch.training.state import compute_losses

    st, batch = driver.state, driver.last_batch
    cfg = dataclasses.replace(st.cfg, nets_to_train="ist")

    def run():
        for p in st.ist_net.parameters():
            p.grad = None
        compute_losses(st.ae_net, st.ist_net, batch, st.step, cfg)[0].backward()

    run()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(3):
        run()
    b.record()
    torch.cuda.synchronize()
    tr.counters["train_ist_ms"] = a.elapsed_time(b) / 3


def read(tr, driver):
    return tr.counters.get("train_ist_ms")
