"""ae_roofline: the AE's share of its roofline (%), in the profiled
sub-window: the least time of the ViT forward's work at the padded batch
(benchmark/work.py: operations over the peak of the configuration's
serving precision, int8 or bf16; or the weights and the crops and features
over the memory rate) over the device time of the kernels launched inside
the AE's span (forward hooks on `estimator.ae_net`). Moves dets_per_s."""

from benchmark import work


def install(tr, driver):
    tr.hook_module(driver.runner.estimator.ae_net, "bench.ae")


def read(tr, driver):
    t = tr.device.get("bench.ae")
    m = driver.cfg["model"]
    B, calls = tr.counters.get("padded_traced", 0), tr.counters.get("images_traced", 0)
    if not t or not B:
        return None
    kind = "int8" if m["serving_quant"] == "int8" else "bf16"
    P = (m["crop_size"] // m["patch_size"]) ** 2
    nbytes = calls * work.vit_weight_bytes(m, 1 if kind == "int8" else 2) \
        + B * (3 * m["crop_size"] ** 2 + P * m["embed_dim"]) * 4
    return 100.0 * work.least_seconds(B * work.vit_forward_ops(m), kind, nbytes) / t
