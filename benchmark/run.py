"""One run of one benchmark cell of the PyTorch and CUDA port:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (inputs and weights from the seed, the program built, the store
onboarded, every shape warmed), then a measured window of --seconds, then
the check of what the window produced against the plain reference. The last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), device, and with --trace 1 breakdown; its last
key, `compared`, holds each number compared with its limit, which the last
lines of standard error repeat.

It runs only on a CUDA card and never falls back to the CPU. It exits with
another code than 0 and prints no result when no card is there, when the
program or a file of the benchmark is missing, or when a module of JAX or
of the JAX package was loaded. `--control <name>` puts one of the
configuration's controls (a lower precision, or a planted fault) in the
program's place, for setting limits; the benchmark's own runs never do.
"""

import time

T_START = time.time()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "gigapose_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of FORBIDDEN: `gigapose_tpu_torch` is not `gigapose_tpu`."""
    return sorted({name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default="", help="a name under the configuration's "
                   "checks.<kind>.controls: that control in the program's place")
    return p.parse_args(argv)


def measure(plan, seed: int, seconds: float, trace: bool, control: str, device) -> dict:
    """Set-up, the window and the check of one run of `plan`'s cell on
    `device` -> the result line's object. `main` passes the card; the CPU
    tests pass tiny plans and the CPU."""
    import torch

    from benchmark.trace import Tracer

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    checks = plan.config["checks"][plan.traffic["kind"]]
    tracer = Tracer(trace, plan.metric_modules.values())
    driver = plan.driver.Driver(plan.config, plan.traffic, seed, device, tracer,
                                control=checks["controls"][control] if control else None)
    driver.setup()
    sync()
    setup_s = time.time() - T_START
    driver.window(seconds)
    sync()
    e2e = driver.end_to_end()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tracer.after_window(driver)
    driver.free_program()
    t_judge = time.time()
    numbers = driver.judge()
    driver.counters["judge_s"] = time.time() - t_judge
    limits = checks["limits"]
    compared = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    failed = int(e2e.get("failed", 0))
    correct = failed == 0 and all(c["limit"] is not None and c["value"] <= c["limit"]
                                  for c in compared.values())
    if trace:
        metrics = {}
        for m in plan.per_layer:
            v = plan.metric_modules[m["name"]].read(tracer, driver)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in plan.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(plan.workload["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(e2e["attempted"]), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=tracer.busy_s, window_s=tracer.window_s)
        out["breakdown"] = tracer.breakdown
    out["info"] = {k: v for k, v in numbers.items() if k not in limits} | driver.counters
    out["compared"] = compared
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark.plan import make_plan

    plan = make_plan(ROOT, args.workload)
    chips = int(plan.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {chips} CUDA card(s) needed, {n} found; nothing measured",
              file=sys.stderr)
        return 2
    out = measure(plan, args.seed, args.seconds, bool(args.trace), args.control,
                  torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    for k, c in out["compared"].items():
        print(f"compared {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
