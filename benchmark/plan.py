"""A cell's plan, found by name from BENCHMARK.json: its configuration file,
its traffic file, the driver the traffic's `kind` names, the end-to-end
metrics it reports and the per-layer metric files it reads. A later change
adds a configuration, a mix or a metric by adding files and entries; this
file needs no edit for them.

Files: `<paths>/configs/<name>.json` (the entry's `file`),
`benchmark/traffic/<traffic>.json`, `benchmark/drivers/<kind>.py`,
`benchmark/metrics/<metric name>.py`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os.path as osp
from types import ModuleType
from typing import Dict, List


@dataclasses.dataclass
class Plan:
    workload: dict
    config: dict
    traffic: dict
    driver: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    metric_modules: Dict[str, ModuleType]


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def make_plan(root: str, cell: str) -> Plan:
    with open(osp.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    wl = {w["name"]: w for w in spec["workloads"]}.get(cell)
    if wl is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    with open(osp.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    here = osp.join(root, "benchmark")
    with open(osp.join(here, "traffic", f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    driver = load_module(osp.join(here, "drivers", f"{traffic['kind']}.py"),
                         f"benchmark_driver_{traffic['kind']}")
    e2e = [m for m in spec["end_to_end"] if _applies(m, cell, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, cell, names)]
    mods = {m["name"]: load_module(osp.join(here, "metrics", f"{m['name']}.py"),
                                   "benchmark_metric_" + m["name"].replace(".", "_"))
            for m in per_layer}
    return Plan(wl, config, traffic, driver, e2e, per_layer, mods)
