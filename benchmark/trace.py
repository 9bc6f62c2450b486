"""Spans, counters and the device trace of a `--trace 1` run.

Spans come from the benchmark's own wrappers, installed on the program's
objects by the per-layer metric files (`benchmark/metrics/*.py`): each
span is a `torch.profiler.record_function` range and a host-clock interval.
The profiler records a sub-window of the measured window (`profile_on` /
`profile_off`), so that its events stay few; the host-clock spans count
only outside that sub-window, since the profiler slows the host.

Reduction of the trace: a kernel (or copy, or memset) belongs to a span when
the host call that launched it (same correlation id) lies inside the span;
the device is busy where any of them runs; an idle gap is named by the
innermost host operation running at its start.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


class Tracer:
    def __init__(self, enabled: bool, metrics=()):
        self.enabled = enabled
        self.metrics = list(metrics)  # the cell's per-layer metric modules
        self.current = None  # the request in flight (set by the driver)
        self.profiling = False
        self.host = defaultdict(float)  # span -> host seconds outside the profiled sub-window
        self.counters: Dict[str, float] = defaultdict(float)
        self.device: Dict[str, float] = {}  # span -> device seconds (profiled sub-window)
        self.busy_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.breakdown: Optional[dict] = None
        self._prof = None
        self._t_on = 0.0
        self._names = set()

    def install(self, driver) -> None:
        """Each metric file's `install(tracer, driver)`, in a traced run."""
        if self.enabled:
            for mod in self.metrics:
                if hasattr(mod, "install"):
                    mod.install(self, driver)

    def after_window(self, driver) -> None:
        """Each metric file's `after_window(tracer, driver)`, in a traced
        run, after the window and before the program is freed."""
        if self.enabled:
            for mod in self.metrics:
                if hasattr(mod, "after_window"):
                    mod.after_window(self, driver)

    def start_window(self) -> None:
        """Forget the spans of set-up: the host-clock spans count the
        window's calls alone."""
        self.host.clear()

    # -- spans ---------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        self._names.add(name)
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        if not self.profiling:  # the profiler slows the host
            self.host[name] += time.perf_counter() - t0

    def wrap(self, obj, attr: str, name: str) -> None:
        """obj.attr(...) inside span `name` (an instance attribute shadows
        a method; a module attribute replaces a function at its call site)."""
        if not self.enabled:
            return
        fn = getattr(obj, attr)

        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)

        setattr(obj, attr, wrapped)

    def hook_module(self, module: torch.nn.Module, name: str) -> None:
        """module's forward inside span `name`, by forward hooks."""
        if not self.enabled:
            return
        stack: List = []

        def pre(m, args):
            cm = self.span(name)
            cm.__enter__()
            stack.append(cm)

        def post(m, args, out):
            stack.pop().__exit__(None, None, None)

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)

    # -- the profiled sub-window ---------------------------------------------
    def warm_profiler(self) -> None:
        """Start and stop the profiler once (set-up of a traced run), so
        that its first start does not fall into the window."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def profile_on(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self.profiling = True
        self._t_on = time.perf_counter()

    def profile_off(self) -> None:
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t_on
        self._prof.stop()
        self.profiling = False
        self._reduce(self._prof)
        self._prof = None

    def _reduce(self, prof) -> None:
        events = prof.profiler.kineto_results.events()
        dev, cpu, launch = [], [], {}
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.duration_ns() > 0 and not e.is_user_annotation():
                    dev.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
            else:
                cpu.append((e.start_ns(), e.end_ns(), e.name()))
                if e.correlation_id():
                    launch[e.correlation_id()] = e.start_ns()
        # busy: the union of device intervals
        dev.sort()
        busy, cur_s, cur_e, gaps = 0, None, None, []
        for s, e, _, _ in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        self.busy_s = busy / 1e9
        # device seconds per span: kernels whose launch lies inside the span
        spans = sorted((s, e, n) for s, e, n in cpu if n in self._names)
        starts = [s for s, _, _ in spans]
        per_span = defaultdict(float)
        per_op = defaultdict(float)
        for s, e, name, corr in dev:
            per_op[name] += (e - s) / 1e9
            t = launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t)
            seen = set()
            for j in range(i - 1, max(i - 64, -1), -1):
                ss, se, sn = spans[j]
                if ss <= t <= se and sn not in seen:
                    per_span[sn] += (e - s) / 1e9
                    seen.add(sn)
        self.device = dict(per_span)
        # idle gaps by the innermost host op running where each gap starts
        cpu.sort()
        cstarts = [s for s, _, _ in cpu]
        idle = defaultdict(float)
        for gs, ge in gaps:
            i = bisect.bisect_right(cstarts, gs)
            name = "no_host_op"
            for j in range(i - 1, max(i - 512, -1), -1):
                s, e, n = cpu[j]
                if s <= gs < e:
                    name = n
                    break
            idle[name] += (ge - gs) / 1e9
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        self.breakdown = {"device_ops": top(per_op), "idle_gaps": top(idle)}
