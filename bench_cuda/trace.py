"""The traced slice of a ``--trace 1`` run: torch.profiler over a short
steady part of the window, reduced to what the per-layer metrics and the
``breakdown`` read.

Device-busy time is the union of the device's activity intervals (kernels,
copies, sets), never a sum of self times: a sum counts twice whatever two
streams run at once (the serving engine uploads on one stream while it
computes on another). Each port kernel's launches in the trace are counted
by the device-kernel names in ``kernels/<kernel>.json`` and held against the
port's own launch counters (``ops.cuda.launches()``): a trace that holds
fewer launches than the port counted has dropped kernels, and the run fails
rather than report a busy time that is too low. The summary also keeps the
program's spans in the slice, reduced by ``spans.reduce``, for the readers
of ``spans.kind_share``, ``host_wait_share`` and ``slowdown``.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import re
import time
import warnings

from bench_cuda import spans


class TraceMismatch(RuntimeError):
    """The trace holds fewer launches of a port kernel than the port
    counted, or a kernel launched that no ``kernels/*.json`` names."""


def kernel_table(bench_dir: str) -> dict:
    """{port kernel: (launch regex, [regexes of kernels that a launch may
    add right after it on its stream])} from ``kernels/<kernel>.json``."""
    table = {}
    for path in sorted(glob.glob(os.path.join(bench_dir, "kernels",
                                              "*.json"))):
        with open(path) as f:
            entry = json.load(f)
        name = os.path.basename(path)[:-len(".json")]
        table[name] = (re.compile(entry["launch"]),
                       [re.compile(r) for r in entry.get("with", [])])
    return table


def short_name(name: str) -> str:
    """A device kernel's name without its return type and arguments."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)", "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:120]


class Slice:
    """torch.profiler over one slice of a run. ``start()`` and ``stop()``
    bracket it; ``stop()`` waits for the device first, so every kernel
    launched inside the slice has ended in it."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.events = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        extra = {}
        try:  # the serving engine launches from threads of its own
            from torch._C._profiler import _ExperimentalConfig

            extra = {"experimental_config": _ExperimentalConfig(
                profile_all_threads=True)}
        except (ImportError, TypeError):
            extra = {}
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        self._sync()
        self.prof = profile(activities=acts, **extra)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.events = list(self.prof.profiler.kineto_results.events())
        self.prof = None


def warm_profiler(device) -> None:
    """Start and stop the profiler once in set-up, so that the slice does not
    pay the tracer's first start."""
    import torch

    s = Slice(device)
    s.start()
    torch.ones(8, device=device).sum()
    s.stop()


def _union(intervals):
    """Merged [start, end) intervals of a list sorted by start."""
    merged = []
    for start, end in intervals:
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def summarize(sl: Slice, table: dict, counted: dict,
              max_scan: int = 4000) -> dict:
    """Reduce a stopped slice.

    counted: {port kernel: launches the port counted inside the slice}.
    Returns {"busy_s", "window_s", "kernels": {port kernel: {"launches",
    "seconds"}}, "device_ops", "idle_gaps", "launch_check", "spans":
    ``spans.reduce`` of the slice's events}. Raises
    TraceMismatch when a port kernel launched more often than the trace
    shows, or launched with no entry in ``table``."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in sl.events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((start, end, e.name(), e.device_resource_id()))
        elif e.device_type() == DeviceType.CPU and e.duration_ns() > 0:
            host.append((start, end, e.name()))
    dev.sort()
    host.sort()
    merged = _union([(s, e) for s, e, _, _ in dev])
    busy_ns = sum(e - s for s, e in merged)

    by_name: dict = {}
    for s, e, name, _ in dev:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0) + (e - s)
    device_ops = sorted(([k, v / 1e9] for k, v in by_name.items()),
                        key=lambda kv: -kv[1])[:10]

    # port kernels: a launch is its first device kernel; the kernels a
    # launch adds (a split reduction) follow it on its stream
    kernels = {name: {"launches": 0, "seconds": 0.0} for name in table}
    current: dict = {}
    for s, e, name, stream in dev:
        owner = None
        for kname, (launch, _) in table.items():
            if launch.search(name):
                owner = kname
                kernels[kname]["launches"] += 1
                break
        if owner is None:
            prev = current.get(stream)
            if prev is not None and any(r.search(name)
                                        for r in table[prev][1]):
                owner = prev
        current[stream] = owner
        if owner is not None:
            kernels[owner]["seconds"] += (e - s) / 1e9

    check = {}
    for kname, n in counted.items():
        if n <= 0:
            continue
        if kname not in table:
            raise TraceMismatch(
                f"port kernel {kname} launched {n} times in the traced "
                f"slice, and no kernels/{kname}.json names its device "
                "kernel")
        traced = kernels[kname]["launches"]
        check[kname] = [traced, n]
        if traced < n:
            raise TraceMismatch(
                f"the trace holds {traced} launches of {kname}, the port "
                f"counted {n}: the profiler dropped kernels, so the busy "
                "time it gives is too low")

    # idle gaps between the merged intervals, named by the innermost host
    # operation running at the gap's midpoint (nested operations: the
    # latest-starting one that still covers it)
    starts = [h[0] for h in host]
    reach, top = [], -1  # reach[i]: the latest end among host[0..i]
    for h in host:
        top = max(top, h[1])
        reach.append(top)
    named: dict = {}
    for i in range(len(merged) - 1):
        g0, g1 = merged[i][1], merged[i + 1][0]
        mid = (g0 + g1) // 2
        label = "no host operation traced"
        j = bisect.bisect_right(starts, mid) - 1
        for _ in range(max_scan):
            if j < 0 or reach[j] < mid:
                break
            if host[j][1] >= mid:
                label = host[j][2]
                break
            j -= 1
        named[label] = named.get(label, 0) + (g1 - g0)
    idle_gaps = sorted(([k, v / 1e9] for k, v in named.items()),
                       key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_ns / 1e9, "window_s": sl.t1 - sl.t0,
            "kernels": kernels, "device_ops": device_ops,
            "idle_gaps": idle_gaps, "launch_check": check,
            "spans": spans.reduce(sl.events)}
