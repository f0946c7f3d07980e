"""The program's spans in a traced slice: device time and host waits put
down to the ``qcnn.*`` ranges of the port's forwards
(``qcnn_tpu_torch/utils/spans.py``).

A span's kind is its name between ``qcnn.`` and the first ":" (``conv``
of ``qcnn.conv:s1b0.conv2``). Each device activity (kernel, copy, set) is
joined to its host launch, the CUDA API call (``cudaLaunchKernel``,
``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...) with the same correlation
id, and that launch to the innermost span that encloses it on the
launching thread. A kernel launched outside every span counts under
``outside``; one whose launch the trace does not hold, under
``unlinked``. The span intervals of a thread come from a stack over its
spans in order of start, so a forward that encloses thousands of host
events costs nothing more than a short one.

A host wait is an idle gap between the merged device intervals that the
device spent waiting for the host: the activity that ends the gap had its
launch call start after the gap began. A gap whose next activity was
queued before it began (the host was ahead, as under "Command Buffer
Full") is the device's own. Each host wait is put down to the span that
encloses the late launch.

:func:`kind_share`, :func:`host_wait_share` and :func:`slowdown` read the
reduction that ``trace.summarize`` keeps under ``"spans"``, for the
per-layer metrics in ``metrics/``.
"""

from __future__ import annotations

import bisect

PREFIX = "qcnn."
OUTSIDE = "outside"


def kind_of(name: str) -> str:
    """``conv`` of ``qcnn.conv:s1b0.conv2``; ``forward`` of
    ``qcnn.forward``."""
    return name[len(PREFIX):].split(":", 1)[0]


def _is_launch(name: str) -> bool:
    """A CUDA API call (``cuda*`` or ``cu*``): the host side of a device
    activity. The program's own ranges and aten operators, which number
    their correlation ids from another counter, never start so."""
    return name.startswith("cu")


class _Innermost:
    """The innermost span at a time on one thread: boundaries where the
    innermost span changes, from a stack over the thread's spans."""

    def __init__(self, spans):
        self.t, self.name = [], []
        stack = []

        def close_until(t):
            while stack and stack[-1][0] <= t:
                end = stack.pop()[0]
                self.t.append(end)
                self.name.append(stack[-1][1] if stack else None)

        for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            close_until(start)
            if stack:  # a range that outlasts its parent ends with it
                end = min(end, stack[-1][0])
            stack.append((end, name))
            self.t.append(start)
            self.name.append(name)
        close_until(float("inf"))

    def at(self, t):
        i = bisect.bisect_right(self.t, t) - 1
        return self.name[i] if i >= 0 else None


def reduce(events) -> dict:
    """Reduce the kineto events of a slice.

    Returns {"forwards": ``qcnn.forward`` spans, "kinds": {kind:
    {"seconds", "kernels"}} by innermost span, "outside", "unlinked" (each
    {"seconds", "kernels"}), "kernel_s": the device activities' summed
    seconds, "names": {span name: [seconds, kernels]}, "host_wait_s" and
    "host_wait": {kind or "outside": seconds}}. Device-side copies of the
    spans (``gpu_user_annotation`` events) are left out."""
    from torch.autograd import DeviceType

    dev, launch, spans = [], {}, {}
    for e in events:
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            if not e.is_user_annotation():
                start = e.start_ns()
                dev.append((start, start + e.duration_ns(),
                            e.correlation_id()))
        elif kind == DeviceType.CPU:
            name = e.name()
            if name.startswith(PREFIX):
                start = e.start_ns()
                spans.setdefault(e.start_thread_id(), []).append(
                    (start, start + e.duration_ns(), name))
            elif _is_launch(name):
                launch[e.correlation_id()] = (e.start_ns(),
                                              e.start_thread_id())
    threads = {tid: _Innermost(s) for tid, s in spans.items()}

    def owner(corr):
        """(launch start, innermost span name or None), or None where the
        trace holds no launch."""
        got = launch.get(corr)
        if got is None:
            return None
        start, tid = got
        inner = threads.get(tid)
        return start, inner.at(start) if inner else None

    def bucket(table, key):
        return table.setdefault(key, {"seconds": 0.0, "kernels": 0})

    kinds, names = {}, {}
    outside = {"seconds": 0.0, "kernels": 0}
    unlinked = {"seconds": 0.0, "kernels": 0}
    kernel_ns = 0
    dev.sort()
    owners = [owner(corr) for _, _, corr in dev]
    for (start, end, _), got in zip(dev, owners):
        kernel_ns += end - start
        if got is None:
            slot = unlinked
        elif got[1] is None:
            slot = outside
        else:
            slot = bucket(kinds, kind_of(got[1]))
            row = names.setdefault(got[1], [0.0, 0])
            row[0] += (end - start) / 1e9
            row[1] += 1
        slot["seconds"] += (end - start) / 1e9
        slot["kernels"] += 1

    # idle gaps: each merged interval's first activity ends the gap before
    # it
    waits, wait_ns, reach = {}, 0, None
    for (start, end, _), got in zip(dev, owners):
        if reach is not None and start > reach and got is not None \
                and got[0] > reach:
            key = kind_of(got[1]) if got[1] else OUTSIDE
            waits[key] = waits.get(key, 0) + (start - reach)
            wait_ns += start - reach
        reach = end if reach is None else max(reach, end)
    return {
        "forwards": sum(1 for s in spans.values() for _, _, n in s
                        if n == PREFIX + "forward"),
        "kinds": kinds, "outside": outside, "unlinked": unlinked,
        "kernel_s": kernel_ns / 1e9, "names": names,
        "host_wait_s": wait_ns / 1e9,
        "host_wait": {k: v / 1e9 for k, v in waits.items()},
    }


def _spans(ctx):
    """The slice's span reduction, or None outside an offline cell, where
    the device ran nothing, or where the slice holds no forward span (a
    program without spans)."""
    tr = ctx.get("trace")
    if ctx.get("kind") != "offline" or not tr or tr["busy_s"] <= 0:
        return None
    sp = tr.get("spans")
    return sp if sp and sp["forwards"] else None


def kind_share(ctx, kinds) -> float | None:
    """100 x device seconds under spans of ``kinds`` / the slice's busy
    seconds; None where no kernel ran under them."""
    sp = _spans(ctx)
    if sp is None:
        return None
    got = [sp["kinds"][k] for k in kinds if k in sp["kinds"]]
    if not got:  # a kind is in the reduction once a kernel ran under it
        return None
    seconds = sum(g["seconds"] for g in got)
    return 100.0 * seconds / ctx["trace"]["busy_s"]


def host_wait_share(ctx) -> float | None:
    """100 x the slice's host waits / the slice."""
    sp = _spans(ctx)
    if sp is None:
        return None
    return 100.0 * sp["host_wait_s"] / ctx["trace"]["window_s"]


def slowdown(ctx) -> float | None:
    """100 x (1 - the slice's images/s / the untraced window's): what the
    profiler costs the steps it traces. The slice's rate is its
    ``qcnn.forward`` spans x the batch / the slice (it starts and ends with
    the device drained, so those are the steps dispatched in it); the
    window's is ``ctx["images_per_s"]``, the steps outside the slice over
    the time outside it."""
    sp = _spans(ctx)
    if sp is None or not ctx.get("images_per_s"):
        return None
    rate = sp["forwards"] * ctx["batch"] / ctx["trace"]["window_s"]
    return 100.0 * (1.0 - rate / ctx["images_per_s"])
