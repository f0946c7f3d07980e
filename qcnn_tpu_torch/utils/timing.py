"""Timers: the wall-clock timer set, and the clock of one call.

``StopWatch`` and ``TimerSet`` are a copy of ``qcnn_tpu/utils/timing.py``,
which replaces the reference's StopWatch set (include/StopWatch.h, 14 named
watches + per-layer vector, CaffeEva.h:115-133). They measure
dispatch-to-completion wall time, fenced by ``torch.cuda.synchronize`` on
the result's device so that asynchronous launches can't flatter the
numbers.

:func:`time_ms` is the clock of the per-layer profiler
(``eval/profiler.py``) and of ``chip_smoke.py``: the device time of one
call on the card, or its wall time on the CPU.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch

from qcnn_tpu_torch._device import iter_tensors

FLUSH_BYTES = 256 << 20  # > the H100's 50 MB L2
SPIN_CYCLES = 18_000_000  # about 10 ms of device clock
SPIN_CYCLES_PER_MS = SPIN_CYCLES // 10


def flush_buffer(device) -> torch.Tensor:
    """The buffer :func:`time_ms` zeroes before each call: ``FLUSH_BYTES``
    on a card (more than its L2 cache), empty on the CPU."""
    device = torch.device(device)
    n = FLUSH_BYTES // 4 if device.type == "cuda" else 0
    return torch.empty(n, dtype=torch.int32, device=device)


def time_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Median time of one call of ``fn()`` in ms, over ``reps`` calls after
    one to warm up.

    On a card (``flush`` on a CUDA device): CUDA events around each call,
    with ``flush`` zeroed before each so the L2 holds nothing of the last
    call. The device first spins while the host enqueues every repetition
    behind it, so that a slow host (Python around a launch, several
    launches a call) does not show up as device time: for about 10 ms, or
    longer where the host takes longer to enqueue the repetitions (timed
    on a second call after the warm-up, which may build a kernel).

    On the CPU (``flush`` on the CPU): ``time.perf_counter`` around each
    call; nothing is flushed."""
    fn()
    if flush.device.type == "cpu":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3
    torch.cuda.synchronize(flush.device)
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(flush.device)
    spin = max(SPIN_CYCLES,
               int(1.25 * reps * enqueue_ms * SPIN_CYCLES_PER_MS))
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(spin)
    for i in range(reps):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize(flush.device)
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


class StopWatch:
    """Accumulating pause/resume timer (StopWatch.h:13-33 analogue, wall time)."""

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0
        self._start: float | None = None

    def resume(self) -> None:
        self._start = time.perf_counter()

    def pause(self) -> None:
        if self._start is None:
            raise RuntimeError("StopWatch not running")
        self.total += time.perf_counter() - self._start
        self.count += 1
        self._start = None

    def reset(self) -> None:
        self.__init__()


class TimerSet:
    """Named timer registry; the DispElpsTime analogue (CaffeEva.cc:297-326)."""

    def __init__(self) -> None:
        self._watches: dict[str, StopWatch] = defaultdict(StopWatch)

    @contextmanager
    def time(self, name: str, result=None):
        """Time the block; with ``result`` (tensors, or lists / tuples /
        dicts of them), wait for their CUDA devices before stopping. A CPU
        tensor needs no fence."""
        w = self._watches[name]
        w.resume()
        try:
            yield
        finally:
            for device in {t.device for t in iter_tensors(result)
                           if t.is_cuda}:
                torch.cuda.synchronize(device)
            w.pause()

    def report(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": w.total, "count": w.count,
                "mean_ms": 1e3 * w.total / max(1, w.count)}
            for k, w in self._watches.items()
        }
