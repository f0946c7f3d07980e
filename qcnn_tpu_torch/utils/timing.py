"""Wall-clock timers for device work.

A copy of ``qcnn_tpu/utils/timing.py``, which replaces the reference's
StopWatch set (include/StopWatch.h, 14 named watches + per-layer vector,
CaffeEva.h:115-133). Device-side profiling should use torch.profiler or CUDA
events; these timers measure dispatch-to-completion wall time, fenced by
``torch.cuda.synchronize`` on the result's device so that asynchronous
launches can't flatter the numbers.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

from qcnn_tpu_torch._device import iter_tensors


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
