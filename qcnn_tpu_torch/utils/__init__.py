"""Host-side utilities: timers, and the one clock of the profiler and the
chip smoke (``timing.time_ms``)."""

from qcnn_tpu_torch.utils.timing import StopWatch, TimerSet  # noqa: F401
