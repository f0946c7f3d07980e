"""The CUDA library's first build and the launch counts under threads
(ops/cuda/_build.py). A serving engine launches its kernels from its
compute thread, and two engines in one process from two: the first launches
must share one build, and no launch may go uncounted. Neither needs nvcc or
a card: the build and the launcher are stubbed."""

import ctypes
import ctypes.util
import sys
import threading
import time

import pytest

from qcnn_tpu_torch.ops.cuda import _build
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


@pytest.fixture
def unloaded(monkeypatch):
    """The library as before the first launch; restored afterwards."""
    monkeypatch.setattr(_build, "_LIB", None)


def test_concurrent_first_launches_build_once(unloaded, monkeypatch):
    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.2)  # as long as nvcc takes, the others pile up
        return ctypes.util.find_library("c"), 0.2, ""

    monkeypatch.setattr(_build, "build", slow_build)
    barrier = threading.Barrier(8)
    libs, errors = [], []

    def first_launch():
        try:
            barrier.wait(timeout=10)
            libs.append(_build._library())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=first_launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(calls) == 1
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)


class _FakeLib:
    """Stands in for the loaded library: every symbol launches nothing and
    returns 0 (no CUDA error)."""

    def __getattr__(self, name):
        def fn(*args):
            return 0
        return fn


class _FakeStream:
    cuda_stream = 0


def test_launch_counts_are_exact_across_threads(monkeypatch):
    """A stress test of the count's lock. Under CPython's GIL an unguarded
    += on an attribute rarely loses an update; without a GIL (free-threaded
    builds) it does."""
    monkeypatch.setattr(_build, "_LIB", _FakeLib())
    monkeypatch.setattr(_build.torch.cuda, "current_stream",
                        lambda: _FakeStream())
    kernel = _build.Kernel("stub_launch", [])
    threads_n, per_thread = 16, 2000
    barrier = threading.Barrier(threads_n)

    def launch_many():
        barrier.wait(timeout=10)
        for _ in range(per_thread):
            kernel.launch()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as it can
    try:
        threads = [threading.Thread(target=launch_many)
                   for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == threads_n * per_thread
