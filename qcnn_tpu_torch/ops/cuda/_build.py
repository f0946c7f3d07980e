"""Build and load the port's hand-written CUDA kernels.

The sources in ``qcnn_tpu_torch/csrc/*.cu`` each export plain ``extern "C"``
launchers that return ``cudaGetLastError()``; ``csrc/*.cuh`` hold the device
code they share. They are compiled for Hopper (``sm_90a``) with ``nvcc``,
one process per ``.cu`` started together, and linked into one shared library
under ``qcnn_tpu_torch/_build/`` whose name carries a hash of the sources,
headers and flags: a changed source or header builds anew, an unchanged
tree is loaded as it is. The library is loaded with ``ctypes``
(no PyTorch headers are compiled, so a build takes seconds).

Nothing is built when a module is imported: the first launch builds. Launches
may come from several threads at once (a serving engine launches from its
compute thread; two engines in one process have two): the first build and
load run under a lock, once, and each kernel's count of launches goes up
under its own lock.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libqcnn_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float, str]:
    """Compile the sources if the hashed library is missing.

    Returns (library path, build seconds, compiler log); 0 seconds and an
    empty log when the library was already built. Raises on any compiler
    error, with the compiler's output."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(logs[-1])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                *(obj for _, obj, _ in procs), "-o", tmp_lib]
        res = subprocess.run(link, capture_output=True, text=True)
        logs.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + logs[-1])
        os.replace(tmp_lib, path)
    return path, time.perf_counter() - t0, "\n".join(logs)


_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    """The loaded library, built on the first call. Threads that launch
    their first kernel together wait for one build: two builds would run
    two sets of nvcc processes into the same directory."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                path, _, _ = build()
                _LIB = ctypes.CDLL(path)
    return _LIB


def current_stream() -> int:
    """The handle of the current device's current CUDA stream: torch's raw
    getter where the build has one, which makes no Python ``Stream`` (5-8
    us a launch less on the card's host), else
    ``torch.cuda.current_stream()``."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream().cuda_stream
    return raw(torch._C._cuda_getDevice())


class Kernel:
    """One launcher of the shared library, with its count of launches.

    ``launches`` goes up by one for each launch of the kernel on the card,
    and nowhere else (the plain versions on the CPU do not count). The
    launcher's argument types are set once for the loaded library."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._count_lock = threading.Lock()
        self._bound = (None, None)  # (library, its launcher)

    def launch(self, *args) -> None:
        lib = _library()
        bound_lib, fn = self._bound
        if bound_lib is not lib:
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._bound = (lib, fn)
        rc = fn(*args, current_stream())
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol} failed to launch: CUDA error {rc}")
        with self._count_lock:  # += is no atomic step across threads
            self.launches += 1


PTR = ctypes.c_void_p
INT = ctypes.c_int

# csrc/launch_floor.cu: an empty kernel of a given grid (x, y, z), block and
# dynamic shared memory, timed as the floor of such a launch; no path of the
# port launches it
EMPTY = Kernel("empty_launch", [INT, INT, INT, INT, INT, PTR])


def check_cuda(name: str, **tensors) -> None:
    """Raise unless every tensor lies on one CUDA device and is
    contiguous (the kernels index dense row-major buffers)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name}: tensors must share one CUDA device, got "
            + ", ".join(f"{k}={t.device}" for k, t in tensors.items()))
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
