"""Build and load the port's host-side C++ libraries (the ``.cbn`` page
codec and the image pipeline), as ``qcnn_tpu/native_build.py`` does for the
JAX package, with one difference: the shared library goes into the
git-ignored ``qcnn_tpu_torch/_build/``, named by a hash of the compiler,
flags and source, as ``ops/cuda/_build.py`` names the CUDA library. A
changed source builds anew and a stale library is never loaded.

Nothing is built when a module is imported: the first ``get()`` builds.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import threading
import time

CXX = os.environ.get("CXX", "g++")
BASE_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def build_cmd(src: str, out: str, *extra: str) -> list[str]:
    return [CXX, *BASE_FLAGS, *extra, "-o", out, src]


class NativeLib:
    """Build-on-first-use ctypes loader of one C++ source.

    Contract: `get()` returns bind(CDLL) — built if the hashed library is
    missing — or None on ANY build/load/bind failure (no compiler, stale
    symbols, ...), after which it never retries. QCNN_DISABLE_NATIVE forces
    None (the C++ parses untrusted input). `build()` is the strict half: it
    raises on a failed build, for callers that must not fall back."""

    def __init__(self, src: str, bind, extra_flags=()):
        self._src = src
        self._bind = bind
        self._extra = tuple(extra_flags)
        self._lock = threading.Lock()
        self._lib = None
        self._failed = False

    def library_path(self) -> str:
        h = hashlib.sha256(" ".join((CXX, *BASE_FLAGS, *self._extra))
                           .encode())
        with open(self._src, "rb") as f:
            h.update(f.read())
        stem = os.path.splitext(os.path.basename(self._src))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")

    def build(self) -> tuple[str, float]:
        """Compile the source unless its hashed library exists. Returns
        (library path, build seconds; 0 when it was built already). Raises
        CalledProcessError, with the compiler's output, on a failed build."""
        import subprocess

        path = self.library_path()
        if os.path.exists(path):
            return path, 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        # compile to a private name, then rename: concurrent builds (test
        # workers) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(build_cmd(self._src, tmp, *self._extra),
                           check=True, capture_output=True, text=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path, time.perf_counter() - t0

    def get(self):
        import ctypes

        if os.environ.get("QCNN_DISABLE_NATIVE"):
            return None
        if self._lib is not None:
            return self._lib
        if self._failed:
            return None
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            try:
                path, _ = self.build()
                self._lib = self._bind(ctypes.CDLL(path))
            except Exception:  # noqa: BLE001 - any failure = no native
                self._failed = True
        return self._lib
