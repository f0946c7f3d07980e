"""ctypes bindings for the native threaded preprocessing pipeline
(imgproc.cc, the JAX package's source copied). Compiled on first use with
g++ into ``qcnn_tpu_torch/_build/`` (``qcnn_tpu_torch.native_build``);
the NumPy pipeline (``preproc/pipeline.py``) stands in when no compiler is
available.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from qcnn_tpu_torch.native_build import NativeLib

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "imgproc.cc")


def _bind(lib):
    lib.qcnn_preproc_batch.restype = ctypes.c_int
    lib.qcnn_preproc_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),   # buffers
        ctypes.POINTER(ctypes.c_int64),    # lengths
        ctypes.c_int,                      # n
        ctypes.c_int, ctypes.c_int,        # full_h, full_w
        ctypes.c_int, ctypes.c_int,        # crop_h, crop_w
        ctypes.c_int,                      # relaxed
        ctypes.POINTER(ctypes.c_float),    # mean
        ctypes.c_int, ctypes.c_int,        # mean_h, mean_w
        ctypes.c_int,                      # mean_full
        ctypes.POINTER(ctypes.c_float),    # out
        ctypes.c_int,                      # threads
    ]
    lib.qcnn_preproc_batch_torch.restype = ctypes.c_int
    lib.qcnn_preproc_batch_torch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),   # buffers
        ctypes.POINTER(ctypes.c_int64),    # lengths
        ctypes.c_int,                      # n
        ctypes.c_int, ctypes.c_int,        # resize, crop
        ctypes.POINTER(ctypes.c_float),    # mean3
        ctypes.POINTER(ctypes.c_float),    # std3
        ctypes.POINTER(ctypes.c_float),    # out
        ctypes.c_int,                      # threads
    ]
    return lib


# -pthread for the threaded pipeline
LIBRARY = NativeLib(_SRC, _bind, extra_flags=("-pthread",))


def _load():
    return LIBRARY.get()


def available() -> bool:
    return _load() is not None


def preproc_batch(
    bmp_blobs: Sequence[bytes],
    *,
    full_h: int,
    full_w: int,
    crop_h: int,
    crop_w: int,
    relaxed: bool,
    mean_hwc: np.ndarray,
    mean_full: bool,
    threads: int = 0,
) -> tuple[np.ndarray, int]:
    """Decode+preprocess BMP byte blobs -> ((N, crop_h, crop_w, 3) float32
    BGR, failure_count). Failed slots are zeroed."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native imgproc unavailable (no g++?)")
    n = len(bmp_blobs)
    mean = np.ascontiguousarray(mean_hwc, np.float32)
    out = np.zeros((n, crop_h, crop_w, 3), np.float32)
    buf_ptrs = (ctypes.c_void_p * n)()
    lengths = (ctypes.c_int64 * n)()
    # keep byte objects alive for the duration of the call
    keepalive = [np.frombuffer(b, np.uint8) for b in bmp_blobs]
    for i, arr in enumerate(keepalive):
        buf_ptrs[i] = arr.ctypes.data
        lengths[i] = arr.size
    failures = lib.qcnn_preproc_batch(
        buf_ptrs, lengths, n,
        full_h, full_w, crop_h, crop_w,
        1 if relaxed else 0,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mean.shape[0], mean.shape[1],
        1 if mean_full else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        threads,
    )
    return out, failures


def preproc_batch_torch(
    bmp_blobs: Sequence[bytes],
    *,
    resize: int,
    crop: int,
    mean: np.ndarray,
    std: np.ndarray,
    threads: int = 0,
) -> tuple[np.ndarray, int]:
    """torch-ecosystem eval transform (TorchPreprocessor semantics) over
    BMP byte blobs -> ((N, crop, crop, 3) float32 RGB normalized,
    failure_count). Failed slots are zeroed."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native imgproc unavailable (no g++?)")
    n = len(bmp_blobs)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.zeros((n, crop, crop, 3), np.float32)
    buf_ptrs = (ctypes.c_void_p * n)()
    lengths = (ctypes.c_int64 * n)()
    keepalive = [np.frombuffer(b, np.uint8) for b in bmp_blobs]
    for i, arr in enumerate(keepalive):
        buf_ptrs[i] = arr.ctypes.data
        lengths[i] = arr.size
    failures = lib.qcnn_preproc_batch_torch(
        buf_ptrs, lengths, n, resize, crop,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        threads,
    )
    return out, failures
