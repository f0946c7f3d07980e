"""ctypes bindings for the native .cbn page codec (cbncodec.cc, the JAX
package's source copied).

The shared library is compiled on first use with g++ -O3 into
``qcnn_tpu_torch/_build/`` (``qcnn_tpu_torch.native_build``). If no
compiler is available the caller falls back to the NumPy codec in
reference_codec.py (same results, slower on multi-MB files).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from qcnn_tpu_torch.native_build import NativeLib

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "cbncodec.cc")
_PAGE_BYTES = 4096


class _Lib:
    def __init__(self, cdll: ctypes.CDLL):
        self._c = cdll
        self._c.qcnn_unpack_pages.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        self._c.qcnn_pack_pages.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]

    def unpack_pages(self, pages: np.ndarray, n: int, bits: int) -> np.ndarray:
        pages = np.ascontiguousarray(pages, dtype=np.uint8)
        out = np.empty(n, dtype=np.uint32)
        self._c.qcnn_unpack_pages(
            pages.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(n),
            ctypes.c_int(bits),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        return out

    def pack_pages(self, vals: np.ndarray, bits: int) -> np.ndarray:
        vals = np.ascontiguousarray(vals, dtype=np.uint32)
        per_page = (_PAGE_BYTES * 8) // bits
        n_pages = -(-vals.size // per_page)
        pages = np.empty(n_pages * _PAGE_BYTES, dtype=np.uint8)
        self._c.qcnn_pack_pages(
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(vals.size),
            ctypes.c_int(bits),
            pages.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return pages


LIBRARY = NativeLib(_SRC, _Lib)


def get_lib() -> _Lib | None:
    """Return the codec library, building it if needed; None if
    unavailable (qcnn_tpu_torch/native_build.py)."""
    return LIBRARY.get()
