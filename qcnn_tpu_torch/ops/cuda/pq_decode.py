"""PQ weight decode: the ``pq_decode`` CUDA kernel and its plain version.

Port of ``qcnn_tpu/ops/pallas/pq_decode.py``. The kernel
(``csrc/pq_decode.cu``) writes the decoded weight straight in the layout the
consumer takes: rows (N, C), i.e. OHWI for a conv kernel and (Cout, Cin)
for an fc weight. One launch decodes a group of weights
(:func:`decode_rows_many`: a residual block's convs, AlexNet's five), each
item by the 16-byte vector kernel or the general one as
``_plan.plan_decode`` decides from its shape. Every in-step decode of the
port goes through it; the layout names of the JAX entry points are views of
the buffers it returns.

On a CPU tensor the plain version (``ops.lut.decode_rows``) runs; on a CUDA
tensor the kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from qcnn_tpu_torch.ops import lut
from qcnn_tpu_torch.ops.cuda import _plan
from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel, check_cuda

# uint8 ids. The JAX Pallas gather's one-vreg cap (K <= 128) stays only on
# the 'gdecode' impl names (ops.fc.check_gdecode_codewords), whose JAX entry
# points raise past it; the JAX one-hot decodes take any K.
MAX_CODEWORDS = 256

KERNEL = Kernel("pq_decode_launch", [PTR, INT, PTR])  # items, count, stream
plan = _plan.plan_decode

_LAYOUTS = {"ohwi": (0, 1, 2, 3), "hwio": (1, 2, 3, 0),
            "iohw": (3, 0, 1, 2), "hwoi": (1, 2, 0, 3)}


class _Item(ctypes.Structure):
    """``PqDecodeItem`` of ``csrc/pq_decode.cu``."""
    _fields_ = [("cb", PTR), ("ids", PTR), ("out", PTR), ("n", INT),
                ("s", INT), ("k", INT), ("d", INT), ("c_len", INT),
                ("elem_bytes", INT), ("vector", INT), ("blocks", INT)]


def _check_item(codebooks: torch.Tensor, assignments: torch.Tensor,
                row_len: int) -> None:
    s, k, d = codebooks.shape
    if k > MAX_CODEWORDS:
        raise ValueError(
            f"pq_decode supports K <= {MAX_CODEWORDS} (uint8 ids); got K={k}"
        )
    if assignments.ndim != 2 or assignments.shape[1] != s:
        raise ValueError(f"subspace mismatch: codebooks S={s}, "
                         f"assignments S={tuple(assignments.shape)[-1]}")
    if not 0 <= row_len <= s * d:
        raise ValueError(f"row length {row_len} outside [0, S*D={s * d}]")


def launch_items(items: Sequence[tuple[torch.Tensor, torch.Tensor, int]],
                 plans: Sequence[_plan.DecodePlan]) -> list[torch.Tensor]:
    """Decode CUDA items under the given plans, ``_plan.DECODE_MAX_ITEMS``
    to a launch. :func:`decode_rows_many` plans each item from its shape;
    a caller that holds the general kernel against the vector one passes
    ``plan(..., vector=False)``."""
    outs, table, keep = [], [], []
    for (cb, ids, row_len), pl in zip(items, plans):
        if cb.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"pq_decode: codebooks must be float32 or "
                             f"bfloat16, got {cb.dtype}")
        if ids.dtype != torch.uint8:
            raise ValueError(f"pq_decode: assignments must be uint8, "
                             f"got {ids.dtype}")
        check_cuda("pq_decode", codebooks=cb, assignments=ids)
        if cb.data_ptr() % 16:  # the vector kernel loads whole codewords
            cb = cb.clone()
        s, k, d = cb.shape
        out = torch.empty((ids.shape[0], row_len), dtype=cb.dtype,
                          device=cb.device)
        outs.append(out)
        keep.append((cb, ids))
        table.append(_Item(cb.data_ptr(), ids.data_ptr(), out.data_ptr(),
                           ids.shape[0], s, k, d, row_len, cb.element_size(),
                           pl.variant == "vector", pl.blocks))
    for lo in range(0, len(table), _plan.DECODE_MAX_ITEMS):
        group = table[lo:lo + _plan.DECODE_MAX_ITEMS]
        if any(item.blocks for item in group):
            array = (_Item * len(group))(*group)
            KERNEL.launch(ctypes.addressof(array), len(group))
    return outs


def decode_rows_many(items: Sequence[tuple[torch.Tensor, torch.Tensor, int]]
                     ) -> list[torch.Tensor]:
    """Decode a group of weights in one launch.

    items: (codebooks (S, K, D), assignments (N, S) uint8, row_len) each.
    Returns one (N, row_len) tensor per item, bit-equal to
    :func:`decode_rows` on that item."""
    items = list(items)
    for item in items:
        _check_item(*item)
    if not items:
        return []
    if all(cb.device.type == "cpu" for cb, _, _ in items):
        return [lut.decode_rows(cb, ids, row_len)
                for cb, ids, row_len in items]
    plans = [plan(ids.shape[0], *cb.shape, row_len, cb.element_size())
             for cb, ids, row_len in items]
    return launch_items(items, plans)


def decode_rows(codebooks: torch.Tensor, assignments: torch.Tensor,
                row_len: int) -> torch.Tensor:
    """(N, S) uint8 ids -> (N, row_len) rows in the codebooks' dtype,
    out[n, s*D + d] = codebooks[s, assignments[n, s], d]. Bit-exact."""
    return decode_rows_many([(codebooks, assignments, row_len)])[0]


def conv_kernel_view(ohwi: torch.Tensor, layout: str) -> torch.Tensor:
    """A decoded (Cout, kh, kw, Cg) buffer in the named logical layout:
    'hwio' (kh, kw, Cg, Cout), 'iohw' (Cg, Cout, kh, kw), 'ohwi' or 'hwoi'
    (kh, kw, Cout, Cg). A view: ``ops.conv.conv_dense`` feeds any of them
    to the convolution without a copy."""
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown decode layout: {layout!r}")
    return ohwi.permute(*_LAYOUTS[layout])


def decode_conv_kernels_many(items: Sequence[tuple[torch.Tensor,
                                                   torch.Tensor, int]]
                             ) -> list[torch.Tensor]:
    """Decode a group of conv kernels in one launch.

    items: (codebooks, assignments (Cout, kh, kw, S), channels per group)
    each. Returns the (Cout, kh, kw, Cg) OHWI buffers."""
    shapes = [(*a.shape[:3], cg) for _, a, cg in items]
    rows = decode_rows_many([(cb, a.reshape(-1, a.shape[3]), cg)
                             for cb, a, cg in items])
    return [w.reshape(shape) for w, shape in zip(rows, shapes)]


def decode_fc_weight_gather(codebooks: torch.Tensor,
                            assignments: torch.Tensor,
                            in_features: int) -> torch.Tensor:
    """``lut.decode_fc_weight`` through the kernel: (Cin, Cout), the
    transpose view of the (Cout, Cin) rows the kernel writes."""
    return decode_rows(codebooks, assignments, in_features).t()


def decode_conv_kernel_gather(codebooks: torch.Tensor,
                              assignments: torch.Tensor,
                              in_channels_per_group: int,
                              layout: str = "hwio") -> torch.Tensor:
    """``lut.decode_conv_kernel`` through the kernel, in the named logical
    layout (:func:`conv_kernel_view`)."""
    (ohwi,) = decode_conv_kernels_many(
        [(codebooks, assignments, in_channels_per_group)])
    return conv_kernel_view(ohwi, layout)
