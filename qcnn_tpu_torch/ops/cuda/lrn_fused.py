"""Across-channel LRN in one pass over memory: the ``lrn_fused`` CUDA kernel
and its plain version.

Port of ``qcnn_tpu/ops/pallas/lrn_fused.py``:

    y = x * (k + alpha/size * sum_{|c'-c| <= r} sq[c']) ** (-beta)

over the last axis, with r = (size - 1) // 2, the window zero-padded at the
channel edges, ``sq`` = x * x rounded to x's dtype, float32 window sums and
the result in x's dtype. All three JAX windows ("dot", "roll", "shift")
square in x's dtype: the "shift" kernel squares before it widens
(``(x * x).astype(jnp.float32)``, lrn_fused.py:81), although its docstring
says it squares in float32 (see ROADMAP.md B2). They differ only in the order
of their float32 sums, so one kernel (``csrc/lrn_fused.cu``) serves all
three names, which are still validated.

As in the JAX package, the kernel is an entry point of its own and is wired
into nothing: ``ops.misc.lrn`` stays plain PyTorch. Its plain version is
``ops.misc.lrn(impl="band")``, which squares in x's dtype and sums in
float32; it runs on a CPU tensor, and on a CUDA tensor the kernel launches
or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from qcnn_tpu_torch.ops import misc
from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel, check_cuda

WINDOWS = ("dot", "roll", "shift")
_BETA_MODES = {0.75: 0, 0.5: 1, 1.0: 2}  # ops.misc._neg_pow's compositions
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = Kernel(
    "lrn_fused_launch",
    [PTR, PTR, ctypes.c_longlong, INT, INT, ctypes.c_float, ctypes.c_float,
     ctypes.c_float, INT, INT, PTR],
)


def lrn_plain(x: torch.Tensor, *, size: int, alpha: float, beta: float,
              k: float) -> torch.Tensor:
    """The kernel's function in PyTorch (the banded-matmul LRN)."""
    return misc.lrn(x, size=size, alpha=alpha, beta=beta, k=k, impl="band")


def lrn_fused(x: torch.Tensor, *, size: int, alpha: float, beta: float,
              k: float, tile_m: int = 2048, pad_lanes: bool = True,
              window: str = "dot") -> torch.Tensor:
    """Across-channel LRN over the last axis of x (any rank), one read and
    one write of x.

    tile_m/pad_lanes: the TPU kernel's row tile and lane padding; accepted
    for the JAX entry's signature and unused. window: "dot", "roll" or
    "shift", the JAX kernel's three window formulations; all name the same
    function here. size must be odd, as ``ops.misc.lrn`` requires."""
    del tile_m, pad_lanes
    if window not in WINDOWS:
        raise ValueError(f"unknown lrn window: {window!r}; expected one of "
                         f"{WINDOWS}")
    if size % 2 == 0:
        raise ValueError(f"lrn requires an odd window size, got {size}")
    if x.device.type == "cpu":
        return lrn_plain(x, size=size, alpha=alpha, beta=beta, k=k)
    if x.dtype not in _DTYPES:
        raise ValueError(f"lrn_fused: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    xc = x.contiguous()
    if xc.data_ptr() % 16:
        xc = xc.clone()  # the kernel moves 16 bytes a load
    check_cuda("lrn_fused", x=xc)
    out = torch.empty_like(xc)
    KERNEL.launch(xc.data_ptr(), out.data_ptr(), xc.numel(), x.shape[-1],
                  (size - 1) // 2, alpha / size, k, beta,
                  _BETA_MODES.get(beta, 3), _DTYPES[x.dtype])
    return out
