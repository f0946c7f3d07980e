"""Across-channel LRN in one pass over memory: the ``lrn_fused`` CUDA kernel
and its plain version.

Port of ``qcnn_tpu/ops/pallas/lrn_fused.py``:

    y = x * (k + alpha/size * sum_{|c'-c| <= r} sq[c']) ** (-beta)

over the last axis, with r = (size - 1) // 2, the window zero-padded at the
channel edges, ``sq`` = x * x rounded to x's dtype, float32 window sums and
the result in x's dtype. All three JAX windows ("dot", "roll", "shift")
square in x's dtype: the "shift" kernel squares before it widens
(``(x * x).astype(jnp.float32)``, lrn_fused.py:81), although its docstring
says it squares in float32. They differ only in the order of their
float32 sums, so one entry (``csrc/lrn_fused.cu``) serves all three names,
which are still validated. It launches one of two kernels,
picked from the shape by ``plan`` (``_plan.plan_lrn``): the register kernel
(``KERNEL``; window radius 1 to 3, rows that are whole 16-byte vectors: the
window stays in registers and the neighbours come from the adjacent lanes)
or the general one (``GENERAL``; the window goes through shared memory),
each with its own launch count. Both add the window's squares in channel
order; :func:`lrn_window_plain` repeats that order in PyTorch
(``chip_smoke.py`` holds both kernels to it bit for bit).

``ops.misc.lrn(impl="auto")`` launches it for an odd window over a bf16 or
float32 CUDA tensor without a channel_map (``misc.lrn_route``), so every
LRN of the AlexNet family's forwards on the card runs here; the JAX
package's forwards never reach its kernel. Its plain version is
``ops.misc.lrn(impl="band")``, which squares in x's dtype and sums in
float32; it runs on a CPU tensor, and on a CUDA tensor the kernel launches
or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from qcnn_tpu_torch.ops import misc
from qcnn_tpu_torch.ops.cuda import _plan
from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel, check_cuda

WINDOWS = ("dot", "roll", "shift")
_BETA_MODES = {0.75: 0, 0.5: 1, 1.0: 2}  # ops.misc._neg_pow's compositions
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = [  # x, out, n, C, radius, alpha/size, k, beta, beta mode, dtype,
    PTR, PTR, ctypes.c_longlong, INT, INT, ctypes.c_float,  # stream
    ctypes.c_float, ctypes.c_float, INT, INT, PTR]
KERNEL = Kernel("lrn_fused_launch", _ARGTYPES)           # the register kernel
GENERAL = Kernel("lrn_fused_general_launch", _ARGTYPES)
plan = _plan.plan_lrn


def lrn_plain(x: torch.Tensor, *, size: int, alpha: float, beta: float,
              k: float) -> torch.Tensor:
    """The kernel's function in PyTorch (the banded-matmul LRN)."""
    return misc.lrn(x, size=size, alpha=alpha, beta=beta, k=k, impl="band")


def lrn_window_plain(x: torch.Tensor, *, size: int, alpha: float,
                     beta: float, k: float) -> torch.Tensor:
    """The kernels' order of float32 additions, in PyTorch: the squares
    (rounded to x's dtype) of channels c - r to c + r added in that order,
    those past a channel edge as zeros."""
    radius = (size - 1) // 2
    c = x.shape[-1]
    padded = torch.nn.functional.pad((x * x).float(), (radius, radius))
    sq_sum = padded[..., :c]
    for off in range(1, size):
        sq_sum = sq_sum + padded[..., off:off + c]
    scale = k + (alpha / size) * sq_sum
    return (x.float() * misc._neg_pow(scale, beta)).to(x.dtype)


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
    radius = (size - 1) // 2
    pl = plan(xc.numel(), x.shape[-1], radius, xc.element_size())
    kernel = KERNEL if pl.variant == "register" else GENERAL
    kernel.launch(xc.data_ptr(), out.data_ptr(), xc.numel(), x.shape[-1],
                  radius, alpha / size, k, beta, _BETA_MODES.get(beta, 3),
                  _DTYPES[x.dtype])
    return out
