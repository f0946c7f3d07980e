"""The pointwise tail after a conv or FC product in one pass: the
``epilogue_fused`` CUDA kernel, its plain version and its route.

Replaces no Pallas kernel: the JAX package leaves the bias add, the
activation and the residual add after each product to XLA. The plain
version (:func:`epilogue_plain`) is the chain the port has always run,
torch's ops in their order: the product cast to the activation dtype, the
bias (cast to that dtype) added, the residual added, then ReLU
(``clamp_min``), exact GELU or the tanh GELU (``gelu_tanh``, MaxViT's). The
kernel (``csrc/epilogue_fused.cu``)
does the same arithmetic in one read of each operand and one write, and
rounds at the same points, so on the card it gives the chain's bits.

``ops.fc.emit`` is the one caller: it sends a call to the kernel where
:func:`route` says so (a CUDA tensor emitted in bf16 with something to
fuse, contiguous rows of a multiple of 8 elements, not an int8 layer's
values) and runs the plain chain everywhere else (float32 emission, the
CPU, int8, odd widths, a cast alone).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from qcnn_tpu_torch.ops import misc
from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel

ACTIVATIONS = {"relu": misc.relu, "gelu": F.gelu,  # gelu: exact (erf)
               "gelu_tanh": functools.partial(F.gelu, approximate="tanh")}
_ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "gelu_tanh": 3}
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VECTOR = 8  # elements a vector of the kernel; a row is whole vectors

KERNEL = Kernel("epilogue_fused_launch", [  # y, bias, residual, out,
    PTR, PTR, PTR, PTR, ctypes.c_longlong,  # n,
    INT, INT, INT, PTR])  # C, product dtype, activation, stream


def check_act(act) -> None:
    if act is not None and act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}; expected one of "
                         f"{sorted(ACTIVATIONS)} or None")


def epilogue_plain(y: torch.Tensor, out_dtype, bias=None, act=None,
                   residual=None) -> torch.Tensor:
    """The chain in torch's ops: y cast to ``out_dtype`` (kept when None,
    and int8 codes stay codes), ``bias`` cast to that dtype and added,
    ``residual`` added, then the activation."""
    check_act(act)
    if out_dtype is not None and y.dtype not in (out_dtype, torch.int8):
        y = y.to(out_dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if residual is not None:
        y = y + residual
    if act is not None:
        y = ACTIVATIONS[act](y)
    return y


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def route(y: torch.Tensor, out_dtype, bias=None, act=None, residual=None,
          *, int8: bool = False) -> str:
    """``"kernel"`` where :func:`epilogue_fused` takes the call, else
    ``"plain"``. The kernel takes a CUDA product, bf16 or float32, emitted
    in bf16, with a bias, an activation or a residual to fuse (a cast
    alone stays torch's one vectorized pass); contiguous rows of C, a
    multiple of 8, 16-byte aligned; a float32 bias of C; a bf16 residual
    of y's shape; and not the values of an int8 layer (``int8``), which
    keep the plain chain."""
    if (int8 or y.device.type != "cuda" or out_dtype != torch.bfloat16
            or y.dtype not in _IN_DTYPES
            or (bias is None and act is None and residual is None)
            or act not in _ACT_CODES or y.dim() == 0 or y.numel() == 0
            or not y.is_contiguous() or y.shape[-1] % VECTOR
            or not _aligned(y)):
        return "plain"
    if bias is not None and (
            bias.dtype != torch.float32 or bias.device != y.device
            or tuple(bias.shape) != (y.shape[-1],)
            or not bias.is_contiguous() or not _aligned(bias)):
        return "plain"
    if residual is not None and (
            residual.dtype != torch.bfloat16 or residual.device != y.device
            or residual.shape != y.shape or not residual.is_contiguous()
            or not _aligned(residual)):
        return "plain"
    return "kernel"


def _launch(y, bias, act, residual) -> torch.Tensor:
    out = torch.empty(y.shape, dtype=torch.bfloat16, device=y.device)
    KERNEL.launch(y.data_ptr(), None if bias is None else bias.data_ptr(),
                  None if residual is None else residual.data_ptr(),
                  out.data_ptr(), y.numel(), y.shape[-1], _IN_DTYPES[y.dtype],
                  _ACT_CODES[act])
    return out


def epilogue(y: torch.Tensor, out_dtype, bias=None, act=None, residual=None,
             *, int8: bool = False) -> torch.Tensor:
    """The chain of :func:`epilogue_plain`, in one launch of the kernel
    where :func:`route` sends it, else in torch's ops."""
    if route(y, out_dtype, bias, act, residual, int8=int8) == "kernel":
        return _launch(y, bias, act, residual)
    return epilogue_plain(y, out_dtype, bias, act, residual)


def epilogue_fused(y: torch.Tensor, bias=None, act=None,
                   residual=None) -> torch.Tensor:
    """:func:`epilogue_plain` emitted in bf16, in one launch: y (..., C) on
    the card as :func:`route` takes it. Raises where the route would not
    take the call."""
    check_act(act)
    if route(y, torch.bfloat16, bias, act, residual) != "kernel":
        raise ValueError(
            f"epilogue_fused: the kernel does not take y {tuple(y.shape)} "
            f"{y.dtype} on {y.device} with bias "
            f"{None if bias is None else (tuple(bias.shape), bias.dtype)}, "
            f"act {act!r}, residual "
            f"{None if residual is None else (tuple(residual.shape), residual.dtype)}")
    return _launch(y, bias, act, residual)
