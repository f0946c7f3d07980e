"""A Swin block's window attention, or a MaxViT block's block or grid
attention, in one pass: the launcher of the ``window_attention_fused`` CUDA
kernel and its argument checks.

Replaces no Pallas kernel: the JAX package has no Swin. The plain version
is ``models.swin.window_attention_plain``, the chain the port ran since the
Swin family came in: the window partition, q kᵀ widened to float32 and
summed without TF32, the division by sqrt(head dim) in float32, the block's
bias (the relative-position bias, plus the -100 shift mask in a shifted
block) added in float32, the float32 softmax with its probabilities rounded
once to v's dtype, the product with v summed in float32 and emitted in
``out_dtype``, and the window reverse with the heads merged. The kernel
(``csrc/window_attention_fused.cu``) computes that function at the same
rounding points in one launch, for bf16 q/k/v, a head dimension in
``HEAD_DIMS`` and windows of at most ``MAX_TOKENS`` tokens: it reads q, k
and v in place from the qkv projection's output on the block's grid, so the
partition, head split, head merge and reverse are its addressing, and it
never rounds the logits to bf16. Its sums run in another order, its exp is
the card's ``ex2`` and its division a multiply by the row's reciprocal, so
a probability on a bf16 rounding boundary may round the other way.

The kernel and the plain version take qkv as (B, G, G, 3 C) on the
block's (rolled) grid, C = heads x head dimension, with q, k and v at
channels [0, C), [C, 2C) and [2C, 3C), head h at h x head dimension within
each, and return (B, G, G, C). The bias is (heads, N, N), or (windows,
heads, N, N) with the windows of one image in row-major order (a size-1
heads axis broadcasts), float32, N = window².

``partition`` says which tokens make a window (``PARTITIONS``): "block",
the contiguous window x window squares of the grid (Swin; MaxViT's block
attention), or "grid", MaxViT's grid attention, where window (a, b) holds
the tokens at row i (G / window) + a, column j (G / window) + b for token
(i, j): a window x window grid dilated across the whole map. Windows are in
row-major order of (a, b) either way, tokens in row-major order of (i, j).
``models.swin.window_attention_route`` sends bf16 CUDA tensors here; the
wrapper launches the kernel or raises ValueError, on a CPU tensor too.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel

HEAD_DIMS = (32,)  # the head dimensions the kernel is compiled for
MAX_TOKENS = 144  # the largest window (window² tokens) it takes: 12 x 12
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PARTITIONS = {"block": 0, "grid": 1}  # the kernel's compile-time cases
_LL = ctypes.c_longlong

KERNEL = Kernel("window_attention_fused_launch", [  # qkv and its strides,
    PTR, _LL, _LL, _LL, PTR, _LL, _LL, PTR,  # bias, its strides, out,
    INT, INT, INT, INT, INT,  # batch, grid, window, heads, head dimension,
    ctypes.c_float, INT, INT, PTR])  # scale, out dtype, partition, stream


def scale_of(hd: int) -> float:
    """1 / sqrt(hd) as the card's chain multiplies by it: the float32
    reciprocal of sqrt(hd) rounded to float32 (torch divides a CUDA tensor
    by a scalar as a product with its reciprocal)."""
    return float(np.float32(1.0) / np.float32(math.sqrt(hd)))


def _check(qkv: torch.Tensor, bias: torch.Tensor, heads: int, window: int,
           out_dtype, partition: str = "block") -> tuple[int, int]:
    """(grid, head dimension) of a call the kernel takes; raises
    ValueError on any other. The device is checked last, so that every
    other check can be seen on tensors that are nowhere ('meta')."""
    if qkv.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise ValueError(f"window_attention_fused: qkv must be bfloat16 and "
                         f"bias float32, got {qkv.dtype} and {bias.dtype}")
    if partition not in PARTITIONS:
        raise ValueError(f"window_attention_fused: partition must be one of "
                         f"{sorted(PARTITIONS)}, got {partition!r}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"window_attention_fused: out_dtype must be float32 "
                         f"or bfloat16, got {out_dtype}")
    if qkv.dim() != 4 or qkv.shape[1] != qkv.shape[2]:
        raise ValueError(f"window_attention_fused: qkv must be (B, G, G, 3C), "
                         f"got {tuple(qkv.shape)}")
    grid = qkv.shape[1]
    if heads < 1 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"window_attention_fused: {qkv.shape[-1]} channels "
                         f"do not split into q, k and v of {heads} heads")
    hd = qkv.shape[-1] // (3 * heads)
    if hd not in HEAD_DIMS:
        raise ValueError(f"window_attention_fused: head dimension {hd} is "
                         f"not one of {HEAD_DIMS}")
    n = window * window
    if window < 1 or grid < window or grid % window or n > MAX_TOKENS:
        raise ValueError(
            f"window_attention_fused: window {window} must divide the grid "
            f"of {grid} and hold at most {MAX_TOKENS} tokens")
    windows = (grid // window) ** 2
    if not ((bias.dim() == 3 and tuple(bias.shape) == (heads, n, n)) or (
            bias.dim() == 4 and bias.shape[0] == windows
            and bias.shape[1] in (1, heads)
            and tuple(bias.shape[2:]) == (n, n))):
        raise ValueError(
            f"window_attention_fused: bias must be ({heads}, {n}, {n}) or "
            f"({windows}, {heads}, {n}, {n}), got {tuple(bias.shape)}")
    if qkv.device.type != "cuda" or bias.device != qkv.device:
        raise ValueError(
            "window_attention_fused: qkv and bias must share one CUDA "
            f"device, got {qkv.device} and {bias.device}")
    return grid, hd


def window_attention_fused(qkv: torch.Tensor, bias: torch.Tensor, *,
                           heads: int, window: int, out_dtype=None,
                           partition: str = "block") -> torch.Tensor:
    """softmax(q kᵀ / sqrt(hd) + bias) v over the window² tokens of each
    window and head, in place on the grid: (B, G, G, 3 C) bf16 qkv ->
    (B, G, G, C) in ``out_dtype`` (float32 when None); the windows by
    ``partition`` ("block" or "grid")."""
    out_dtype = out_dtype or torch.float32
    grid, hd = _check(qkv, bias, heads, window, out_dtype, partition)
    if (qkv.stride(-1) != 1 or qkv.data_ptr() % 16
            or any(s % 8 for s in qkv.stride()[:3])):
        qkv = qkv.contiguous()
        if qkv.data_ptr() % 16:
            qkv = qkv.clone()
    n = window * window
    if bias.stride(-1) != 1 or bias.stride(-2) != n:
        bias = bias.contiguous()
    if bias.dim() == 3:
        bias_sw, bias_sh = 0, bias.stride(0)
    else:
        bias_sw = bias.stride(0)
        bias_sh = bias.stride(1) if bias.shape[1] == heads else 0
    b = qkv.shape[0]
    out = torch.empty((b, grid, grid, heads * hd), dtype=out_dtype,
                      device=qkv.device)
    KERNEL.launch(qkv.data_ptr(), *qkv.stride()[:3], bias.data_ptr(),
                  bias_sw, bias_sh, out.data_ptr(), b, grid, window, heads,
                  hd, scale_of(hd), _OUT_DTYPES[out_dtype],
                  PARTITIONS[partition])
    return out
