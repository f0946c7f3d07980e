"""A ViT block's attention in one pass: the ``attention_fused`` CUDA kernel
and its plain version.

Replaces no Pallas kernel: the JAX package leaves attention to XLA
(``qcnn_tpu/models/vit.py`` ``_masked_attention``). The kernel
(``csrc/attention_fused.cu``) computes the function of the port's
materialized chain (``models.vit._masked_attention`` with bf16 logits, at a
head dimension of 64, whose scale 1/8 is a power of two): q kᵀ summed in
float32, times ``scale``, rounded once to bf16; the softmax's max and sum
in float32 over those rounded logits; the probabilities in bf16; their
product with v summed in float32 and emitted in ``out_dtype``. It keeps the logits out of device memory by the online
softmax, so each probability is rounded to bf16 before the division by its
row's sum, where the chain divides first: one rounding moves, the
precision stays.

q, k and v are (B, N, H, hd) and may be strided views of one qkv tensor
(the qkv projection's output), which the kernel reads in place; the output
is a dense (B, N, H * hd) tensor, returned as its (B, N, H, hd) view.
``models.vit.attention_route`` sends a bf16 CUDA tensor with bf16 logits
and a head dimension in ``HEAD_DIMS`` here. On a CPU tensor the wrapper
runs :func:`attention_plain`; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel

HEAD_DIMS = (64,)  # the head dimensions the kernel is compiled for
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LL = ctypes.c_longlong

KERNEL = Kernel("attention_fused_launch", [  # q, k, v, out, their strides,
    PTR, PTR, PTR, PTR, *[_LL] * 9, INT, INT, INT, INT,  # B, N, H, hd,
    ctypes.c_float, INT, PTR])  # scale, out dtype, stream


def _check_scale(scale: float) -> None:
    if not (scale > 0 and math.frexp(scale)[0] == 0.5):
        raise ValueError(f"attention_fused: scale must be a power of two, "
                         f"got {scale}")


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, out_dtype=None) -> torch.Tensor:
    """The kernel's function in PyTorch, as ``models.vit``'s chain computes
    it for bf16 q/k/v with bf16 logits (``vit._logits``): the bf16 product
    (float32 sums, rounded once) times ``scale``, a power of two, which is
    exact."""
    from qcnn_tpu_torch.ops import fc as fc_ops  # ops/fc imports ops.cuda

    _check_scale(scale)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, hd)
    logits = fc_ops.matmul(q, k.transpose(-1, -2), torch.bfloat16) * scale
    att = torch.softmax(logits, dim=-1, dtype=torch.float32).to(v.dtype)
    return fc_ops.matmul(att, v, out_dtype).transpose(1, 2)


def _in_place(t: torch.Tensor) -> torch.Tensor:
    """t itself where the kernel can read it by its strides (a dense last
    dimension, 16-byte aligned, strides of whole 16-byte groups), else a
    dense copy."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:3])):
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, out_dtype=None) -> torch.Tensor:
    """softmax(q kᵀ * scale) v over the N tokens of each (batch, head).

    q, k, v: (B, N, H, hd) bf16; scale: a power of two; out_dtype: float32
    (when None) or bf16. Returns (B, N, H, hd) in out_dtype, a view of a
    dense (B, N, H * hd) tensor."""
    _check_scale(scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, out_dtype=out_dtype)
    out_dtype = out_dtype or torch.float32
    if {t.device for t in (q, k, v)} != {q.device} or q.device.type != "cuda":
        raise ValueError(
            "attention_fused: q, k and v must share one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention_fused: q, k, v must be (B, N, H, hd) "
                         f"alike, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if {t.dtype for t in (q, k, v)} != {torch.bfloat16}:
        raise ValueError(f"attention_fused: q, k, v must be bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, n, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"attention_fused: head dimension {hd} is not one "
                         f"of {HEAD_DIMS}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"attention_fused: out_dtype must be float32 or "
                         f"bfloat16, got {out_dtype}")
    q, k, v = (_in_place(t) for t in (q, k, v))
    out = torch.empty((b, n, h * hd), dtype=out_dtype, device=q.device)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], b, n, h,
                  hd, float(scale), _OUT_DTYPES[out_dtype])
    return out.view(b, n, h, hd)
