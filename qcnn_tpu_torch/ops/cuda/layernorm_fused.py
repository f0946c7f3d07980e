"""LayerNorm over the last axis in one pass: the ``layernorm_fused`` CUDA
kernel, its plain version and its route.

Replaces no Pallas kernel: the JAX package leaves LayerNorm to XLA. The
plain version (:func:`layernorm_plain`) is the form the port has always
run, the float32 form: x widened to float32, ``F.layer_norm`` with the
float32 scale and shift, the result cast back to x's dtype (three passes
for a bf16 x). The kernel (``csrc/layernorm_fused.cu``) reads a bf16 row
once, keeps the statistics in float32 (the mean, then the biased variance
as a second sum of squared deviations over the row held in registers),
applies the scale and shift in float32 in the float32 form's order and
rounds the result to bf16 once. Its statistics are summed in another
order than torch's Welford update, so an element may round to the
neighbouring bf16 value, or, where the shift nearly cancels it, differ by
the float32 rounding of its terms (tests/test_torch_layernorm_route.py).

``models.transformer.layernorm``, which every ViT, Swin and MaxViT
LayerNorm calls, sends a call to the kernel where :func:`route` says so (a
bf16 CUDA x, contiguous and 16-byte aligned, rows of a multiple of 8 up to
``MAX_WIDTH``, float32 scale and shift of that width beside it) and runs
the float32 form everywhere else: the CPU, float32 activations (the
quantizer's calibration, the references), odd widths.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel

VECTOR = 8  # elements a vector of the kernel; a row is whole vectors
MAX_WIDTH = 4096  # the widest row the kernel takes (its general instance)

KERNEL = Kernel("layernorm_fused_launch", [  # x, scale, shift, out,
    PTR, PTR, PTR, PTR, ctypes.c_longlong,  # rows,
    INT, ctypes.c_float, PTR])  # C, eps, stream


def layernorm_plain(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """The float32 form: (x - mean) / sqrt(var + eps) * p["scale"] +
    p["shift"] over the last axis by ``F.layer_norm`` on x widened to
    float32, cast back to x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"], p["shift"],
                        eps).to(x.dtype)


def _aligned(t) -> bool:
    return t.data_ptr() % 16 == 0


def route(x: torch.Tensor, p: dict) -> str:
    """``"kernel"`` where :func:`layernorm_fused` takes the call, else
    ``"plain"``. The kernel takes a bf16 CUDA x, contiguous, 16-byte
    aligned, with rows of C elements, C a multiple of 8 and at most
    ``MAX_WIDTH``; and ``p["scale"]``, ``p["shift"]`` float32 of shape (C,)
    on x's device, contiguous and 16-byte aligned."""
    if (x.device.type != "cuda" or x.dtype != torch.bfloat16
            or x.dim() == 0 or x.numel() == 0 or not x.is_contiguous()
            or x.shape[-1] % VECTOR or x.shape[-1] > MAX_WIDTH
            or not _aligned(x)):
        return "plain"
    for t in (p["scale"], p["shift"]):
        if (t.dtype != torch.float32 or t.device != x.device
                or tuple(t.shape) != (x.shape[-1],)
                or not t.is_contiguous() or not _aligned(t)):
            return "plain"
    return "kernel"


def layernorm_fused(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """:func:`layernorm_plain`'s function for x on the card as :func:`route`
    takes it, in one launch. Raises where the route would not take the
    call."""
    if route(x, p) != "kernel":
        scale, shift = p["scale"], p["shift"]
        raise ValueError(
            f"layernorm_fused: the kernel does not take x {tuple(x.shape)} "
            f"{x.dtype} on {x.device} with scale "
            f"{(tuple(scale.shape), scale.dtype, str(scale.device))} and "
            f"shift {(tuple(shift.shape), shift.dtype, str(shift.device))}")
    out = torch.empty_like(x)
    c = x.shape[-1]
    KERNEL.launch(x.data_ptr(), p["scale"].data_ptr(), p["shift"].data_ptr(),
                  out.data_ptr(), x.numel() // c, c, eps)
    return out
