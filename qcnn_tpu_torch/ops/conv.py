"""Convolution ops: dense and PQ paths.

Port of ``qcnn_tpu/ops/conv.py``. Reference semantics: CalcFeatMap_ConvPrec
(CaffeEva.cc:681-758, per-group im2col + sgemm) and CalcFeatMap_ConvAprx
(:760-868). Output size floor((H + 2p - k)/s) + 1 (:361-362).

Activations are NHWC ``(B, H, W, C)`` at the public functions, as in the
JAX package. The convolution itself runs on the NCHW view of the same
memory (``channels_last``), and a kernel whose memory is OHWI — as every
decode of the port writes it — is a ``channels_last`` OIHW weight: neither
side is copied.

Strategy names keep the JAX vocabulary. Every in-step decode (``indecode``,
``indecode_ohwi``, ``indecode_hwoi``, ``gdecode``, ``gdecode_iohw``) runs the
``pq_decode`` kernel and differs only in the logical layout it hands to
``conv_dense``: the JAX package's one-hot decodes give the same bits as its
gather (qcnn_tpu/ops/lut.py:107-111) and only work around a slow TPU
gather. ``decode`` is the plain PyTorch gather.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.cuda import pq_decode

_NOT_PORTED = {
    "lut": "ROADMAP.md A4 (the LUT + one-hot conv formulation)",
    "gemm": "ROADMAP.md A4 (the im2col GEMM formulation)",
    "memory": "ROADMAP.md A4 (the per-op 'memory' im2col/decode mix)",
    "fusedconv": "ROADMAP.md B5 (qcnn_tpu/ops/pallas/pq_conv_fused.py)",
    "memory_fused": "ROADMAP.md B5 (qcnn_tpu/ops/pallas/pq_conv_fused.py)",
    "fc1x1": "ROADMAP.md B5 (the 1x1 reroute through pq_fc_fused)",
}

# in-step decode impl -> the logical kernel layout it hands to conv_dense
_INSTEP_LAYOUTS = {
    "indecode": "hwio",
    "gdecode": "hwio",
    "indecode_ohwi": "ohwi",
    "indecode_hwoi": "hwoi",
    "gdecode_iohw": "iohw",
}


def conv_dense(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    *,
    stride: int,
    pad: int,
    groups: int = 1,
    kernel_layout: str = "HWIO",
    out_dtype=None,
) -> torch.Tensor:
    """x: (B,H,W,Cin), kernel (kh,kw,Cin/groups,Cout) -> (B,Ho,Wo,Cout).

    Computes in the kernel's dtype with float32 accumulation, emitted in
    ``out_dtype`` (float32 when None), in which the bias is added — as the
    JAX package's ``preferred_element_type=out_dtype``.

    kernel_layout: any permutation of "HWIO" naming the kernel's axes.
    """
    if x.dtype == torch.int8:
        # int8 activations are quantized codes (qcnn_tpu/ops/conv.py:164-171)
        raise ValueError(
            "conv_dense received int8 activation codes; the consumer "
            "must be conv_dense_int8 or the producer must not requantize"
        )
    layout = kernel_layout.upper()
    if sorted(layout) != sorted("HWIO"):
        raise ValueError(f"kernel_layout must permute 'HWIO', got "
                         f"{kernel_layout!r}")
    if x.dtype != kernel.dtype:
        x = x.to(kernel.dtype)
    w = kernel.permute(*(layout.index(c) for c in "OIHW"))
    xn = x.permute(0, 3, 1, 2)
    out_dtype = out_dtype or torch.float32
    if out_dtype == kernel.dtype:
        y = F.conv2d(xn, w, stride=stride, padding=pad, groups=groups)
    else:
        # widen exactly, sum in f32, round once
        y = F.conv2d(xn.float(), w.float(), stride=stride, padding=pad,
                     groups=groups).to(out_dtype)
    y = y + bias.to(out_dtype)[:, None, None]
    return y.permute(0, 2, 3, 1)


def pq_conv_decode(
    x: torch.Tensor, params: dict, *, stride: int, pad: int, groups: int = 1,
    layout: str | None = None, out_dtype=None,
) -> torch.Tensor:
    """PQ conv via a kernel decode + dense conv. layout=None decodes with
    the plain gather (HWIO); a layout name ('hwio', 'ohwi', 'hwoi', 'iohw')
    decodes with the ``pq_decode`` kernel and hands that logical layout on."""
    cg = x.shape[-1] // groups
    if layout is None:
        kernel = lut_ops.decode_conv_kernel(
            params["codebooks"], params["assignments"], cg)
        layout = "hwio"
    else:
        kernel = pq_decode.decode_conv_kernel_gather(
            params["codebooks"], params["assignments"], cg, layout=layout)
    return conv_dense(
        x, kernel, params["bias"], stride=stride, pad=pad, groups=groups,
        kernel_layout=layout.upper(), out_dtype=out_dtype,
    )


def pq_conv(
    x: torch.Tensor,
    params: dict,
    *,
    stride: int,
    pad: int,
    groups: int = 1,
    impl: str = "decode",
    out_dtype=None,
) -> torch.Tensor:
    """PQ conv by strategy name (see the module docstring)."""
    if impl in _NOT_PORTED:
        raise NotImplementedError(
            f"pq_conv impl {impl!r} is not ported yet: {_NOT_PORTED[impl]}")
    if impl != "decode" and impl not in _INSTEP_LAYOUTS:
        raise ValueError(f"unknown pq_conv impl: {impl}")
    if "perm" in params:
        # OPQ channel permutation (quantizer/opq.py): codebooks are shared
        # across groups, so the same within-group permutation applies to
        # each group's channel block
        perm = params["perm"].long()
        cg = x.shape[-1] // groups
        if groups > 1:
            perm = torch.cat([perm + g * cg for g in range(groups)])
        x = torch.index_select(x, -1, perm)
    return pq_conv_decode(
        x, params, stride=stride, pad=pad, groups=groups,
        layout=_INSTEP_LAYOUTS.get(impl), out_dtype=out_dtype,
    )
