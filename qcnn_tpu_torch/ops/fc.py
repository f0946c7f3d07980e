"""Fully-connected ops: dense and PQ paths.

Port of ``qcnn_tpu/ops/fc.py``. Reference semantics: CalcFeatMap_FCntPrec
(CaffeEva.cc:932-966, one sgemm with transposed weights + bias) and
CalcFeatMap_FCntAprx (:968-1025, LUT build once per batch then
per-subspace gather-accumulate).

Strategy names keep the JAX vocabulary. In-step decodes (``indecode``,
``gdecode``) run the ``pq_decode`` kernel, ``lutgather`` the
``pq_lut_gather`` kernel, ``pallas`` the ``pq_fc`` kernel and
``fused``/``fgather`` the ``pq_fc_fused`` kernel; ``gather`` and ``decode``
are plain PyTorch.
"""

from __future__ import annotations

import torch

from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.cuda import (
    pq_decode,
    pq_fc as pq_fc_kernel,
    pq_fc_fused,
    pq_lut_gather,
)

_NOT_PORTED = {
    "onehot": "ROADMAP.md A4 (the one-hot LUT contraction)",
}


def _matmul(x: torch.Tensor, weight: torch.Tensor, out_dtype) -> torch.Tensor:
    """x @ weight in the weight's dtype with float32 sums, emitted in
    ``out_dtype`` (float32 when None), as ``jnp.dot(...,
    preferred_element_type=out_dtype or f32)``."""
    out_dtype = out_dtype or torch.float32
    if out_dtype == weight.dtype:
        return torch.matmul(x, weight)
    # widen exactly, sum in f32, round once
    return torch.matmul(x.float(), weight.float()).to(out_dtype)


def fc_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             out_dtype=None) -> torch.Tensor:
    """x: (B, Cin), weight: (Cin, Cout) -> (B, Cout). Computes in the
    weight's dtype with float32 accumulation; ``out_dtype`` is the emitted
    dtype, in which the bias is added (float32 when None)."""
    if x.dtype == torch.int8:
        # int8 activations are quantized codes; a float op would read them
        # as values (qcnn_tpu/ops/fc.py:24-34)
        raise ValueError(
            "fc_dense received int8 activation codes; the consumer must "
            "be an int8 op (fc_dense_int8) or the producer must not "
            "requantize (out_scale)"
        )
    if x.dtype != weight.dtype:
        x = x.to(weight.dtype)
    out = _matmul(x, weight, out_dtype)
    return out + bias.to(out.dtype)


def pq_fc_gather(x: torch.Tensor, params: dict) -> torch.Tensor:
    """PQ FC via the explicit LUT gather (the reference's pointer walk,
    CaffeEva.cc:1006-1017), in plain PyTorch. (B, Cout) float32."""
    lut = lut_ops.build_lut(x, params["codebooks"])  # (B, S, K)
    return pq_lut_gather.lut_gather_plain(lut, params["assignments"],
                                          params["bias"])


def pq_fc_decode(x: torch.Tensor, params: dict, out_dtype=None) -> torch.Tensor:
    """PQ FC via a plain decode to dense + GEMM."""
    w = lut_ops.decode_fc_weight(params["codebooks"], params["assignments"],
                                 x.shape[-1])
    return fc_dense(x, w, params["bias"], out_dtype=out_dtype)


def pq_fc_indecode(x: torch.Tensor, params: dict,
                   out_dtype=None) -> torch.Tensor:
    """Memory-mode PQ FC: decode the dense weight inside the step with the
    ``pq_decode`` kernel, then the dense GEMM. Only the compressed params
    stay resident; the dense copy is a transient."""
    w = pq_decode.decode_fc_weight_gather(
        params["codebooks"], params["assignments"], x.shape[-1])
    return fc_dense(x, w, params["bias"], out_dtype=out_dtype)


def pq_fc(x: torch.Tensor, params: dict, impl: str = "gather",
          out_dtype=None) -> torch.Tensor:
    """PQ FC by strategy name. out_dtype: the dtype emitted by decode-GEMM
    impls; the gather and kernel impls emit float32 and the caller casts."""
    if impl in _NOT_PORTED:
        raise NotImplementedError(
            f"pq_fc impl {impl!r} is not ported yet: {_NOT_PORTED[impl]}")
    if "perm" in params:
        # OPQ input permutation (quantizer/opq.py): sub-spaces were fit on
        # w[:, perm], so every in-graph formulation consumes x[..., perm]
        x = torch.index_select(x, -1, params["perm"].long())
    if impl == "gather":
        return pq_fc_gather(x, params)
    if impl == "decode":
        return pq_fc_decode(x, params, out_dtype=out_dtype)
    if impl in ("indecode", "gdecode"):
        # the JAX package decodes 'indecode' by one-hot matmul and
        # 'gdecode' by its Pallas gather; both are the same bits, and both
        # run the pq_decode kernel here
        return pq_fc_indecode(x, params, out_dtype=out_dtype)
    if impl == "pallas":
        return pq_fc_kernel.pq_fc_pallas(x, params)
    if impl == "lutgather":
        return pq_lut_gather.pq_fc_lut_gather(x, params)
    if impl == "fused":
        return pq_fc_fused.pq_fc_fused(x, params, decode="select")
    if impl == "fgather":
        return pq_fc_fused.pq_fc_fused(x, params, decode="gather")
    raise ValueError(f"unknown pq_fc impl: {impl}")
