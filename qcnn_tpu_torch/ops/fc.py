"""Fully-connected ops: dense and PQ paths.

Port of ``qcnn_tpu/ops/fc.py``. Reference semantics: CalcFeatMap_FCntPrec
(CaffeEva.cc:932-966, one sgemm with transposed weights + bias) and
CalcFeatMap_FCntAprx (:968-1025, LUT build once per batch then
per-subspace gather-accumulate).

Strategy names keep the JAX vocabulary. In-step decodes (``indecode``,
``gdecode``) run the ``pq_decode`` kernel, ``lutgather`` the
``pq_lut_gather`` kernel, ``pallas`` the ``pq_fc`` kernel and
``fused``/``fgather`` the ``pq_fc_fused`` kernel; ``onehot``, ``gather`` and
``decode`` are plain PyTorch.

int8 execution (``fc_dense_int8``, shared with ``ops.conv``): symmetric
per-tensor activation codes times per-output-channel weight codes, summed
in int32 by :func:`int8_matmul`, which is cuBLASLt's int8 GEMM
(``torch._int_mm``) on the card, as the JAX package leaves its int8
``dot_general`` to XLA.
"""

from __future__ import annotations

import contextlib

import torch

from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.cuda import (
    pq_decode,
    pq_fc as pq_fc_kernel,
    pq_fc_fused,
    pq_lut_gather,
)

# the JAX Pallas gather's one-vreg table, kept on the names whose JAX entry
# points raise past it (qcnn_tpu/ops/pallas/pq_decode.py:88-92)
GDECODE_MAX_CODEWORDS = 128
# the smallest operands torch._int_mm takes on the card: more than 16 rows,
# K and N multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8


def check_gdecode_codewords(codebooks: torch.Tensor) -> None:
    """The 'gdecode' names keep the JAX entry points' K <= 128 (the other
    in-step decodes take any uint8 id)."""
    k = codebooks.shape[1]
    if k > GDECODE_MAX_CODEWORDS:
        raise ValueError(
            f"gather decode supports K <= {GDECODE_MAX_CODEWORDS} (one vreg "
            f"of lanes); got K={k}")


@contextlib.contextmanager
def _no_tf32():
    """float32 matmuls inside run in IEEE float32, whatever the caller's
    global setting (``torch.set_float32_matmul_precision``): TF32 would
    round their operands to 10 mantissa bits."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def matmul(x: torch.Tensor, weight: torch.Tensor, out_dtype) -> torch.Tensor:
    """x @ weight (batched as ``torch.matmul``) in the weight's dtype with
    float32 sums, emitted in ``out_dtype`` (float32 when None), as
    ``jnp.dot(..., preferred_element_type=out_dtype or f32)``."""
    out_dtype = out_dtype or torch.float32
    if out_dtype == weight.dtype and weight.dtype != torch.float32:
        return torch.matmul(x, weight)
    # widen exactly, sum in f32 without TF32, round once
    with _no_tf32():
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
    out = matmul(x, weight, out_dtype)
    return out + bias.to(out.dtype)


def padded_k(k: int) -> int:
    """A K (or N) of the int8 GEMM, padded to the next multiple of 8."""
    return -(-k // INT_MM_ALIGN) * INT_MM_ALIGN


def _scale_tensor(scale, device) -> torch.Tensor:
    """A static scale as a float32 scalar on ``device``, floored at
    1e-12/127: a zero scale quantizes to zeros, not NaN. A tensor divisor
    (not a Python float) keeps the division a true division on the card."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    return torch.clamp_min(s, 1e-12 / 127.0)


def quantize_activations_int8(x: torch.Tensor, act_scale=None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 codes: (x_q, scale) with x ~ x_q * scale
    (qcnn_tpu/ops/fc.py:44-81).

    act_scale: a static scale from a calibration pass
    (``models.calibrate``); None takes the dynamic amax of |x|. int8 input
    is a producer's codes already in this layer's scale and passes through;
    it needs ``act_scale``. Codes are round-half-to-even, clipped to
    [-127, 127]."""
    if x.dtype == torch.int8:
        if act_scale is None:
            raise ValueError(
                "int8-domain activations need a static act_scale (the "
                "producer's out_scale) — dynamic amax cannot recover the "
                "quantization grid from codes")
        return x, _scale_tensor(act_scale, x.device)
    xf = x.float()
    if act_scale is None:
        scale = torch.clamp_min(xf.abs().amax(), 1e-12) / 127.0
    else:
        scale = _scale_tensor(act_scale, x.device)
    xq = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return xq, scale


def requantize_int8(acc: torch.Tensor, x_scale: torch.Tensor,
                    w_scale: torch.Tensor, bias: torch.Tensor,
                    out_scale) -> torch.Tensor:
    """int32 sums -> int8 codes in the consumer's scale:
    clip(round(acc * (x_scale * w_scale) / out_scale + bias / out_scale)),
    in the JAX package's order of float32 operations
    (qcnn_tpu/ops/fc.py:84-102)."""
    out_scale = _scale_tensor(out_scale, acc.device)
    m = (x_scale * w_scale) / out_scale
    y = acc.float() * m + bias / out_scale
    return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, through float64: exact,
    since |a @ b| <= K * 127^2 < 2^53 for any K a layer has."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def pad_k_columns(b: torch.Tensor, k_pad: int) -> torch.Tensor:
    """b (K, N) as (k_pad, N). A column-major b whose columns already lie
    k_pad apart in its storage (``models.prepare`` holds int8 weights so,
    with the gap zeroed) is widened as a view; any other b is copied into
    a zeroed column-major buffer. Rows past K meet zero activation columns,
    so they add nothing to the sums either way."""
    k, n = b.shape
    if k == k_pad:
        return b
    end = b.storage_offset() + (n - 1) * b.stride(1) + k_pad
    if (b.stride(0) == 1 and b.stride(1) >= k_pad
            and end * b.element_size() <= b.untyped_storage().nbytes()):
        return b.as_strided((k_pad, n), (1, b.stride(1)))
    out = torch.zeros((n, k_pad), dtype=b.dtype, device=b.device)
    out[:, :k] = b.t()
    return out.t()


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, the int8 GEMM of every
    int8 conv and fc.

    On the card it is cuBLASLt's int8 GEMM (``torch._int_mm``), whose
    operands must have more than 16 rows and K and N multiples of 8: they
    are zero-padded to that (exact) and the result is sliced. b is best
    column-major (the transpose view of a (N, K) weight), the layout the
    int8 GEMM takes without a copy. On the CPU the same padded operands go
    through :func:`int8_matmul_plain`."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"int8_matmul takes int8 operands, got {a.dtype} "
                         f"and {b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"int8_matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    k_pad, n_pad = padded_k(k), padded_k(n)
    m_pad = max(m, INT_MM_MIN_ROWS)
    if (m_pad, k_pad) != (m, k):
        a = torch.nn.functional.pad(a, (0, k_pad - k, 0, m_pad - m))
    b = pad_k_columns(b, k_pad)
    if n_pad != n:
        b = torch.nn.functional.pad(b.t(), (0, 0, 0, n_pad - n)).t()
    if a.device.type == "cpu":
        acc = int8_matmul_plain(a, b)
    else:
        acc = torch._int_mm(a, b)
    return acc[:m, :n]


def fc_dense_int8(x: torch.Tensor, weight_q: torch.Tensor,
                  w_scale: torch.Tensor, bias: torch.Tensor, act_scale=None,
                  out_scale=None) -> torch.Tensor:
    """int8 fc: weight_q (Cin, Cout) int8 with per-output-channel scales
    (``models.prepare`` int8 mode; the (Cin, Cout) view of (Cout, Cin)
    memory), activations quantized with a static or dynamic scale.

    out_scale: emit int8 codes in the consumer's calibrated scale
    (:func:`requantize_int8`, the int8-native dataflow) instead of float32
    values (qcnn_tpu/ops/fc.py:105-131)."""
    xq, x_scale = quantize_activations_int8(x, act_scale)
    acc = int8_matmul(xq, weight_q)
    if out_scale is not None:
        return requantize_int8(acc, x_scale, w_scale, bias, out_scale)
    return acc.float() * (x_scale * w_scale) + bias


def pq_fc_onehot(x: torch.Tensor, params: dict, out_dtype=None
                 ) -> torch.Tensor:
    """PQ FC via the LUT and a one-hot contraction over (S, K)
    (qcnn_tpu/ops/fc.py:134-148), in plain PyTorch; float32 sums emitted in
    ``out_dtype`` (float32 when None), in which the bias is added."""
    codebooks = params["codebooks"]
    k = codebooks.shape[1]
    lut = lut_ops.build_lut(x, codebooks)  # (B, S, K) float32
    onehot = torch.nn.functional.one_hot(
        params["assignments"].t().long(), k).float()  # (S, Cout, K)
    out_dtype = out_dtype or torch.float32
    out = torch.einsum("bsk,sok->bo", lut, onehot).to(out_dtype)
    return out + params["bias"].to(out_dtype)


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


def pq_fc_indecode(x: torch.Tensor, params: dict, out_dtype=None,
                   decoded: torch.Tensor | None = None) -> torch.Tensor:
    """Memory-mode PQ FC: decode the dense weight inside the step with the
    ``pq_decode`` kernel, then the dense GEMM. Only the compressed params
    stay resident; the dense copy is a transient.

    decoded: the layer's (Cout, Cin) rows from a grouped decode
    (:func:`instep_decodes`) in place of its own launch."""
    if decoded is None:
        decoded = pq_decode.decode_rows(params["codebooks"],
                                        params["assignments"], x.shape[-1])
    return fc_dense(x, decoded.t(), params["bias"], out_dtype=out_dtype)


def instep_decodes(fcs: dict) -> dict:
    """Decode, in one ``pq_decode`` launch, every FC of a group that runs
    an in-step decode impl ('indecode', 'gdecode').

    fcs: {key: (params, impl, Cin)}; entries with another impl are
    skipped. Returns {key: (Cout, Cin) rows} to hand to :func:`pq_fc` as
    ``decoded``. The weights of the group live until the caller drops the
    dict."""
    keys = [key for key, (_, impl, _) in fcs.items()
            if impl in ("indecode", "gdecode")]
    rows = pq_decode.decode_rows_many(
        [(fcs[key][0]["codebooks"], fcs[key][0]["assignments"], fcs[key][2])
         for key in keys])
    return dict(zip(keys, rows))


def pq_fc(x: torch.Tensor, params: dict, impl: str = "onehot",
          out_dtype=None, decoded: torch.Tensor | None = None
          ) -> torch.Tensor:
    """PQ FC by strategy name. out_dtype: the dtype emitted by the one-hot
    and decode-GEMM impls; the gather and kernel impls emit float32 and the
    caller casts. decoded: the layer's rows from :func:`instep_decodes`,
    for the in-step decode impls."""
    if "perm" in params:
        # OPQ input permutation (quantizer/opq.py): sub-spaces were fit on
        # w[:, perm], so every in-graph formulation consumes x[..., perm]
        x = torch.index_select(x, -1, params["perm"].long())
    if impl == "onehot":
        return pq_fc_onehot(x, params, out_dtype=out_dtype)
    if impl == "gather":
        return pq_fc_gather(x, params)
    if impl == "decode":
        return pq_fc_decode(x, params, out_dtype=out_dtype)
    if impl in ("indecode", "gdecode"):
        # the JAX package decodes 'indecode' by one-hot matmul and
        # 'gdecode' by its Pallas gather; both are the same bits, and both
        # run the pq_decode kernel here
        if impl == "gdecode":
            check_gdecode_codewords(params["codebooks"])
        return pq_fc_indecode(x, params, out_dtype=out_dtype,
                              decoded=decoded)
    if impl == "pallas":
        return pq_fc_kernel.pq_fc_pallas(x, params)
    if impl == "lutgather":
        return pq_lut_gather.pq_fc_lut_gather(x, params)
    if impl == "fused":
        return pq_fc_fused.pq_fc_fused(x, params, decode="select")
    if impl == "fgather":
        return pq_fc_fused.pq_fc_fused(x, params, decode="gather")
    raise ValueError(f"unknown pq_fc impl: {impl}")
