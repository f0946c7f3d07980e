"""PQ primitives: codebook decode and inner-product LUT construction.

Port of ``qcnn_tpu/ops/lut.py``. The reference's hot path is two-phase
(SURVEY.md §3.2): an inner-product LUT per input sub-vector (GetInPdMat,
CaffeEva.cc:1261-1296), then a per-output gather-accumulate over it
(CaffeEva.cc:848-861, :1006-1017). Decoding the PQ weights back to dense
(W[o] = concat_s C[s, A[o,s]]) gives the same function as one dense product.

The decodes here are plain gathers. The JAX package's one-hot decodes
(``decode_*_onehot``) only work around a slow TPU gather and give the same
bits, so they are not ported: every in-step decode of the port runs the
``pq_decode`` kernel (``ops/cuda/pq_decode.py``), whose plain version is
:func:`decode_rows` below. :func:`assignments_one_hot` is the one-hot kernel
of the LUT conv formulation (``ops.conv.pq_conv_lut``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_features(x: torch.Tensor, subvector_len_total: int) -> torch.Tensor:
    """Zero-pad the trailing feature axis to S*D (the reference clamps the
    last, overhanging sub-space, GetInPdMat CaffeEva.cc:1277; zeros give
    the same inner products)."""
    deficit = subvector_len_total - x.shape[-1]
    if deficit == 0:
        return x
    if deficit < 0:
        raise ValueError(
            f"features {x.shape[-1]} exceed codebook span {subvector_len_total}"
        )
    return F.pad(x, (0, deficit))


def build_lut(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Inner-product lookup table.

    Args:
      x: (..., Cin) activations with Cin <= S*D.
      codebooks: (S, K, D).
    Returns:
      (..., S, K) float32 — lut[..., s, k] = <x[..., s*D:(s+1)*D], C[s, k]>.
      Operands are widened to f32 before the product (exact for bf16), as
      the JAX package's ``preferred_element_type=float32`` contraction.
    """
    s, k, d = codebooks.shape
    xp = pad_features(x, s * d).float()
    xs = xp.reshape(*xp.shape[:-1], s, d)
    return torch.einsum("...sd,skd->...sk", xs, codebooks.float())


def decode_rows(codebooks: torch.Tensor, assignments: torch.Tensor,
                row_len: int) -> torch.Tensor:
    """Decode (N, S) assignments to (N, row_len) weight rows:
    out[n, s*D + d] = codebooks[s, assignments[n, s], d], cut to
    ``row_len`` <= S*D columns. Conv weights (N = Cout*kh*kw) come out OHWI,
    fc weights (N = Cout) as (Cout, Cin)."""
    s, k, d = codebooks.shape
    n = assignments.shape[0]
    rows = torch.arange(s, device=codebooks.device)[None, :]
    gathered = codebooks[rows, assignments.long()]  # (N, S, D)
    return gathered.reshape(n, s * d)[:, :row_len]


def decode_fc_weight(
    codebooks: torch.Tensor, assignments: torch.Tensor, in_features: int
) -> torch.Tensor:
    """Decode PQ FC parameters to a dense (Cin, Cout) weight matrix:
    W̃[s*D + d, o] = codebooks[s, assignments[o, s], d], cut to Cin rows.
    Returned as the transpose view of the (Cout, Cin) rows."""
    return decode_rows(codebooks, assignments, in_features).t()


def decode_conv_kernel(
    codebooks: torch.Tensor, assignments: torch.Tensor,
    in_channels_per_group: int,
) -> torch.Tensor:
    """Decode PQ conv parameters (assignments (Cout, kh, kw, S)) to a dense
    HWIO kernel (kh, kw, Cg, Cout). The memory is OHWI, which
    ``ops.conv.conv_dense`` feeds to the convolution as a channels_last
    OIHW weight without a copy."""
    cout, kh, kw, s = assignments.shape
    w = decode_rows(codebooks, assignments.reshape(cout * kh * kw, s),
                    in_channels_per_group)
    return w.reshape(cout, kh, kw, in_channels_per_group).permute(1, 2, 3, 0)


def assignments_one_hot(assignments: torch.Tensor, num_codewords: int,
                        dtype=torch.float32) -> torch.Tensor:
    """One-hot expansion of assignment indices over the codeword axis:
    sum_s lut[b,s,A[o,s]] == einsum('bsk,osk->bo', lut, onehot)."""
    return F.one_hot(assignments.long(), num_codewords).to(dtype)
