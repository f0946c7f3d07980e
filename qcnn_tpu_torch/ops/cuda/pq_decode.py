"""PQ weight decode: the ``pq_decode`` CUDA kernel and its plain version.

Port of ``qcnn_tpu/ops/pallas/pq_decode.py``. The kernel
(``csrc/pq_decode.cu``) writes the decoded weight straight in the layout the
consumer takes: rows (N, C), i.e. OHWI for a conv kernel and (Cout, Cin)
for an fc weight. Every in-step decode of the port goes through
:func:`decode_rows`; the layout names of the JAX entry points are views of
that one buffer.

On a CPU tensor the plain version (``ops.lut.decode_rows``) runs; on a CUDA
tensor the kernel launches or the call raises.
"""

from __future__ import annotations

import torch

from qcnn_tpu_torch.ops import lut
from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel, check_cuda

MAX_CODEWORDS = 128  # the JAX kernel's one-vreg table (pq_decode.py:88-92)

KERNEL = Kernel(
    "pq_decode_launch",
    [PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, PTR],
)


def decode_rows(codebooks: torch.Tensor, assignments: torch.Tensor,
                row_len: int) -> torch.Tensor:
    """(N, S) uint8 ids -> (N, row_len) rows in the codebooks' dtype,
    out[n, s*D + d] = codebooks[s, assignments[n, s], d]. Bit-exact."""
    s, k, d = codebooks.shape
    if k > MAX_CODEWORDS:
        raise ValueError(
            f"gather decode supports K <= {MAX_CODEWORDS} (one vreg of lanes); "
            f"got K={k}"
        )
    n, s2 = assignments.shape
    if s2 != s:
        raise ValueError(f"subspace mismatch: codebooks S={s}, "
                         f"assignments S={s2}")
    if not 0 <= row_len <= s * d:
        raise ValueError(f"row length {row_len} outside [0, S*D={s * d}]")
    if codebooks.device.type == "cpu":
        return lut.decode_rows(codebooks, assignments, row_len)
    if codebooks.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pq_decode: codebooks must be float32 or bfloat16, "
                         f"got {codebooks.dtype}")
    if assignments.dtype != torch.uint8:
        raise ValueError(f"pq_decode: assignments must be uint8, "
                         f"got {assignments.dtype}")
    check_cuda("pq_decode", codebooks=codebooks, assignments=assignments)
    out = torch.empty((n, row_len), dtype=codebooks.dtype,
                      device=codebooks.device)
    KERNEL.launch(codebooks.data_ptr(), assignments.data_ptr(),
                  out.data_ptr(), n, s, k, d, row_len,
                  codebooks.element_size())
    return out


def decode_fc_weight_gather(codebooks: torch.Tensor,
                            assignments: torch.Tensor,
                            in_features: int) -> torch.Tensor:
    """``lut.decode_fc_weight`` through the kernel: (Cin, Cout), the
    transpose view of the (Cout, Cin) rows the kernel writes."""
    return decode_rows(codebooks, assignments, in_features).t()


def decode_conv_kernel_gather(codebooks: torch.Tensor,
                              assignments: torch.Tensor,
                              in_channels_per_group: int,
                              layout: str = "hwio") -> torch.Tensor:
    """``lut.decode_conv_kernel`` through the kernel, in the named logical
    layout: 'hwio' (kh, kw, Cg, Cout), 'iohw' (Cg, Cout, kh, kw), 'ohwi'
    (Cout, kh, kw, Cg) or 'hwoi' (kh, kw, Cout, Cg). All four are views of
    one OHWI buffer, which ``ops.conv.conv_dense`` feeds to the convolution
    without a copy."""
    cout, kh, kw, s = assignments.shape
    cg = in_channels_per_group
    w = decode_rows(codebooks, assignments.reshape(cout * kh * kw, s), cg)
    ohwi = w.reshape(cout, kh, kw, cg)
    order = {"ohwi": (0, 1, 2, 3), "hwio": (1, 2, 3, 0),
             "iohw": (3, 0, 1, 2), "hwoi": (1, 2, 0, 3)}
    if layout not in order:
        raise ValueError(f"unknown decode layout: {layout!r}")
    return ohwi.permute(*order[layout])
