"""PQ FC as LUT build + a batch-tiled gather-accumulate: the ``pq_fc`` CUDA
kernel and its plain version.

Port of ``qcnn_tpu/ops/pallas/pq_fc.py`` (strategy ``"pallas"``):

    out[b, o] = bias[o] + sum_s LUT[b, s, A[o, s]],   LUT = build_lut(x, C)

The LUT (B, S, K) float32 is built outside the kernel by
``ops.lut.build_lut``, as the JAX entry builds it outside its kernel. The
kernel (``csrc/pq_fc.cu``) tiles the batch: one staged chunk of ids serves
eight batch rows. The function is the one ``pq_lut_gather`` computes, so
the plain version is that module's.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches or the call raises.
"""

from __future__ import annotations

import torch

from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel, check_cuda
from qcnn_tpu_torch.ops.cuda.pq_lut_gather import lut_gather_plain

MAX_CODEWORDS = 256  # uint8 ids

KERNEL = Kernel("pq_fc_launch", [PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR])


def gather_accumulate(lut: torch.Tensor, assignments: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """(B, S, K) LUT, (Cout, S) uint8 ids, (Cout,) bias -> (B, Cout) float32:
    the kernel on a CUDA tensor, the plain version on a CPU one."""
    b, s, k = lut.shape
    cout, s2 = assignments.shape
    if s2 != s:
        raise ValueError(f"subspace mismatch: LUT S={s}, assignments S={s2}")
    if lut.device.type == "cpu":
        return lut_gather_plain(lut, assignments, bias)
    if lut.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("pq_fc: LUT and bias must be float32")
    if assignments.dtype != torch.uint8:
        raise ValueError(f"pq_fc: assignments must be uint8, "
                         f"got {assignments.dtype}")
    if bias.shape != (cout,):
        raise ValueError(f"pq_fc: bias shape {tuple(bias.shape)} != "
                         f"({cout},)")
    check_cuda("pq_fc", lut=lut, assignments=assignments, bias=bias)
    out = torch.empty((b, cout), dtype=torch.float32, device=lut.device)
    KERNEL.launch(lut.data_ptr(), assignments.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), b, s, k, cout)
    return out


def pq_fc_pallas(x: torch.Tensor, params: dict, *, block_b: int = 8,
                 block_o: int = 512) -> torch.Tensor:
    """PQ FC forward via the batch-tiled gather kernel.

    Args:
      x: (B, Cin) activations.
      params: {"codebooks" (S,K,D), "assignments" (Cout,S) uint8, "bias"}.
      block_b/block_o: the TPU kernel's batch and output tiles; accepted for
        the JAX entry's signature and unused (a block here owns 8 rows and
        256 outputs).
    Returns:
      (B, Cout) float32.
    """
    del block_b, block_o
    k = params["codebooks"].shape[1]
    if k > MAX_CODEWORDS:
        raise ValueError(f"pq_fc supports K <= {MAX_CODEWORDS} (uint8 ids); "
                         f"got K={k}")
    lut = lut_ops.build_lut(x, params["codebooks"])  # (B, S, K) f32
    return gather_accumulate(lut.contiguous(), params["assignments"],
                             params["bias"].float())
