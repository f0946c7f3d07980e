"""PQ FC as LUT build + gather-accumulate: the ``pq_lut_gather`` CUDA kernel
and its plain version.

Port of ``qcnn_tpu/ops/pallas/pq_lut_gather.py``, the reference's own
hot-path algorithm (GetInPdMat CaffeEva.cc:1261-1296, then the per-output
gather loop :1006-1017):

    out[b, o] = bias[o] + sum_s LUT[b, s, A[o, s]]

The LUT (B, S, K) float32 is built outside the kernel by ``ops.lut.build_lut``
(a PyTorch contraction, as the JAX package builds it in XLA). The kernel
(``csrc/pq_lut_gather.cu``) reads the ids in their natural (Cout, S) layout.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches or the call raises.
"""

from __future__ import annotations

import torch

from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel, check_cuda

MAX_CODEWORDS = 128  # the JAX kernel's one-vreg table (pq_lut_gather.py:150)

KERNEL = Kernel(
    "pq_lut_gather_launch",
    [PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR],
)


def lut_gather_plain(lut: torch.Tensor, assignments: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: (B, S, K) LUT, (Cout, S) ids,
    (Cout,) bias -> (B, Cout) float32."""
    s = lut.shape[1]
    rows = torch.arange(s, device=lut.device)[:, None]
    g = lut[:, rows, assignments.long().t()]  # (B, S, Cout)
    return g.sum(dim=1) + bias.float()


def lut_gather(lut: torch.Tensor, assignments: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Gather-accumulate over a built LUT: the kernel on a CUDA tensor, the
    plain version on a CPU one."""
    b, s, k = lut.shape
    cout, s2 = assignments.shape
    if s2 != s:
        raise ValueError(f"subspace mismatch: LUT S={s}, assignments S={s2}")
    if lut.device.type == "cpu":
        return lut_gather_plain(lut, assignments, bias)
    if lut.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("pq_lut_gather: LUT and bias must be float32")
    if assignments.dtype != torch.uint8:
        raise ValueError(f"pq_lut_gather: assignments must be uint8, "
                         f"got {assignments.dtype}")
    if bias.shape != (cout,):
        raise ValueError(f"pq_lut_gather: bias shape {tuple(bias.shape)} "
                         f"!= ({cout},)")
    check_cuda("pq_lut_gather", lut=lut, assignments=assignments, bias=bias)
    out = torch.empty((b, cout), dtype=torch.float32, device=lut.device)
    KERNEL.launch(lut.data_ptr(), assignments.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), b, s, k, cout)
    return out


def pq_fc_lut_gather(x: torch.Tensor, params: dict) -> torch.Tensor:
    """PQ FC via LUT build + gather-accumulate.

    Args:
      x: (B, Cin) activations.
      params: {"codebooks" (S,K,D), "assignments" (Cout,S) uint8, "bias"}.
    Returns:
      (B, Cout) float32.
    """
    k = params["codebooks"].shape[1]
    if k > MAX_CODEWORDS:
        raise ValueError(
            f"lut-gather kernel supports K <= {MAX_CODEWORDS} (one vreg of "
            f"table lanes); got K={k}"
        )
    lut = lut_ops.build_lut(x, params["codebooks"])  # (B, S, K) f32
    return lut_gather(lut.contiguous(), params["assignments"],
                      params["bias"].float())
