"""PQ FC as one GEMM with weight tiles decoded on chip: the ``pq_fc_fused``
CUDA kernel and its plain version.

Port of ``qcnn_tpu/ops/pallas/pq_fc_fused.py``:

    out = bf16(x) @ W̃ + bias,   W̃[s*D + d, o] = bf16(C[s, A[o, s], d])

with float32 accumulation and float32 output; x is zero-padded where
Cin < S*D. The decoded weight never reaches device memory. The JAX entry's
two decode formulations ("gather", strategy ``fgather``; "select", strategy
``fused``) compute the same function; one kernel (``csrc/pq_fc_fused.cu``)
serves both, and the name is still validated.

On a CPU tensor the plain version runs; on a CUDA tensor a kernel launches
or the call raises. Which kernel is a pure function of the shape
(``plan``): the ``wgmma`` kernel of ``csrc/pq_fc_fused.cu`` where it takes
the shape, else the general one of ``csrc/pq_fc_fused_general.cu``; each has
its own count of launches. Where the wgmma kernel splits the contraction
across blocks, each split's float32 partial sums go to a workspace and are
added in split order, so two launches give the same bits; the sum differs
from the plain version's only in the order of float32 additions.
"""

from __future__ import annotations

import torch

from qcnn_tpu_torch.ops import lut
from qcnn_tpu_torch.ops.cuda import _plan
from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel, check_cuda

MAX_CODEWORDS = 128  # uint8 ids of the JAX kernel (pq_fc_fused.py:295-299)
DECODES = ("select", "gather")

KERNEL = Kernel(  # x, cb, ids, bias, out, workspace, B, Cin, S, K, D, Cout,
    "pq_fc_fused_launch",  # tile rows, splits, stream
    [PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, INT,
     PTR],
)
GENERAL = Kernel(
    "pq_fc_fused_general_launch",
    [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, PTR],
)
plan = _plan.plan_fc


def fused_plain(x: torch.Tensor, codebooks: torch.Tensor,
                assignments: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: bf16 operands, products exact in
    float32, float32 sums."""
    w = lut.decode_rows(codebooks.to(torch.bfloat16), assignments,
                        x.shape[1])  # (Cout, Cin)
    xb = x.to(torch.bfloat16).float()
    return torch.matmul(xb, w.float().t()) + bias.float()


def pq_fc_fused(x: torch.Tensor, params: dict, *,
                decode: str = "select") -> torch.Tensor:
    """PQ FC via the fused decode-GEMM kernel.

    Args:
      x: (B, Cin) activations.
      params: {"codebooks" (S,K,D), "assignments" (Cout,S) uint8, "bias"}.
      decode: "select" or "gather", the JAX kernel's two tile-decode
        formulations; both name the same function here.
    Returns:
      (B, Cout) float32.
    """
    if decode not in DECODES:
        raise ValueError(f"unknown decode formulation: {decode!r}")
    codebooks = params["codebooks"]
    assignments = params["assignments"]
    bias = params["bias"]
    s, k, d = codebooks.shape
    if k > MAX_CODEWORDS:
        raise ValueError(
            f"fused kernel supports K <= {MAX_CODEWORDS} (int8 assignment "
            f"ids; one vreg of table lanes for decode='gather'); got K={k}"
        )
    b, cin = x.shape
    if s * d < cin:
        raise ValueError(
            f"pq_fc_fused: codebooks cover {s * d} features < Cin={cin}"
        )
    cout, s2 = assignments.shape
    if s2 != s:
        raise ValueError(f"subspace mismatch: codebooks S={s}, "
                         f"assignments S={s2}")
    if x.device.type == "cpu":
        return fused_plain(x, codebooks, assignments, bias)
    if assignments.dtype != torch.uint8:
        raise ValueError(f"pq_fc_fused: assignments must be uint8, "
                         f"got {assignments.dtype}")
    if bias.dtype != torch.float32 or bias.shape != (cout,):
        raise ValueError("pq_fc_fused: bias must be float32 of shape (Cout,)")
    xb = x.to(torch.bfloat16)
    cb = codebooks.to(torch.bfloat16)
    check_cuda("pq_fc_fused", x=xb, codebooks=cb, assignments=assignments,
               bias=bias)
    out = torch.empty((b, cout), dtype=torch.float32, device=x.device)
    pl = plan(b, cin, cout, s, k, d)
    if pl.variant == "general":
        GENERAL.launch(xb.data_ptr(), cb.data_ptr(), assignments.data_ptr(),
                       bias.data_ptr(), out.data_ptr(), b, cin, s, k, d, cout)
        return out
    # the kernel copies 16 bytes at a time
    xb, cb, ids = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (xb, cb, assignments))
    ws = torch.empty(pl.workspace_bytes // 4, dtype=torch.float32,
                     device=x.device) if pl.splits > 1 else None
    KERNEL.launch(xb.data_ptr(), cb.data_ptr(), ids.data_ptr(),
                  bias.data_ptr(), out.data_ptr(),
                  ws.data_ptr() if ws is not None else None, b, cin, s, k, d,
                  cout, pl.tile_rows, pl.splits)
    return out
