"""PQ FC as LUT build + a batch-tiled gather-accumulate: the ``pq_fc`` CUDA
kernel and its plain version.

Port of ``qcnn_tpu/ops/pallas/pq_fc.py`` (strategy ``"pallas"``):

    out[b, o] = bias[o] + sum_s LUT[b, s, A[o, s]],   LUT = build_lut(x, C)

The LUT (B, S, K) float32 is built outside the kernel by
``ops.lut.build_lut``, as the JAX entry builds it outside its kernel. The
kernel (``csrc/pq_fc.cu``) tiles the batch and the outputs: a block owns 1
to 16 batch rows and 512 or 1024 outputs, walks S in staged chunks and,
where the tiles do not fill the card, shares S with other blocks. The tile,
the chunk, the ring's depth, the split of S and the workspace come from
``plan`` (``_plan.plan_gather``), a pure function of the shape. A split
sum goes through a float32 workspace and is added in split order, so two
launches give the same bits; :func:`split_sum_plain` repeats that order in
PyTorch. The function is the one ``pq_lut_gather`` computes, so the plain
version is that module's.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches or the call raises.
"""

from __future__ import annotations

import torch

from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.cuda import _plan
from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel, check_cuda
from qcnn_tpu_torch.ops.cuda.pq_lut_gather import lut_gather_plain

MAX_CODEWORDS = 256  # uint8 ids

KERNEL = Kernel(  # lut, ids, bias, out, workspace, B, S, K, Cout, rows,
    "pq_fc_launch",  # outputs, chunk, stages, splits, stream
    [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, INT, INT,
     PTR],
)
plan = _plan.plan_gather


def split_sum_plain(lut: torch.Tensor, assignments: torch.Tensor,
                    bias: torch.Tensor, pl: _plan.GatherPlan) -> torch.Tensor:
    """The kernel's order of float32 additions under plan ``pl``, in
    PyTorch: each split of S summed sub-space by sub-space from 0, then the
    splits in order, then the bias (with one split, the bias joins the
    sum)."""
    b, s, _ = lut.shape
    ids = assignments.long().t()  # (S, Cout)
    span = pl.chunks_per_split * pl.chunk
    total = None
    for lo in range(0, max(s, 1), span):
        part = torch.zeros((b, ids.shape[1]), dtype=torch.float32,
                           device=lut.device)
        for j in range(lo, min(s, lo + span)):
            part = part + lut[:, j, ids[j]]
        total = part if total is None else total + part
    return total + bias.float()


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
    pl = plan(b, s, k, cout)
    ws = torch.empty(pl.workspace_bytes // 4, dtype=torch.float32,
                     device=lut.device) if pl.splits > 1 else None
    KERNEL.launch(lut.data_ptr(), assignments.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), ws.data_ptr() if ws is not None else None,
                  b, s, k, cout, pl.rows, pl.outputs, pl.chunk, pl.stages,
                  pl.splits)
    return out


def pq_fc_pallas(x: torch.Tensor, params: dict, *, block_b: int = 8,
                 block_o: int = 512) -> torch.Tensor:
    """PQ FC forward via the batch-tiled gather kernel.

    Args:
      x: (B, Cin) activations.
      params: {"codebooks" (S,K,D), "assignments" (Cout,S) uint8, "bias"}.
      block_b/block_o: the TPU kernel's batch and output tiles; accepted for
        the JAX entry's signature and unused (``plan`` picks the rows and
        outputs of a block from the shape).
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
