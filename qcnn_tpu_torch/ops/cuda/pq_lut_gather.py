"""PQ FC as LUT build + gather-accumulate: the ``pq_lut_gather`` CUDA kernel
and its plain version.

Port of ``qcnn_tpu/ops/pallas/pq_lut_gather.py``, the reference's own
hot-path algorithm (GetInPdMat CaffeEva.cc:1261-1296, then the per-output
gather loop :1006-1017):

    out[b, o] = bias[o] + sum_s LUT[b, s, A[o, s]]

The LUT (B, S, K) float32 is built outside the kernel by ``ops.lut.build_lut``
(a PyTorch contraction, as the JAX package builds it in XLA). The kernels
(``csrc/pq_lut_gather.cu``) read the ids in their natural (Cout, S) layout.
The staged kernel keeps a block's slice of the LUT in shared memory, reads
the ids once for all rows of its batch tile as 16-byte words, and shares S
with other blocks; the general kernel (S not a multiple of 16, K not a
multiple of 4) leaves the LUT to the caches. Which runs, the tile and the split of S
come from ``plan`` (``_plan.plan_lut_gather``), a pure function of the
shape. The splits' partial sums go through a float32 workspace and are added
in split order by a reduce kernel launched programmatically dependent on the
gather, so two launches give the same bits; :func:`split_sum_plain` repeats
the staged kernel's order of additions in PyTorch (``chip_smoke.py`` holds
the kernel to it bit for bit). The two kernels have a launcher and a launch
count each (``KERNEL``, ``GENERAL``).

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches or the call raises.
"""

from __future__ import annotations

import torch

from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.cuda import _plan
from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel, check_cuda

MAX_CODEWORDS = 128  # the JAX entry's cap (pq_lut_gather.py:150), kept

KERNEL = Kernel(  # the staged kernel: lut, ids, bias, out, workspace, B, S,
    "pq_lut_gather_launch",  # K, Cout, rows, outputs, splits, stream
    [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, PTR],
)
GENERAL = Kernel(  # lut, ids, bias, out, B, S, K, Cout, stream
    "pq_lut_gather_general_launch",
    [PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR],
)
plan = _plan.plan_lut_gather


def lut_gather_plain(lut: torch.Tensor, assignments: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: (B, S, K) LUT, (Cout, S) ids,
    (Cout,) bias -> (B, Cout) float32."""
    s = lut.shape[1]
    rows = torch.arange(s, device=lut.device)[:, None]
    g = lut[:, rows, assignments.long().t()]  # (B, S, Cout)
    return g.sum(dim=1) + bias.float()


def split_sum_plain(lut: torch.Tensor, assignments: torch.Tensor,
                    bias: torch.Tensor,
                    pl: _plan.LutGatherPlan) -> torch.Tensor:
    """The staged kernel's order of float32 additions under plan ``pl``, in
    PyTorch: a warp's sub-range of a block's range summed sub-space by
    sub-space, the block's sub-ranges in order, the blocks in order, then
    the bias."""
    b, s, _ = lut.shape
    ids = assignments.long().t()  # (S, Cout)
    units = s // _plan.LUTG_UNIT
    total = None
    for lo in range(0, units, pl.units_per_split):
        hi = min(units, lo + pl.units_per_split)
        per_group = _plan.ceil_div(hi - lo, pl.groups)
        block = None
        for g_lo in range(lo, hi, per_group):
            part = torch.zeros((b, ids.shape[1]), dtype=torch.float32,
                               device=lut.device)
            for j in range(g_lo * _plan.LUTG_UNIT,
                           min(hi, g_lo + per_group) * _plan.LUTG_UNIT):
                part = part + lut[:, j, ids[j]]
            block = part if block is None else block + part
        total = block if total is None else total + block
    return total + bias.float()


def lut_gather(lut: torch.Tensor, assignments: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Gather-accumulate over a built LUT: the kernel that ``plan`` names on
    a CUDA tensor, the plain version on a CPU one."""
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
    pl = plan(b, s, k, cout)
    out = torch.empty((b, cout), dtype=torch.float32, device=lut.device)
    if pl.variant == "general":
        GENERAL.launch(lut.data_ptr(), assignments.data_ptr(),
                       bias.data_ptr(), out.data_ptr(), b, s, k, cout)
        return out
    if lut.data_ptr() % 16:  # 16-byte loads of both
        lut = lut.clone()
    if assignments.data_ptr() % 16:
        assignments = assignments.clone()
    ws = torch.empty(pl.workspace_bytes // 4, dtype=torch.float32,
                     device=lut.device) if pl.workspace_bytes else None
    KERNEL.launch(lut.data_ptr(), assignments.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), ws.data_ptr() if ws is not None else None,
                  b, s, k, cout, pl.rows, pl.outputs, pl.splits)
    return out


def pq_fc_lut_gather(x: torch.Tensor, params: dict, *,
                     block_s: int = 256) -> torch.Tensor:
    """PQ FC via LUT build + gather-accumulate.

    Args:
      x: (B, Cin) activations.
      params: {"codebooks" (S,K,D), "assignments" (Cout,S) uint8, "bias"}.
      block_s: the TPU kernel's sub-space tile; accepted for the JAX
        entry's signature and unused (``plan`` cuts S from the shape).
    Returns:
      (B, Cout) float32.
    """
    del block_s
    k = params["codebooks"].shape[1]
    if k > MAX_CODEWORDS:
        raise ValueError(
            f"lut-gather kernel supports K <= {MAX_CODEWORDS} (one vreg of "
            f"table lanes); got K={k}"
        )
    lut = lut_ops.build_lut(x, params["codebooks"])  # (B, S, K) f32
    return lut_gather(lut.contiguous(), params["assignments"],
                      params["bias"].float())
