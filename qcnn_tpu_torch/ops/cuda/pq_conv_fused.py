"""PQ conv with the weight decoded on chip: the ``pq_conv_fused`` CUDA kernel
and its plain version.

Port of ``qcnn_tpu/ops/pallas/pq_conv_fused.py``: a stride-1, ungrouped,
square kh = kw > 1 convolution

    out = conv(bf16(x), W̃) + bias,   W̃[o, ti, tj, s*D + d] = bf16(C[s, A[o, ti, tj, s], d])

with float32 accumulation and a float32 output; channels past Cin (the
codebook overhang) meet zeros. The kernels read NHWC x directly for each
tap and never write the decoded weight to device memory.

Which kernel runs is a pure function of the geometry (``plan``): the
``wgmma`` kernel of ``csrc/pq_conv_fused.cu`` where it takes the geometry,
else the general one of ``csrc/pq_conv_fused_general.cu``; each has its own
count of launches. Where the wgmma kernel splits the (chunk, tap) range
across blocks, each split's float32 partial sums go to a workspace and are
added in split order, so two launches give the same bits; the sum differs
from the plain version's only in the order of float32 additions.

The geometry gates (``supports``, ``fits_vmem`` and the sizes behind them)
are copies of the JAX package's. They are TPU limits, kept so that both
packages route the same layers; re-deriving them for Hopper is queued in
ROADMAP.md A7.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches or the call raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qcnn_tpu_torch.ops import lut
from qcnn_tpu_torch.ops.cuda import _plan
from qcnn_tpu_torch.ops.cuda._build import INT, PTR, Kernel, check_cuda

_LANES = 128
_VMEM_BUDGET = 6 * 1024 * 1024  # per-block bytes of the TPU kernel

KERNEL = Kernel(  # x, cb, ids, bias, out, workspace, B, H, W, Cin, S, K, D,
    "pq_conv_fused_launch",  # Cout, kh, pad, tile rows, splits, stream
    [PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, INT,
     INT, INT, INT, INT, PTR],
)
GENERAL = Kernel(
    "pq_conv_fused_general_launch",
    [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, INT, INT,
     INT, PTR],
)
plan = _plan.plan_conv


def ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _grid_geometry(h: int, w: int, pad: int, kh: int,
                   kw: int) -> tuple[int, int]:
    """(l_out, lp) of the TPU kernel's flattened padded grid."""
    hp, wp = h + 2 * pad, w + 2 * pad
    ho = hp - kh + 1
    l_out = ceil_to(ho * wp, 8)
    lp = ceil_to(max(hp * wp, (kh - 1) * wp + (kw - 1) + l_out), 8)
    return l_out, lp


def _per_image_bytes(h: int, w: int, pad: int, kh: int, kw: int) -> int:
    _, lp = _grid_geometry(h, w, pad, kh, kw)
    return lp * (_LANES * 2 + _LANES * 4)  # x bf16 + out f32


def fits_vmem(h: int, w: int, pad: int, kh: int, kw: int) -> bool:
    """Whether a one-image block of the TPU kernel fits its VMEM budget
    (``memory_fused_route`` falls back to the decode when it does not)."""
    return _per_image_bytes(h, w, pad, kh, kw) <= _VMEM_BUDGET


def supports(params: dict, *, stride: int, groups: int,
             cin: int | None = None) -> bool:
    """Geometry gate of the fused decode-conv: stride 1, ungrouped, square
    multi-tap kernels, K <= 128, 128 % D == 0 with 128 // D >= 32 (so
    D in {1, 2, 4}) and, when cin is given, cin >= 256."""
    s, k, d = params["codebooks"].shape
    cout, kh, kw, _ = params["assignments"].shape
    return (
        stride == 1
        and groups == 1
        and kh == kw
        and kh > 1
        and k <= _LANES
        and _LANES % d == 0
        and _LANES // d >= 32
        and (cin is None or cin >= 256)
    )


def conv_fused_plain(x: torch.Tensor, codebooks: torch.Tensor,
                     assignments: torch.Tensor, bias: torch.Tensor, *,
                     pad: int) -> torch.Tensor:
    """The kernel's function in PyTorch: the weight decoded in bf16, the
    conv in float32 on the bf16-rounded operands, plus the float32 bias.
    (B, H, W, Cin) -> (B, Ho, Wo, Cout) float32."""
    hwio = lut.decode_conv_kernel(codebooks.to(torch.bfloat16), assignments,
                                  x.shape[-1])
    xn = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    y = F.conv2d(xn, hwio.float().permute(3, 2, 0, 1), padding=pad)
    return (y + bias.float()[:, None, None]).permute(0, 2, 3, 1)


def pq_conv_fused(x: torch.Tensor, params: dict, *, stride: int, pad: int,
                  groups: int = 1, block_b: int = 8) -> torch.Tensor:
    """PQ conv with the weight decoded inside the kernel (memory mode).

    Args:
      x: (B, H, W, Cin) activations.
      params: {"codebooks" (S,K,D), "assignments" (Cout,kh,kw,S) uint8,
        "bias" (Cout,)}.
      stride/groups: must satisfy ``supports``.
      block_b: the TPU kernel's batch tile; accepted for the JAX entry's
        signature and unused (``plan`` tiles the output pixels).
    Returns:
      (B, Ho, Wo, Cout) float32.
    """
    del block_b
    if not supports(params, stride=stride, groups=groups):
        raise ValueError(
            "pq_conv_fused: unsupported geometry (need stride=1, groups=1, "
            "square kh=kw>1, K<=128, 128%D==0, 128//D>=32)"
        )
    b, h, w, cin = x.shape
    cb = params["codebooks"]
    a = params["assignments"]
    cout, kh, kw, s = a.shape
    if s != cb.shape[0]:
        raise ValueError(
            f"pq_conv_fused: assignments S={s} != codebooks "
            f"S={cb.shape[0]}"
        )
    if cb.shape[0] * cb.shape[2] < cin:
        raise ValueError(
            f"pq_conv_fused: codebooks cover {cb.shape[0] * cb.shape[2]} "
            f"channels < Cin={cin}"
        )
    if not fits_vmem(h, w, pad, kh, kw):
        raise ValueError(
            f"pq_conv_fused: a single {h}x{w} image's flattened grid "
            "exceeds the VMEM block budget (memory_fused_route checks "
            "fits_vmem and falls back to the OHWI decode)"
        )
    bias = params["bias"]
    if x.device.type == "cpu":
        return conv_fused_plain(x, cb, a, bias, pad=pad)
    if a.dtype != torch.uint8:
        raise ValueError(f"pq_conv_fused: assignments must be uint8, "
                         f"got {a.dtype}")
    if bias.dtype != torch.float32 or bias.shape != (cout,):
        raise ValueError("pq_conv_fused: bias must be float32 of shape "
                         "(Cout,)")
    xb = x.to(torch.bfloat16).contiguous()
    cbb = cb.to(torch.bfloat16).contiguous()
    if cbb.data_ptr() % 16:
        cbb = cbb.clone()  # one codeword is one aligned load
    check_cuda("pq_conv_fused", x=xb, codebooks=cbb, assignments=a,
               bias=bias)
    ho, wo = h + 2 * pad - kh + 1, w + 2 * pad - kw + 1
    out = torch.empty((b, ho, wo, cout), dtype=torch.float32,
                      device=x.device)
    k, d = cb.shape[1], cb.shape[2]
    pl = plan(b, h, w, cin, cout, kh, pad, s, k, d)
    if pl.variant == "general":
        GENERAL.launch(xb.data_ptr(), cbb.data_ptr(), a.data_ptr(),
                       bias.data_ptr(), out.data_ptr(), b, h, w, cin, s, k, d,
                       cout, kh, pad)
        return out
    # the kernel copies 16 bytes at a time
    xb, a = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (xb, a))
    ws = torch.empty(pl.workspace_bytes // 4, dtype=torch.float32,
                     device=x.device) if pl.splits > 1 else None
    KERNEL.launch(xb.data_ptr(), cbb.data_ptr(), a.data_ptr(),
                  bias.data_ptr(), out.data_ptr(),
                  ws.data_ptr() if ws is not None else None, b, h, w, cin, s,
                  k, d, cout, kh, pad, pl.tile_rows, pl.splits)
    return out
