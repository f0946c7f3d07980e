"""Memory-mode FC routing, the same rule as ``qcnn_tpu/models/common.py``.

The port resolves ``fc_impl="memory"`` exactly as the JAX package does, so
both run the same program for the same model and batch. The thresholds
below were measured on a TPU (qcnn_tpu/models/common.py:35-66) and are not
facts about the H100: re-deriving them on the card is queued in
ROADMAP.md.
"""

from __future__ import annotations

import torch

MEMORY_FC_IMPL = "auto"


def fc_memory_impl(batch: int, params: dict, dtype=None) -> str:
    """Resolve MEMORY_FC_IMPL for one FC layer and batch size.

    params: the PQ dict ({"codebooks" (S,K,D), "assignments" (Cout,S)}).
    dtype: the activation dtype; the fused kernel computes in bf16, so f32
    callers keep the exact in-step decode."""
    if MEMORY_FC_IMPL != "auto":
        return MEMORY_FC_IMPL
    s, k, d = params["codebooks"].shape
    cout = params["assignments"].shape[0]
    if k > 128:
        return "indecode"
    if dtype is not None and dtype != torch.bfloat16:
        return "indecode"
    # TPU-measured: the gather kernels won only for weight-dominated
    # (fc6-class) layers, lutgather at batch <= 2 and the fused kernel up
    # to batch 1024
    if s * d < 4096 and cout < 4096:
        return "indecode"
    if batch > 1024:
        return "indecode"
    if batch <= 2:
        return "lutgather"
    return "fgather"
