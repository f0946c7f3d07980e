"""Shared knobs of the model families and the memory-mode FC routing, the
same rules as ``qcnn_tpu/models/common.py``.

The port resolves memory mode exactly as the JAX package does, so both run
the same program for the same model and batch. The thresholds below were
measured on a TPU (qcnn_tpu/models/common.py:20-66) and are not facts about
the H100: re-deriving them on the card is queued in ROADMAP.md A7b.

The PQ convs of the ResNet family run ``ops.conv.memory_fused_route``'s
pick when their params still carry codebooks: the fused decode-conv kernel
where the geometry qualifies and the in-step OHWI decode elsewhere. A PQ
FC runs :func:`fc_memory_impl`.
"""

from __future__ import annotations

import functools
import importlib

import torch

from qcnn_tpu_torch._device import default_dtype, resolve_device
from qcnn_tpu_torch.core import is_pq
from qcnn_tpu_torch.models import prepare

FAMILIES = ("resnet", "vit", "swin", "maxvit")


def fc_memory_impl(batch: int, params: dict, dtype=None) -> str:
    """The memory-mode strategy of one FC layer at a batch size.

    params: the PQ dict ({"codebooks" (S,K,D), "assignments" (Cout,S)}); a
    dense or int8 layer runs 'dense'.
    dtype: the activation dtype; the fused kernel computes in bf16, so f32
    callers keep the exact in-step decode."""
    if not is_pq(params):
        return "dense"
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


def serving_defaults(model: str) -> dict:
    """Per-family serving config {max_batch, buckets}, copied from the JAX
    package. Its ladders come from batch sweeps on a TPU
    (qcnn_tpu/models/common.py:69-102) and were not measured on the H100;
    ROADMAP.md A7b queues that. Swin and MaxViT, which the JAX package
    lacks, take ViT's ladder, unmeasured as the others."""
    m = model.lower()
    if m.startswith(("vit", "swin", "maxvit")):
        return {"max_batch": 32, "buckets": (1, 8, 32)}
    if "resnet101" in m:
        return {"max_batch": 128, "buckets": (1, 8, 32, 64, 128)}
    if "resnet152" in m:
        return {"max_batch": 64, "buckets": (1, 8, 32, 64)}
    return {"max_batch": 64, "buckets": (1, 8, 32, 64)}


def make_cast(compute_dtype):
    """Activation-cast closure shared by the family forwards; ``.dtype``
    carries the dtype the convs and GEMMs emit (their ``out_dtype``)."""
    def cast(v):
        return v.to(compute_dtype) if compute_dtype is not None else v
    cast.dtype = compute_dtype
    return cast


def build_family_forward(family, spec, params, *, memory=False,
                         compute_dtype=None, device=None):
    """The family wiring of the serving and eval surfaces: compute-dtype
    default, the int8 -> bf16 activation rule, prepare, and the
    softmax-emitting partial forward (qcnn_tpu/models/common.py:131-147).

    family: a registry name ('resnet', 'vit', 'swin', 'maxvit') or the
      module itself.
    compute_dtype: torch.float32, torch.bfloat16 or torch.int8 (int8
      weights, bf16 activations); None means bf16 on the card and f32 on
      the CPU, as the JAX package picks bf16 on its accelerator.
    device: None means "cuda"; pass "cpu" to run the plain versions.
    Returns (prepared_params, forward_fn(params, x), act_dtype)."""
    if isinstance(family, str):
        if family not in FAMILIES:
            raise ValueError(f"unknown model family {family!r}; expected "
                             f"one of {FAMILIES}")
        family = importlib.import_module(f"qcnn_tpu_torch.models.{family}")
    device = resolve_device(device)
    if compute_dtype is None:
        compute_dtype = default_dtype(device)
    act_dtype = prepare.act_dtype_for(compute_dtype)
    prepared = family.prepare_params(spec, params, dtype=compute_dtype,
                                     memory=memory, device=device)
    fwd = functools.partial(family.forward, spec=spec,
                            compute_dtype=act_dtype, with_softmax=True,
                            device=device)
    return prepared, fwd, act_dtype
