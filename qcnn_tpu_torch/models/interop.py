"""Weights carried across from the JAX package.

``params_from_jax`` turns a ``qcnn_tpu`` parameter list — NumPy arrays, raw
PQ or as ``prepare_params`` of ``qcnn_tpu/models/prepare.py`` returns
them — into the port's; ``family_params_from_jax`` does the same for the
nested dict of a model family (``prepare_params`` or ``quantize_params``
of ``qcnn_tpu/models/resnet.py`` and ``qcnn_tpu/models/vit.py``), int8
ones included. Neither imports JAX or ml_dtypes: a bfloat16 NumPy array is
recognised by its dtype's name and moved as its 16 bits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from qcnn_tpu_torch._device import resolve_device
from qcnn_tpu_torch.models.prepare import (
    conv_kernel_tensor,
    fc_weight_tensor,
    int8_conv_kernel_tensor,
    int8_rows_tensor,
)

_SCALE_KEYS = ("scale", "act_scale", "out_scale")


def array_to_tensor(arr, device) -> torch.Tensor:
    """A NumPy array (including ml_dtypes bfloat16) as a tensor on device."""
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _layer_from_jax(p: dict, device: torch.device) -> dict:
    """One layer dict: PQ arrays keep their dtype (assignments uint8, OPQ
    perm as int64); a dense HWIO conv kernel comes across in the port's
    layout (OHWI memory, HWIO view) and a (Cin, Cout) fc weight as the
    (Cin, Cout) view of (Cout, Cin) memory. int8 kernels and weights
    (``kernel_q``, ``weight_q``) take the same memory with the int8 GEMM's
    row padding (``models.prepare.int8_rows_tensor``); their scales come
    across as float32, ``act_scale`` and ``out_scale`` as scalars."""
    q = {}
    for key, v in p.items():
        if key in _SCALE_KEYS:
            q[key] = torch.as_tensor(np.asarray(v, np.float32),
                                     device=device)
            continue
        t = array_to_tensor(v, "cpu")
        if key == "kernel_q":
            q[key] = int8_conv_kernel_tensor(t.permute(3, 0, 1, 2), device)
        elif key == "weight_q":
            q[key] = int8_rows_tensor(t.t(), device).t()
        elif key == "kernel":
            q[key] = conv_kernel_tensor(t.permute(3, 0, 1, 2), t.dtype,
                                        device)
        elif key == "weight":
            q[key] = fc_weight_tensor(t.t(), t.dtype, device)
        elif key == "perm":
            q[key] = t.to(device=device, dtype=torch.int64)
        else:
            q[key] = t.to(device)
    return q


def params_from_jax(params: Sequence[Optional[dict]],
                    device=None) -> list:
    """The port's params for a ``qcnn_tpu`` param list (None entries stay
    None). device: None means "cuda"."""
    device = resolve_device(device)
    return [None if p is None else _layer_from_jax(p, device)
            for p in params]


def family_params_from_jax(params: dict, device=None) -> dict:
    """The port's params for a ``qcnn_tpu`` family's nested dict: each
    layer dict (one whose values are arrays) comes across as in
    :func:`params_from_jax`, a block (a dict of layer dicts) keeps its
    keys, and a bare array (ViT's ``cls_token`` and ``pos_embed``) comes
    across as a tensor of its dtype. A LayerNorm dict ({"scale",
    "shift"}) is a layer dict whose ``scale`` comes across as float32, as
    it is. device: None means "cuda"."""
    device = resolve_device(device)

    def walk(p):
        if not isinstance(p, dict):
            return array_to_tensor(p, device)
        if all(isinstance(v, dict) for v in p.values()):
            return {k: walk(v) for k, v in p.items()}
        return _layer_from_jax(p, device)

    return {name: walk(p) for name, p in params.items()}
