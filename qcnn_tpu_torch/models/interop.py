"""Weights carried across from the JAX package.

``params_from_jax`` turns a ``qcnn_tpu`` parameter list — NumPy arrays, raw
PQ or as ``qcnn_tpu.models.prepare.prepare_params`` returns them — into the
port's. It imports neither JAX nor ml_dtypes: a bfloat16 NumPy array is
recognised by its dtype's name and moved as its 16 bits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from qcnn_tpu_torch._device import resolve_device
from qcnn_tpu_torch.models.prepare import conv_kernel_tensor, fc_weight_tensor

_INT8_KEYS = ("kernel_q", "weight_q", "scale", "act_scale", "out_scale")


def array_to_tensor(arr, device) -> torch.Tensor:
    """A NumPy array (including ml_dtypes bfloat16) as a tensor on device."""
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_jax(params: Sequence[Optional[dict]],
                    device=None) -> list:
    """The port's params for a ``qcnn_tpu`` param list.

    PQ dicts keep their arrays (codebooks in their dtype, assignments uint8,
    bias, OPQ perm as int64). A dense HWIO conv kernel comes across in the
    port's layout (OHWI memory, HWIO view) and a (Cin, Cout) fc weight as
    the (Cin, Cout) view of (Cout, Cin) memory, both in their dtype.
    device: None means "cuda"."""
    device = resolve_device(device)
    out: list = []
    for p in params:
        if p is None:
            out.append(None)
            continue
        if any(key in p for key in _INT8_KEYS):
            raise NotImplementedError(
                "int8 params are not ported yet: ROADMAP.md A7")
        q = {}
        for key, v in p.items():
            t = array_to_tensor(v, "cpu")
            if key == "kernel":
                q[key] = conv_kernel_tensor(t.permute(3, 0, 1, 2), t.dtype,
                                            device)
            elif key == "weight":
                q[key] = fc_weight_tensor(t.t(), t.dtype, device)
            elif key == "perm":
                q[key] = t.to(device=device, dtype=torch.int64)
            else:
                q[key] = t.to(device)
        out.append(q)
    return out
