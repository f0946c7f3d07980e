"""One-time parameter preparation for execution (the PrepCtrdBuf/PrepAsmtBuf
analogue, CaffeEva.cc:534-623).

Port of ``qcnn_tpu/models/prepare.py`` for float32 and bfloat16:

- ``decode`` layers: decode codebooks + assignments to a dense kernel or
  weight on the host in NumPy (exact: PQ(x) == W̃x), then cast to the
  compute dtype and move to the device. A conv kernel is HWIO logically and
  OHWI in memory (a channels_last OIHW weight for the convolution); an fc
  weight is (Cin, Cout) logically and (Cout, Cin) in memory.
- every other PQ strategy keeps codebooks + assignments (the ~21x smaller
  form) and only casts: codebooks to the compute dtype, assignments uint8
  in their (Cout, S) layout, bias float32. Those layers decode in the step.

The returned params feed models.network.forward unchanged: decoded layers
look like dense layers, PQ layers keep their PQ dict.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from qcnn_tpu_torch._device import default_dtype, resolve_device
from qcnn_tpu_torch.core import ConvSpec, FCSpec, ModelSpec, is_pq
from qcnn_tpu_torch.models import network


def inverse_permutation(perm) -> np.ndarray:
    """argsort(perm): maps original dimension index -> permuted position
    (a copy of qcnn_tpu/quantizer/opq.py:81-83)."""
    return np.argsort(np.asarray(perm)).astype(np.int32)


def _np(a) -> np.ndarray:
    """A host NumPy array of a param (a bf16 tensor widens to f32, exactly)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def _decode_rows_np(codebooks, assignments2d, row_len):
    s, k, d = codebooks.shape
    gathered = codebooks[np.arange(s)[None, :], assignments2d.astype(np.int64)]
    return gathered.reshape(assignments2d.shape[0], s * d)[:, :row_len]


def _tensor(a, dtype, device) -> torch.Tensor:
    """A contiguous tensor on device from a NumPy array or a tensor."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.contiguous().to(device=device, dtype=dtype)


def conv_kernel_tensor(ohwi: np.ndarray, dtype, device) -> torch.Tensor:
    """A (Cout, kh, kw, Cg) kernel as the port holds it: OHWI memory,
    returned as its HWIO view."""
    return _tensor(ohwi, dtype, device).permute(1, 2, 3, 0)


def fc_weight_tensor(w_oi: np.ndarray, dtype, device) -> torch.Tensor:
    """A (Cout, Cin) weight as the port holds it, returned as its (Cin, Cout)
    view."""
    return _tensor(w_oi, dtype, device).t()


def prepare_params(
    spec: ModelSpec,
    params: Sequence[Optional[dict]],
    *,
    batch_hint: int = 1,
    conv_impl: str = "auto",
    fc_impl: str = "auto",
    dtype=None,
    device=None,
) -> tuple[list, tuple[str, ...], tuple[str, ...]]:
    """Resolve strategies and pre-decode/pre-layout parameters.

    Returns (prepared_params, conv_impls, fc_impls) where the impl tuples are
    the per-layer strategies to pass to network.forward (decoded layers
    become 'dense').

    dtype: torch.float32 or torch.bfloat16; None means bf16 on the card and
      f32 on the CPU. int8 is not ported yet (ROADMAP.md A7).
    device: None means "cuda"; pass "cpu" to prepare for the CPU.
    """
    device = resolve_device(device)
    if dtype is None:
        dtype = default_dtype(device)
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"prepare_params(dtype={dtype}) is not ported yet: only float32 "
            "and bfloat16 are (int8: ROADMAP.md A7)"
        )
    conv_strat, fc_strat = network.resolve_strategy(
        spec, params, batch_hint, conv_impl, fc_impl, dtype=dtype)

    out: list = []
    conv_final: list[str] = []
    fc_final: list[str] = []
    shapes = spec.feature_shapes(batch=1)
    for i, (layer, p) in enumerate(zip(spec.layers, params)):
        _, h, w, c = shapes[i]
        is_conv = isinstance(layer, ConvSpec)
        is_fc = isinstance(layer, FCSpec)
        conv_final.append("-")
        fc_final.append("-")
        final = conv_final if is_conv else fc_final
        if not (is_conv or is_fc) or p is None:
            out.append(None)
            continue
        if any(key in p for key in ("kernel_q", "weight_q")):
            raise NotImplementedError(
                "int8 layers are not ported yet: ROADMAP.md A7")
        bias = _tensor(_np(p["bias"]).astype(np.float32), torch.float32,
                       device)
        if not is_pq(p):
            final[i] = "dense"
            if is_conv:
                hwio = _np(p["kernel"])
                kernel = conv_kernel_tensor(hwio.transpose(3, 0, 1, 2),
                                            dtype, device)
                out.append({"kernel": kernel, "bias": bias})
            else:
                weight = fc_weight_tensor(_np(p["weight"]).T, dtype, device)
                out.append({"weight": weight, "bias": bias})
            continue
        strat = conv_strat[i] if is_conv else fc_strat[i]
        if strat != "decode":
            final[i] = strat
            out.append(_cast_pq(p, dtype, device))
            continue
        final[i] = "dense"
        codebooks = _np(p["codebooks"]).astype(np.float32)
        asmt = _np(p["assignments"])
        if is_conv:
            cout, kh, kw, s = asmt.shape
            cg = c // layer.groups
            ohwi = _decode_rows_np(codebooks, asmt.reshape(-1, s), cg)
            ohwi = ohwi.reshape(cout, kh, kw, cg)
            if "perm" in p:
                # fold the OPQ channel permutation into the dense kernel:
                # W_eq[..., ch] = W_perm[..., invperm[ch]]
                ohwi = ohwi[..., inverse_permutation(_np(p["perm"]))]
            out.append({"kernel": conv_kernel_tensor(ohwi, dtype, device),
                        "bias": bias})
        else:
            w_oi = _decode_rows_np(codebooks, asmt, h * w * c)
            if "perm" in p:
                w_oi = w_oi[:, inverse_permutation(_np(p["perm"]))]
            out.append({"weight": fc_weight_tensor(w_oi, dtype, device),
                        "bias": bias})
    return out, tuple(conv_final), tuple(fc_final)


def _cast_pq(p: dict, dtype, device) -> dict:
    out = {
        "codebooks": _tensor(_np(p["codebooks"]).astype(np.float32), dtype,
                             device),
        "assignments": _tensor(_np(p["assignments"]), torch.uint8, device),
        "bias": _tensor(_np(p["bias"]).astype(np.float32), torch.float32,
                        device),
    }
    if "perm" in p:  # OPQ permutation (consumed by ops.fc/ops.conv)
        out["perm"] = _tensor(_np(p["perm"]), torch.int64, device)
    return out
