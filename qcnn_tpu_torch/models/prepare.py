"""One-time parameter preparation for execution (the PrepCtrdBuf/PrepAsmtBuf
analogue, CaffeEva.cc:534-623).

Port of ``qcnn_tpu/models/prepare.py``:

- ``decode`` layers: decode codebooks + assignments to a dense kernel or
  weight on the host in NumPy (exact: PQ(x) == W̃x), then cast to the
  compute dtype and move to the device. A conv kernel is HWIO logically and
  OHWI in memory (a channels_last OIHW weight for the convolution); an fc
  weight is (Cin, Cout) logically and (Cout, Cin) in memory.
- int8: dense and decoded layers are quantized per output channel
  (``kernel_q`` / ``weight_q`` int8 with float32 ``scale``), in the same
  memory, each row zero-padded to a multiple of 8 for the int8 GEMM
  (``ops.fc.int8_matmul``). ``act_scales`` from ``models.calibrate`` become
  each layer's static ``act_scale``, and :func:`int8_out_scales` plants the
  ``out_scale`` of the int8-native dataflow. Strategies resolve as in bf16.
- every other PQ strategy keeps codebooks + assignments (the ~21x smaller
  form) and only casts: codebooks to the compute dtype (bf16 under int8),
  assignments uint8 in their (Cout, S) layout, bias float32. Those layers
  decode in the step.

The returned params feed models.network.forward unchanged: decoded layers
look like dense layers, PQ layers keep their PQ dict.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from qcnn_tpu_torch._device import resolve_device
from qcnn_tpu_torch.core import (
    ConvSpec,
    DropoutSpec,
    FCSpec,
    ModelSpec,
    PoolSpec,
    ReLUSpec,
    is_pq,
)
from qcnn_tpu_torch.models import network
from qcnn_tpu_torch.ops.fc import padded_k
from qcnn_tpu_torch.quantizer.opq import inverse_permutation


def _is_int8(dtype) -> bool:
    return dtype in (torch.int8, np.int8, "int8")


def act_dtype_for(compute_dtype):
    """The activation dtype between layers for an execution dtype: int8
    selects the weight representation only, activations stay bf16
    (qcnn_tpu/models/prepare.py:58-67)."""
    if compute_dtype is not None and _is_int8(compute_dtype):
        return torch.bfloat16
    return compute_dtype


def _quantize_weight_int8(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel (last axis) symmetric int8: w ≈ w_q * scale (a
    copy of qcnn_tpu/models/prepare.py:70-75)."""
    amax = np.maximum(np.abs(w).max(axis=tuple(range(w.ndim - 1))), 1e-12)
    scale = (amax / 127.0).astype(np.float32)
    wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return wq, scale


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


def int8_rows_tensor(rows_q, device) -> torch.Tensor:
    """(N, K) int8 rows (an array or a tensor) as the int8 GEMM takes them:
    each row zero-padded to a multiple of 8 in memory, returned as the
    (N, K) view of the unpadded part (``ops.fc.pad_k_columns`` widens it
    again without a copy)."""
    rows_q = torch.as_tensor(rows_q)
    n, k = rows_q.shape
    padded = torch.zeros((n, padded_k(k)), dtype=torch.int8, device=device)
    padded[:, :k] = rows_q.to(device)
    return padded[:, :k]


def int8_conv_kernel_tensor(ohwi_q, device) -> torch.Tensor:
    """An int8 (Cout, kh, kw, Cg) kernel (an array or a tensor): OHWI rows
    padded for the int8 GEMM (:func:`int8_rows_tensor`), returned as its
    HWIO view."""
    cout, kh, kw, cg = ohwi_q.shape
    rows = int8_rows_tensor(torch.as_tensor(ohwi_q).reshape(cout, -1),
                            device)
    return rows.view(cout, kh, kw, cg).permute(1, 2, 3, 0)


def dense_layer(kind: str, rows: np.ndarray, bias, dtype, device) -> dict:
    """A dense or decoded layer in the port's memory: rows are OHWI for
    kind 'kernel', (Cout, Cin) for 'weight'. int8 quantizes per output
    channel on the logical (HWIO / (Cin, Cout)) array, as the JAX package
    does, and keeps the port's memory."""
    bias_t = _tensor(_np(bias).astype(np.float32), torch.float32, device)
    if not _is_int8(dtype):
        if kind == "kernel":
            return {"kernel": conv_kernel_tensor(rows, dtype, device),
                    "bias": bias_t}
        return {"weight": fc_weight_tensor(rows, dtype, device),
                "bias": bias_t}
    rows = np.asarray(rows, np.float32)
    if kind == "kernel":
        kq, scale = _quantize_weight_int8(rows.transpose(1, 2, 3, 0))
        q = int8_conv_kernel_tensor(kq.transpose(3, 0, 1, 2), device)
    else:
        wq, scale = _quantize_weight_int8(rows.T)
        q = int8_rows_tensor(wq.T, device).t()
    return {f"{kind}_q": q,
            "scale": _tensor(scale, torch.float32, device), "bias": bias_t}


def int8_out_scales(
    spec: ModelSpec,
    params: Sequence[Optional[dict]],
    conv_strat: tuple,
    fc_strat: tuple,
    act_scales: Optional[dict],
) -> dict[int, float]:
    """The int8-native dataflow plan: {producer layer index: out_scale}
    (qcnn_tpu/models/prepare.py:95-145).

    ReLU and max-pool commute with symmetric per-tensor quantization and
    inference dropout/flatten are identity, so a conv/FC whose path to the
    next conv/FC crosses only those emits int8 codes in the consumer's
    calibrated input scale. LRN breaks the chain. Both ends must run
    int8-dense ('dense' or 'decode') and the consumer must have a static
    scale."""
    if act_scales is None:
        return {}

    def int8_dense_at(j: int) -> bool:
        layer, p = spec.layers[j], params[j]
        if p is None:
            return False
        strat = conv_strat[j] if isinstance(layer, ConvSpec) else fc_strat[j]
        return strat in ("dense", "decode")

    plan: dict[int, float] = {}
    for i, layer in enumerate(spec.layers):
        if not isinstance(layer, (ConvSpec, FCSpec)) or not int8_dense_at(i):
            continue
        j = i + 1
        commutes = True
        while j < len(spec.layers) and not isinstance(
                spec.layers[j], (ConvSpec, FCSpec)):
            if not isinstance(spec.layers[j],
                              (ReLUSpec, PoolSpec, DropoutSpec)):
                commutes = False
                break
            j += 1
        if (commutes and j < len(spec.layers) and j in act_scales
                and int8_dense_at(j)):
            plan[i] = act_scales[j]
    return plan


def prepare_params(
    spec: ModelSpec,
    params: Sequence[Optional[dict]],
    *,
    batch_hint: int = 1,
    conv_impl: str = "auto",
    fc_impl: str = "auto",
    dtype=torch.bfloat16,
    act_scales: Optional[dict] = None,
    device=None,
) -> tuple[list, tuple[str, ...], tuple[str, ...]]:
    """Resolve strategies and pre-decode/pre-layout parameters.

    Returns (prepared_params, conv_impls, fc_impls) where the impl tuples are
    the per-layer strategies to pass to network.forward (decoded layers
    become 'dense').

    dtype: torch.bfloat16 (the default, as in the JAX package),
      torch.float32 or torch.int8; None keeps float32 arrays and resolves
      strategies with no dtype, as the JAX package does.
    act_scales: {layer_index: static activation scale} from
      ``models.calibrate.calibrate_act_scales``; int8 only.
    device: None means "cuda"; pass "cpu" to prepare for the CPU.
    """
    device = resolve_device(device)
    int8 = _is_int8(dtype)
    if not (int8 or dtype in (None, torch.float32, torch.bfloat16)):
        raise ValueError(f"prepare_params: unsupported dtype {dtype}")
    conv_strat, fc_strat = network.resolve_strategy(
        spec, params, batch_hint, conv_impl, fc_impl,
        dtype=torch.bfloat16 if int8 else dtype)
    out_scales = (int8_out_scales(spec, params, conv_strat, fc_strat,
                                  act_scales) if int8 else {})
    store = torch.float32 if dtype is None else dtype

    def scalar(v) -> torch.Tensor:
        return torch.tensor(np.float32(v), device=device)

    def with_act_scale(d: dict, i: int) -> dict:
        if int8 and act_scales is not None and i in act_scales:
            d["act_scale"] = scalar(act_scales[i])
        if i in out_scales:
            d["out_scale"] = scalar(out_scales[i])
        return d

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
            raise ValueError(
                f"prepare_params: the params of layer {i} are prepared int8 "
                "already; pass them to network.forward (JAX-prepared ones "
                "through models.interop.params_from_jax)")
        if not is_pq(p):
            final[i] = "dense"
            if is_conv:
                rows = _np(p["kernel"]).transpose(3, 0, 1, 2)
            else:
                rows = _np(p["weight"]).T
            out.append(with_act_scale(dense_layer(
                "kernel" if is_conv else "weight", rows, p["bias"], store,
                device), i))
            continue
        strat = conv_strat[i] if is_conv else fc_strat[i]
        if strat != "decode":
            final[i] = strat
            out.append(_cast_pq(p, torch.bfloat16 if int8 else store, device))
            continue
        final[i] = "dense"
        codebooks = _np(p["codebooks"]).astype(np.float32)
        asmt = _np(p["assignments"])
        if is_conv:
            cout, kh, kw, s = asmt.shape
            cg = c // layer.groups
            rows = _decode_rows_np(codebooks, asmt.reshape(-1, s), cg)
            rows = rows.reshape(cout, kh, kw, cg)
            if "perm" in p:
                # fold the OPQ channel permutation into the dense kernel:
                # W_eq[..., ch] = W_perm[..., invperm[ch]]
                rows = rows[..., inverse_permutation(_np(p["perm"]))]
        else:
            rows = _decode_rows_np(codebooks, asmt, h * w * c)
            if "perm" in p:
                rows = rows[:, inverse_permutation(_np(p["perm"]))]
        out.append(with_act_scale(dense_layer(
            "kernel" if is_conv else "weight", rows, p["bias"], store,
            device), i))
    return out, tuple(conv_final), tuple(fc_final)


def _cast_pq(p: dict, dtype, device) -> dict:
    """A PQ layer kept compressed: codebooks in ``dtype``, uint8 ids, float32
    bias and the OPQ perm (consumed by ops.fc / ops.conv)."""
    out = {
        "codebooks": _tensor(_np(p["codebooks"]).astype(np.float32), dtype,
                             device),
        "assignments": _tensor(_np(p["assignments"]), torch.uint8, device),
        "bias": _tensor(_np(p["bias"]).astype(np.float32), torch.float32,
                        device),
    }
    if "perm" in p:
        out["perm"] = _tensor(_np(p["perm"]), torch.int64, device)
    return out
