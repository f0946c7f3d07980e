"""The parts of a pre-norm transformer that the ViT, Swin and MaxViT
families share.

Both families keep every weight matrix as a (Cin, Cout) GEMM with the PQ
data model of the FC layers (``ops.fc.fc_layer``), LayerNorms with float32
statistics, and the same block skeleton: LayerNorm, attention, the out
projection with the residual add in its epilogue, LayerNorm, the MLP with
the exact GELU in mlp1's epilogue and the residual add in mlp2's. What
differs (the class token and position embedding, the windows, shift, bias
and merging) stays in ``models/vit.py`` and ``models/swin.py``.

- :func:`gemm_params`, :func:`ln_params`: dense float32 init (NumPy).
- :func:`prepare_tree`: a family's nested params to their served form.
- :func:`layernorm`, :func:`logits`, :func:`proj`: the forward's ops.
- :func:`block_projections`: one block's four projections, routed once from
  the block's input and decoded together at its head.
- :func:`relative_position_index`: the bias table's row of each token pair
  of a window (Swin's, and MaxViT's read backwards).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qcnn_tpu_torch._device import resolve_device
from qcnn_tpu_torch.core import is_pq
from qcnn_tpu_torch.models import common
from qcnn_tpu_torch.models.prepare import (
    _cast_pq,
    _decode_rows_np,
    _is_int8,
    _np,
    _tensor,
    dense_layer,
)
from qcnn_tpu_torch.ops import fc as fc_ops
from qcnn_tpu_torch.ops.conv import instep_decodes
from qcnn_tpu_torch.ops.cuda import layernorm_fused as ln_ops
from qcnn_tpu_torch.quantizer.opq import inverse_permutation
from qcnn_tpu_torch.utils.spans import span

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def gemm_params(rng, cin, cout):
    """Dense (Cin, Cout) GEMM: N(0, 1/Cin) weights, zero biases."""
    return {
        "weight": (rng.standard_normal((cin, cout)) /
                   np.sqrt(cin)).astype(np.float32),
        "bias": np.zeros(cout, np.float32),
    }


def ln_params(dim):
    return {"scale": np.ones(dim, np.float32),
            "shift": np.zeros(dim, np.float32)}


def prepare_tree(params: dict, cin_map: dict, dtype, *, memory: bool,
                 device, who: str) -> dict:
    """The nested params of a transformer family on the device, by the
    rules of ``vit.prepare_params``: every GEMM dict (PQ or dense) to its
    served form, every other leaf a float32 tensor.

    cin_map: the true Cin of every GEMM, keyed by its key path joined with
      "." ("patch_embed", "blk3.qkv"); who: the caller's name, in errors."""
    device = resolve_device(device)
    if not (_is_int8(dtype) or dtype in (torch.float32, torch.bfloat16)):
        raise ValueError(f"{who}: unsupported dtype {dtype}")
    cb_dtype = torch.bfloat16 if _is_int8(dtype) else dtype

    def prep(p, path: str):
        if isinstance(p, dict) and "codebooks" in p:
            if memory:
                return _cast_pq(p, cb_dtype, device)
            rows = _decode_rows_np(_np(p["codebooks"]).astype(np.float32),
                                   _np(p["assignments"]), cin_map[path])
            if "perm" in p:
                rows = rows[:, inverse_permutation(_np(p["perm"]))]
            return dense_layer("weight", rows, p["bias"], dtype, device)
        if isinstance(p, dict) and "weight_q" in p:
            raise ValueError(
                f"{who}: these params are prepared int8 already "
                "(models.interop.family_params_from_jax carries JAX-prepared "
                "ones)")
        if isinstance(p, dict) and "weight" in p:
            return dense_layer("weight", _np(p["weight"]).T, p["bias"],
                               dtype, device)
        if isinstance(p, dict):
            return {k: prep(v, f"{path}.{k}") for k, v in p.items()}
        return _tensor(_np(p).astype(np.float32), torch.float32, device)

    return {name: prep(p, name) for name, p in params.items()}


def relative_position_index(window: int) -> torch.Tensor:
    """(N, N) int64 with N = window^2: the row of the bias table that
    token pair (a, b) of a window reads, (dy + w - 1) (2w - 1) + dx + w - 1
    for a's row and column minus b's."""
    r = torch.arange(window)
    rows = r.repeat_interleave(window)
    cols = r.repeat(window)
    dy = rows[:, None] - rows[None, :] + window - 1
    dx = cols[:, None] - cols[None, :] + window - 1
    return dy * (2 * window - 1) + dx


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def layernorm(x, p, eps: float):
    """(x - mean) / sqrt(var + eps) * scale + shift over the last axis with
    float32 statistics: one ``layernorm_fused`` launch where its route
    takes x (bf16 on the card), else the float32 form (``F.layer_norm`` on
    x widened to float32, cast back to x's dtype)."""
    if ln_ops.route(x, p) == "kernel":
        return ln_ops.layernorm_fused(x, p, eps)
    return ln_ops.layernorm_plain(x, p, eps)


def logits(q, k_t, hd: int, logits_dtype):
    """q @ kᵀ / sqrt(hd) in ``logits_dtype``, as the JAX package: float32
    sums divided by sqrt(hd) in float32, rounded once. Where 1/sqrt(hd) is
    a power of two (hd = 16, 64, 256, ...) the division commutes with the
    rounding, so one matmul emits ``logits_dtype`` and the scale follows
    exactly; any other hd takes the float32 matmul."""
    root = math.isqrt(hd)
    power_of_two = root * root == hd and root & (root - 1) == 0
    if power_of_two and q.dtype == logits_dtype:
        return fc_ops.matmul(q, k_t, logits_dtype) * (1.0 / root)
    return (fc_ops.matmul(q, k_t, torch.float32)
            / math.sqrt(hd)).to(logits_dtype)


def proj(x, p, out_dtype=None, impl=None, decoded=None, act=None,
         residual=None):
    """(…, Cin) @ gemm -> (…, Cout) in ``out_dtype`` through
    ``ops.fc.fc_layer``, with ``residual`` (…, Cout) and ``act`` after the
    bias in its epilogue.

    impl: the strategy :func:`block_routes` resolved (None resolves
    ``common.fc_memory_impl`` on the rows here: projections see B x tokens
    rows); decoded: the weight from the block's grouped decode."""
    x2 = x.reshape(-1, x.shape[-1])
    if residual is not None:
        residual = residual.reshape(x2.shape[0], -1)
    y = fc_ops.fc_layer(
        x2, p, impl=impl or common.fc_memory_impl(x2.shape[0], p, x2.dtype),
        out_dtype=out_dtype, decoded=decoded, act=act, residual=residual)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def block_inputs(x, blk, od) -> dict:
    """{projection: (input rows, Cin, input dtype)} of one block, which
    follow from the block's input x (B, N, D): qkv and mlp1 take the
    LayerNorm of x (x's dtype), out takes the attention output and mlp2
    the GELU of mlp1's output, both ``od`` (float32 when None)."""
    rows, d = x.shape[0] * x.shape[1], x.shape[2]
    inner = od if od is not None else torch.float32
    return {"qkv": (rows, d, x.dtype), "out": (rows, d, inner),
            "mlp1": (rows, d, x.dtype),
            "mlp2": (rows, blk["mlp1"]["bias"].shape[0], inner)}


def block_routes(inputs: dict, blk) -> dict:
    """{projection: (params, impl, Cin)} for the block's PQ projections:
    the strategy ``common.fc_memory_impl`` resolves for its rows and dtype,
    decided once per projection from its input (:func:`block_inputs`)."""
    return {name: (blk[name], common.fc_memory_impl(rows, blk[name], dtype),
                   cin)
            for name, (rows, cin, dtype) in inputs.items()
            if is_pq(blk[name])}


def block_projections(x, blk, od, key: str, project=None):
    """``run(v, name, act=None, residual=None)``, which applies projection
    ``name`` ("qkv", "out", "mlp1", "mlp2") of the block whose input is x
    (B, N, D) to v, in ``od``, under the span ``qcnn.fc:<key>.<name>``.

    The routes are decided here from x (:func:`block_inputs`), and the
    projections that decode their weight in the step are decoded here, in
    one ``pq_decode`` launch: call it at the head of the block. ``run``
    raises if v is not the input its route was decided for.

    project: the function that runs one projection; None is :func:`proj`.
      ViT passes its module-level ``_proj``, looked up at each call, so
      that swapping that name reaches its blocks' projections."""
    inputs = block_inputs(x, blk, od)
    routes = block_routes(inputs, blk)
    decoded = instep_decodes(routes)
    project = project or proj

    def run(v, name, act=None, residual=None):
        if (v.shape[0] * v.shape[1], v.shape[2], v.dtype) != inputs[name]:
            raise RuntimeError(
                f"{name}: input {tuple(v.shape)} {v.dtype}, but its route "
                f"was decided for (rows, Cin, dtype) {inputs[name]}")
        impl = routes[name][1] if name in routes else None
        with span("fc", key, name):
            return project(v, blk[name], out_dtype=od, impl=impl,
                           decoded=decoded.get(name), act=act,
                           residual=residual)
    return run
