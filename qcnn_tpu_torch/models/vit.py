"""Vision Transformer with product-quantized projection GEMMs.

Port of ``qcnn_tpu/models/vit.py``. Every weight matrix (patch embedding,
the qkv and out projections, the two MLP matrices and the head) is a
(Cin, Cout) GEMM carrying the PQ data model of the FC layers, so the FC op
library applies unchanged. Parameters are a nested dict: "patch_embed",
"cls_token" (1, 1, D), "pos_embed" (1, N+1, D), "blk{i}" (a dict of
"ln1", "qkv", "out", "ln2", "mlp1", "mlp2"), "ln_final" and "head".
Activations are (B, tokens, D); the input image is NHWC.

Attention has no weights. It runs as two batched matmuls in the JAX
package's numerics (:func:`_masked_attention`): float32 sums, the logits
divided by sqrt(hd) in float32 and materialized in ``logits_dtype``, the
softmax in float32. ``F.scaled_dot_product_attention`` never materializes
the logits in bf16, so it would compute another function.

In memory mode (``prepare_params(memory=True)``) each projection is routed
by ``common.fc_memory_impl`` on its rows (B x tokens), as the JAX package
does. A block's projections that decode in the step ('indecode') are
decoded together in one ``pq_decode`` launch at the head of the block, and
their weights live until the block returns; the others ('fgather' at
ViT-L's MLP widths) run the ``pq_fc_fused`` kernel. In int8
(``prepare_params(dtype=torch.int8)``) dense and decoded GEMMs run the int8
fc with the dynamic amax of each input, activations bf16; memory mode keeps
bf16 codebooks there.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from qcnn_tpu_torch._device import resolve_device
from qcnn_tpu_torch.models import common
from qcnn_tpu_torch.models.common import make_cast as _make_cast
from qcnn_tpu_torch.models.prepare import (
    _cast_pq,
    _decode_rows_np,
    _is_int8,
    _np,
    _tensor,
    dense_layer,
    inverse_permutation,
)
from qcnn_tpu_torch.ops import fc as fc_ops


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    name: str
    patch: int = 16
    image_size: int = 224
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    num_classes: int = 1000

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + [CLS]


def vit_b16() -> ViTSpec:
    return ViTSpec("ViT-B/16")


def vit_s16() -> ViTSpec:
    return ViTSpec("ViT-S/16", dim=384, depth=12, heads=6)


def vit_l16() -> ViTSpec:
    return ViTSpec("ViT-L/16", dim=1024, depth=24, heads=16)


def vit_tiny_test() -> ViTSpec:
    """Miniature config for CPU tests."""
    return ViTSpec("ViT-test", patch=8, image_size=32, dim=64, depth=2,
                   heads=4, num_classes=10)


VITS = {"vit_b16": vit_b16, "vit_s16": vit_s16, "vit_l16": vit_l16}


# ---------------------------------------------------------------------------
# Parameters (NumPy: the same seed gives the JAX package's bits)
# ---------------------------------------------------------------------------

def _gemm(rng, cin, cout):
    return {
        "weight": (rng.standard_normal((cin, cout)) /
                   np.sqrt(cin)).astype(np.float32),
        "bias": np.zeros(cout, np.float32),
    }


def _ln(dim):
    return {"scale": np.ones(dim, np.float32),
            "shift": np.zeros(dim, np.float32)}


def init_dense_params(spec: ViTSpec, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    d = spec.dim
    params: dict = {
        "patch_embed": _gemm(rng, spec.patch * spec.patch * 3, d),
        "cls_token": np.zeros((1, 1, d), np.float32),
        "pos_embed": (rng.standard_normal((1, spec.seq_len, d)) *
                      0.02).astype(np.float32),
        "head": _gemm(rng, d, spec.num_classes),
        "ln_final": _ln(d),
    }
    for i in range(spec.depth):
        params[f"blk{i}"] = {
            "ln1": _ln(d),
            "qkv": _gemm(rng, d, 3 * d),
            "out": _gemm(rng, d, d),
            "ln2": _ln(d),
            "mlp1": _gemm(rng, d, spec.mlp_ratio * d),
            "mlp2": _gemm(rng, spec.mlp_ratio * d, d),
        }
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layernorm(x, p, eps=1e-6):
    """(x - mean) / sqrt(var + eps) * scale + shift over the last axis, in
    float32 (one ``F.layer_norm`` pass), cast back to x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"], p["shift"],
                        eps).to(x.dtype)


def _logits(q, k_t, hd: int, logits_dtype):
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


def _masked_attention(q, k, v, n_pad: int = 0, logits_dtype=torch.float32,
                      out_dtype=None):
    """(B, N, H, hd) q/k/v -> (B, N, H, hd) in ``out_dtype`` (float32 when
    None); keys and values zero-padded by n_pad tokens with an additive
    -inf mask. exp(-inf) = 0 and the softmax max and denominator see only
    real keys, so any n_pad gives the outputs of n_pad=0 up to the order
    of float32 sums.

    logits_dtype: the dtype the (B, H, N, N) logits are materialized in;
    the softmax takes them in float32 and emits v's dtype."""
    hd = q.shape[-1]
    if n_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, n_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, n_pad))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, hd)
    att = _logits(q, k.transpose(-1, -2), hd, logits_dtype)
    if n_pad:
        mask = torch.zeros(k.shape[2], dtype=logits_dtype, device=k.device)
        mask[-n_pad:] = -math.inf
        att = att + mask
    att = torch.softmax(att, dim=-1, dtype=torch.float32).to(v.dtype)
    return fc_ops.matmul(att, v, out_dtype).transpose(1, 2)


def _proj(x, p, out_dtype=None, impl=None, decoded=None):
    """(…, Cin) @ gemm -> (…, Cout), PQ or dense.

    impl: the PQ strategy :func:`_block_routes` resolved (None resolves
    ``common.fc_memory_impl`` on the rows here); decoded: the weight from
    the block's grouped decode. out_dtype: the dtype the GEMM emits."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if "codebooks" in p:
        # the PQ FC by models/common.py MEMORY_FC_IMPL (a per-rows rule:
        # projections see B * tokens rows)
        y = fc_ops.pq_fc(x2, p, impl=impl or common.fc_memory_impl(
            x2.shape[0], p, x2.dtype), out_dtype=out_dtype, decoded=decoded)
    elif "weight_q" in p:
        y = fc_ops.fc_dense_int8(x2, p["weight_q"], p["scale"], p["bias"],
                                 act_scale=p.get("act_scale"))
    else:
        y = fc_ops.fc_dense(x2, p["weight"], p["bias"], out_dtype=out_dtype)
    if out_dtype is not None and y.dtype != out_dtype:
        y = y.to(out_dtype)  # the int8 and kernel branches emit float32
    return y.reshape(*lead, y.shape[-1])


def forward(params: dict, x, *, spec: ViTSpec, compute_dtype=None,
            with_softmax: bool = False, attn_logits_dtype=None,
            device=None) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, num_classes) float32 logits (or
    probabilities).

    compute_dtype: activation dtype between layers; None keeps x's dtype.
    attn_logits_dtype: the dtype of the attention logits; None follows the
      activations: bf16 when they are bf16, float32 otherwise.
    device: None means "cuda"; pass "cpu" to run the plain versions. The
      params must already be there (``prepare_params(device=...)``)."""
    device = resolve_device(device)
    x = torch.as_tensor(x, device=device)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if attn_logits_dtype is None:
        attn_logits_dtype = (torch.bfloat16 if x.dtype == torch.bfloat16
                             else torch.float32)
    cast = _make_cast(compute_dtype)
    x = _run_embed(x, params, spec, cast)
    for i in range(spec.depth):
        x = _run_block(x, params[f"blk{i}"], spec, cast, attn_logits_dtype)
    return _run_head(x, params, with_softmax)


def _run_embed(x, params, spec, cast):
    b, h, w, c = x.shape
    p = spec.patch
    # patchify: (B, H/p, p, W/p, p, C) -> (B, N, p*p*C), (row, col, ch) order
    x = x.reshape(b, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, spec.num_patches, -1)
    x = cast(_proj(x, params["patch_embed"], out_dtype=cast.dtype))
    cls = params["cls_token"].to(x.dtype).expand(b, 1, spec.dim)
    x = torch.cat([cls, x], dim=1)
    return x + params["pos_embed"].to(x.dtype)


def _block_inputs(x, blk, od) -> dict:
    """{projection: (input rows, Cin, input dtype)} of one block, which
    follow from the block's input x (B, N, D): qkv and mlp1 take the
    LayerNorm of x (x's dtype), out takes the attention output and mlp2
    the GELU of mlp1's output, both ``od`` (float32 when None)."""
    rows, d = x.shape[0] * x.shape[1], x.shape[2]
    inner = od if od is not None else torch.float32
    return {"qkv": (rows, d, x.dtype), "out": (rows, d, inner),
            "mlp1": (rows, d, x.dtype),
            "mlp2": (rows, blk["mlp1"]["bias"].shape[0], inner)}


def _block_routes(inputs: dict, blk) -> dict:
    """{projection: (params, impl, Cin)} for the block's PQ projections:
    the strategy ``common.fc_memory_impl`` resolves for its rows and dtype,
    decided once per projection from its input (:func:`_block_inputs`)."""
    return {name: (blk[name], common.fc_memory_impl(rows, blk[name], dtype),
                   cin)
            for name, (rows, cin, dtype) in inputs.items()
            if "codebooks" in blk[name]}


def _run_block(x, blk, spec, cast, attn_logits_dtype):
    """One transformer block (shared by forward and forward_segments). The
    projections that decode their weight in the step do so in one
    ``pq_decode`` launch at the head of the block."""
    b = x.shape[0]
    nh = spec.heads
    hd = spec.dim // nh
    od = cast.dtype
    inputs = _block_inputs(x, blk, od)
    routes = _block_routes(inputs, blk)
    decoded = fc_ops.instep_decodes(routes)

    def proj(v, name):
        if (v.shape[0] * v.shape[1], v.shape[2], v.dtype) != inputs[name]:
            raise RuntimeError(
                f"{name}: input {tuple(v.shape)} {v.dtype}, but its route "
                f"was decided for (rows, Cin, dtype) {inputs[name]}")
        impl = routes[name][1] if name in routes else None
        return _proj(v, blk[name], out_dtype=od, impl=impl,
                     decoded=decoded.get(name))

    y = _layernorm(x, blk["ln1"])
    qkv = proj(y, "qkv")  # (B, N, 3D)
    q, k, v = (t.reshape(b, -1, nh, hd) for t in qkv.chunk(3, dim=-1))
    o = _masked_attention(q, k, v, 0, attn_logits_dtype, out_dtype=od)
    o = cast(o.reshape(b, -1, spec.dim))
    x = x + cast(proj(o, "out"))
    y = _layernorm(x, blk["ln2"])
    # exact (erf) GELU, the timm/torch semantics
    y = cast(F.gelu(proj(y, "mlp1")))
    return x + cast(proj(y, "mlp2"))


def _run_head(x, params, with_softmax: bool):
    x = _layernorm(x, params["ln_final"])
    logits = _proj(x[:, 0], params["head"]).float()
    if with_softmax:
        logits = torch.softmax(logits, dim=-1)
    return logits


def forward_segments(spec: ViTSpec, *, compute_dtype=None,
                     with_softmax: bool = False, attn_logits_dtype=None):
    """[(name, fn(x, params) -> x)] whose composition equals forward on
    tensors already on the params' device: "embed", one per block,
    "head"."""
    if attn_logits_dtype is None and compute_dtype is not None:
        # forward's rule, which reads x's dtype after the compute_dtype cast
        attn_logits_dtype = (torch.bfloat16 if compute_dtype == torch.bfloat16
                             else torch.float32)

    def _attn_dtype(x):
        if attn_logits_dtype is not None:
            return attn_logits_dtype
        return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32

    cast = _make_cast(compute_dtype)

    def embed(x, p):
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        return _run_embed(x, p, spec, cast)

    segs = [("embed", embed)]
    for i in range(spec.depth):
        segs.append((
            f"blk{i}",
            lambda x, p, i=i: _run_block(x, p[f"blk{i}"], spec, cast,
                                         _attn_dtype(x)),
        ))
    segs.append(("head", lambda x, p: _run_head(x, p, with_softmax)))
    return segs


# ---------------------------------------------------------------------------
# Quantization / preparation
# ---------------------------------------------------------------------------

def quantize_params(spec: ViTSpec, dense: dict, **kwargs) -> dict:
    """The quantizer is not ported yet (ROADMAP.md A11); synthetic PQ
    params come from ``models.synth.random_vit_pq_params``."""
    raise NotImplementedError(
        "vit.quantize_params needs the quantizer, which is not ported yet: "
        "ROADMAP.md A11")


def prepare_params(spec: ViTSpec, params: dict, dtype=torch.bfloat16, *,
                   memory: bool = False, device=None) -> dict:
    """The nested params on the device, ready for :func:`forward`.

    Decode at load (memory=False): PQ GEMMs are decoded to dense on the
    host in NumPy (an OPQ permutation folded in by its inverse), then cast
    to ``dtype``: a weight is (Cin, Cout) logically and (Cout, Cin) in
    memory. memory=True keeps PQ GEMMs compressed: codebooks cast to
    ``dtype``, assignments uint8, bias float32 and the OPQ ``perm`` kept
    for ``ops.fc.pq_fc`` to apply; the forward decodes in the step.
    LayerNorms, ``cls_token`` and ``pos_embed`` stay float32.

    dtype: torch.float32, torch.bfloat16 or torch.int8. int8 quantizes
      dense and decoded weights per output channel
      (``models.prepare.dense_layer``); memory mode keeps bf16 codebooks
      under it.
    device: None means "cuda"; pass "cpu" to prepare for the CPU."""
    device = resolve_device(device)
    if not (_is_int8(dtype) or dtype in (torch.float32, torch.bfloat16)):
        raise ValueError(f"vit.prepare_params: unsupported dtype {dtype}")
    cb_dtype = torch.bfloat16 if _is_int8(dtype) else dtype
    cin_map = _gemm_cin_map(spec)

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
                "vit.prepare_params: these params are prepared int8 already "
                "(models.interop.family_params_from_jax carries JAX-prepared "
                "ones)")
        if isinstance(p, dict) and "weight" in p:
            return dense_layer("weight", _np(p["weight"]).T, p["bias"],
                               dtype, device)
        if isinstance(p, dict):
            return {k: prep(v, f"{path}.{k}") for k, v in p.items()}
        return _tensor(_np(p).astype(np.float32), torch.float32, device)

    return {name: prep(p, name) for name, p in params.items()}


def _gemm_cin_map(spec: ViTSpec) -> dict:
    """True Cin of every GEMM (the codebook span may overhang), keyed
    "patch_embed", "head" and "blk{i}.{name}"."""
    d = spec.dim
    m = {
        "patch_embed": spec.patch * spec.patch * 3,
        "head": d,
    }
    for i in range(spec.depth):
        m[f"blk{i}.qkv"] = d
        m[f"blk{i}.out"] = d
        m[f"blk{i}.mlp1"] = d
        m[f"blk{i}.mlp2"] = spec.mlp_ratio * d
    return m
