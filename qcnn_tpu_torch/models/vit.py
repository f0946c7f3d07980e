"""Vision Transformer with product-quantized projection GEMMs.

Port of ``qcnn_tpu/models/vit.py``. Every weight matrix (patch embedding,
the qkv and out projections, the two MLP matrices and the head) is a
(Cin, Cout) GEMM carrying the PQ data model of the FC layers, so the FC op
library applies unchanged. Parameters are a nested dict: "patch_embed",
"cls_token" (1, 1, D), "pos_embed" (1, N+1, D), "blk{i}" (a dict of
"ln1", "qkv", "out", "ln2", "mlp1", "mlp2"), "ln_final" and "head".
Activations are (B, tokens, D); the input image is NHWC.

Attention has no weights. It computes the JAX package's numerics
(:func:`_masked_attention`): float32 sums, the logits divided by sqrt(hd)
in float32 and rounded to ``logits_dtype``, the softmax in float32. On the
CPU, and on the card outside :func:`attention_route`'s kernel route, it
runs as two batched matmuls that materialize the logits; on a bf16 CUDA
tensor with bf16 logits and a head dimension of 64 it is one launch of the
``attention_fused`` kernel (``ops/cuda/attention_fused.py``), which keeps
the logits in registers. ``F.scaled_dot_product_attention`` never rounds
the logits to bf16, so it would compute another function.

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
from qcnn_tpu_torch.models.common import make_cast as _make_cast
from qcnn_tpu_torch.models.transformer import (
    block_projections,
    gemm_params,
    layernorm,
    ln_params,
    prepare_tree,
)
# the forward looks these two up at each call, so they can be swapped
from qcnn_tpu_torch.models.transformer import logits as _logits
from qcnn_tpu_torch.models.transformer import proj as _proj
from qcnn_tpu_torch.ops import fc as fc_ops
from qcnn_tpu_torch.ops.cuda import attention_fused as attn_kernel
from qcnn_tpu_torch.quantizer.kmeans import split
from qcnn_tpu_torch.quantizer.pq import quantize_fc_layer
from qcnn_tpu_torch.utils.spans import span

LN_EPS = 1e-6  # every LayerNorm's, as the JAX package's


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

def init_dense_params(spec: ViTSpec, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    d = spec.dim
    params: dict = {
        "patch_embed": gemm_params(rng, spec.patch * spec.patch * 3, d),
        "cls_token": np.zeros((1, 1, d), np.float32),
        "pos_embed": (rng.standard_normal((1, spec.seq_len, d)) *
                      0.02).astype(np.float32),
        "head": gemm_params(rng, d, spec.num_classes),
        "ln_final": ln_params(d),
    }
    for i in range(spec.depth):
        params[f"blk{i}"] = {
            "ln1": ln_params(d),
            "qkv": gemm_params(rng, d, 3 * d),
            "out": gemm_params(rng, d, d),
            "ln2": ln_params(d),
            "mlp1": gemm_params(rng, d, spec.mlp_ratio * d),
            "mlp2": gemm_params(rng, spec.mlp_ratio * d, d),
        }
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def attention_route(device: torch.device, dtype: torch.dtype,
                    logits_dtype: torch.dtype, hd: int) -> str:
    """The form :func:`_masked_attention` takes: ``"kernel"``
    (``attention_fused``) for bf16 q/k/v on a CUDA device with bf16 logits
    and a head dimension the kernel is compiled for, else ``"plain"`` (the
    materialized chain: the CPU, float32 logits, other dtypes)."""
    if (device.type == "cuda" and dtype == torch.bfloat16
            and logits_dtype == torch.bfloat16
            and hd in attn_kernel.HEAD_DIMS):
        return "kernel"
    return "plain"


def _masked_attention(q, k, v, n_pad: int = 0, logits_dtype=torch.float32,
                      out_dtype=None):
    """(B, N, H, hd) q/k/v -> (B, N, H, hd) in ``out_dtype`` (float32 when
    None); keys and values zero-padded by n_pad tokens with an additive
    -inf mask. exp(-inf) = 0 and the softmax max and denominator see only
    real keys, so any n_pad gives the outputs of n_pad=0 up to the order
    of float32 sums.

    logits_dtype: the dtype the (B, H, N, N) logits are materialized in;
    the softmax takes them in float32 and emits v's dtype. On the kernel
    route (:func:`attention_route`) nothing is materialized or padded: the
    kernel reads the N real keys only."""
    hd = q.shape[-1]
    if attention_route(q.device, q.dtype, logits_dtype, hd) == "kernel":
        return attn_kernel.attention_fused(q, k, v, scale=1 / math.sqrt(hd),
                                           out_dtype=out_dtype)
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
    with span("forward"):
        device = resolve_device(device)
        x = torch.as_tensor(x, device=device)
        if attn_logits_dtype is None:
            attn_logits_dtype = (
                torch.bfloat16 if (compute_dtype or x.dtype) == torch.bfloat16
                else torch.float32)
        cast = _make_cast(compute_dtype)
        x = _run_embed(x, params, spec, cast)
        for i in range(spec.depth):
            x = _run_block(x, params[f"blk{i}"], spec, cast,
                           attn_logits_dtype, f"blk{i}")
        return _run_head(x, params, with_softmax)


def _run_embed(x, params, spec, cast):
    """The input cast to the activation dtype, the patch embedding, the
    class token and the position embedding."""
    with span("embed"):
        x = cast(x)
        b, h, w, c = x.shape
        p = spec.patch
        # patchify: (B, H/p, p, W/p, p, C) -> (B, N, p*p*C), (row, col, ch)
        # order
        x = x.reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, spec.num_patches, -1)
        x = _proj(x, params["patch_embed"], out_dtype=cast.dtype)
        cls = params["cls_token"].to(x.dtype).expand(b, 1, spec.dim)
        x = torch.cat([cls, x], dim=1)
        return x + params["pos_embed"].to(x.dtype)


def _run_block(x, blk, spec, cast, attn_logits_dtype, key: str = "blk"):
    """One transformer block (shared by forward and forward_segments). The
    projections that decode their weight in the step do so in one
    ``pq_decode`` launch at the head of the block; the two residual adds
    and the GELU run in the epilogues of out, mlp2 and mlp1. key: the
    block's name ("blk{i}"), which its spans carry."""
    b = x.shape[0]
    nh = spec.heads
    hd = spec.dim // nh
    od = cast.dtype
    proj = block_projections(x, blk, od, key, project=_proj)

    with span("layernorm", key, "ln1"):
        y = layernorm(x, blk["ln1"], LN_EPS)
    qkv = proj(y, "qkv")  # (B, N, 3D)
    with span("attention", key):
        q, k, v = (t.reshape(b, -1, nh, hd) for t in qkv.chunk(3, dim=-1))
        o = _masked_attention(q, k, v, 0, attn_logits_dtype, out_dtype=od)
        o = cast(o.reshape(b, -1, spec.dim))
    x = proj(o, "out", residual=x)
    with span("layernorm", key, "ln2"):
        y = layernorm(x, blk["ln2"], LN_EPS)
    # exact (erf) GELU, the timm/torch semantics
    y = proj(y, "mlp1", act="gelu")
    return proj(y, "mlp2", residual=x)


def _run_head(x, params, with_softmax: bool):
    with span("layernorm", "final"):
        x = layernorm(x, params["ln_final"], LN_EPS)
    with span("fc", "head"):
        logits = _proj(x[:, 0], params["head"], out_dtype=torch.float32)
    if with_softmax:
        with span("softmax", "head"):
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

    segs = [("embed", lambda x, p: _run_embed(x, p, spec, cast))]
    for i in range(spec.depth):
        segs.append((
            f"blk{i}",
            lambda x, p, i=i: _run_block(x, p[f"blk{i}"], spec, cast,
                                         _attn_dtype(x), f"blk{i}"),
        ))
    segs.append(("head", lambda x, p: _run_head(x, p, with_softmax)))
    return segs


# ---------------------------------------------------------------------------
# Quantization / preparation
# ---------------------------------------------------------------------------

def quantize_params(
    spec: ViTSpec,
    dense: dict,
    *,
    seed: int = 0,
    subvec_len: int = 4,
    num_codewords: int = 32,
    device=None,
) -> dict:
    """PQ every projection GEMM (plain k-means, NumPy params out);
    LN/embeddings stay dense (tiny). device: where the k-means runs; None
    means "cuda". One generator seeded with ``seed`` is split once per
    leaf, in the JAX package's order."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)

    def quant(p):
        if isinstance(p, dict) and "weight" in p:
            cin = p["weight"].shape[0]
            return quantize_fc_layer(
                split(gen), np.asarray(p["weight"]).T, p["bias"],
                num_subspaces=-(-cin // subvec_len),
                num_codewords=num_codewords,
            )
        if isinstance(p, dict):
            return {k: quant(v) for k, v in p.items()}
        return p

    return {name: quant(p) for name, p in dense.items()}


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
    return prepare_tree(params, _gemm_cin_map(spec), dtype, memory=memory,
                        device=device, who="vit.prepare_params")


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
