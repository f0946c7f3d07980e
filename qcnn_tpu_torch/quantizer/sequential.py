"""Sequential (whole-network) error-corrected PQ — the CVPR'16 algorithm.

Port of ``qcnn_tpu/quantizer/sequential.py``. The paper's scheme quantizes
LAYER BY LAYER against real activation statistics with error feedback:
layer i's calibration inputs are computed by running the calibration batch
through the ALREADY-QUANTIZED prefix, so each layer's codebooks compensate
the accumulated quantization error of everything before it.

  for each learnable layer i (in topology order):
      a_i   = forward(quantized_params, x_calib, upto=i)   # quantized prefix
      xcal  = sub-vector samples of a_i in the layer's weight data model
      q_i   = quantize_{fc,conv}_layer(..., xcal=xcal)     # error-corrected
      params[i] = q_i                                      # feeds layer i+1

xcal construction mirrors the weight sub-vector model (SURVEY.md §2a): FC
layers use the (NCHW-flattened at the first FC, CaffeEva.cc:184-204) input
rows directly; conv layers sample input-channel-group vectors over batch x
spatial positions.

Everything runs on the device of the generator the caller passes: the
calibration forwards in float32 through the port's own forward functions,
and the fits. The samples are drawn on the host with NumPy's
``default_rng(seed)``, so the same activations give the JAX package's
samples bit for bit. The returned params are NumPy, as the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from qcnn_tpu_torch.core import ConvSpec, FCSpec, ModelSpec, is_pq
from qcnn_tpu_torch.models import network
from qcnn_tpu_torch.models import resnet as R
from qcnn_tpu_torch.models import vit as V
from qcnn_tpu_torch.models.network import _to_device
from qcnn_tpu_torch.models.transformer import layernorm
from qcnn_tpu_torch.ops.conv import conv_layer
from qcnn_tpu_torch.quantizer.kmeans import split
from qcnn_tpu_torch.quantizer.pq import quantize_conv_layer, quantize_fc_layer


def _conv_xcal(a: np.ndarray, groups: int, max_samples: int,
               rng: np.random.Generator) -> np.ndarray:
    """(B, H, W, C) activation map -> (N, C/groups) channel-group vectors
    sampled over batch x space (x groups)."""
    b, h, w, c = a.shape
    cg = c // groups
    v = a.reshape(b * h * w, groups, cg)
    v = np.transpose(v, (1, 0, 2)).reshape(-1, cg)
    if v.shape[0] > max_samples:
        idx = rng.choice(v.shape[0], max_samples, replace=False)
        v = v[idx]
    return np.ascontiguousarray(v)


def _fc_xcal(a: np.ndarray, max_samples: int,
             rng: np.random.Generator) -> np.ndarray:
    """(..., Cin) activations -> (N, Cin) row samples."""
    v = a.reshape(-1, a.shape[-1])
    if v.shape[0] > max_samples:
        v = v[rng.choice(v.shape[0], max_samples, replace=False)]
    return np.ascontiguousarray(v)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def quantize_resnet_ec(
    gen: torch.Generator,
    spec,
    dense: dict,
    x_calib: np.ndarray,
    *,
    conv_subvec_len: int = 4,
    conv_codewords: int = 128,
    fc_subvec_len: int = 4,
    fc_codewords: int = 32,
    min_cin: int = 16,
    max_samples: int = 16384,
    seed: int = 0,
) -> dict:
    """Sequential error-corrected PQ for the ResNet family: single pass —
    each conv/fc quantizes against the activation entering it (already
    carrying the quantization error of everything upstream), then the
    quantized leaf produces the next activation. Mirrors
    resnet.quantize_params' geometry/min_cin policy and resnet.forward's
    walk (_run_stem/_run_block composition)."""
    dev = gen.device
    rng = np.random.default_rng(seed)
    out: dict = {}
    run: dict = {}  # out's leaves as tensors on dev, for the forward

    def quant_conv(p: dict, a: torch.Tensor) -> dict:
        kh, kw, cin, cout = p["kernel"].shape
        if cin < min_cin:
            return dict(p)
        oihw = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
        return quantize_conv_layer(
            split(gen), oihw, p["bias"],
            num_subspaces=-(-cin // conv_subvec_len),
            num_codewords=conv_codewords,
            xcal=_conv_xcal(_host(a), 1, max_samples, rng),
        )

    a = torch.as_tensor(np.asarray(x_calib, np.float32), device=dev)
    cast = R._make_cast(None)
    out["stem"] = quant_conv(dense["stem"], a)
    run["stem"] = _to_device(out["stem"], dev)
    a = R._run_stem(a, run, cast)
    for key, stride, _ in R.block_layout(spec):
        src = dense[key]
        qblk: dict = {}
        rblk: dict = {}

        def quant(name, v):
            qblk[name] = quant_conv(src[name], v)
            rblk[name] = _to_device(qblk[name], dev)
            return rblk[name]

        def conv(v, name, **kw):
            return conv_layer(v, quant(name, v), impl="memory_fused", **kw)

        if "proj" in src:
            quant("proj", a)
        if spec.bottleneck:
            y = conv(a, "conv1", stride=1, pad=0, act="relu")
            y = conv(y, "conv2", stride=stride, pad=1, act="relu")
            quant("conv3", y)
        else:
            y = conv(a, "conv1", stride=stride, pad=1, act="relu")
            quant("conv2", y)
        out[key] = qblk
        a = R._run_block(a, rblk, stride, spec.bottleneck, cast, key)
    pooled = _host(a.float().mean(dim=(1, 2)))
    out["fc"] = quantize_fc_layer(
        split(gen), np.asarray(dense["fc"]["weight"]).T,
        dense["fc"]["bias"],
        num_subspaces=-(-dense["fc"]["weight"].shape[0] // fc_subvec_len),
        num_codewords=fc_codewords,
        xcal=_fc_xcal(pooled, max_samples, rng),
    )
    return out


def quantize_vit_ec(
    gen: torch.Generator,
    spec,
    dense: dict,
    x_calib: np.ndarray,
    *,
    subvec_len: int = 4,
    num_codewords: int = 32,
    max_samples: int = 16384,
    seed: int = 0,
) -> dict:
    """Sequential error-corrected PQ for the ViT family: every projection
    GEMM quantizes against its own input under the already-quantized
    prefix. Mirrors vit.quantize_params' policy and vit.forward's walk
    (_run_embed/_run_block/_run_head composition)."""
    dev = gen.device
    rng = np.random.default_rng(seed)

    def quant_gemm(p: dict, a: torch.Tensor) -> dict:
        return quantize_fc_layer(
            split(gen), np.asarray(p["weight"]).T, p["bias"],
            num_subspaces=-(-p["weight"].shape[0] // subvec_len),
            num_codewords=num_codewords,
            xcal=_fc_xcal(_host(a), max_samples, rng),
        )

    cast = V._make_cast(None)
    out: dict = {
        "cls_token": dense["cls_token"],
        "pos_embed": dense["pos_embed"],
        "ln_final": dense["ln_final"],
    }
    run = {name: torch.as_tensor(np.asarray(out[name]), device=dev)
           for name in ("cls_token", "pos_embed")}
    run["ln_final"] = _to_device(out["ln_final"], dev)
    x = torch.as_tensor(np.asarray(x_calib, np.float32), device=dev)
    b, h, w, c = x.shape
    p_sz = spec.patch
    patches = x.reshape(b, h // p_sz, p_sz, w // p_sz, p_sz, c)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(
        b, spec.num_patches, -1)
    out["patch_embed"] = quant_gemm(dense["patch_embed"], patches)
    run["patch_embed"] = _to_device(out["patch_embed"], dev)
    a = V._run_embed(x, run, spec, cast)
    nh, hd = spec.heads, spec.dim // spec.heads
    for i in range(spec.depth):
        src = dense[f"blk{i}"]
        qblk = {"ln1": src["ln1"], "ln2": src["ln2"]}
        rblk = {name: _to_device(qblk[name], dev) for name in qblk}

        def quant(name, v):
            qblk[name] = quant_gemm(src[name], v)
            rblk[name] = _to_device(qblk[name], dev)
            return rblk[name]

        y = layernorm(a, rblk["ln1"], V.LN_EPS)
        qkv = V._proj(y, quant("qkv", y))
        q, k, v = (t.reshape(b, -1, nh, hd) for t in qkv.chunk(3, dim=-1))
        o = V._masked_attention(q, k, v, 0).reshape(b, -1, spec.dim)
        x2 = a + V._proj(o, quant("out", o))
        y2 = layernorm(x2, rblk["ln2"], V.LN_EPS)
        g = F.gelu(V._proj(y2, quant("mlp1", y2)))
        quant("mlp2", g)
        out[f"blk{i}"] = qblk
        a = V._run_block(a, rblk, spec, cast, torch.float32)
    head_in = layernorm(a, run["ln_final"], V.LN_EPS)[:, 0]
    out["head"] = quant_gemm(dense["head"], head_in)
    return out


def quantize_network(
    gen: torch.Generator,
    spec: ModelSpec,
    params: Sequence[Optional[dict]],
    *,
    conv_subvec_len: int = 8,
    conv_codewords: int = 128,
    fc_subvec_len: int = 4,
    fc_codewords: int = 32,
    overrides: Optional[dict] = None,
    x_calib: Optional[np.ndarray] = None,
    max_conv_samples: int = 16384,
    seed: int = 0,
    opq: Optional[str] = None,
    log=lambda *_: None,
) -> list:
    """Quantize every dense layer of a linear-spec network.

    Without x_calib: plain per-layer k-means (weights only). With x_calib
    ((B, H, W, C) preprocessed inputs): sequential error-corrected PQ as
    described in the module docstring. opq="variance" adds the OPQ input
    permutation per layer (quantizer/opq.py). Already-PQ / parameter-free
    layers pass through.

    Calibration cost is O(L^2) forwards by design: layer i's inputs must
    come from the ALREADY-QUANTIZED prefix, and the prefix is re-run after
    each layer's params change."""
    overrides = overrides or {}
    out = list(params)
    rng = np.random.default_rng(seed)
    x_dev = (None if x_calib is None else
             torch.as_tensor(np.asarray(x_calib, np.float32),
                             device=gen.device))
    for i, (layer, p) in enumerate(zip(spec.layers, out)):
        if p is None or is_pq(p):
            continue
        ov = overrides.get(i, {})
        sub = split(gen)
        xcal = None
        if x_dev is not None:
            a = _host(network.forward(out, x_dev, spec=spec, upto=i,
                                      with_softmax=False, device=gen.device))
            if isinstance(layer, FCSpec):
                if a.ndim == 4:
                    # first FC: Caffe/torch NCHW flatten (network.py rule)
                    a = np.transpose(a, (0, 3, 1, 2)).reshape(a.shape[0], -1)
                else:
                    a = a.reshape(a.shape[0], -1)
                xcal = a
            else:
                xcal = _conv_xcal(a, layer.groups, max_conv_samples, rng)
        if isinstance(layer, ConvSpec) and "kernel" in p:
            kernel = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
            cg = kernel.shape[1]
            d = ov.get("subvec_len", conv_subvec_len)
            out[i] = quantize_conv_layer(
                sub, kernel, p["bias"],
                num_subspaces=-(-cg // d),
                num_codewords=ov.get("codewords", conv_codewords),
                xcal=xcal, opq=opq,
            )
            log(f"layer {i} (ConvSpec): quantized"
                + (" [error-corrected]" if xcal is not None else ""))
        elif isinstance(layer, FCSpec) and "weight" in p:
            weight = np.asarray(p["weight"]).T  # (Cin, Cout) -> (Cout, Cin)
            d = ov.get("subvec_len", fc_subvec_len)
            out[i] = quantize_fc_layer(
                sub, weight, p["bias"],
                num_subspaces=-(-weight.shape[1] // d),
                num_codewords=ov.get("codewords", fc_codewords),
                xcal=xcal, opq=opq,
            )
            log(f"layer {i} (FCSpec): quantized"
                + (" [error-corrected]" if xcal is not None else ""))
    return out
