"""torch-ecosystem checkpoint ingestion (model families + linear zoo).

Port of ``qcnn_tpu/models/torch_import.py``. It maps the torchvision ResNet
state_dict (``conv1``/``bn1``, ``layer{1..4}.{b}.conv{i}``/``bn{i}``/
``downsample``, ``fc``), the timm ViT state_dict (``patch_embed.proj``,
``blocks.{i}.attn.qkv``, ...) and the torchvision sequential-CNN state_dict
(``features.N`` / ``classifier.N``, the vgg naming) onto the dense NumPy
params of the JAX importer, in the logical layouts: HWIO conv kernels and
(Cin, Cout) fc weights. Each family's ``prepare_params`` takes them as it
takes any dense params. For ResNet:

- conv weights transpose OIHW -> HWIO;
- every BatchNorm folds into its preceding conv (``resnet.fold_batchnorm``,
  valid at inference);
- the fc weight transposes (out, in) -> (in, out).

A state_dict's values may be tensors or arrays; they are read as float32.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from qcnn_tpu_torch.core import (
    ConvSpec,
    FCSpec,
    dense_conv_params,
    dense_fc_params,
)
from qcnn_tpu_torch.models.resnet import ResNetSpec, fold_batchnorm


def _np(t) -> np.ndarray:
    """A tensor (any device) or array-like as a float32 NumPy array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def resnet_from_torch_state_dict(spec: ResNetSpec,
                                 state_dict: Mapping) -> dict:
    """Map a torchvision-naming ResNet state_dict to the dense params
    ``resnet.prepare_params`` takes."""
    sd = state_dict

    def conv_bn(conv_key: str, bn_key: str) -> dict:
        w = _np(sd[f"{conv_key}.weight"])  # (Cout, Cin, kh, kw)
        conv = {
            "kernel": np.transpose(w, (2, 3, 1, 0)).copy(),  # HWIO
            "bias": _np(sd.get(f"{conv_key}.bias",
                               np.zeros(w.shape[0], np.float32))),
        }
        return fold_batchnorm(
            conv,
            _np(sd[f"{bn_key}.weight"]),
            _np(sd[f"{bn_key}.bias"]),
            _np(sd[f"{bn_key}.running_mean"]),
            _np(sd[f"{bn_key}.running_var"]),
        )

    params: dict = {"stem": conv_bn("conv1", "bn1")}
    n_convs = 3 if spec.bottleneck else 2
    for s, depth in enumerate(spec.stage_depths):
        for b in range(depth):
            prefix = f"layer{s + 1}.{b}"
            block = {
                f"conv{i}": conv_bn(f"{prefix}.conv{i}", f"{prefix}.bn{i}")
                for i in range(1, n_convs + 1)
            }
            if f"{prefix}.downsample.0.weight" in sd:
                block["proj"] = conv_bn(
                    f"{prefix}.downsample.0", f"{prefix}.downsample.1"
                )
            params[f"s{s}b{b}"] = block
    params["fc"] = {
        "weight": _np(sd["fc.weight"]).T.copy(),  # (in, out)
        "bias": _np(sd["fc.bias"]),
    }
    return params


def vit_from_torch_state_dict(spec, state_dict: Mapping) -> dict:
    """Map a timm-naming ViT state_dict (the vit_base_patch16_224 family:
    patch_embed.proj, cls_token, pos_embed, blocks.{i}.norm1/attn.qkv/
    attn.proj/norm2/mlp.fc1/mlp.fc2, norm, head) onto ``models.vit``'s
    dense params.

    The patch-embedding conv (D, 3, p, p) becomes a GEMM over the
    (row, col, channel)-flattened patch vectors that ``vit.forward``
    builds: permute to (p, p, 3, D), then reshape to (p*p*3, D)."""
    sd = state_dict
    p = spec.patch

    def gemm(prefix: str) -> dict:
        return {
            "weight": _np(sd[f"{prefix}.weight"]).T.copy(),  # (in, out)
            "bias": _np(sd[f"{prefix}.bias"]),
        }

    def ln(prefix: str) -> dict:
        return {
            "scale": _np(sd[f"{prefix}.weight"]),
            "shift": _np(sd[f"{prefix}.bias"]),
        }

    w_patch = _np(sd["patch_embed.proj.weight"])  # (D, 3, p, p)
    params: dict = {
        "patch_embed": {
            "weight": np.transpose(w_patch, (2, 3, 1, 0))
            .reshape(p * p * 3, spec.dim).copy(),
            "bias": _np(sd["patch_embed.proj.bias"]),
        },
        "cls_token": _np(sd["cls_token"]).reshape(1, 1, spec.dim),
        "pos_embed": _np(sd["pos_embed"]).reshape(1, spec.seq_len, spec.dim),
        "ln_final": ln("norm"),
        "head": gemm("head"),
    }
    for i in range(spec.depth):
        b = f"blocks.{i}"
        params[f"blk{i}"] = {
            "ln1": ln(f"{b}.norm1"),
            "qkv": gemm(f"{b}.attn.qkv"),
            "out": gemm(f"{b}.attn.proj"),
            "ln2": ln(f"{b}.norm2"),
            "mlp1": gemm(f"{b}.mlp.fc1"),
            "mlp2": gemm(f"{b}.mlp.fc2"),
        }
    return params


def linear_from_torch_state_dict(spec, state_dict: Mapping) -> list:
    """Map a torchvision-style sequential CNN state_dict (the conv stack
    under ``features.N``, the FC head under ``classifier.N``: the vgg11..19
    naming) onto a linear zoo ModelSpec, returning the spec-aligned dense
    params list.

    torch's NCHW flatten before the first FC is the Caffe flatten that
    ``models.network`` implements, so ``classifier.0`` maps with a plain
    transpose. The mapping follows the order of the learnable layers, so
    any sequential features/classifier model whose topology matches the
    spec imports too."""

    def indexed(prefix: str) -> list:
        idxs = sorted({
            int(k.split(".")[1]) for k in state_dict
            if k.startswith(prefix + ".") and k.endswith(".weight")
        })
        return [(f"{prefix}.{i}.weight", f"{prefix}.{i}.bias")
                for i in idxs]

    pairs = indexed("features") + indexed("classifier")
    spec_learnable = [
        (i, layer) for i, layer in enumerate(spec.layers)
        if isinstance(layer, (ConvSpec, FCSpec))
    ]
    if len(pairs) != len(spec_learnable):
        raise ValueError(
            f"{len(pairs)} learnable torch layers vs "
            f"{len(spec_learnable)} in spec {spec.name}"
        )
    params: list = [None] * len(spec.layers)
    for (idx, lspec), (wk, bk) in zip(spec_learnable, pairs):
        w = _np(state_dict[wk])
        bias = (_np(state_dict[bk]) if bk in state_dict
                else np.zeros(w.shape[0], np.float32))
        if isinstance(lspec, ConvSpec):
            if w.ndim != 4 or w.shape[0] != lspec.out_channels \
                    or w.shape[2] != lspec.kernel:
                raise ValueError(
                    f"{wk}: blob {w.shape} does not match spec "
                    f"(out={lspec.out_channels}, k={lspec.kernel})"
                )
            params[idx] = dense_conv_params(
                np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))), bias
            )
        else:
            if w.shape[0] != lspec.out_features:
                raise ValueError(
                    f"{wk}: FC blob {w.shape} does not match "
                    f"out_features={lspec.out_features}"
                )
            params[idx] = dense_fc_params(np.ascontiguousarray(w.T), bias)
    return params


def _load_state_dict(path: str):
    """Load a .pt/.pth file: a bare state_dict, or a dict carrying one
    under 'state_dict' or 'model'. Tensors only (``weights_only=True``),
    mapped to the CPU."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and not any(
        k.endswith(".weight") for k in obj
    ):
        for key in ("state_dict", "model"):
            if key in obj:
                obj = obj[key]
                break
    return obj


def load_torch_resnet(spec: ResNetSpec, path: str) -> dict:
    return resnet_from_torch_state_dict(spec, _load_state_dict(path))


def load_torch_vit(spec, path: str) -> dict:
    return vit_from_torch_state_dict(spec, _load_state_dict(path))


def load_torch_linear(spec, path: str) -> list:
    return linear_from_torch_state_dict(spec, _load_state_dict(path))
