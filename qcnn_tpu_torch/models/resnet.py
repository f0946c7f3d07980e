"""ResNet-v1.5 family with product-quantized convolutions and classifier.

Port of ``qcnn_tpu/models/resnet.py``. The graph is Python composition of
ops, the spec is static data, and parameters are a nested dict: "stem",
"s{stage}b{block}" (a dict of "conv1", "conv2", optional "conv3" and
"proj") and "fc", each a layer dict of tensors. PQ applies per conv
(including 1x1 projections) over the input-channel axis and to the final
FC. Activations are NHWC, as in the JAX package.

In memory mode (``prepare_params(memory=True)``) each PQ conv runs the
route ``ops.conv.memory_fused_route`` picks for it (the ``pq_conv_fused``
kernel for qualifying 3x3 convs, the ``pq_decode`` kernel elsewhere) and
the fc runs ``common.fc_memory_impl``. Every conv and the fc go through
``ops.conv.conv_layer`` and ``ops.fc.fc_layer``, which read a layer's
format; a conv's ReLU, and the shortcut added before the block's last
ReLU, run in its product's epilogue (``ops.fc.emit``). In int8
(``prepare_params(dtype=torch.int8)``) dense and decoded layers run the
int8 conv and fc with the dynamic amax of each input, as the JAX
package's families do; memory mode keeps bf16 codebooks there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qcnn_tpu_torch._device import resolve_device
from qcnn_tpu_torch.core import is_pq
from qcnn_tpu_torch.models import common
from qcnn_tpu_torch.models.common import make_cast as _make_cast
from qcnn_tpu_torch.models.prepare import (
    _cast_pq,
    _decode_rows_np,
    _is_int8,
    _np,
    dense_layer,
)
from qcnn_tpu_torch.ops import conv as conv_ops
from qcnn_tpu_torch.ops import fc as fc_ops
from qcnn_tpu_torch.ops.misc import caffe_max_pool
from qcnn_tpu_torch.quantizer.kmeans import split
from qcnn_tpu_torch.quantizer.opq import inverse_permutation
from qcnn_tpu_torch.quantizer.pq import quantize_conv_layer, quantize_fc_layer
from qcnn_tpu_torch.utils.spans import span


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    name: str
    stage_depths: tuple[int, ...]      # blocks per stage, e.g. (3, 4, 6, 3)
    stage_channels: tuple[int, ...]    # block out channels per stage
    num_classes: int = 1000
    in_size: int = 224
    bottleneck: bool = True


def resnet50() -> ResNetSpec:
    return ResNetSpec("ResNet50", (3, 4, 6, 3), (256, 512, 1024, 2048))


def resnet18() -> ResNetSpec:
    return ResNetSpec(
        "ResNet18", (2, 2, 2, 2), (64, 128, 256, 512), bottleneck=False
    )


def resnet101() -> ResNetSpec:
    return ResNetSpec("ResNet101", (3, 4, 23, 3), (256, 512, 1024, 2048))


def resnet152() -> ResNetSpec:
    return ResNetSpec("ResNet152", (3, 8, 36, 3), (256, 512, 1024, 2048))


RESNETS = {"resnet50": resnet50, "resnet18": resnet18,
           "resnet101": resnet101, "resnet152": resnet152}


# ---------------------------------------------------------------------------
# Parameter construction (NumPy: the same seed gives the JAX package's bits)
# ---------------------------------------------------------------------------

def _conv_param(rng, kh, kw, cin, cout):
    fan = kh * kw * cin
    return {
        "kernel": (rng.standard_normal((kh, kw, cin, cout)) /
                   np.sqrt(fan)).astype(np.float32),
        "bias": np.zeros(cout, np.float32),
    }


def _block_channels(spec: ResNetSpec, stage: int) -> tuple[int, int]:
    cout = spec.stage_channels[stage]
    mid = cout // 4 if spec.bottleneck else cout
    return mid, cout


def block_layout(spec: ResNetSpec):
    """(block key, stride, [(conv name, kh, cin, cout)]) for every block,
    in forward order. A projection ("proj", 1x1) exists where the channels
    change: ResNet-v1.5, so stage-0 block-0 of ResNet-18 keeps the identity
    shortcut."""
    out = []
    cin = 64
    for s, depth in enumerate(spec.stage_depths):
        mid, cout = _block_channels(spec, s)
        for b in range(depth):
            stride = 2 if (s > 0 and b == 0) else 1
            if spec.bottleneck:
                convs = [("conv1", 1, cin, mid), ("conv2", 3, mid, mid),
                         ("conv3", 1, mid, cout)]
            else:
                convs = [("conv1", 3, cin, mid), ("conv2", 3, mid, cout)]
            if cin != cout:
                convs.append(("proj", 1, cin, cout))
            out.append((f"s{s}b{b}", stride, convs))
            cin = cout
    return out


def init_dense_params(spec: ResNetSpec, seed: int = 0) -> dict:
    """Random dense parameters (NumPy), the same draws as the JAX package's
    ``init_dense_params``."""
    rng = np.random.default_rng(seed)
    params: dict = {"stem": _conv_param(rng, 7, 7, 3, 64)}
    for key, _, convs in block_layout(spec):
        params[key] = {name: _conv_param(rng, kh, kh, ci, co)
                       for name, kh, ci, co in convs}
    cin = spec.stage_channels[-1]
    params["fc"] = {
        "weight": (rng.standard_normal((cin, spec.num_classes)) /
                   np.sqrt(cin)).astype(np.float32),
        "bias": np.zeros(spec.num_classes, np.float32),
    }
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _block_inputs(x, block, stride: int, bottleneck: bool, od) -> dict:
    """{conv name: (input shape, input dtype, stride, pad)} of one residual
    block, which follow from the block's input x (NHWC): a stride-s conv
    gives ceil(h / s) rows (pad 1 for 3x3, 0 for 1x1), a conv emits
    ``od`` (float32 when None) and its Cout is the next conv's Cin."""
    b, h, w, _ = x.shape
    inner = od if od is not None else torch.float32
    down = (b, -(-h // stride), -(-w // stride))
    first = (tuple(x.shape), x.dtype)

    def after(name, hw):
        return ((*hw, block[name]["bias"].shape[0]), inner)

    if bottleneck:
        convs = {"conv1": (*first, 1, 0),
                 "conv2": (*after("conv1", (b, h, w)), stride, 1),
                 "conv3": (*after("conv2", down), 1, 0)}
    else:
        convs = {"conv1": (*first, stride, 1),
                 "conv2": (*after("conv1", down), 1, 1)}
    if "proj" in block:
        convs["proj"] = (*first, stride, 0)
    return convs


def _block_routes(inputs: dict, block) -> dict:
    """{conv name: (params, impl, Cin)} for the block's PQ convs: the route
    ``ops.conv.memory_fused_route`` picks, decided once per conv from its
    input (:func:`_block_inputs`)."""
    return {name: (block[name],
                   conv_ops.memory_fused_route(block[name], shape, dtype,
                                               stride=st, pad=pad),
                   shape[3])
            for name, (shape, dtype, st, pad) in inputs.items()
            if is_pq(block[name])}


def _run_block(x, block, stride: int, bottleneck: bool, cast, key: str):
    """One residual block (shared by forward and forward_segments); ``key``
    ("s{stage}b{block}") names its spans (``utils.spans``); its convs emit
    ``cast.dtype``. Every conv of the block that decodes its weight in the
    step does so in one ``pq_decode`` launch at the head of the block; the
    weights live until the block returns. The ReLUs and the shortcut run
    in the convs' epilogues."""
    od = getattr(cast, "dtype", None)
    inputs = _block_inputs(x, block, stride, bottleneck, od)
    routes = _block_routes(inputs, block)
    decoded = conv_ops.instep_decodes(routes)

    def conv(v, name, act=None, residual=None):
        shape, dtype, st, pad = inputs[name]
        if tuple(v.shape) != shape or v.dtype != dtype:
            raise RuntimeError(
                f"{name}: input {tuple(v.shape)} {v.dtype}, but its route "
                f"was decided for {shape} {dtype}")
        impl = routes[name][1] if name in routes else "dense"
        with span("conv", key, name):
            return conv_ops.conv_layer(
                v, block[name], impl=impl, stride=st, pad=pad, out_dtype=od,
                decoded=decoded.get(name), act=act, residual=residual)

    shortcut = conv(x, "proj") if "proj" in block else x
    y = conv(x, "conv1", "relu")
    if bottleneck:
        y = conv(y, "conv2", "relu")
    return conv(y, "conv3" if bottleneck else "conv2", "relu", shortcut)


def _run_stem(x, params, cast):
    with span("conv", "stem"):
        x = conv_ops.conv_layer(x, params["stem"], impl="memory_fused",
                                stride=2, pad=3,
                                out_dtype=getattr(cast, "dtype", None),
                                act="relu")
    # floor-mode pool: 112 -> 56, as torchvision
    with span("pool", "stem"):
        return caffe_max_pool(x, kernel=3, stride=2, pad=1, ceil_mode=False)


def _run_head(x, params, cast, with_softmax: bool):
    with span("pool", "head"):
        x = x.float().mean(dim=(1, 2))  # global average pool
    with span("fc", "head"):
        x = cast(x)
        p = params["fc"]
        logits = fc_ops.fc_layer(
            x, p, impl=common.fc_memory_impl(x.shape[0], p, x.dtype),
            out_dtype=torch.float32)
    if with_softmax:
        with span("softmax", "head"):
            logits = torch.softmax(logits, dim=-1)
    return logits


def forward(params: dict, x, *, spec: ResNetSpec, compute_dtype=None,
            with_softmax: bool = False, device=None) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, num_classes) float32 logits (or
    probabilities).

    compute_dtype: activation dtype between layers; None keeps x's dtype.
    device: None means "cuda"; pass "cpu" to run the plain versions. The
      params must already be there (``prepare_params(device=...)``)."""
    with span("forward"):
        device = resolve_device(device)
        x = torch.as_tensor(x, device=device)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        cast = _make_cast(compute_dtype)
        x = _run_stem(x, params, cast)
        for key, stride, _ in block_layout(spec):
            x = _run_block(x, params[key], stride, spec.bottleneck, cast,
                           key)
        return _run_head(x, params, cast, with_softmax)


def forward_segments(spec: ResNetSpec, *, compute_dtype=None,
                     with_softmax: bool = False):
    """[(name, fn(x, params) -> x)] whose composition equals forward on
    tensors already on the params' device: "stem+pool", one per stage,
    "head"."""
    cast = _make_cast(compute_dtype)
    layout = block_layout(spec)
    segs = [(
        "stem+pool",
        lambda x, p: _run_stem(
            x.to(compute_dtype) if compute_dtype is not None else x, p, cast),
    )]
    for s in range(len(spec.stage_depths)):
        blocks = [(key, stride) for key, stride, _ in layout
                  if key.startswith(f"s{s}b")]

        def stage(x, p, blocks=blocks):
            for key, stride in blocks:
                x = _run_block(x, p[key], stride, spec.bottleneck, cast,
                               key)
            return x

        segs.append((f"stage{s}", stage))
    segs.append(("head", lambda x, p: _run_head(x, p, cast, with_softmax)))
    return segs


# ---------------------------------------------------------------------------
# Quantization / preparation
# ---------------------------------------------------------------------------

def quantize_params(
    spec: ResNetSpec,
    dense: dict,
    *,
    seed: int = 0,
    conv_subvec_len: int = 4,
    conv_codewords: int = 128,
    fc_subvec_len: int = 4,
    fc_codewords: int = 32,
    min_cin: int = 16,
    device=None,
) -> dict:
    """Quantize every conv/fc (plain k-means, NumPy params out). Convs
    with cin < min_cin (the stem) stay dense — PQ on 3 input channels
    saves nothing (cf. AlexNet conv1's degenerate single-subspace
    codebook, SURVEY.md §2a).

    device: where the k-means runs; None means "cuda". One generator
    seeded with ``seed`` is split once per leaf, in the JAX package's
    order."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)

    def quant_leaf(p: dict) -> dict:
        if "kernel" in p:
            kh, kw, cin, cout = p["kernel"].shape
            if cin < min_cin:
                return p
            oihw = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
            return quantize_conv_layer(
                split(gen), oihw, p["bias"],
                num_subspaces=-(-cin // conv_subvec_len),
                num_codewords=conv_codewords,
            )
        if "weight" in p:
            return quantize_fc_layer(
                split(gen), np.asarray(p["weight"]).T, p["bias"],
                num_subspaces=-(-p["weight"].shape[0] // fc_subvec_len),
                num_codewords=fc_codewords,
            )
        return {k: quant_leaf(v) for k, v in p.items()}

    return {name: quant_leaf(p) for name, p in dense.items()}


def _conv_cin_map(spec: ResNetSpec) -> dict:
    """True input-channel count per conv (the codebook span may overhang),
    keyed "stem", "s{s}b{b}.{conv}" and "fc"."""
    shapes: dict = {"stem": 3}
    for key, _, convs in block_layout(spec):
        for name, _, ci, _ in convs:
            shapes[f"{key}.{name}"] = ci
    shapes["fc"] = spec.stage_channels[-1]
    return shapes


def prepare_params(spec: ResNetSpec, params: dict, dtype=torch.bfloat16, *,
                   memory: bool = False, device=None) -> dict:
    """The nested params on the device, ready for :func:`forward`.

    Decode at load (memory=False): PQ tensors are decoded to dense on the
    host in NumPy (an OPQ permutation folded in by its inverse), then cast
    to ``dtype``; a conv kernel is HWIO logically and OHWI in memory, an fc
    weight (Cin, Cout) logically and (Cout, Cin) in memory.
    memory=True keeps PQ layers compressed: codebooks cast to ``dtype``,
    assignments uint8 unchanged, bias float32, and the OPQ ``perm`` kept for
    the ops to apply; the forward then decodes in the step.

    dtype: torch.float32, torch.bfloat16 or torch.int8. int8 quantizes
      dense and decoded weights per output channel
      (``models.prepare.dense_layer``, qcnn_tpu/models/resnet.py:304-326);
      memory mode keeps bf16 codebooks under it.
    device: None means "cuda"; pass "cpu" to prepare for the CPU."""
    device = resolve_device(device)
    if not (_is_int8(dtype) or dtype in (torch.float32, torch.bfloat16)):
        raise ValueError(f"resnet.prepare_params: unsupported dtype {dtype}")
    cb_dtype = torch.bfloat16 if _is_int8(dtype) else dtype

    def prep(p: dict, cin, is_fc: bool) -> dict:
        if "codebooks" in p:
            if memory:
                return _cast_pq(p, cb_dtype, device)
            cb = _np(p["codebooks"]).astype(np.float32)
            asmt = _np(p["assignments"])
            s, _, d = cb.shape
            cin = cin or s * d
            if is_fc:
                w = _decode_rows_np(cb, asmt, cin)  # (Cout, Cin)
                if "perm" in p:
                    w = w[:, inverse_permutation(_np(p["perm"]))]
                return dense_layer("weight", w, p["bias"], dtype, device)
            cout, kh, kw, _ = asmt.shape
            w = _decode_rows_np(cb, asmt.reshape(-1, s), cin).reshape(
                cout, kh, kw, cin)
            if "perm" in p:
                w = w[..., inverse_permutation(_np(p["perm"]))]
            return dense_layer("kernel", w, p["bias"], dtype, device)
        if any(key in p for key in ("kernel_q", "weight_q")):
            raise ValueError(
                "resnet.prepare_params: these params are prepared int8 "
                "already (models.interop.family_params_from_jax carries "
                "JAX-prepared ones)")
        if "kernel" in p:
            return dense_layer("kernel",
                               _np(p["kernel"]).transpose(3, 0, 1, 2),
                               p["bias"], dtype, device)
        return dense_layer("weight", _np(p["weight"]).T, p["bias"], dtype,
                           device)

    cins = _conv_cin_map(spec)
    prepared: dict = {}
    for name, p in params.items():
        if name == "fc":
            prepared[name] = prep(p, cins["fc"], is_fc=True)
        elif "codebooks" in p or "kernel" in p:
            # the stem, or any other bare top-level conv
            prepared[name] = prep(p, cins.get(name), is_fc=False)
        else:  # a block
            prepared[name] = {k: prep(v, cins.get(f"{name}.{k}"),
                                      is_fc=False)
                              for k, v in p.items()}
    return prepared


def fold_batchnorm(conv: dict, gamma, beta, mean, var, eps=1e-5) -> dict:
    """Fold an inference BatchNorm into the preceding dense conv (NumPy):
    W' = W * gamma/sqrt(var+eps); b' = (b - mean) * scale + beta."""
    scale = np.asarray(gamma) / np.sqrt(np.asarray(var) + eps)
    return {
        "kernel": np.asarray(conv["kernel"]) * scale,  # broadcast over Cout
        "bias": (np.asarray(conv["bias"]) - np.asarray(mean)) * scale
        + np.asarray(beta),
    }
