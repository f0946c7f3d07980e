"""Builder of the ResNet-v1.5 PQ configurations in memory mode, through the
port's family path (``models.common.build_family_forward("resnet", ...,
memory=True)``).

The weights are made here, on the device, from the seed: a frozen copy of
the port's ``models/synth.random_resnet_pq_params`` (the geometry of
``resnet.quantize_params``' defaults, codewords scaled 1/sqrt(kernel^2 x
cin) so that the activations keep their scale through the blocks), drawn
with a ``torch.Generator`` on the card in two large calls, in the types
they are served in (bf16 codebooks and stem, uint8 ids, float32 biases).
"""

from __future__ import annotations

import math

import torch

from bench_cuda.reference import resnet50 as ref
from bench_cuda.reference.pq import e4m3

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def input_shape(cfg: dict) -> tuple:
    return tuple(cfg["input"])


def dtype(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["dtype"]]


def _leaves(cfg: dict) -> list:
    """(path, kind, kernel, cin, cout, S, K, D, scale) of every weighted
    layer, in forward order."""
    pq = cfg["pq"]
    out = []
    for path, kind, k, _, ci, co, _ in ref.layers(cfg):
        if kind == "conv":
            out.append((path, kind, k, ci, co, 0, 0, 0,
                        1 / math.sqrt(k * k * ci)))
        elif kind == "pq_conv":
            d, kk = pq["conv"]["D"], pq["conv"]["K"]
            out.append((path, kind, k, ci, co, -(-ci // d), kk, d,
                        1 / math.sqrt(k * k * ci)))
        else:
            d, kk = pq["fc"]["D"], pq["fc"]["K"]
            out.append((path, kind, 1, ci, co, -(-ci // d), kk, d,
                        1 / math.sqrt(ci)))
    return out


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """{"stem", "s{stage}b{block}": {conv name: layer}, "fc"}, the nesting
    of the port's family params."""
    leaves = _leaves(cfg)

    def n_float(leaf):
        _, kind, k, ci, co, s, kk, d, _ = leaf
        return k * k * ci * co if kind == "conv" else s * kk * d + co

    def n_ids(leaf):
        _, kind, k, _, co, s, _, _, _ = leaf
        if kind == "conv":
            return 0
        return co * s if kind == "fc" else co * k * k * s

    normal = torch.randn(sum(map(n_float, leaves)), generator=gen,
                         device=device)
    ints = torch.randint(0, 256, (sum(map(n_ids, leaves)),), generator=gen,
                         device=device, dtype=torch.int32)
    bias_scale = cfg["pq"]["bias_scale"]
    params: dict = {}
    fo = io = 0
    for leaf in leaves:
        path, kind, k, ci, co, s, kk, d, scale = leaf
        nf, ni = n_float(leaf), n_ids(leaf)
        chunk = normal[fo:fo + nf]
        fo += nf
        if kind == "conv":
            layer = {"kernel": (chunk.view(k, k, ci, co) * scale).to(
                         dtype(cfg)).contiguous(),
                     "bias": torch.zeros(co, device=device)}
        else:
            if 256 % kk:
                raise ValueError(f"K={kk} does not divide 256")
            shape = (co, s) if kind == "fc" else (co, k, k, s)
            layer = {"codebooks": (chunk[:s * kk * d].view(s, kk, d)
                                   * scale).to(dtype(cfg)).contiguous(),
                     "assignments": (ints[io:io + ni] % kk).to(
                         torch.uint8).view(shape).contiguous(),
                     "bias": (chunk[s * kk * d:] * bias_scale).contiguous()}
            io += ni
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = layer
    return params


def spec(cfg: dict):
    from qcnn_tpu_torch.models.resnet import ResNetSpec

    return ResNetSpec(cfg["model"], tuple(cfg["stage_depths"]),
                      tuple(cfg["stage_channels"]),
                      num_classes=cfg["num_classes"],
                      in_size=cfg["input"][0], bottleneck=True)


def _family(cfg: dict, weights: dict, device):
    """``build_family_forward("resnet", ..., memory=True)``: (prepared
    params, forward, activation dtype)."""
    from qcnn_tpu_torch.models.common import build_family_forward

    return build_family_forward("resnet", spec(cfg), weights, memory=True,
                                compute_dtype=dtype(cfg), device=device)


def offline_forward(cfg: dict, weights: dict, batch: int, device):
    """The forward that ``FamilyClassifier`` calls in memory mode. Returns
    fn(x)."""
    prepared, fwd, _ = _family(cfg, weights, device)
    return lambda x: fwd(prepared, x)


def int8_forward(cfg: dict, weights: dict, batch: int, device):
    """A control of the comparison: the program's own int8 path, as
    ``--dtype int8`` without ``--memory-mode`` runs it
    (``build_family_forward(compute_dtype=torch.int8)``: every layer decoded
    at load and quantized per output channel, bf16 activations quantized
    per tensor at each product). Returns fn(x), in ``offline_forward``'s
    place."""
    from qcnn_tpu_torch.models.common import build_family_forward

    prepared, fwd, _ = build_family_forward(
        "resnet", spec(cfg), weights, memory=False,
        compute_dtype=torch.int8, device=device)
    return lambda x: fwd(prepared, x)


def fp8_forward(cfg: dict, weights: dict, batch: int, device):
    """A control of the comparison: the reference with every product's
    operands in fp8 (e4m3, one scale a tensor), its softmax in bf16 as the
    program hands it over. Returns fn(x), in ``offline_forward``'s
    place."""
    return lambda x: torch.softmax(
        ref.logits(cfg, weights, x, operand=e4m3), 1).to(torch.bfloat16)


def reference_logits(cfg: dict, weights: dict, x: torch.Tensor):
    return ref.logits(cfg, weights, x)


def flops_per_image(cfg: dict) -> float:
    return ref.flops_per_image(cfg)


def kernel_work(cfg: dict, batch: int) -> dict:
    """{port kernel: [(operations, bytes) of each launch of one forward]}:
    for ``pq_conv_fused``, the stride-1 3x3 PQ convs with at least 256
    input channels (the geometries that ``ops.conv.memory_fused_route``
    gives the fused kernel), counted from the shapes as ``chip_smoke.py``
    counts them: bf16 input, uint8 ids, bf16 codebooks, float32 bias and
    output, each once."""
    work = []
    for _, kind, k, st, ci, co, h in ref.layers(cfg):
        if kind != "pq_conv" or k != 3 or st != 1 or ci < 256:
            continue
        d, kk = cfg["pq"]["conv"]["D"], cfg["pq"]["conv"]["K"]
        s = -(-ci // d)
        nbytes = (batch * h * h * ci * 2 + co * k * k * s + s * kk * d * 2
                  + co * 4 + batch * h * h * co * 4)
        work.append((2.0 * batch * h * h * k * k * ci * co, float(nbytes)))
    return {"pq_conv_fused": work}
