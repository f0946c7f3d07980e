"""Builder of the AlexNet-class PQ configurations in memory mode.

The weights are made here, on the device, from the seed: a frozen copy of
the port's ``models/synth.random_pq_params`` (the same geometry and
scales), drawn with a ``torch.Generator`` on the card in two large calls,
in the types they are served in (bf16 codebooks, uint8 ids, float32
biases). The program gets them through its own entry points; the plain
reference (``reference/alexnet.py``) gets the same tensors.
"""

from __future__ import annotations

import torch

from bench_cuda.reference import alexnet as ref
from bench_cuda.reference.pq import e4m3

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def input_shape(cfg: dict) -> tuple:
    return tuple(cfg["input"])


def dtype(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["dtype"]]


def make_weights(cfg: dict, gen: torch.Generator, device) -> list:
    """[{"codebooks", "assignments", "bias"} or None] per layer."""
    geo = ref.geometry(cfg)
    weighted = [e for e in geo if e["type"] in ("conv", "fc")]
    n_float = sum(e["S"] * e["K"] * e["D"] + e["cout"] for e in weighted)
    n_ids = sum(torch.Size(e["ids"]).numel() for e in weighted)
    normal = torch.randn(n_float, generator=gen, device=device)
    # K divides 256 in every geometry here, so ints mod K is uniform
    ints = torch.randint(0, 256, (n_ids,), generator=gen, device=device,
                         dtype=torch.int32)
    bias_scale = cfg["pq"]["bias_scale"]
    out, fo, io = [], 0, 0
    for e in geo:
        if e["type"] not in ("conv", "fc"):
            out.append(None)
            continue
        if 256 % e["K"]:
            raise ValueError(f"K={e['K']} does not divide 256")
        n_cb = e["S"] * e["K"] * e["D"]
        cb = normal[fo:fo + n_cb].view(e["S"], e["K"], e["D"]) * e["scale"]
        bias = normal[fo + n_cb:fo + n_cb + e["cout"]] * bias_scale
        fo += n_cb + e["cout"]
        n_id = torch.Size(e["ids"]).numel()
        ids = (ints[io:io + n_id] % e["K"]).to(torch.uint8).view(e["ids"])
        io += n_id
        out.append({"codebooks": cb.to(dtype(cfg)).contiguous(),
                    "assignments": ids.contiguous(),
                    "bias": bias.contiguous()})
    return out


def spec(cfg: dict):
    """The port's ModelSpec of the configuration."""
    from qcnn_tpu_torch.core import (
        ConvSpec, DropoutSpec, FCSpec, LRNSpec, ModelSpec, PoolSpec,
        ReLUSpec, SoftmaxSpec,
    )

    layers = []
    for layer in cfg["layers"]:
        t = layer["type"]
        if t == "conv":
            layers.append(ConvSpec(kernel=layer["kernel"],
                                   out_channels=layer["out"],
                                   pad=layer.get("pad", 0),
                                   groups=layer.get("groups", 1),
                                   stride=layer.get("stride", 1)))
        elif t == "relu":
            layers.append(ReLUSpec())
        elif t == "lrn":
            layers.append(LRNSpec(layer["size"], layer["alpha"],
                                  layer["beta"], layer["k"]))
        elif t == "pool":
            layers.append(PoolSpec(kernel=layer["kernel"],
                                   stride=layer["stride"],
                                   pad=layer.get("pad", 0)))
        elif t == "fc":
            layers.append(FCSpec(layer["out"]))
        elif t == "dropout":
            layers.append(DropoutSpec(layer["rate"]))
        elif t == "softmax":
            layers.append(SoftmaxSpec())
        else:
            raise ValueError(f"unknown layer type {t!r}")
    h, w, c = cfg["input"]
    return ModelSpec(name=cfg["model"], in_height=h, in_width=w,
                     in_channels=c, layers=tuple(layers))


def offline_forward(cfg: dict, weights: list, batch: int, device):
    """The forward that ``Classifier`` calls in memory mode:
    ``prepare_params(conv_impl="memory", fc_impl="memory",
    batch_hint=batch)`` and ``network.make_forward_fn``. Returns fn(x)."""
    from qcnn_tpu_torch.models import network, prepare

    sp = spec(cfg)
    prepared, conv_impls, fc_impls = prepare.prepare_params(
        sp, weights, batch_hint=batch, conv_impl="memory", fc_impl="memory",
        dtype=dtype(cfg), device=device)
    fwd = network.make_forward_fn(
        sp, conv_impls=conv_impls, fc_impls=fc_impls,
        compute_dtype=prepare.act_dtype_for(dtype(cfg)), device=device)
    return lambda x: fwd(prepared, x)


def int8_forward(cfg: dict, weights: list, batch: int, device):
    """A control of the comparison: the program's own int8 path, as
    ``--dtype int8`` without ``--memory-mode`` runs it (``prepare_params(
    dtype=torch.int8)`` with the default strategies: every layer decoded at
    load and quantized per output channel, bf16 activations quantized per
    tensor at each product). Returns fn(x), in ``offline_forward``'s
    place."""
    from qcnn_tpu_torch.models import network, prepare

    sp = spec(cfg)
    prepared, conv_impls, fc_impls = prepare.prepare_params(
        sp, weights, batch_hint=batch, dtype=torch.int8, device=device)
    fwd = network.make_forward_fn(
        sp, conv_impls=conv_impls, fc_impls=fc_impls,
        compute_dtype=prepare.act_dtype_for(torch.int8), device=device)
    return lambda x: fwd(prepared, x)


def fp8_forward(cfg: dict, weights: list, batch: int, device):
    """A control of the comparison: the reference with every product's
    operands in fp8 (e4m3, one scale a tensor), its softmax in bf16 as the
    program hands it over. Returns fn(x), in ``offline_forward``'s
    place."""
    return lambda x: torch.softmax(
        ref.logits(cfg, weights, x, operand=e4m3), 1).to(torch.bfloat16)


def reference_logits(cfg: dict, weights: list, x: torch.Tensor):
    return ref.logits(cfg, weights, x)


def flops_per_image(cfg: dict) -> float:
    return ref.flops_per_image(cfg)


def kernel_work(cfg: dict, batch: int) -> dict:
    """{port kernel: [(operations, bytes) of each launch of one forward]}:
    the inner products at ``batch`` rows for ``pq_fc_fused``, counted from
    the layer shapes as ``chip_smoke.py`` counts them (each input read
    once, each output written once: bf16 rows, uint8 ids, bf16 codebooks,
    float32 bias and output)."""
    work = []
    for e in ref.geometry(cfg):
        if e["type"] != "fc":
            continue
        s, k, d, cin, cout = e["S"], e["K"], e["D"], e["cin"], e["cout"]
        nbytes = (batch * cin * 2 + cout * s + s * k * d * 2 + cout * 4
                  + batch * cout * 4)
        work.append((2.0 * batch * cin * cout, float(nbytes)))
    return {"pq_fc_fused": work}
