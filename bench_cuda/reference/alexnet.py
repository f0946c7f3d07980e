"""Plain reference of the AlexNet-class configurations: a float32 forward
pass in plain PyTorch (TF32 off), from the configuration's layer list and
the PQ codebooks and ids that the harness made. It imports nothing of the
program.

Layers (Caffe semantics, bvlc_alexnet): conv with groups and a bias; ReLU;
across-channel LRN, out = x * (k + alpha / size * sum of x^2 over the
``size`` channels centred on each, zero-padded) ^ -beta; max pooling with
Caffe's ceil rule; inner product on the NCHW flattening of its input (the
Caffe weight layout); dropout, the identity at test time. The forward stops
at the last inner product and returns its logits: the softmax is applied by
whoever compares.

Also here: the configuration's geometry (the shape entering each layer and
the PQ shapes of each weighted layer), which the harness's generator and
FLOP count read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench_cuda.reference.pq import NoTF32, decode_conv, decode_rows, same


def _pool_out(h: int, kernel: int, stride: int, pad: int) -> int:
    out = -(-(h + 2 * pad - kernel) // stride) + 1
    if pad and (out - 1) * stride >= h + pad:
        out -= 1
    return out


def geometry(cfg: dict) -> list:
    """One entry per layer: {"type", "in": (H, W, C), ...}; conv and fc
    entries also hold "cin" (per group for a conv), "cout", "S", "K", "D",
    "ids" (the ids' shape) and "scale" (the codewords' standard deviation),
    and the last fc is the classifier."""
    h, w, c = cfg["input"]
    fcs = [i for i, layer in enumerate(cfg["layers"]) if layer["type"] == "fc"]
    pq = cfg["pq"]
    out = []
    for i, layer in enumerate(cfg["layers"]):
        entry = dict(layer, **{"in": (h, w, c)})
        t = layer["type"]
        if t == "conv":
            g = layer.get("groups", 1)
            cg = c // g
            k, s_ = layer["kernel"], layer.get("stride", 1)
            p = layer.get("pad", 0)
            d, kk = pq["conv"]["D"], pq["conv"]["K"]
            s = -(-cg // d)
            entry.update(cin=cg, cout=layer["out"], S=s, K=kk, D=d,
                         ids=(layer["out"], k, k, s),
                         scale=pq["conv"]["scale"])
            h = (h + 2 * p - k) // s_ + 1
            w = (w + 2 * p - k) // s_ + 1
            c = layer["out"]
        elif t == "fc":
            cin = h * w * c
            kind = "classifier" if i == fcs[-1] else "fc"
            d, kk = pq[kind]["D"], pq[kind]["K"]
            s = -(-cin // d)
            entry.update(cin=cin, cout=layer["out"], S=s, K=kk, D=d,
                         ids=(layer["out"], s), scale=pq[kind]["scale"])
            h, w, c = 1, 1, layer["out"]
        elif t == "pool":
            k, s_, p = layer["kernel"], layer["stride"], layer.get("pad", 0)
            h, w = _pool_out(h, k, s_, p), _pool_out(w, k, s_, p)
        out.append(entry)
    return out


def flops_per_image(cfg: dict) -> float:
    """2 x the multiply-adds of the convolutions and inner products."""
    total = 0
    for e in geometry(cfg):
        if e["type"] == "conv":
            h, w, _ = e["in"]
            k, s, p = e["kernel"], e.get("stride", 1), e.get("pad", 0)
            ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            total += 2 * ho * wo * e["cout"] * k * k * e["cin"]
        elif e["type"] == "fc":
            total += 2 * e["cin"] * e["cout"]
    return float(total)


def lrn(x: torch.Tensor, size: int, alpha: float, beta: float,
        k: float) -> torch.Tensor:
    """Across-channel LRN of an NCHW tensor."""
    r = (size - 1) // 2
    sq = F.pad((x * x).unsqueeze(1), (0, 0, 0, 0, r, size - 1 - r))
    window = sq.unfold(2, size, 1).sum(-1).squeeze(1)
    return x * (k + alpha / size * window) ** -beta


def logits(cfg: dict, weights: list, x_nhwc: torch.Tensor,
           operand=same) -> torch.Tensor:
    """(B, H, W, C) images -> (B, classes) float32 logits. ``operand``
    rounds both operands of every conv and inner product (``pq.e4m3`` for
    the control); the identity by default."""
    with NoTF32(), torch.no_grad():
        x = x_nhwc.float().permute(0, 3, 1, 2)
        for e, p in zip(geometry(cfg), weights):
            t = e["type"]
            if t == "conv":
                wt = decode_conv(p["codebooks"], p["assignments"], e["cin"])
                x = F.conv2d(operand(x), operand(wt), p["bias"].float(),
                             stride=e.get("stride", 1),
                             padding=e.get("pad", 0),
                             groups=e.get("groups", 1))
            elif t == "fc":
                wt = decode_rows(p["codebooks"], p["assignments"], e["cin"])
                x = (operand(x.reshape(x.shape[0], -1)) @ operand(wt).t()
                     + p["bias"].float())
            elif t == "relu":
                x = x.clamp_min(0)
            elif t == "lrn":
                x = lrn(x, e["size"], e["alpha"], e["beta"], e["k"])
            elif t == "pool":
                x = F.max_pool2d(x, e["kernel"], e["stride"],
                                 padding=e.get("pad", 0), ceil_mode=True)
            elif t in ("dropout", "softmax"):
                pass
            else:
                raise ValueError(f"unknown layer type {t!r}")
        if not math.prod(x.shape[1:]) == x.shape[-1]:
            raise ValueError("the layer list does not end in an inner "
                             "product")
        return x.reshape(x.shape[0], -1)
