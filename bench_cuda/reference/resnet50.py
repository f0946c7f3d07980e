"""Plain reference of the ResNet-v1.5 configurations (torchvision's
ResNet-50 widths, BatchNorm folded into each conv's bias): a float32
forward pass in plain PyTorch (TF32 off), from the configuration's sizes
and the weights that the harness made. It imports nothing of the program.

Graph: a 7x7 stride-2 stem conv (dense weights), ReLU, a 3x3 stride-2 max
pool with one pixel of padding (floor rule); then bottleneck blocks: 1x1
conv, ReLU, 3x3 conv with the block's stride, ReLU, 1x1 conv, plus the
shortcut (a 1x1 projection with the block's stride where the channels
change), ReLU; then the global average pool and the inner product. Every
conv with at least ``pq.min_cin`` input channels, and the inner product,
are product-quantized over their input channels. Returns logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_cuda.reference.pq import NoTF32, decode_conv, decode_rows, same


def blocks(cfg: dict) -> list:
    """(block key, stride, [(conv name, kernel, cin, cout)]) in forward
    order; the first block of every stage but the first has stride 2."""
    out = []
    cin = cfg["stem"]["out"]
    for s, (depth, cout) in enumerate(zip(cfg["stage_depths"],
                                          cfg["stage_channels"])):
        mid = cout // cfg["bottleneck_ratio"]
        for b in range(depth):
            stride = 2 if (s > 0 and b == 0) else 1
            convs = [("conv1", 1, cin, mid), ("conv2", 3, mid, mid),
                     ("conv3", 1, mid, cout)]
            if cin != cout:
                convs.append(("proj", 1, cin, cout))
            out.append((f"s{s}b{b}", stride, convs))
            cin = cout
    return out


def layers(cfg: dict) -> list:
    """Every weighted layer: (path, kind, kernel, stride, cin, cout, input
    height) with kind "pq_conv", "conv" (dense) or "fc"."""
    size = cfg["input"][0]
    stem = cfg["stem"]
    out = [(("stem",), "pq_conv" if 3 >= cfg["pq"]["min_cin"] else "conv",
            stem["kernel"], stem["stride"], cfg["input"][2], stem["out"],
            size)]
    h = -(-size // stem["stride"])  # 224 -> 112
    h = (h + 2 - 3) // 2 + 1        # the max pool: 112 -> 56
    for key, stride, convs in blocks(cfg):
        for name, k, ci, co in convs:
            hin = -(-h // stride) if name == "conv3" else h
            kind = "pq_conv" if ci >= cfg["pq"]["min_cin"] else "conv"
            st = stride if name in ("conv2", "proj") else 1
            out.append(((key, name), kind, k, st, ci, co, hin))
        h = -(-h // stride)
    out.append((("fc",), "fc", 1, 1, cfg["stage_channels"][-1],
                cfg["num_classes"], 1))
    return out


def flops_per_image(cfg: dict) -> float:
    """2 x the multiply-adds of the convolutions and the inner product."""
    total = 0
    for _, kind, k, st, ci, co, h in layers(cfg):
        ho = -(-h // st)
        total += 2 * ho * ho * k * k * ci * co
    return float(total)


def _conv(x, p, k: int, stride: int, cin: int, operand=same):
    if "codebooks" in p:
        w = decode_conv(p["codebooks"], p["assignments"], cin)
    else:  # dense, HWIO
        w = p["kernel"].float().permute(3, 2, 0, 1)
    return F.conv2d(operand(x), operand(w), p["bias"].float(),
                    stride=stride, padding=k // 2)


def logits(cfg: dict, weights: dict, x_nhwc: torch.Tensor,
           operand=same) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, classes) float32 logits. ``operand``
    rounds both operands of every conv and inner product (``pq.e4m3`` for
    the control); the identity by default."""
    with NoTF32(), torch.no_grad():
        x = x_nhwc.float().permute(0, 3, 1, 2)
        stem = cfg["stem"]
        x = _conv(x, weights["stem"], stem["kernel"], stem["stride"],
                  cfg["input"][2], operand).clamp_min(0)
        x = F.max_pool2d(x, 3, 2, padding=1)
        for key, stride, convs in blocks(cfg):
            p = weights[key]
            dims = {name: (k, ci) for name, k, ci, _ in convs}
            short = x
            if "proj" in p:
                short = _conv(x, p["proj"], 1, stride, dims["proj"][1],
                              operand)
            y = _conv(x, p["conv1"], 1, 1, dims["conv1"][1],
                      operand).clamp_min(0)
            y = _conv(y, p["conv2"], 3, stride, dims["conv2"][1],
                      operand).clamp_min(0)
            y = _conv(y, p["conv3"], 1, 1, dims["conv3"][1], operand)
            x = (y + short).clamp_min(0)
        x = x.mean(dim=(2, 3))
        fc = weights["fc"]
        w = decode_rows(fc["codebooks"], fc["assignments"], x.shape[1])
        return operand(x) @ operand(w).t() + fc["bias"].float()
