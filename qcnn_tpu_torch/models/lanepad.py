"""Lane-pad conv channel blocks to 128 channels (exact).

A copy of ``qcnn_tpu/models/lanepad.py``: the same rule picks the same
segments and gives the same spec, and the padded arrays hold the same
values. The JAX package pads for the TPU's 128-lane vector registers:
AlexNet-family block 1 runs at C=96, so every elementwise, LRN and pool op
between conv1 and conv2 there uses 3/4 of each register. On the card the
pass is an option to measure, not a default.

The pass pads conv1's output channels to 128 with zero filters and consumes
the padding in conv2. The transform is exact:

- zero filters produce zero activations; ReLU/pool/dropout are channelwise
  and map zero to zero;
- LRN windows span the ORIGINAL channel adjacency via the band matrix
  (LRNSpec.channel_map -> ops.misc.lrn): real channels see exactly their
  original windows, padded channels output x * scale = 0;
- conv2 contracts the padded channels against zero kernel columns.

The padding layout respects the CONSUMER's group structure: conv2 with
groups=2 reads channels [0:48 | 48:96] as two groups, so the padded layout
is [48 real | 16 zero | 48 real | 16 zero] and conv2's kernel zero-pads its
per-group input axis 48 -> 64. (The reference hardwires these group splits,
CaffePara.cc:20-52; grouped dispatch at CaffeEva.cc:795.)

Applied AFTER prepare_params (models/prepare.py), on decode-at-load dense
layers only: memory-mode PQ layers keep compressed params whose subspace
structure the pad would break. It works on the port's prepared params, not
on NumPy HWIO arrays: a conv ``kernel`` is an HWIO view of OHWI memory and
an int8 ``kernel_q`` an HWIO view of OHWI rows zero-padded for the int8
GEMM. The padded kernels are rebuilt in that memory
(``prepare.conv_kernel_tensor`` / ``prepare.int8_conv_kernel_tensor``), on
the input's device and in its dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from qcnn_tpu_torch.core import (
    ConvSpec,
    DropoutSpec,
    LRNSpec,
    ModelSpec,
    PoolSpec,
    ReLUSpec,
)
from qcnn_tpu_torch.models.prepare import (
    conv_kernel_tensor,
    int8_conv_kernel_tensor,
)

_LANES = 128
_PASSTHROUGH = (ReLUSpec, LRNSpec, PoolSpec, DropoutSpec)


def ceil_to(x: int, m: int) -> int:
    """x rounded up to a multiple of m (qcnn_tpu/ops/pallas/_common.py)."""
    return -(-x // m) * m


def _is_dense_conv(p: Optional[dict]) -> bool:
    return p is not None and ("kernel" in p or "kernel_q" in p)


def _scatter_rows(t: torch.Tensor, pos: torch.Tensor, total: int,
                  fill=0) -> torch.Tensor:
    """Scatter the first axis of `t` to `pos` within a `total`-long axis."""
    out = torch.full((total,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                     device=t.device)
    out[pos] = t
    return out


def _pad_producer(p: dict, pos: torch.Tensor, total: int) -> dict:
    """The producer conv's filters (and bias / int8 scale) at their padded
    positions, zero filters between."""
    p = dict(p)
    if "kernel" in p:
        k = p["kernel"]
        ohwi = _scatter_rows(k.permute(3, 0, 1, 2), pos, total)
        p["kernel"] = conv_kernel_tensor(ohwi, k.dtype, k.device)
    else:
        k = p["kernel_q"]
        ohwi = _scatter_rows(k.permute(3, 0, 1, 2), pos, total)
        p["kernel_q"] = int8_conv_kernel_tensor(ohwi, k.device)
        # padded channels: scale 1.0 (they only ever multiply zeros)
        p["scale"] = _scatter_rows(p["scale"], pos, total, fill=1.0)
    p["bias"] = _scatter_rows(p["bias"], pos, total)
    return p


def _pad_consumer(p: dict, cig: int, cig_pad: int) -> dict:
    """The consumer conv's per-group input axis zero-padded at its tail (the
    real channels keep their in-group positions)."""
    p = dict(p)
    key = "kernel" if "kernel" in p else "kernel_q"
    k = p[key]  # HWIO, I = cig
    assert k.shape[2] == cig, (tuple(k.shape), cig)
    ohwi = k.permute(3, 0, 1, 2)
    padded = ohwi.new_zeros(tuple(ohwi.shape[:3]) + (cig_pad,))
    padded[..., :cig] = ohwi
    if key == "kernel":
        p[key] = conv_kernel_tensor(padded, k.dtype, k.device)
    else:
        p[key] = int8_conv_kernel_tensor(padded, k.device)
    return p


def lane_pad(
    spec: ModelSpec,
    params: Sequence[Optional[dict]],
) -> tuple[ModelSpec, list]:
    """Pad misaligned conv->conv channel blocks to 128 channels (exact).

    Returns (new_spec, new_params); the spec is the same object when no
    segment qualifies. A segment qualifies when: a dense-prepared conv with
    out_channels % 128 != 0 is followed (through ReLU/LRN/pool/dropout
    only) by another dense-prepared conv whose group count divides the
    padded width evenly.
    """
    layers = list(spec.layers)
    new_params = list(params)
    changed = False

    for a, layer_a in enumerate(layers):
        if not isinstance(layer_a, ConvSpec):
            continue
        cout = layer_a.out_channels
        if cout % _LANES == 0 or not _is_dense_conv(new_params[a]):
            continue
        # walk to the consumer conv
        b = None
        for j in range(a + 1, len(layers)):
            if isinstance(layers[j], ConvSpec):
                b = j
                break
            if not isinstance(layers[j], _PASSTHROUGH):
                break
        if b is None or not _is_dense_conv(new_params[b]):
            continue
        gb = layers[b].groups
        if cout % gb:
            continue
        total = ceil_to(cout, _LANES)
        if total % gb:
            continue
        # the pad adds (total/cout - 1) extra MACs to both convs; the JAX
        # package pads only the near-aligned case (e.g. 96 -> 128, +33%),
        # where lane utilization wins back more than it spends (VGG16's
        # 64 -> 128 would double them)
        if total > cout * 3 // 2:
            continue
        cig, cig_pad = cout // gb, total // gb

        # channel ch -> padded position (per consumer group, tail padding)
        pos = np.arange(cout)
        pos = (pos // cig) * cig_pad + (pos % cig)
        channel_map = np.full(total, -1, np.int64)
        channel_map[pos] = np.arange(cout)

        new_params[a] = _pad_producer(
            new_params[a],
            torch.as_tensor(pos, device=new_params[a]["bias"].device), total)
        layers[a] = dataclasses.replace(layer_a, out_channels=total)
        new_params[b] = _pad_consumer(new_params[b], cig, cig_pad)

        # LRNs inside the segment follow the original adjacency
        for j in range(a + 1, b):
            if isinstance(layers[j], LRNSpec):
                layers[j] = dataclasses.replace(
                    layers[j], channel_map=tuple(int(v) for v in channel_map)
                )
        changed = True

    if not changed:
        return spec, list(params)
    return dataclasses.replace(spec, layers=tuple(layers)), new_params
