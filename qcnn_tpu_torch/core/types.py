"""Layer and model specifications + parameter dicts.

A copy of ``qcnn_tpu/core/types.py`` (the port imports nothing of the JAX
package). The reference encodes model architecture as a linear list of 7
layer types with per-type config (include/CaffePara.h:25-42,
src/CaffePara.cc:380-423). Here the specs are frozen, hashable dataclasses,
while the parameters live in plain lists of dicts of arrays.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

import numpy as np


class LayerKind(enum.Enum):
    CONV = "conv"
    POOL = "pool"
    FC = "fc"
    RELU = "relu"
    LRN = "lrn"
    DROPOUT = "dropout"
    SOFTMAX = "softmax"


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Grouped 2-D convolution (reference ConfigConvLayer, CaffePara.cc:380-388).

    Output spatial size uses floor((H + 2*pad - kernel)/stride) + 1
    (CaffeEva.cc:361-362)."""

    kernel: int
    out_channels: int
    pad: int = 0
    groups: int = 1
    stride: int = 1
    kind: LayerKind = LayerKind.CONV


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """Max pooling with Caffe's CEIL output-size rule
    (CaffeEva.cc:367-370) and window clamping at borders (:885-898)."""

    kernel: int
    stride: int
    pad: int = 0
    kind: LayerKind = LayerKind.POOL


@dataclasses.dataclass(frozen=True)
class FCSpec:
    """Fully-connected layer (ConfigFCntLayer, CaffePara.cc:398-401). The first
    FC in a network flattens its NHWC input in NCHW order to match the weight
    layout (CaffeEva.cc:184-204)."""

    out_features: int
    kind: LayerKind = LayerKind.FC


@dataclasses.dataclass(frozen=True)
class ReLUSpec:
    kind: LayerKind = LayerKind.RELU


@dataclasses.dataclass(frozen=True)
class LRNSpec:
    """Across-channel local response normalization (CalcFeatMap_LoRN,
    CaffeEva.cc:1038-1089): out = x * (k + alpha/n * sum_win x^2)^(-beta).

    channel_map: when the surrounding convs carry lane-padded channels
    (models/lanepad.py), maps each padded position to its original channel
    index (-1 for zero padding) so the window sum spans the ORIGINAL
    channel adjacency — e.g. AlexNet's LRN window crosses conv2's group
    boundary, which padding would otherwise sever."""

    size: int
    alpha: float
    beta: float
    k: float
    channel_map: Optional[tuple[int, ...]] = None
    kind: LayerKind = LayerKind.LRN


@dataclasses.dataclass(frozen=True)
class DropoutSpec:
    """Identity at inference time (CalcFeatMap_Drpt, CaffeEva.cc:1091-1096)."""

    rate: float
    kind: LayerKind = LayerKind.DROPOUT


@dataclasses.dataclass(frozen=True)
class SoftmaxSpec:
    kind: LayerKind = LayerKind.SOFTMAX


LayerSpec = Union[
    ConvSpec, PoolSpec, FCSpec, ReLUSpec, LRNSpec, DropoutSpec, SoftmaxSpec
]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A linear layer graph, the reference's LayerInfoLst (CaffePara.cc:20-237)."""

    name: str
    in_height: int
    in_width: int
    in_channels: int
    layers: tuple[LayerSpec, ...]

    @property
    def num_classes(self) -> int:
        for layer in reversed(self.layers):
            if isinstance(layer, FCSpec):
                return layer.out_features
        raise ValueError("model has no FC layer")

    def feature_shapes(self, batch: int) -> list[tuple[int, int, int, int]]:
        """Shape inference for every feature map, NHWC (PrepFeatMap,
        CaffeEva.cc:328-392)."""
        shapes = [(batch, self.in_height, self.in_width, self.in_channels)]
        for layer in self.layers:
            b, h, w, c = shapes[-1]
            if isinstance(layer, ConvSpec):
                oh = (h + 2 * layer.pad - layer.kernel) // layer.stride + 1
                ow = (w + 2 * layer.pad - layer.kernel) // layer.stride + 1
                shapes.append((b, oh, ow, layer.out_channels))
            elif isinstance(layer, PoolSpec):
                oh = -(-(h + 2 * layer.pad - layer.kernel) // layer.stride) + 1
                ow = -(-(w + 2 * layer.pad - layer.kernel) // layer.stride) + 1
                if layer.pad:
                    # Caffe's clamp (pooling_layer.cpp, mirrored by
                    # ops/misc.caffe_max_pool): drop a trailing output
                    # whose window lies entirely in padding — without
                    # this, predicted shapes diverge from executed ones
                    # for ceil-mode pools with pad > 0 and the first-FC
                    # weight is sized against the wrong flatten width
                    if (oh - 1) * layer.stride >= h + layer.pad:
                        oh -= 1
                    if (ow - 1) * layer.stride >= w + layer.pad:
                        ow -= 1
                shapes.append((b, oh, ow, c))
            elif isinstance(layer, FCSpec):
                shapes.append((b, 1, 1, layer.out_features))
            else:
                shapes.append((b, h, w, c))
        return shapes


# ---------------------------------------------------------------------------
# Parameter pytrees
# ---------------------------------------------------------------------------
#
# Per quantized layer (SURVEY.md §2a):
#   codebooks  : (S, K, D) float — S sub-spaces, K codewords, D dims/sub-space
#   assignments: conv (Cout, kh, kw, S) uint8; fc (Cout, S) uint8
#   bias       : (Cout,) float
#
# Dense layers carry the decoded/original weights instead:
#   conv kernel: HWIO (kh, kw, Cin/groups, Cout) — lax.conv native layout
#   fc weight  : (Cin, Cout)


def pq_conv_params(codebooks, assignments, bias) -> dict:
    codebooks = np.asarray(codebooks)
    assignments = np.asarray(assignments)
    s, k, d = codebooks.shape
    cout, kh, kw, s2 = assignments.shape
    if s2 != s:
        raise ValueError(f"subspace mismatch: codebooks S={s}, assignments S={s2}")
    if int(assignments.max()) >= k:
        raise ValueError("assignment index out of codebook range")
    return {"codebooks": codebooks, "assignments": assignments,
            "bias": np.asarray(bias).reshape(-1)}


def pq_fc_params(codebooks, assignments, bias) -> dict:
    codebooks = np.asarray(codebooks)
    assignments = np.asarray(assignments)
    s, k, d = codebooks.shape
    cout, s2 = assignments.shape
    if s2 != s:
        raise ValueError(f"subspace mismatch: codebooks S={s}, assignments S={s2}")
    if int(assignments.max()) >= k:
        raise ValueError("assignment index out of codebook range")
    return {"codebooks": codebooks, "assignments": assignments,
            "bias": np.asarray(bias).reshape(-1)}


def dense_conv_params(kernel_hwio, bias) -> dict:
    return {"kernel": np.asarray(kernel_hwio), "bias": np.asarray(bias).reshape(-1)}


def dense_fc_params(weight_io, bias) -> dict:
    return {"weight": np.asarray(weight_io), "bias": np.asarray(bias).reshape(-1)}


def is_pq(params: Optional[dict]) -> bool:
    return params is not None and "codebooks" in params
