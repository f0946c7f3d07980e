"""Minimal dependency-free ONNX weight importer for the linear zoo.

A copy of ``qcnn_tpu/formats/onnx_import.py`` (NumPy only: the same file
gives the same params in both packages).

Third real-world FP32 ingestion format next to Caffe protobuf
(formats/caffe_pb.py) and torch state_dicts (models/torch_import.py) —
the reference lineage starts from `.caffemodel` (README.md), but the
ecosystem's interchange format is ONNX, so `python -m qcnn_tpu_torch quantize
model.onnx out --arch vgg16` must work too.

Reuses caffe_pb's protobuf wire primitives; implements exactly the ONNX
subset weights need (onnx.proto field numbers):

  ModelProto  { graph=7 }
  GraphProto  { node=1; initializer=5 }
  NodeProto   { input=1; output=2; op_type=4; attribute=5 }
  AttributeProto { name=1; i=3 }
  TensorProto { dims=1; data_type=2 (FLOAT=1); float_data=4; name=8;
                raw_data=9 }

Weight mapping walks the graph's Conv/Gemm/MatMul nodes in node order and
zips them against the spec's learnable layers (the same order-driven
contract as import_caffemodel): Conv weights are ONNX OIHW -> our HWIO;
Gemm respects transB (torch exports transB=1, weight (Cout, Cin));
MatMul weights are already (Cin, Cout). Biases default to zeros when a
node carries none.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Union

import numpy as np

from qcnn_tpu_torch.formats.caffe_pb import _iter_fields, _read_varint

_LEN = 2
_FLOAT = 1  # TensorProto.DataType.FLOAT


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: list
    attrs: dict  # name -> int|float (transA/transB, Gemm alpha/beta)


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    name = ""
    dtype = _FLOAT
    raw = b""
    floats: list[float] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            if wire == _LEN:  # packed repeated int64
                i = 0
                while i < len(val):
                    d, i = _read_varint(val, i)  # ValueError on truncation
                    dims.append(d)
            else:
                dims.append(int(val))
        elif field == 2:
            dtype = int(val)
        elif field == 4:
            if wire == _LEN:  # packed floats
                floats.extend(np.frombuffer(val, "<f4").tolist())
            else:
                import struct

                floats.append(struct.unpack("<f", int(val).to_bytes(
                    4, "little"))[0])
        elif field == 8:
            name = val.decode("utf-8", "replace")
        elif field == 9:
            raw = val
    if dtype != _FLOAT:
        raise ValueError(
            f"initializer {name!r}: only float32 tensors are supported "
            f"(data_type={dtype})"
        )
    if raw:
        arr = np.frombuffer(raw, "<f4").copy()
    else:
        arr = np.asarray(floats, np.float32)
    return name, arr.reshape(dims or (-1,))


def _parse_node(buf: bytes) -> OnnxNode:
    inputs: list[str] = []
    op_type = ""
    attrs: dict[str, int] = {}
    for field, _wire, val in _iter_fields(buf):
        if field == 1:
            inputs.append(val.decode("utf-8", "replace"))
        elif field == 4:
            op_type = val.decode("utf-8", "replace")
        elif field == 5:
            aname = ""
            aval = None
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:
                    aname = v2.decode("utf-8", "replace")
                elif f2 == 2:  # AttributeProto.f (float, fixed32 wire)
                    aval = struct.unpack(
                        "<f", int(v2).to_bytes(4, "little"))[0]
                elif f2 == 3:  # AttributeProto.i
                    aval = int(v2)
            if aname and aval is not None:
                attrs[aname] = aval
    return OnnxNode(op_type, inputs, attrs)


def read_onnx(path_or_bytes: Union[str, os.PathLike, bytes]):
    """-> (nodes, initializers): graph nodes in order + name->ndarray."""
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    else:
        buf = path_or_bytes
    graph = None
    for field, _wire, val in _iter_fields(buf):
        if field == 7:
            graph = val
            break
    if graph is None:
        raise ValueError("not an ONNX ModelProto (no graph field)")
    nodes: list[OnnxNode] = []
    inits: dict[str, np.ndarray] = {}
    for field, _wire, val in _iter_fields(graph):
        if field == 1:
            nodes.append(_parse_node(val))
        elif field == 5:
            name, arr = _parse_tensor(val)
            inits[name] = arr
    return nodes, inits


def import_onnx(path_or_bytes, spec) -> list:
    """Map an ONNX model's Conv/Gemm/MatMul weights onto `spec` (a zoo
    ModelSpec) in node order, returning the spec-aligned dense params list
    the quantizer consumes (the import_caffemodel contract:
    conv kernels HWIO, FC weights (Cin, Cout))."""
    from qcnn_tpu_torch.core import (
        ConvSpec, FCSpec, dense_conv_params, dense_fc_params,
    )

    nodes, inits = read_onnx(path_or_bytes)
    # weight (inputs[1]) must itself be an initializer: a node whose only
    # initializer is its bias (weight produced by a preceding node, e.g.
    # DequantizeLinear) is not importable and must not crash with a raw
    # KeyError at inits[nd.inputs[1]] below
    learnable_nodes = [
        nd for nd in nodes
        if nd.op_type in ("Conv", "Gemm", "MatMul")
        and len(nd.inputs) > 1 and nd.inputs[1] in inits
    ]
    spec_learnable = [
        (i, l) for i, l in enumerate(spec.layers)
        if isinstance(l, (ConvSpec, FCSpec))
    ]
    if len(learnable_nodes) != len(spec_learnable):
        raise ValueError(
            f"{len(learnable_nodes)} Conv/Gemm/MatMul nodes with weights "
            f"vs {len(spec_learnable)} learnable layers in spec {spec.name}"
        )
    params: list = [None] * len(spec.layers)
    for (idx, lspec), nd in zip(spec_learnable, learnable_nodes):
        w = inits[nd.inputs[1]]
        bias = (
            inits[nd.inputs[2]].ravel().astype(np.float32)
            if len(nd.inputs) > 2 and nd.inputs[2] in inits
            else None
        )
        if isinstance(lspec, ConvSpec):
            if nd.op_type != "Conv" or w.ndim != 4:
                raise ValueError(
                    f"node {nd.op_type}({nd.inputs[1]}): expected a Conv "
                    f"for spec layer {idx}"
                )
            if (w.shape[0] != lspec.out_channels
                    or w.shape[2:] != (lspec.kernel, lspec.kernel)):
                # both spatial dims: a non-square kernel used to pass
                # (only kh was checked) and die later as a confusing
                # lax.conv shape error (round-5 review)
                raise ValueError(
                    f"{nd.inputs[1]}: {w.shape} does not match spec "
                    f"(out={lspec.out_channels}, k={lspec.kernel})"
                )
            if bias is None:
                bias = np.zeros(lspec.out_channels, np.float32)
            params[idx] = dense_conv_params(
                np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))
                .astype(np.float32), bias
            )
        else:
            if nd.op_type == "Conv":
                raise ValueError(
                    f"node Conv({nd.inputs[1]}): expected an FC for spec "
                    f"layer {idx}"
                )
            # Gemm transB=1 (torch export default): (Cout, Cin) -> .T;
            # MatMul / transB=0: already (Cin, Cout). Non-default
            # alpha/beta/transA would silently change the math (the
            # int-attr parser cannot read float attrs at all), so any
            # captured transA must be rejected rather than ignored
            # (round-5 review).
            if nd.op_type == "Gemm":
                if nd.attrs.get("transA", 0):
                    raise ValueError(
                        f"Gemm({nd.inputs[1]}): transA=1 is not supported "
                        "(the activation side is never transposed in the "
                        "torch export path this importer targets)"
                    )
                for scale_attr in ("alpha", "beta"):
                    v = float(nd.attrs.get(scale_attr, 1.0))
                    if abs(v - 1.0) > 1e-6:
                        raise ValueError(
                            f"Gemm({nd.inputs[1]}): {scale_attr}={v} — "
                            "non-unit Gemm scales would silently change "
                            "the imported math; rescale the weights "
                            "before export"
                        )
            trans_b = nd.op_type == "Gemm" and nd.attrs.get("transB", 0)
            w2 = w.T if trans_b else w
            if w2.shape[1] != lspec.out_features:
                raise ValueError(
                    f"{nd.inputs[1]}: {w.shape} does not match "
                    f"out_features={lspec.out_features}"
                )
            if bias is None:
                bias = np.zeros(lspec.out_features, np.float32)
            params[idx] = dense_fc_params(
                np.ascontiguousarray(w2).astype(np.float32), bias
            )
    return params
