"""Minimal dependency-free Caffe `.caffemodel` protobuf codec + importer.

A copy of ``qcnn_tpu/formats/caffe_pb.py`` (NumPy only: the same file gives
the same params in both packages).

The reference's weights descend from Caffe models quantized offline
(README.md: "model files ... converted from the pre-trained Caffe models";
the CVPR'16 pipeline starts from a `.caffemodel`). This module lets the
in-repo quantizer (`python -m qcnn_tpu_torch quantize model.caffemodel out
--arch vgg16`) ingest that original real-world format directly, closing the
FP32-checkpoint-ingestion gap: no protobuf library, just the wire format.

Implements exactly the subset of caffe.proto the weights need:

  NetParameter   { name=1; layers=2 (V1LayerParameter); layer=100 }
  LayerParameter { name=1; type=2 (string); blobs=7 }
  V1LayerParameter { bottom=2; top=3; name=4; type=5 (enum); blobs=6 }
  BlobProto      { num=1; channels=2; height=3; width=4;
                   data=5 (packed/unpacked float); shape=7 }
  BlobShape      { dim=1 (packed/unpacked int64) }

Every other field is skipped by wire type (forward-compatible). Blob layouts
follow Caffe: conv (Cout, Cin/groups, kh, kw) — the reference's convKnl OIHW
(SURVEY.md §2a) — and FC (Cout, Cin).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator, Optional, Union

import numpy as np

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    val = shift = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated varint")
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
        if shift > 63:
            raise ValueError("varint longer than 64 bits")


def _write_varint(val: int) -> bytes:
    out = bytearray()
    while True:
        b = val & 0x7F
        val >>= 7
        if val:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, value) where value is an int for
    varint/fixed wires and the raw bytes for length-delimited wires."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            val, i = _read_varint(buf, i)
        elif wire == _I64:
            if i + 8 > n:
                raise ValueError(f"truncated fixed64 field {field}")
            val = int.from_bytes(buf[i:i + 8], "little")
            i += 8
        elif wire == _I32:
            if i + 4 > n:
                raise ValueError(f"truncated fixed32 field {field}")
            val = int.from_bytes(buf[i:i + 4], "little")
            i += 4
        elif wire == _LEN:
            ln, i = _read_varint(buf, i)
            if i + ln > n:
                raise ValueError(f"truncated field {field} (need {ln} bytes)")
            val = buf[i:i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, val


def _key(field: int, wire: int) -> bytes:
    return _write_varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, _LEN) + _write_varint(len(payload)) + payload


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CaffeLayer:
    name: str
    type: str          # string form; V1 enum types are mapped via _V1_TYPES
    blobs: list       # list[np.ndarray] float32, shaped


@dataclasses.dataclass
class CaffeNet:
    name: str
    layers: list      # list[CaffeLayer], file order


# V1LayerParameter.LayerType enum values we care about
# (caffe.proto upstream; only learnable types are needed to map weights)
_V1_TYPES = {
    4: "Convolution", 14: "InnerProduct", 18: "ReLU", 17: "Pooling",
    15: "LRN", 6: "Dropout", 20: "Softmax", 5: "Data", 21: "SoftmaxWithLoss",
    39: "Deconvolution", 3: "Concat",
}


def _parse_blob(buf: bytes) -> np.ndarray:
    shape: Optional[list[int]] = None
    legacy = [0, 0, 0, 0]  # num, channels, height, width
    chunks: list[np.ndarray] = []
    for field, wire, val in _iter_fields(buf):
        if field == 5:  # data
            if wire == _LEN:
                chunks.append(np.frombuffer(val, dtype="<f4"))
            else:  # unpacked repeated float (one fixed32 per element)
                chunks.append(
                    np.frombuffer(struct.pack("<I", val), dtype="<f4")
                )
        elif field == 7 and wire == _LEN:  # shape: BlobShape
            shape = []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    if w2 == _LEN:  # packed int64 dims
                        i = 0
                        while i < len(v2):
                            d, i = _read_varint(v2, i)
                            shape.append(d)
                    else:
                        shape.append(v2)
        elif field in (1, 2, 3, 4) and wire == _VARINT:
            legacy[field - 1] = val
    data = (np.concatenate(chunks) if chunks
            else np.zeros(0, np.float32)).astype(np.float32)
    if shape is None:
        # legacy 4-D num/channels/height/width header: keep ALL dims.
        # (An earlier unconditional leading-1 squeeze mangled valid conv
        # blobs with num==1 — (1,Cin,kh,kw) became rank 3 and a valid
        # model was rejected; round-5 review. Consumers that expect
        # lower rank — FC weights, biases — squeeze/ravel at the point
        # where the expected rank is actually known.)
        shape = legacy
    if int(np.prod(shape)) != data.size:
        raise ValueError(
            f"blob shape {shape} does not match {data.size} floats"
        )
    return data.reshape(shape)


def _parse_layer(buf: bytes, v1: bool) -> CaffeLayer:
    name, ltype, blobs = "", "", []
    name_f, type_f, blobs_f = (4, 5, 6) if v1 else (1, 2, 7)
    for field, wire, val in _iter_fields(buf):
        if field == name_f and wire == _LEN:
            name = val.decode("utf-8", "replace")
        elif field == type_f:
            if v1:  # enum
                ltype = _V1_TYPES.get(val, f"V1_{val}")
            elif wire == _LEN:
                ltype = val.decode("utf-8", "replace")
        elif field == blobs_f and wire == _LEN:
            blobs.append(_parse_blob(val))
    return CaffeLayer(name, ltype, blobs)


def read_caffemodel(path_or_bytes) -> CaffeNet:
    """Parse a .caffemodel (NetParameter); both modern `layer` (field 100)
    and legacy `layers` (V1LayerParameter, field 2) nets are accepted."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    name, layers = "", []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == _LEN:
            name = val.decode("utf-8", "replace")
        elif field == 100 and wire == _LEN:
            layers.append(_parse_layer(val, v1=False))
        elif field == 2 and wire == _LEN:
            layers.append(_parse_layer(val, v1=True))
    return CaffeNet(name, layers)


# ---------------------------------------------------------------------------
# Writer (synthetic fixtures / export)
# ---------------------------------------------------------------------------

def _encode_blob(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, dtype="<f4")
    shape_payload = b"".join(
        _key(1, _VARINT) + _write_varint(int(d)) for d in arr.shape
    )
    return (
        _len_field(7, shape_payload)
        + _len_field(5, arr.ravel().tobytes())
    )


def write_caffemodel(path, net: CaffeNet, *, v1: bool = False) -> None:
    """Encode a NetParameter. v1=True writes legacy `layers` records (enum
    types) — used to test the legacy read path."""
    out = bytearray(_len_field(1, net.name.encode()))
    inv_v1 = {v: k for k, v in _V1_TYPES.items()}
    for layer in net.layers:
        if v1:
            payload = (
                _len_field(4, layer.name.encode())
                + _key(5, _VARINT) + _write_varint(inv_v1.get(layer.type, 0))
                + b"".join(_len_field(6, _encode_blob(b))
                           for b in layer.blobs)
            )
            out += _len_field(2, payload)
        else:
            payload = (
                _len_field(1, layer.name.encode())
                + _len_field(2, layer.type.encode())
                + b"".join(_len_field(7, _encode_blob(b))
                           for b in layer.blobs)
            )
            out += _len_field(100, payload)
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# Importer: caffemodel -> (spec-aligned dense params)
# ---------------------------------------------------------------------------

def import_caffemodel(path_or_bytes, spec) -> list:
    """Map a caffemodel's learnable blobs onto `spec` (a zoo ModelSpec) in
    order, returning the dense params list the quantizer consumes
    (conv kernels HWIO, FC weights (Cin, Cout) — formats/checkpoint.py
    conventions). Shape-checks every layer; learnable layer count must
    match exactly."""
    from qcnn_tpu_torch.core import (
        ConvSpec, FCSpec, dense_conv_params, dense_fc_params,
    )

    net = read_caffemodel(path_or_bytes)
    learnable = [l for l in net.layers if l.blobs]
    spec_learnable = [
        (i, l) for i, l in enumerate(spec.layers)
        if isinstance(l, (ConvSpec, FCSpec))
    ]
    if len(learnable) != len(spec_learnable):
        raise ValueError(
            f"{net.name or 'net'}: {len(learnable)} learnable caffemodel "
            f"layers vs {len(spec_learnable)} in spec {spec.name}"
        )
    params: list = [None] * len(spec.layers)
    for (idx, lspec), clayer in zip(spec_learnable, learnable):
        w = clayer.blobs[0]
        bias = (clayer.blobs[1].ravel() if len(clayer.blobs) > 1
                else np.zeros(_out_channels(lspec), np.float32))
        if isinstance(lspec, ConvSpec):
            if w.ndim != 4:
                raise ValueError(
                    f"{clayer.name}: conv blob rank {w.ndim} != 4"
                )
            cout, _, kh, kw = w.shape
            if cout != lspec.out_channels or (kh, kw) != (lspec.kernel,) * 2:
                raise ValueError(
                    f"{clayer.name}: blob {w.shape} does not match spec "
                    f"(out={lspec.out_channels}, k={lspec.kernel})"
                )
            kernel = np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))
            params[idx] = dense_conv_params(kernel.astype(np.float32),
                                            bias.astype(np.float32))
        else:
            # legacy FC blobs arrive (1, 1, Cout, Cin): drop leading
            # 1-dims here (the parser no longer squeezes)
            while w.ndim > 2 and w.shape[0] == 1:
                w = w[0]
            w2 = w.reshape(w.shape[0], -1) if w.ndim > 2 else w
            if w2.shape[0] != lspec.out_features:
                raise ValueError(
                    f"{clayer.name}: FC blob {w.shape} does not match "
                    f"out_features={lspec.out_features}"
                )
            params[idx] = dense_fc_params(
                np.ascontiguousarray(w2.T).astype(np.float32),
                bias.astype(np.float32),
            )
    return params


def _out_channels(lspec) -> int:
    from qcnn_tpu_torch.core import ConvSpec

    return (lspec.out_channels if isinstance(lspec, ConvSpec)
            else lspec.out_features)
