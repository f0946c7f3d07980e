"""Load reference-format model parameters into the port's parameter lists.

A copy of ``qcnn_tpu/models/loader.py``: the same files, the same NumPy
parameter lists (which ``models.prepare.prepare_params`` takes), the same
seeds for synthesized assignments.

Mirrors CaffePara::LoadLayerPara (src/CaffePara.cc:239-306): per conv/FC layer
index i (0-based), files are named ``{prefix}.{kind}.{i+1:02d}.{ext}``:

  biasVec.NN.bin              float32, always
  ctrdLst.NN.bin              float32 (S, K, D), quantized models
  asmtLst.NN.{cbn|bin}        uint8 indices, quantized models
  convKnl.NN.bin              float32 (Cout, Cg, kh, kw), dense conv
  fcntWei.NN.bin              float32 (Cout, Cin), dense FC

Upstream ships AlexNet quantized weights minus the fc6 assignment blob
(``.MISSING_LARGE_BLOBS``); ``synthesize_missing=True`` fills such gaps with
deterministic pseudo-random indices so that performance work and end-to-end
plumbing don't block on a download. Synthesized layers are recorded in the
returned manifest — accuracy numbers are only meaningful when it's empty.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from qcnn_tpu_torch.core import (
    ConvSpec,
    FCSpec,
    ModelSpec,
    dense_conv_params,
    dense_fc_params,
    pq_conv_params,
    pq_fc_params,
)
from qcnn_tpu_torch.formats import read_asmt, read_bin


@dataclasses.dataclass
class LoadResult:
    params: list
    synthesized_layers: list  # layer indices whose assignments were synthesized

    @property
    def is_authentic(self) -> bool:
        return not self.synthesized_layers


def _synth_assignments(shape, num_codewords: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_codewords, size=shape, dtype=np.uint8)


def load_reference_model(
    spec: ModelSpec,
    weights_dir: str,
    prefix: str,
    *,
    quantized: bool = True,
    encoding: str = "cbn",
    synthesize_missing: bool = False,
    dtype=np.float32,
) -> LoadResult:
    """Build the params list for `network.forward` from reference files."""
    params: list[Optional[dict]] = []
    synthesized: list[int] = []

    def path(kind: str, idx: int, ext: str) -> str:
        return os.path.join(weights_dir, f"{prefix}.{kind}.{idx + 1:02d}.{ext}")

    for i, layer in enumerate(spec.layers):
        if not isinstance(layer, (ConvSpec, FCSpec)):
            params.append(None)
            continue
        bias = read_bin(path("biasVec", i, "bin"), dtype).reshape(-1)
        if quantized:
            ctrd = read_bin(path("ctrdLst", i, "bin"), dtype)
            s, k, d = ctrd.shape
            asmt_path = path("asmtLst", i, encoding)
            if os.path.exists(asmt_path):
                asmt = read_asmt(asmt_path)
            elif synthesize_missing:
                if isinstance(layer, ConvSpec):
                    shape = (layer.out_channels, layer.kernel, layer.kernel, s)
                else:
                    shape = (layer.out_features, s)
                asmt = _synth_assignments(shape, k, seed=1000 + i)
                synthesized.append(i)
            else:
                raise FileNotFoundError(asmt_path)
            if isinstance(layer, ConvSpec):
                params.append(pq_conv_params(ctrd, asmt, bias))
            else:
                params.append(pq_fc_params(ctrd, asmt, bias))
        else:
            if isinstance(layer, ConvSpec):
                knl = read_bin(path("convKnl", i, "bin"), dtype)
                # (Cout, Cg, kh, kw) -> HWIO (kh, kw, Cg, Cout)
                params.append(
                    dense_conv_params(np.transpose(knl, (2, 3, 1, 0)), bias)
                )
            else:
                wei = read_bin(path("fcntWei", i, "bin"), dtype)  # (Cout, Cin)
                params.append(dense_fc_params(wei.T, bias))
    return LoadResult(params=params, synthesized_layers=synthesized)


def load_alexnet_reference(reference_dir: str, **kwargs) -> LoadResult:
    """AlexNet-PQ from a reference checkout's ``AlexNet/Bin.Files``."""
    from qcnn_tpu_torch.models.zoo import alexnet

    return load_reference_model(
        alexnet(),
        os.path.join(reference_dir, "AlexNet", "Bin.Files"),
        "bvlc_alexnet_aCaF",
        quantized=True,
        synthesize_missing=kwargs.pop("synthesize_missing", True),
        **kwargs,
    )


def save_reference_model(
    spec: ModelSpec,
    params,
    weights_dir: str,
    prefix: str,
    *,
    encoding: str = "cbn",
) -> None:
    """Write params back out in the reference's loose-file layout — the
    inverse of load_reference_model, enabling bit-exact round-trip tests and
    interop with the original C++ binary (file naming per
    CaffePara::LoadLayerPara, src/CaffePara.cc:239-306)."""
    from qcnn_tpu_torch.formats import write_bin
    from qcnn_tpu_torch.formats.reference_codec import write_cbn

    os.makedirs(weights_dir, exist_ok=True)

    def path(kind: str, idx: int, ext: str) -> str:
        return os.path.join(weights_dir, f"{prefix}.{kind}.{idx + 1:02d}.{ext}")

    for i, (layer, p) in enumerate(zip(spec.layers, params)):
        if p is None or not isinstance(layer, (ConvSpec, FCSpec)):
            continue
        if "perm" in p:
            raise ValueError(
                f"layer {i}: OPQ-permuted params cannot be exported to the "
                "reference layout (the C++ engine has no permutation "
                "concept); re-quantize without --opq for interop"
            )
        write_bin(path("biasVec", i, "bin"),
                  np.asarray(p["bias"], np.float32))
        if "codebooks" in p:
            write_bin(path("ctrdLst", i, "bin"),
                      np.asarray(p["codebooks"], np.float32))
            asmt = np.asarray(p["assignments"], np.uint8)
            if encoding == "cbn":
                write_cbn(path("asmtLst", i, "cbn"), asmt)
            else:
                # raw .bin stores 1-BASED MATLAB indices — the reference
                # loader subtracts 1 on read (CaffePara.cc:284-288) and
                # our read_asmt rejects files containing 0. Round-5
                # review: writing the raw 0-based array here corrupted
                # every exported layer by one codeword (or failed the
                # reload). Same uint8 format ceiling as convert_asmt.
                if asmt.max(initial=0) >= 255:
                    raise ValueError(
                        f"layer {i}: codeword index "
                        f"{int(asmt.max())} cannot be stored 1-based in "
                        "the uint8 .bin format; use encoding='cbn'"
                    )
                write_bin(path("asmtLst", i, "bin"), asmt + 1)
        elif "kernel" in p:
            # HWIO -> reference convKnl (Cout, Cg, kh, kw)
            write_bin(path("convKnl", i, "bin"),
                      np.transpose(np.asarray(p["kernel"], np.float32),
                                   (3, 2, 0, 1)))
        elif "weight" in p:
            write_bin(path("fcntWei", i, "bin"),
                      np.asarray(p["weight"], np.float32).T)


def load_class_names(path: str) -> list[str]:
    """Class id -> name table (Cls.Names/class_names.txt; one name per line,
    reference CaffeEvaWrapper.cc:219-243)."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return [line.rstrip("\r\n") for line in f if line.strip()]


def load_image_labels(path: str) -> dict[str, int]:
    """Image file stem -> ground-truth class id. The file lists
    ``<name>.JPEG <class_id>`` pairs; the reference keys lookups by the file
    name with extension stripped (LoadImgLabl + ExtrFileName,
    CaffeEvaWrapper.cc:251-320)."""
    mapping: dict[str, int] = {}
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                stem = os.path.splitext(os.path.basename(parts[0]))[0]
                mapping[stem] = int(parts[1])
    return mapping
