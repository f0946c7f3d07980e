"""Native checkpoint format: a self-describing model spec + parameter store.

A copy of ``qcnn_tpu/formats/checkpoint.py`` that writes the same files, so
a checkpoint written by either package loads in the other. Two array
stores: ``npz`` (the default, which both packages read) and ``dcp``
(``params_dcp/``, PyTorch's sharded checkpoint store,
``torch.distributed.checkpoint``), the port's counterpart of the JAX
package's Orbax/TensorStore store (``params_ts/``). Neither package reads
the other's second store: ``store="orbax"``, and a checkpoint that holds
only ``params_ts/``, raise NotImplementedError naming the way out.

Replaces the reference's loose-file weight directory (CaffePara::LoadLayerPara,
src/CaffePara.cc:239-306, where the architecture lives in compiled-in C++ and
the files carry no schema) with a single portable artifact:

  <path>/spec.json     model architecture (ModelSpec, versioned)
  <path>/params.npz    one entry per tensor: "L{i:02d}.{name}"
  <path>/manifest.json format version, per-layer kinds, dtype/shape table

uint8 assignments are stored bit-packed (the .cbn idea, FileIO.h:110-178,
generalized: ceil(log2(K)) bits per index, little-endian bit order, no page
structure) so a checkpoint is about as small as the reference's compact form.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import warnings
from typing import Optional, Sequence

import numpy as np

from qcnn_tpu_torch.core import types as core_types
from qcnn_tpu_torch.core import ModelSpec

FORMAT_VERSION = 1

_SPEC_CLASSES = {
    "ConvSpec": core_types.ConvSpec,
    "PoolSpec": core_types.PoolSpec,
    "FCSpec": core_types.FCSpec,
    "ReLUSpec": core_types.ReLUSpec,
    "LRNSpec": core_types.LRNSpec,
    "DropoutSpec": core_types.DropoutSpec,
    "SoftmaxSpec": core_types.SoftmaxSpec,
}


def spec_to_dict(spec: ModelSpec) -> dict:
    layers = []
    for layer in spec.layers:
        d = dataclasses.asdict(layer)
        d.pop("kind", None)
        layers.append({"type": type(layer).__name__, **d})
    return {
        "name": spec.name,
        "in_height": spec.in_height,
        "in_width": spec.in_width,
        "in_channels": spec.in_channels,
        "layers": layers,
    }


def spec_from_dict(d: dict) -> ModelSpec:
    layers = []
    for ld in d["layers"]:
        ld = dict(ld)
        cls = _SPEC_CLASSES[ld.pop("type")]
        # JSON round-trips tuples as lists (e.g. LRNSpec.channel_map);
        # frozen specs must stay hashable for jit staticness (round-5
        # review — load_family_checkpoint already converts, this didn't)
        ld = {k: tuple(v) if isinstance(v, list) else v
              for k, v in ld.items()}
        layers.append(cls(**ld))
    return ModelSpec(
        name=d["name"],
        in_height=d["in_height"],
        in_width=d["in_width"],
        in_channels=d["in_channels"],
        layers=tuple(layers),
    )


def pack_indices(asmt: np.ndarray, num_codewords: int) -> tuple[np.ndarray, int]:
    """Bit-pack uint8/int indices at ceil(log2(K)) bits each (little-endian
    bit order within the stream; cf. the reference's MSB-first page codec,
    FileIO.h:281-350 — layout here is our own, simpler and page-free)."""
    bits = max(1, int(np.ceil(np.log2(max(num_codewords, 2)))))
    flat = np.asarray(asmt, np.uint32).ravel()
    if flat.size and int(flat.max()) >= (1 << bits):
        # the reference codec has exactly this guard (write_cbn); without
        # it an out-of-range index silently truncates to its low bits and
        # round-trips as a DIFFERENT codeword
        raise ValueError(
            f"assignment index {int(flat.max())} does not fit "
            f"{bits} bits (num_codewords={num_codewords})"
        )
    n = flat.size
    # expand to bit matrix (n, bits) then pack
    bitmat = ((flat[:, None] >> np.arange(bits)[None, :]) & 1).astype(np.uint8)
    packed = np.packbits(bitmat.ravel(), bitorder="little")
    return packed, bits


def unpack_indices(
    packed: np.ndarray, bits: int, shape: tuple[int, ...]
) -> np.ndarray:
    n = int(np.prod(shape))
    bitstream = np.unpackbits(
        np.asarray(packed, np.uint8), count=n * bits, bitorder="little"
    )
    bitmat = bitstream.reshape(n, bits).astype(np.uint32)
    vals = (bitmat << np.arange(bits)[None, :]).sum(axis=1, dtype=np.uint32)
    return vals.reshape(shape).astype(np.uint8 if bits <= 8 else np.uint16)


# ---------------------------------------------------------------------------
# Array stores: npz (the default) and dcp (torch.distributed.checkpoint: a
# .metadata file and one .distcp file a rank). Both hold the SAME flat
# {key: array} dict the manifest describes; load detects which is present.
# The JAX package's second store, Orbax/TensorStore (params_ts/: an OCDBT
# B-tree over zarr chunks), has no reader without TensorStore.
# ---------------------------------------------------------------------------

_DCP_DIR = "params_dcp"
_ORBAX_DIR = "params_ts"
_ORBAX_REFUSED = (
    "the orbax array store (params_ts/) is the JAX package's and has no "
    "reader here: save with store='npz' (read by both packages) or "
    "store='dcp' (this package's sharded store)")
_ORBAX_UNREADABLE = (
    "holds only an orbax array store (params_ts/), which this package "
    "cannot read: re-save it with the JAX package's --store npz")


def _in_group() -> bool:
    """Whether a torch.distributed process group is initialised."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _writes_shared_files(store: str) -> bool:
    """Whether this process writes the files every rank would write alike
    (spec, manifest, stale-store removal): always, except in a dcp save
    under a process group, where every rank saves and rank 0 writes them."""
    if store != "dcp" or not _in_group():
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


def _barrier(store: str) -> None:
    """A dcp save under a process group returns on every rank once the
    checkpoint is whole."""
    if store == "dcp" and _in_group():
        import torch.distributed as dist

        dist.barrier()


def check_store(store: str) -> None:
    """Raise unless `store` is one this package writes."""
    if store == "orbax":
        raise NotImplementedError(_ORBAX_REFUSED)
    if store not in ("npz", "dcp"):
        raise ValueError(f"unknown array store {store!r}")


def _write_arrays(path: str, arrays: dict, store: str) -> None:
    # remove the OTHER stores' artifacts too: re-saving into an existing
    # checkpoint dir must not leave a stale copy behind (_read_arrays
    # prefers params.npz, so a stale one would win)
    import shutil

    check_store(store)
    # a dcp save clears its own dir too: a save by more ranks left more
    # .distcp files than this one writes
    stale = {"npz": (_DCP_DIR, _ORBAX_DIR),
             "dcp": ("params.npz", _DCP_DIR, _ORBAX_DIR)}[store]
    if _writes_shared_files(store):
        for name in stale:
            p = os.path.join(path, name)
            if os.path.isdir(p):
                shutil.rmtree(p)
            elif os.path.exists(p):
                os.remove(p)
    if store == "npz":
        np.savez_compressed(os.path.join(path, "params.npz"), **arrays)
        return
    import torch
    import torch.distributed.checkpoint as dcp

    group = _in_group()
    _barrier(store)  # no rank writes before rank 0 has cleared the dir
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in arrays.items()}
    with _single_process_quietly():
        dcp.save(tensors, storage_writer=dcp.FileSystemWriter(
            os.path.join(path, _DCP_DIR)), no_dist=not group)


@contextlib.contextmanager
def _single_process_quietly():
    """dcp warns on every save or load outside a process group that it
    assumes one process: that is what this package asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="torch.distributed is disabled")
        yield


def _write_json(path: str, store: str, spec_d: dict, manifest: dict) -> None:
    """spec.json and manifest.json, as the JAX package writes them; in a dcp
    save under a process group rank 0 writes them and every rank returns
    once they are written."""
    if _writes_shared_files(store):
        with open(os.path.join(path, "spec.json"), "w") as f:
            json.dump(spec_d, f, indent=1)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    _barrier(store)


def _read_dcp(path: str) -> dict:
    """{key: NumPy array} of a dcp store: shapes and dtypes from its
    metadata, tensors allocated on the host and filled by dcp.load. Each
    process reads on its own (no collective), so one rank may load what
    every rank saved."""
    import torch
    import torch.distributed.checkpoint as dcp

    reader = dcp.FileSystemReader(path)
    meta = reader.read_metadata().state_dict_metadata
    tensors = {k: torch.empty(m.size, dtype=m.properties.dtype)
               for k, m in meta.items()}
    with _single_process_quietly():
        dcp.load(tensors, storage_reader=dcp.FileSystemReader(path),
                 no_dist=True)
    return {k: t.numpy() for k, t in tensors.items()}


def _read_arrays(path: str):
    npz = os.path.join(path, "params.npz")
    if os.path.exists(npz):
        return np.load(npz)
    if os.path.isdir(os.path.join(path, _DCP_DIR)):
        return _read_dcp(os.path.join(path, _DCP_DIR))
    if os.path.isdir(os.path.join(path, _ORBAX_DIR)):
        raise NotImplementedError(f"{path} {_ORBAX_UNREADABLE}")
    raise FileNotFoundError(f"no parameter store under {path}")


# ---------------------------------------------------------------------------
# Family checkpoints (ResNet, ViT, Swin, MaxViT): nested-dict params + spec
# ---------------------------------------------------------------------------

# module:class of each family's spec, imported by name on load; the port's
# own modules (the JAX package's table names its own)
_FAMILY_SPECS = {
    "resnet": "qcnn_tpu_torch.models.resnet:ResNetSpec",
    "vit": "qcnn_tpu_torch.models.vit:ViTSpec",
    "swin": "qcnn_tpu_torch.models.swin:SwinSpec",
    "maxvit": "qcnn_tpu_torch.models.maxvit:MaxViTSpec",
}


def _check_family(family: str) -> None:
    if family not in _FAMILY_SPECS:
        raise ValueError(f"unknown family {family!r}")


def _family_spec_cls(family: str):
    import importlib

    _check_family(family)
    mod_name, cls_name = _FAMILY_SPECS[family].split(":")
    return getattr(importlib.import_module(mod_name), cls_name)


def _flatten(params: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def save_family_checkpoint(path: str, family: str, spec, params: dict,
                           *, store: str = "npz") -> None:
    """Checkpoint for the nested-dict model families (models/resnet.py,
    models/vit.py). Assignments are bit-packed like the linear format.
    store='dcp' writes the arrays to a torch.distributed.checkpoint store
    instead of params.npz (load detects it); under a process group every
    rank calls it with the same arrays."""
    _check_family(family)
    os.makedirs(path, exist_ok=True)
    flat = _flatten(params)
    arrays: dict[str, np.ndarray] = {}
    tensor_meta: dict[str, dict] = {}
    for key, arr in flat.items():
        if key.endswith("/assignments") or key == "assignments":
            cb_key = (key[: -len("assignments")] + "codebooks"
                      if key.endswith("/assignments") else "codebooks")
            k = int(flat[cb_key].shape[1])
            packed, bits = pack_indices(arr, k)
            arrays[key] = packed
            tensor_meta[key] = {
                "packed_bits": bits,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
        else:
            arrays[key] = arr
            tensor_meta[key] = {
                "shape": list(arr.shape), "dtype": str(arr.dtype)
            }
    _write_arrays(path, arrays, store)
    _write_json(path, store, {"family": family, **dataclasses.asdict(spec)},
                {"format_version": FORMAT_VERSION, "family": family,
                 "array_store": store, "tensors": tensor_meta})


def load_family_checkpoint(path: str):
    """-> (family, spec, params)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format_version", 1) > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format {manifest['format_version']} is newer than "
            f"supported {FORMAT_VERSION}"
        )
    family = manifest["family"]
    with open(os.path.join(path, "spec.json")) as f:
        spec_d = json.load(f)
    spec_d.pop("family")
    for k, v in spec_d.items():
        if isinstance(v, list):
            spec_d[k] = tuple(v)
    spec = _family_spec_cls(family)(**spec_d)
    data = _read_arrays(path)
    flat = {}
    for key, meta in manifest["tensors"].items():
        arr = data[key]
        if "packed_bits" in meta:
            arr = unpack_indices(
                arr, meta["packed_bits"], tuple(meta["shape"])
            )
        flat[key] = arr
    return family, spec, _unflatten(flat)


def save_preprocessor(path: str, pre) -> None:
    """Embed the preprocessing config so a checkpoint is a self-contained
    serving artifact — the reference instead wires preprocessing per model
    in code (CaffeEvaWrapper.cc:54-85) and loads the mean from a side file.
    Accepts either pipeline kind: Preprocessor (Caffe semantics, mean
    image) or TorchPreprocessor (torch-ecosystem mean/std)."""
    from qcnn_tpu_torch.preproc.pipeline import TorchPreprocessor

    if isinstance(pre, TorchPreprocessor):
        with open(os.path.join(path, "preproc.json"), "w") as f:
            json.dump({
                "kind": "torch",
                "resize": pre.resize, "crop": pre.crop,
                "mean": [float(v) for v in pre.mean],
                "std": [float(v) for v in pre.std],
            }, f)
        return
    np.save(os.path.join(path, "mean_image.npy"), pre.mean_image)
    with open(os.path.join(path, "preproc.json"), "w") as f:
        json.dump({
            "full_h": pre.full_h, "full_w": pre.full_w,
            "crop_h": pre.crop_h, "crop_w": pre.crop_w,
            "resz_type": pre.resz_type.value,
            "mean_type": pre.mean_type.value,
        }, f)


def load_preprocessor(path: str):
    """-> Preprocessor | TorchPreprocessor, or None when the checkpoint
    carries no preproc (kind-dispatched on preproc.json)."""
    cfg_path = os.path.join(path, "preproc.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        cfg = json.load(f)
    if cfg.get("kind") == "torch":
        from qcnn_tpu_torch.preproc.pipeline import TorchPreprocessor

        return TorchPreprocessor(
            resize=cfg["resize"], crop=cfg["crop"],
            mean=np.asarray(cfg["mean"], np.float32),
            std=np.asarray(cfg["std"], np.float32),
        )
    from qcnn_tpu_torch.preproc.pipeline import MeanType, Preprocessor, ReszType

    mean = np.load(os.path.join(path, "mean_image.npy"))
    return Preprocessor(
        full_h=cfg["full_h"], full_w=cfg["full_w"],
        crop_h=cfg["crop_h"], crop_w=cfg["crop_w"],
        resz_type=ReszType(cfg["resz_type"]),
        mean_type=MeanType(cfg["mean_type"]),
        mean_image=mean.astype(np.float32),
    )


def save_act_scales(path: str, scales: dict) -> None:
    """Persist static int8 activation scales ({layer_index: scale}, from
    models.calibrate.calibrate_act_scales) as a checkpoint sidecar. Optional:
    int8 loads without it fall back to dynamic per-tensor quantization."""
    with open(os.path.join(path, "act_scales.json"), "w") as f:
        json.dump({str(k): float(v) for k, v in scales.items()}, f)


def load_act_scales(path: str) -> Optional[dict]:
    """-> {layer_index: scale} or None when the checkpoint has no sidecar."""
    p = os.path.join(path, "act_scales.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return {int(k): float(v) for k, v in json.load(f).items()}


def save_checkpoint(
    path: str, spec: ModelSpec, params: Sequence[Optional[dict]],
    *, store: str = "npz"
) -> None:
    """store: 'npz' (params.npz, read by both packages) or 'dcp'
    (params_dcp/, a torch.distributed.checkpoint store; under a process
    group every rank calls this with the same params)."""
    os.makedirs(path, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    layer_meta = []
    for i, p in enumerate(params):
        if p is None:
            layer_meta.append(None)
            continue
        meta: dict = {"tensors": {}}
        for name, value in p.items():
            arr = np.asarray(value)
            key = f"L{i:02d}.{name}"
            if name == "assignments":
                k = int(np.asarray(p["codebooks"]).shape[1])
                packed, bits = pack_indices(arr, k)
                arrays[key] = packed
                meta["tensors"][name] = {
                    "packed_bits": bits,
                    "shape": list(arr.shape),
                    "dtype": str(arr.dtype),
                }
            else:
                arrays[key] = arr
                meta["tensors"][name] = {
                    "shape": list(arr.shape),
                    "dtype": str(arr.dtype),
                }
        layer_meta.append(meta)
    _write_arrays(path, arrays, store)
    _write_json(path, store, spec_to_dict(spec),
                {"format_version": FORMAT_VERSION, "array_store": store,
                 "layers": layer_meta})


def load_checkpoint(path: str) -> tuple[ModelSpec, list]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if "family" in manifest:
        raise ValueError(
            f"{path} is a family checkpoint "
            f"({manifest['family']}); use load_family_checkpoint"
        )
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format {manifest['format_version']} is newer than "
            f"supported {FORMAT_VERSION}"
        )
    with open(os.path.join(path, "spec.json")) as f:
        spec = spec_from_dict(json.load(f))
    data = _read_arrays(path)
    params: list = []
    for i, meta in enumerate(manifest["layers"]):
        if meta is None:
            params.append(None)
            continue
        p = {}
        for name, tmeta in meta["tensors"].items():
            key = f"L{i:02d}.{name}"
            arr = data[key]
            if "packed_bits" in tmeta:
                arr = unpack_indices(
                    arr, tmeta["packed_bits"], tuple(tmeta["shape"])
                )
            p[name] = arr
        params.append(p)
    return spec, params
