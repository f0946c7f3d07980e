"""Sharding rules for PQ model parameters and the sharded forward pass.

Port of ``qcnn_tpu/parallel/sharding.py`` on ``torch.distributed``. Two
tensor-parallel layouts for quantized FC layers (fc6 alone outweighs all the
conv weights):

- ``column`` (default): assignments (Cout, S) and bias sharded over Cout on
  the model axis; codebooks replicated. Every rank gathers its slice of the
  output channels; a tiled ``all_gather`` over ``model`` restores the
  activation.
- ``row``: codebooks (S, K, D) and assignments sharded over the sub-space
  axis S. Each rank sums its sub-spaces' partial products; one
  ``all_reduce`` over ``model`` plus the bias gives the output (the PQ
  analogue of a contraction-sharded, Megatron row-parallel GEMM).

Conv parameters are replicated: they are KBs to a few MB and the conv path
is activation-bound.

Where the JAX package lets GSPMD insert the collectives, every rank here
holds its own shards as plain tensors (:func:`shard_params`) and the
forward (:func:`make_sharded_forward`) calls the collectives itself: each
rank runs its ``data`` slice of the batch, each sharded FC runs its shard
through the same ``ops.fc.pq_fc`` impls (the CUDA kernels on the card), and
a final ``all_gather`` over ``data`` hands every rank the whole output.

One difference: an int8 layer without a static ``act_scale`` takes the
dynamic amax of the rank's own rows, where GSPMD reduces it over the whole
batch. Served int8 models carry static scales (``models.calibrate``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard

from qcnn_tpu_torch._device import resolve_device
from qcnn_tpu_torch.core import FCSpec, ModelSpec, is_pq
from qcnn_tpu_torch.models import network
from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.fc import emit, fc_layer
from qcnn_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_gather_cat,
    axis_index,
    axis_size,
    batch_sharding,
    local_shard,
    on_axis,
    replicated,
)

FC_MODES = ("column", "row", "replicated")
_PQ_KEYS = ("codebooks", "assignments", "bias")


def param_shardings(
    spec: ModelSpec,
    params: Sequence[Optional[dict]],
    mesh: DeviceMesh,
    *,
    fc_mode: str = "column",
) -> list:
    """Placements matching the params list: per layer a {key: placements}
    dict (one placement per mesh dimension), None for parameter-free
    layers."""
    if fc_mode not in FC_MODES:
        raise ValueError(f"unknown fc_mode {fc_mode!r}")
    rep = replicated(mesh)
    out: list = []
    tp = axis_size(mesh, MODEL_AXIS)
    for layer, p in zip(spec.layers, params):
        if p is None:
            out.append(None)
            continue
        if isinstance(layer, FCSpec) and is_pq(p) and fc_mode != "replicated":
            cout, s = p["assignments"].shape
            # keys beyond the PQ triple (the OPQ "perm", int8 scale
            # sidecars) replicate
            extra = {k: rep for k in p if k not in _PQ_KEYS}
            if fc_mode == "column" and cout % tp == 0:
                out.append({
                    "codebooks": rep,
                    "assignments": on_axis(mesh, MODEL_AXIS, 0),
                    "bias": on_axis(mesh, MODEL_AXIS, 0),
                    **extra,
                })
                continue
            if fc_mode == "row" and s % tp == 0:
                out.append({
                    "codebooks": on_axis(mesh, MODEL_AXIS, 0),
                    "assignments": on_axis(mesh, MODEL_AXIS, 1),
                    "bias": rep,
                    **extra,
                })
                continue
        # conv params / dense fallbacks / non-divisible shapes: replicate
        out.append({k: rep for k in p})
    return out


class ShardedParams(list):
    """:func:`shard_params`' result: this rank's layer dicts of local
    tensors, with the placements they were cut by (``placements``) and the
    global shape of every tensor (``global_shapes``), from which the
    forward resolves strategies as the unsharded model would."""

    def __init__(self, layers, placements, global_shapes):
        super().__init__(layers)
        self.placements = placements
        self.global_shapes = global_shapes

    @functools.cached_property
    def stand_ins(self) -> list:
        """Layer dicts of shape-only (meta) tensors at the global shapes:
        what ``network.resolve_strategy`` reads, so a shard resolves the
        memory-FC route of the whole layer and batch."""
        return [None if s is None else
                {k: torch.empty(v, device="meta") for k, v in s.items()}
                for s in self.global_shapes]


def _as_tensor(v, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(v, device=device)


def shard_params(
    spec: ModelSpec,
    params: Sequence[Optional[dict]],
    mesh: DeviceMesh,
    *,
    fc_mode: str = "column",
    device=None,
) -> ShardedParams:
    """This rank's shards of ``params`` (raw or ``prepare_params``
    output, tensors or NumPy arrays) on ``device``, as placed by
    :func:`param_shardings`. A cut dimension gives a contiguous copy (the
    kernels take dense buffers); a replicated tensor keeps its layout.

    device: None means "cuda"; pass "cpu" for gloo ranks on the CPU."""
    device = resolve_device(device)
    placements = param_shardings(spec, params, mesh, fc_mode=fc_mode)
    layers, shapes = [], []
    for p, pl in zip(params, placements):
        if p is None:
            layers.append(None)
            shapes.append(None)
            continue
        full = {k: _as_tensor(v, device) for k, v in p.items()}
        layers.append({k: local_shard(v, pl[k], mesh)
                       for k, v in full.items()})
        shapes.append({k: tuple(v.shape) for k, v in full.items()})
    return ShardedParams(layers, placements, shapes)


def _pad_batch(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def data_slice(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a global batch (padded with zero rows to a
    multiple of the data axis: engine bucket 1 on dp=2)."""
    x = _pad_batch(x, axis_size(mesh, DATA_AXIS))
    return local_shard(x, batch_sharding(mesh, x.ndim), mesh)


def gather_batch(out: torch.Tensor, mesh: DeviceMesh, batch: int
                 ) -> torch.Tensor:
    """Every rank's rows over ``data``, cut back to the global batch."""
    return all_gather_cat(out, mesh.get_group(DATA_AXIS), dim=0)[:batch]


def make_dp_forward(forward_fn, mesh: DeviceMesh):
    """Data-parallel wrapper for an arbitrary forward(params, x_nhwc):
    batch sharded over ``data``, params replicated (every rank holds them
    whole). Works for the nested-dict families (ResNet/ViT). The returned
    fn takes the global batch and returns the whole output on every
    rank."""

    def fwd(params, x):
        x = torch.as_tensor(x)
        out = forward_fn(params, data_slice(x, mesh))
        return gather_batch(out, mesh, x.shape[0])

    return fwd


def _fc_mode_of(pl: dict) -> Optional[str]:
    """'column' / 'row' for a sharded PQ FC's placements, else None."""
    if not pl or "assignments" not in pl:
        return None
    for p in pl["assignments"]:
        if isinstance(p, Shard):
            return "column" if p.dim == 0 else "row"
    return None


def column_fc(x: torch.Tensor, p: dict, impl: str, group,
              out_dtype=None) -> torch.Tensor:
    """A column-parallel PQ FC: this rank's output channels (assignments
    and bias cut over Cout) in ``out_dtype``, then a tiled all_gather over
    ``group``."""
    local = fc_layer(x, p, impl=impl, out_dtype=out_dtype)
    return all_gather_cat(local, group, dim=-1)


def row_fc(x: torch.Tensor, p: dict, impl: str, group, index: int, tp: int,
           out_dtype=None) -> torch.Tensor:
    """A row-parallel PQ FC: this rank's sub-spaces (codebooks and
    assignments cut over S) summed in float32, an all_reduce over
    ``group``, then the bias once, emitted in ``out_dtype``. The OPQ
    ``perm`` applies to the full input before the slice; the input is
    zero-padded to the codebooks' span (S*D) first, as
    ``ops.lut.build_lut`` does."""
    if "perm" in p:
        x = torch.index_select(x, -1, p["perm"].long())
    s_local, _, d = p["codebooks"].shape
    x = lut_ops.pad_features(x, s_local * tp * d)
    span = s_local * d
    x = x[:, index * span:(index + 1) * span].contiguous()
    local = {"codebooks": p["codebooks"], "assignments": p["assignments"],
             "bias": torch.zeros(p["bias"].shape, dtype=torch.float32,
                                 device=x.device)}
    partial = fc_layer(x, local, impl=impl, out_dtype=torch.float32)
    dist.all_reduce(partial, group=group)
    return emit(partial + p["bias"].float(), out_dtype)


def make_sharded_forward(
    spec: ModelSpec,
    mesh: DeviceMesh,
    *,
    conv_impl: str = "auto",
    fc_impl: str = "auto",
    fc_mode: str = "column",
    with_softmax: bool = True,
    conv_impls=None,
    fc_impls=None,
    compute_dtype=None,
    device=None,
):
    """Forward with the batch sharded on ``data`` and FC tensors on
    ``model``. The returned fn takes (:func:`shard_params` output, the
    global batch) on every rank and returns the whole (B, classes) float32
    probabilities (or logits) on every rank.

    conv_impls/fc_impls/compute_dtype: the per-layer strategies resolved by
    ``prepare_params`` (against the global ``batch_hint``) and the
    activation dtype; callers that prepared params MUST pass them. Without
    them the strategies resolve per call against the global batch and the
    global shapes, never a shard's. fc_mode is the layout ``shard_params``
    cut; the forward reads it from the params' placements.
    device: None means "cuda"; pass "cpu" for gloo ranks on the CPU."""
    if fc_mode not in FC_MODES:
        raise ValueError(f"unknown fc_mode {fc_mode!r}")
    device = resolve_device(device)
    model_group = mesh.get_group(MODEL_AXIS)
    tp = axis_size(mesh, MODEL_AXIS)
    index = axis_index(mesh, MODEL_AXIS)

    def fwd(params: ShardedParams, x):
        if not isinstance(params, ShardedParams):
            raise TypeError("make_sharded_forward takes shard_params' "
                            "output")
        x = torch.as_tensor(x, device=device)
        batch = x.shape[0]
        plan = network.layer_plan(
            spec, params.stand_ins, batch, conv_impl=conv_impl,
            fc_impl=fc_impl, dtype=compute_dtype, conv_impls=conv_impls,
            fc_impls=fc_impls)
        h = data_slice(x, mesh)
        if compute_dtype is not None:
            h = h.to(compute_dtype)
        pq_convs, decoded = network.step_decode(
            spec, params, [impl for _, _, impl, _ in plan], device)
        for i, layer, impl, first_fc in plan:
            p = pq_convs[i][0] if i in pq_convs else params[i]
            mode = _fc_mode_of(params.placements[i])
            if mode == "column":
                h = column_fc(network.fc_input(h, first_fc), p, impl,
                              model_group, out_dtype=compute_dtype)
            elif mode == "row":
                h = row_fc(network.fc_input(h, first_fc), p, impl,
                           model_group, index, tp, out_dtype=compute_dtype)
            else:
                h = network.apply_layer(
                    layer, p, h, impl, index=i, first_fc=first_fc,
                    compute_dtype=compute_dtype, with_softmax=with_softmax,
                    decoded=decoded.get(i))
        return gather_batch(h, mesh, batch)

    return fwd
