"""The network executor: the forward pass over a ModelSpec.

Port of ``qcnn_tpu/models/network.py`` (the reference's CaffeEva dispatch
loop, CaffeEva.cc:151-260, :625-670). Whole batches flow through each layer;
the per-layer PQ strategy is chosen up front, in :func:`layer_plan`, the
one walk of a spec that ``forward``, ``parallel.make_sharded_forward`` and
``eval.profiler.profile_layers`` iterate.

Layout contract: ``forward`` takes NHWC ``(B, H, W, C)`` and returns
``(B, classes)``; the first FC flattens in NCHW order to match the Caffe
weight layout (CaffeEva.cc:184-204). Inside, convolutions and pools run on
the NCHW ``channels_last`` view of the same memory (ops/conv.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from qcnn_tpu_torch._device import resolve_device
from qcnn_tpu_torch.core import (
    ConvSpec,
    DropoutSpec,
    FCSpec,
    LRNSpec,
    ModelSpec,
    PoolSpec,
    ReLUSpec,
    SoftmaxSpec,
    is_pq,
)
from qcnn_tpu_torch.models import common
from qcnn_tpu_torch.ops.conv import conv_layer, instep_decodes
from qcnn_tpu_torch.ops.fc import fc_layer
from qcnn_tpu_torch.ops.misc import (
    caffe_max_pool,
    dropout_inference,
    lrn,
    relu,
    softmax,
)
from qcnn_tpu_torch.utils.spans import span

# The request-level strategy vocabulary of the JAX package
# (qcnn_tpu/models/network.py:59-63); every name runs.
CONV_IMPLS = ("auto", "decode", "indecode", "indecode_ohwi", "indecode_hwoi",
              "gdecode", "gdecode_iohw", "gemm", "lut", "memory",
              "fusedconv", "memory_fused", "fc1x1")
FC_IMPLS = ("auto", "onehot", "gather", "decode", "indecode", "gdecode",
            "pallas", "fused", "fgather", "lutgather", "memory")


def resolve_strategy(
    spec: ModelSpec,
    params: Sequence[Optional[dict]],
    batch: int,
    conv_impl: str = "auto",
    fc_impl: str = "auto",
    dtype=None,
) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """Resolve ('auto' | explicit) strategy names per layer index, as the
    JAX package does: 'auto' -> 'decode'; conv 'memory' -> 'indecode_ohwi';
    fc 'memory' -> models.common.fc_memory_impl.

    dtype: the execution dtype (a torch dtype); the fc 'memory' rule keeps
    f32 runs on the exact in-step decode."""
    if conv_impl not in CONV_IMPLS:
        raise ValueError(
            f"unknown conv impl {conv_impl!r}; expected one of {CONV_IMPLS}"
        )
    if fc_impl not in FC_IMPLS:
        raise ValueError(
            f"unknown fc impl {fc_impl!r}; expected one of {FC_IMPLS}"
        )
    conv_choices = []
    fc_choices = []
    for layer, p in zip(spec.layers, params):
        if isinstance(layer, ConvSpec):
            if not is_pq(p):
                conv_choices.append("dense")
            elif conv_impl == "auto":
                conv_choices.append("decode")
            elif conv_impl == "memory":
                conv_choices.append("indecode_ohwi")
            else:
                conv_choices.append(conv_impl)
            fc_choices.append("-")
        elif isinstance(layer, FCSpec):
            if not is_pq(p):
                fc_choices.append("dense")
            elif fc_impl == "auto":
                fc_choices.append("decode")
            elif fc_impl == "memory":
                fc_choices.append(common.fc_memory_impl(batch, p, dtype))
            else:
                fc_choices.append(fc_impl)
            conv_choices.append("-")
        else:
            conv_choices.append("-")
            fc_choices.append("-")
    return tuple(conv_choices), tuple(fc_choices)


def _to_device(p: Optional[dict], device: torch.device) -> Optional[dict]:
    """Layer params as tensors on ``device`` (a no-op for prepared params
    already there; NumPy arrays are copied over)."""
    if p is None:
        return None
    out = {}
    for key, v in p.items():
        if isinstance(v, torch.Tensor):
            out[key] = v.to(device)
        else:
            out[key] = torch.as_tensor(np.asarray(v), device=device)
    return out


def layer_plan(
    spec: ModelSpec,
    params: Sequence[Optional[dict]],
    batch: int,
    *,
    conv_impl: str = "auto",
    fc_impl: str = "auto",
    dtype=None,
    conv_impls: Optional[Sequence[str]] = None,
    fc_impls: Optional[Sequence[str]] = None,
) -> list[tuple[int, object, str, bool]]:
    """The walk of a forward over ``spec``: (index, layer, impl, first_fc)
    for every layer, impl its resolved strategy ('-' for a layer without
    weights) and first_fc True for the first FC, which flattens NCHW
    (:func:`fc_input`).

    conv_impls/fc_impls: pre-resolved per-layer strategies; a side left
    None resolves with :func:`resolve_strategy` on ``params`` (their
    shapes only: a sharded forward hands it stand-ins of the global
    shapes) at ``batch`` in ``dtype`` (float32 when None)."""
    if conv_impls is None or fc_impls is None:
        # resolve only the missing side — a caller passing one
        # pre-resolved tuple must not have it silently discarded
        conv_r, fc_r = resolve_strategy(
            spec, params, batch, conv_impl, fc_impl,
            dtype=dtype if dtype is not None else torch.float32)
        conv_impls = conv_impls if conv_impls is not None else conv_r
        fc_impls = fc_impls if fc_impls is not None else fc_r
    plan, first_fc_done = [], False
    for i, layer in enumerate(spec.layers):
        first_fc = isinstance(layer, FCSpec) and not first_fc_done
        first_fc_done = first_fc_done or first_fc
        impl = (conv_impls[i] if isinstance(layer, ConvSpec)
                else fc_impls[i] if isinstance(layer, FCSpec) else "-")
        plan.append((i, layer, impl, first_fc))
    return plan


def step_decode(spec: ModelSpec, params: Sequence[Optional[dict]],
                impls: Sequence[str], device: torch.device,
                upto: Optional[int] = None) -> tuple[dict, dict]:
    """The step's grouped decode: ({layer index: (params on ``device``,
    impl, channels per group)} of the PQ convs before layer ``upto``, and
    their weights from ``ops.conv.instep_decodes``, which decodes those of
    an in-step impl in one launch at the start of the step).

    impls: each layer's strategy (a plan's, or a conv_impls tuple; only
    the convs' are read)."""
    shapes = spec.feature_shapes(batch=1)
    convs = {
        i: (_to_device(params[i], device), impls[i],
            shapes[i][3] // layer.groups)
        for i, layer in enumerate(spec.layers[:upto])
        if isinstance(layer, ConvSpec) and impls[i] != "dense"}
    return convs, instep_decodes(convs)


def fc_input(x: torch.Tensor, first_fc: bool) -> torch.Tensor:
    """An FC's (B, features) input; the first FC flattens NHWC in NCHW
    order to match the Caffe weight layout (CaffeEva.cc:184-204)."""
    if first_fc:
        x = x.permute(0, 3, 1, 2)
    return x.reshape(x.shape[0], -1)


def apply_layer(layer, p: Optional[dict], x: torch.Tensor, impl: str, *,
                index: int, first_fc: bool = False, compute_dtype=None,
                with_softmax: bool = True,
                decoded: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer of :func:`forward`: ``index`` is the layer's place in the
    spec, which names its span (``utils.spans``); ``impl`` its resolved
    strategy ('dense' for prepared or int8 weights), ``decoded`` its weight
    from the step's grouped decode (:func:`step_decode`; None decodes in
    the layer). A conv or FC emits ``compute_dtype`` (int8 codes stay
    codes)."""
    if isinstance(layer, ConvSpec):
        with span("conv", index):
            return conv_layer(x, p, impl=impl, stride=layer.stride,
                              pad=layer.pad, groups=layer.groups,
                              out_dtype=compute_dtype, decoded=decoded)
    if isinstance(layer, FCSpec):
        with span("fc", index):
            return fc_layer(fc_input(x, first_fc), p, impl=impl,
                            out_dtype=compute_dtype)
    if isinstance(layer, PoolSpec):
        with span("pool", index):
            return caffe_max_pool(x, kernel=layer.kernel,
                                  stride=layer.stride, pad=layer.pad)
    if isinstance(layer, ReLUSpec):
        with span("relu", index):
            return relu(x)
    if isinstance(layer, LRNSpec):
        with span("lrn", index):
            return lrn(x, size=layer.size, alpha=layer.alpha,
                       beta=layer.beta, k=layer.k,
                       channel_map=layer.channel_map,
                       sum_dtype=compute_dtype)
    if isinstance(layer, DropoutSpec):
        return dropout_inference(x)
    if isinstance(layer, SoftmaxSpec):
        if not with_softmax:
            return x
        with span("softmax", index):
            return softmax(x.float())
    raise TypeError(f"unhandled layer spec: {layer!r}")


def forward(
    params: Sequence[Optional[dict]],
    x,
    *,
    spec: ModelSpec,
    conv_impl: str = "auto",
    fc_impl: str = "auto",
    with_softmax: bool = True,
    compute_dtype=None,
    conv_impls: Optional[tuple[str, ...]] = None,
    fc_impls: Optional[tuple[str, ...]] = None,
    collect_act_amax: bool = False,
    upto: Optional[int] = None,
    device=None,
):
    """Run the full forward pass.

    Args:
      params: one entry per layer; dict for conv/fc (PQ, dense, or int8
        with ``kernel_q`` / ``weight_q``), None for parameter-free layers
        (``prepare_params`` output, or raw params).
      x: (B, H, W, C) NHWC activations (tensor or NumPy array).
      compute_dtype: activation dtype between layers (bf16 for int8
        params, ``prepare.act_dtype_for``); None keeps x's dtype and
        resolves strategies as float32, as the JAX package does. Sums and
        the softmax stay float32. int8 layers take and may emit int8 codes
        (their ``out_scale``), which relu, pool, dropout and flatten pass
        on as codes.
      conv_impls/fc_impls: pre-resolved per-layer strategies (from
        models.prepare.prepare_params); override conv_impl/fc_impl.
      collect_act_amax: also return {layer_index: amax(|input|)} for every
        conv/FC layer.
      upto: stop and return the activation ENTERING layer ``upto``.
      device: None means "cuda"; pass "cpu" to run the plain versions on
        the CPU.
    Returns:
      (B, num_classes) float32 probabilities (or logits if
      with_softmax=False); with collect_act_amax, a (probs, amax_dict).
    """
    with span("forward"):
        device = resolve_device(device)
        x = torch.as_tensor(x, device=device)
        if x.ndim != 4:
            raise ValueError(
                f"expected NHWC input, got shape {tuple(x.shape)}")
        plan = layer_plan(spec, params, x.shape[0], conv_impl=conv_impl,
                          fc_impl=fc_impl, dtype=compute_dtype,
                          conv_impls=conv_impls, fc_impls=fc_impls)
        if compute_dtype is not None:
            x = x.to(compute_dtype)

        act_amax: dict[int, torch.Tensor] = {}

        # every PQ conv that decodes in the step, in one launch at its start
        pq_convs, decoded = step_decode(
            spec, params, [impl for _, _, impl, _ in plan], device, upto)
        for i, layer, impl, first_fc in plan:
            if i == upto:
                return x
            p = (pq_convs[i][0] if i in pq_convs
                 else _to_device(params[i], device))
            if collect_act_amax and isinstance(layer, (ConvSpec, FCSpec)):
                act_amax[i] = x.float().abs().amax()
            x = apply_layer(layer, p, x, impl, index=i, first_fc=first_fc,
                            compute_dtype=compute_dtype,
                            with_softmax=with_softmax,
                            decoded=decoded.get(i))
        if collect_act_amax:
            return x, act_amax
        return x


def make_forward_fn(
    spec: ModelSpec,
    *,
    conv_impl: str = "auto",
    fc_impl: str = "auto",
    with_softmax: bool = True,
    donate_input: bool = False,
    compute_dtype=None,
    conv_impls: Optional[tuple[str, ...]] = None,
    fc_impls: Optional[tuple[str, ...]] = None,
    device=None,
):
    """A forward(params, x) closure for a fixed spec and strategy (PyTorch
    runs eagerly; there is nothing to compile). donate_input is taken for
    the JAX package's signature and has no effect: the forward never
    writes into x."""
    del donate_input
    return functools.partial(
        forward,
        spec=spec,
        conv_impl=conv_impl,
        fc_impl=fc_impl,
        with_softmax=with_softmax,
        compute_dtype=compute_dtype,
        conv_impls=conv_impls,
        fc_impls=fc_impls,
        device=device,
    )


def top_k_labels(probs: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Top-k class indices per example, best first and the lower index
    first among equal values, as ``lax.top_k`` (CvtFeatMapToLablVec,
    CaffeEva.cc:1162-1190, without the destructive zero-out)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    return order[..., :k]
