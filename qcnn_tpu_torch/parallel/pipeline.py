"""Pipeline parallelism (GPipe) for the ViT family.

Port of ``qcnn_tpu/parallel/pipeline.py`` on ``torch.distributed``. The
JAX package runs the schedule as one ``shard_map``'d loop over a
("stage",) mesh with ``ppermute`` hops; here each stage is a rank, holds
depth/S consecutive blocks (:func:`place_pipeline_params`), and moves
microbatch activations to the next stage with ``send``/``recv``.

ViT is the natural pipeline target: its blocks are homogeneous, so the
per-block parameters stack into leaves with a leading (depth,) axis that
cuts cleanly over the stages.

Schedule: with S stages and M microbatches the loop runs M + S - 1 ticks.
At tick t, stage s runs microbatch t - s when 0 <= t - s < M: stage 0
takes it from the embedded batch, the others receive it from stage s - 1;
every stage applies its local blocks and hands the result on (the last
stage keeps it). The JAX loop also computes the bubble ticks, on repeated
inputs it then discards; here a stage idles through them. The last stage's
outputs reach every stage by ``broadcast`` (the JAX package's masked
``psum``), and the small head runs replicated. Only the [CLS] token crosses:
the head's LayerNorm is per token and reads that token alone.

Pipeline efficiency is the standard M / (M + S - 1); pick M >= ~4*S.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from qcnn_tpu_torch._device import resolve_device
from qcnn_tpu_torch.models import vit as vit_mod
from qcnn_tpu_torch.models.common import make_cast
from qcnn_tpu_torch.parallel.mesh import (
    axis_index,
    axis_ranks,
    comm_device_type,
    irecv,
    isend,
)

STAGE_AXIS = "stage"


def make_pipeline_mesh(devices: Optional[Sequence[int]] = None, *,
                       stages: Optional[int] = None) -> DeviceMesh:
    """1-D ("stage",) mesh over the first ``stages`` of the given ranks
    (default: all ranks of the default group). Every rank of the group
    calls it; ranks beyond the stages hold no coordinate."""
    if devices is None:
        devices = range(dist.get_world_size())
    ranks = list(devices)
    if stages is None:
        stages = len(ranks)
    if stages > len(ranks):
        # a silently truncated mesh has other parallelism than requested
        raise ValueError(f"{stages} pipeline stages > {len(ranks)} devices")
    return DeviceMesh(comm_device_type(), torch.tensor(ranks[:stages]),
                      mesh_dim_names=(STAGE_AXIS,))


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stack(*leaves):
    """Leaves stacked on a new leading axis. A tensor that is the
    column-major (transpose) view of its memory, as prepared (Cin, Cout)
    weights are, stays so per block."""
    first = leaves[0]
    if not isinstance(first, torch.Tensor):
        return np.stack([np.asarray(v) for v in leaves])
    if first.ndim == 2 and first.stride(0) == 1 and first.stride(1) > 1:
        return torch.stack([v.t() for v in leaves]).transpose(1, 2)
    return torch.stack(leaves)


def stack_vit_blocks(spec, params: dict) -> tuple[dict, dict]:
    """Split a vit params dict into (stacked_blocks, rest).

    stacked_blocks mirrors one block's structure with every leaf gaining a
    leading (depth,) axis; rest carries embed/head params unchanged."""
    blocks = [params[f"blk{i}"] for i in range(spec.depth)]
    stacked = _tree_map(_stack, *blocks)
    rest = {k: v for k, v in params.items() if not k.startswith("blk")}
    return stacked, rest


def _depth(stacked: dict) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def _as_tensor(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


def place_pipeline_params(mesh: DeviceMesh, stacked: dict, rest: dict, *,
                          device=None):
    """This stage's consecutive depth/S blocks of the stacked leaves (a copy
    of its own, strides kept) and the embed/head params, on ``device``. A
    rank outside the mesh keeps no blocks (None).

    device: None means "cuda"; pass "cpu" for gloo ranks on the CPU."""
    device = resolve_device(device)
    s_stages = mesh.size(0)
    depth = _depth(stacked)
    if depth % s_stages:
        raise ValueError(f"depth {depth} not divisible by {s_stages} stages")
    per = depth // s_stages
    rest = _tree_map(lambda v: _as_tensor(v, device), rest)
    if mesh.get_coordinate() is None:
        return None, rest
    lo = axis_index(mesh, STAGE_AXIS) * per
    return (_tree_map(lambda v: _as_tensor(v, device)[lo:lo + per].clone(),
                      stacked),
            rest)


def pipeline_vit_forward(
    mesh: DeviceMesh,
    spec,
    *,
    microbatches: int,
    compute_dtype=None,
    with_softmax: bool = False,
    attn_logits_dtype=None,
):
    """-> fn(stacked_blocks, rest, x) running the blocks pipeline-parallel
    over the mesh's stages; every stage calls it with the global batch x
    (B, H, W, 3) and gets the whole output. Any B runs: it is padded to a
    multiple of ``microbatches`` and cut back. The output matches
    vit.forward on the unstacked params."""
    s_stages = mesh.size(0)
    if spec.depth % s_stages != 0:
        raise ValueError(
            f"depth {spec.depth} not divisible by {s_stages} stages")
    m = microbatches
    if attn_logits_dtype is None and compute_dtype is not None:
        attn_logits_dtype = (torch.bfloat16 if compute_dtype == torch.bfloat16
                             else torch.float32)
    cast = make_cast(compute_dtype)
    if mesh.get_coordinate() is None:
        raise ValueError("this rank holds no stage of the pipeline mesh")
    stage = axis_index(mesh, STAGE_AXIS)
    ranks = axis_ranks(mesh, STAGE_AXIS)
    group = mesh.get_group(STAGE_AXIS)

    def apply_local(blocks, h):
        logits_dtype = attn_logits_dtype or torch.float32
        for j in range(_depth(blocks)):
            blk = _tree_map(lambda v: v[j], blocks)
            h = vit_mod._run_block(h, blk, spec, cast, logits_dtype)
        return h

    def fn(stacked_blocks, rest, x):
        device = rest["pos_embed"].device
        x = torch.as_tensor(x, device=device)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        b = x.shape[0]
        pad = (-b) % m
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        bp = b + pad
        mb = bp // m
        # the embedded microbatch's shape and dtype, known to every stage
        like = torch.empty((mb, spec.seq_len, spec.dim), device=device,
                           dtype=x.dtype)
        if stage == 0:
            x_mb = vit_mod._run_embed(x, rest, spec, cast).reshape(
                m, mb, spec.seq_len, spec.dim)
        cls = torch.empty((m, mb, 1, spec.dim), dtype=x.dtype, device=device)
        sends = []
        for t in range(m + s_stages - 1):
            k = t - stage  # the microbatch this stage runs at tick t
            if not 0 <= k < m:
                continue
            h = x_mb[k] if stage == 0 else irecv(like, ranks[stage - 1]).wait()
            h = apply_local(stacked_blocks, h)
            if stage < s_stages - 1:
                sends.append(isend(h, ranks[stage + 1]))
            else:
                cls[k] = h[:, :1]
        for s in sends:
            s.wait()
        # only the last stage holds real outputs: broadcast them
        dist.broadcast(cls, src=ranks[-1], group=group)
        h = cls.reshape(bp, 1, spec.dim)
        return vit_mod._run_head(h, rest, with_softmax)[:b]

    return fn
