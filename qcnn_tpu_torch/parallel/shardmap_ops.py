"""Explicit-collective tensor-parallel PQ FCs, and the process group's
bring-up.

Port of ``qcnn_tpu/parallel/shardmap_ops.py``. The JAX package maps a
function over the mesh with ``shard_map``; here every rank runs the
returned function on the same global arguments, cuts its own block, and
calls the collectives itself:

- row-parallel PQ FC: codebooks/assignments cut over the sub-space axis;
  each rank sums its S/TP sub-spaces; one ``all_reduce`` over ``model``
  gives the output (Megatron row-parallel, contraction sharded).
- column-parallel PQ FC: assignments cut over output channels; each rank
  computes its Cout/TP slice; a tiled ``all_gather`` over ``model``
  restores the full activation.

The per-shard sums go through ``ops.fc.pq_fc`` with any of its impl names,
so on the card a shard runs the CUDA kernel of its impl (``lutgather``,
``fgather``, ``fused``, ``pallas``, the in-step decodes). Each function
returns the whole (B, Cout) float32 output on every rank (the JAX
``out_specs=P(data, None)`` read as one array).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.cuda import pq_lut_gather
from qcnn_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    all_gather_cat,
    axis_index,
    axis_ranks,
    axis_size,
    exchange,
)
from qcnn_tpu_torch.parallel.sharding import (
    column_fc,
    data_slice,
    gather_batch,
    row_fc,
)


def _check_subspaces(s: int, tp: int) -> None:
    if s % tp:
        raise ValueError(
            f"S={s} sub-spaces do not split over tp={tp}: pad S to a "
            f"multiple of tp with all-zero codebooks (their sub-spaces add "
            f"exact zeros)")


def row_parallel_pq_fc(mesh: DeviceMesh, *, impl: str = "onehot"):
    """fn(x, codebooks, assignments, bias) with codebooks (S,K,D) and
    assignments (Cout,S) cut over S on the ``model`` axis and x over batch
    on ``data``; returns the whole output on every rank.

    Sharding S requires S % tp == 0 (callers pad; padded sub-spaces carry
    all-zero codebooks and contribute exact zeros)."""
    tp = axis_size(mesh, MODEL_AXIS)
    index = axis_index(mesh, MODEL_AXIS)
    group = mesh.get_group(MODEL_AXIS)

    def fn(x, codebooks, assignments, bias):
        s = codebooks.shape[0]
        _check_subspaces(s, tp)
        span = s // tp
        p = {"codebooks": codebooks[index * span:(index + 1) * span],
             "assignments":
                 assignments[:, index * span:(index + 1) * span].contiguous(),
             "bias": bias}
        out = row_fc(data_slice(x, mesh), p, impl, group, index, tp)
        return gather_batch(out, mesh, x.shape[0])

    return fn


def column_parallel_pq_fc(mesh: DeviceMesh, *, impl: str = "onehot"):
    """fn(x, codebooks, assignments, bias): assignments (Cout,S) and bias
    cut over Cout on ``model``; the output all-gathered to full Cout and
    over ``data`` to the whole batch."""
    tp = axis_size(mesh, MODEL_AXIS)
    index = axis_index(mesh, MODEL_AXIS)
    group = mesh.get_group(MODEL_AXIS)

    def fn(x, codebooks, assignments, bias):
        chunk = assignments.shape[0] // tp
        if chunk * tp != assignments.shape[0]:
            raise ValueError(f"Cout={assignments.shape[0]} does not split "
                             f"over tp={tp}")
        rows = slice(index * chunk, (index + 1) * chunk)
        p = {"codebooks": codebooks, "assignments": assignments[rows],
             "bias": bias[rows]}
        out = column_fc(data_slice(x, mesh), p, impl, group)
        return gather_batch(out.float(), mesh, x.shape[0])

    return fn


def _chunk_partial(lut: torch.Tensor, assignments: torch.Tensor,
                   c: int, chunk: int) -> torch.Tensor:
    """This rank's contribution to output chunk ``c``: the LUT gather over
    its local sub-spaces (the ``pq_lut_gather`` kernel on the card, its
    plain version on the CPU; the JAX package's one-hot einsum computes
    the same sums)."""
    rows = assignments[c * chunk:(c + 1) * chunk]
    zeros = torch.zeros(chunk, dtype=torch.float32, device=lut.device)
    return pq_lut_gather.lut_gather(lut, rows, zeros)


def row_parallel_pq_fc_overlapped(mesh: DeviceMesh):
    """Row-parallel PQ FC with the reduction pipelined against compute.

    The plain row-parallel form computes the FULL local partial and then
    blocks on one all_reduce: the collective is fully exposed. Here the
    output axis is split into tp chunks and the reduction runs as a ring
    reduce-scatter interleaved with compute: at step t, rank i

      1. posts the send of its in-flight chunk to its ring neighbour and
         the receive from the other (``isend``/``irecv``), and
      2. gather-accumulates its OWN contribution to the chunk arriving
         next (the LUT built once),

    then adds (1)'s payload to (2). Per step only Cout/tp channels cross
    instead of all of Cout. A final tiled all_gather restores the full
    activation.

    Chunk schedule: rank i contributes to chunk (i + tp-1 - t) mod tp at
    step t, so after tp-1 hops chunk i lands fully reduced on rank i and
    the tiled all_gather needs no reorder.

    Requires Cout % tp == 0 and S % tp == 0 (callers pad; padded
    sub-spaces hold zero codebooks -> exact zeros)."""
    tp = axis_size(mesh, MODEL_AXIS)
    i = axis_index(mesh, MODEL_AXIS)
    ring = axis_ranks(mesh, MODEL_AXIS)
    right, left = ring[(i + 1) % tp], ring[(i - 1) % tp]
    group = mesh.get_group(MODEL_AXIS)

    def fn(x, codebooks, assignments, bias):
        s, _, d = codebooks.shape
        cout = assignments.shape[0]
        _check_subspaces(s, tp)
        if cout % tp:
            raise ValueError(f"Cout={cout} does not split over tp={tp}")
        span, chunk = s // tp, cout // tp
        xs = lut_ops.pad_features(data_slice(x, mesh), s * d)
        xs = xs[:, i * span * d:(i + 1) * span * d]
        local_a = assignments[:, i * span:(i + 1) * span].contiguous()
        lut = lut_ops.build_lut(
            xs, codebooks[i * span:(i + 1) * span]).contiguous()
        buf = _chunk_partial(lut, local_a, (i + tp - 1) % tp, chunk)
        for t in range(1, tp):
            arriving = exchange(buf, right, left)
            mine = _chunk_partial(lut, local_a, (i + tp - 1 - t) % tp, chunk)
            buf = arriving.wait() + mine
        # rank i now holds fully-reduced chunk i
        buf = buf + bias[i * chunk:(i + 1) * chunk].float()
        out = all_gather_cat(buf, group, dim=-1)
        return gather_batch(out, mesh, x.shape[0])

    return fn


def choose_backend(num_processes: int) -> str:
    """NCCL when each rank on this host can own a card of it, gloo
    otherwise (CPU ranks, or ranks sharing a card). The ranks on this host
    are ``LOCAL_WORLD_SIZE`` where a launcher such as ``torchrun`` sets it,
    else all ``num_processes``."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def init_method(coordinator: str) -> str:
    """A coordinator "host:port" as a ``tcp://`` URL; a URL passes as is
    (``file://`` stores need no free port)."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Process-group bring-up: every rank calls this before building a
    mesh. ``coordinator`` is rank 0's "host:port" (or a ``tcp://`` /
    ``file://`` URL); None reads ``MASTER_ADDR``/``MASTER_PORT``, and
    ``num_processes``/``process_id`` default to ``WORLD_SIZE``/``RANK``
    (``torchrun``'s variables). The backend is :func:`choose_backend`'s;
    under NCCL each rank takes card ``process_id % device_count``."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    backend = choose_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=(init_method(coordinator) if coordinator is not None
                     else "env://"),
        world_size=num_processes, rank=process_id)
