"""Device mesh construction, axis conventions and the collectives over them.

Port of ``qcnn_tpu/parallel/mesh.py`` on ``torch.distributed``. The design
is process-per-device SPMD: every process (a rank of the default process
group) runs the same program on its own device, and a mesh is a
``DeviceMesh`` over those ranks with the JAX package's axis names:

- ``data``  : batch dimension (data parallelism);
- ``model`` : tensor parallelism, FC output channels (column-parallel) or
              PQ sub-spaces (row-parallel).

The JAX package's ``NamedSharding`` becomes a tuple of placements, one per
mesh dimension (``Shard(dim)`` or ``Replicate()``).

Collectives. NCCL takes CUDA tensors only; gloo takes CPU tensors, and of
CUDA tensors only in ``all_reduce`` and ``broadcast``, which the callers
call directly. The other collectives of CUDA tensors on a gloo group
(``all_gather``, ``send``, ``recv``) go through host copies here. That
staging is chosen from the group's backend by name (:func:`host_staged`)
and logged once per operation; it is never the answer to a caught error.
Only activations cross: the FC and conv compute stays on the device.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
MODEL_AXIS = "model"

_log = logging.getLogger(__name__)
_logged: set = set()


def comm_device_type() -> str:
    """The mesh's device type: 'cuda' under NCCL, 'cpu' under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(
    devices: Optional[Sequence[int]] = None,
    *,
    dp: Optional[int] = None,
    tp: Optional[int] = None,
) -> DeviceMesh:
    """Build a (data, model) mesh over the given ranks of the default group
    (default: all of them). Every rank of the group calls it.

    Defaults: all ranks on the data axis (pure DP) unless dp/tp given."""
    if devices is None:
        devices = range(dist.get_world_size())
    ranks = list(devices)
    n = len(ranks)
    if dp is None and tp is None:
        dp, tp = n, 1
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != device count {n}")
    return DeviceMesh(comm_device_type(),
                      torch.tensor(ranks).reshape(dp, tp),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_ranks(mesh: DeviceMesh, axis: str) -> list[int]:
    """The global ranks along ``axis`` through this rank, in axis order."""
    return dist.get_process_group_ranks(mesh.get_group(axis))


def batch_sharding(mesh: DeviceMesh, ndim: int = 4) -> tuple:
    """Activations sharded over batch on the data axis (ndim: the
    activations' rank, kept for the JAX signature; a placement names only
    the sharded dimension)."""
    return tuple(Shard(0) if name == DATA_AXIS else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def on_axis(mesh: DeviceMesh, axis: str, dim: int) -> tuple:
    """Tensor dimension ``dim`` sharded over ``axis``, replicated over the
    other axes (the JAX ``P(..., axis, ...)``)."""
    return tuple(Shard(dim) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def local_shard(value: torch.Tensor, placements: tuple,
                mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of a global tensor under ``placements``: contiguous
    where a dimension was cut (the kernels take dense row-major buffers),
    the tensor itself where it is replicated."""
    coord = mesh.get_coordinate()
    out = value
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.mesh.shape[i]
            size = out.shape[pl.dim] // n
            out = out.narrow(pl.dim, coord[i] * size, size)
    return out if out is value else out.contiguous()


# -- collectives -----------------------------------------------------------

def host_staged(op: str, t: torch.Tensor, group=None) -> bool:
    """Whether ``op`` (all_gather, send or recv) of ``t`` on ``group`` goes
    through a host copy: a CUDA tensor on a gloo group."""
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    if staged and op not in _logged:
        _logged.add(op)
        _log.info("gloo group: %s of CUDA tensors goes through host copies",
                  op)
    return staged


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0
                   ) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order
    (the JAX ``all_gather(..., tiled=True)``)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    staged = host_staged("all_gather", t, group)
    src = t.cpu() if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


class _Recv:
    """Posted point-to-point work: ``wait()`` returns the received tensor
    on its device."""

    def __init__(self, works, buf: torch.Tensor, device: torch.device,
                 keep: Optional[torch.Tensor] = None):
        self._works, self._buf, self._device = works, buf, device
        self._keep = keep  # a send's (host) buffer, alive until the wait

    def wait(self) -> Optional[torch.Tensor]:
        for work in self._works:
            work.wait()
        self._keep = None
        return None if self._buf is None else self._buf.to(self._device)


def isend(t: torch.Tensor, dst: int) -> _Recv:
    """Post a send of ``t`` to global rank ``dst``."""
    buf = t.cpu() if host_staged("send", t) else t.contiguous()
    return _Recv([dist.isend(buf, dst)], None, t.device, keep=buf)


def irecv(like: torch.Tensor, src: int) -> _Recv:
    """Post a receive from global rank ``src`` into a new tensor of
    ``like``'s shape, dtype and device."""
    staged = host_staged("recv", like)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if staged else like.device)
    return _Recv([dist.irecv(buf, src)], buf, like.device)


def exchange(t: torch.Tensor, dst: int, src: int) -> _Recv:
    """Post, as one group, a send of ``t`` to global rank ``dst`` and a
    receive of a tensor like it from ``src`` (a ring step: under NCCL two
    separate calls could each wait on the other's peer)."""
    staged = host_staged("send", t)
    out = t.cpu() if staged else t.contiguous()
    buf = torch.empty_like(out)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, out, dst),
                                    dist.P2POp(dist.irecv, buf, src)])
    return _Recv(works, buf, t.device, keep=out)
