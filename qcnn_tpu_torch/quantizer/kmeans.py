"""Batched sub-space k-means in PyTorch.

Port of ``qcnn_tpu/quantizer/kmeans.py``. All S sub-spaces are clustered
at once: the data is (S, N, D), and every Lloyd iteration is one batched
distance computation and one scatter-add of the members into their
centroids. It runs on the device of its tensors.

The JAX package's random key becomes an explicit ``torch.Generator`` on
that device: :func:`split` takes the place of JAX's key split, and
the D² sampling of the k-means++ seeding draws by inverse CDF.
The draws cannot match JAX's, so a seed reproduces the port's own runs
only, and on the card only up to the order of the scatter-add's atomic
float sums.

Memory: the (S, N, K) distance tensor is formed a chunk of sub-spaces at a
time (:data:`CHUNK_ELEMENTS`), and the update sums with ``scatter_add_``:
at AlexNet fc6 (S = 2304, N = 4096, K = 32) either the whole distance
tensor or a one-hot of the assignments would be 1.2 GB of float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from qcnn_tpu_torch.ops.fc import _no_tf32

# elements of one chunk of the (S, N, K) distance tensor, by device type:
# on the CPU a chunk that stays in cache (4 MB of f32; larger chunks ran
# the assignment 1.2-4x slower on 8 cores), on the card one large enough
# (256 MB) that launches do not dominate
CHUNK_ELEMENTS = {"cpu": 1 << 20, "cuda": 1 << 26}


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # (S, K, D)
    assignments: torch.Tensor  # (S, N) int32
    mse: torch.Tensor          # () mean squared quantization error


def split(gen: torch.Generator) -> torch.Generator:
    """A new generator on ``gen``'s device, seeded by one draw from
    ``gen``: the counterpart of splitting a JAX key."""
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=gen.device)
    return torch.Generator(device=gen.device).manual_seed(int(seed))


def chunk_size(per_row: int, device: torch.device) -> int:
    """Rows of ``per_row`` elements each that one chunk of
    :data:`CHUNK_ELEMENTS` on ``device`` holds (at least one)."""
    return max(1, CHUNK_ELEMENTS[device.type] // max(1, per_row))


def _pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x: (S, N, D), c: (S, K, D) -> (S, N, K) squared distances, in
    float32 without TF32 (TF32 would move assignments)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)            # (S, N, 1)
    c2 = torch.sum(c * c, dim=-1)[:, None, :]              # (S, 1, K)
    d2 = torch.add(x2, c2)
    with _no_tf32():
        return d2.baddbmm_(x, c.transpose(1, 2), alpha=-2.0)


def _assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(S, N) int64 index of the nearest centroid, the first of equals
    (as ``jnp.argmin``)."""
    s, n, _ = x.shape
    step = chunk_size(n * c.shape[1], x.device)
    return torch.cat([_pairwise_sq_dists(x[i:i + step], c[i:i + step])
                      .argmin(dim=-1) for i in range(0, s, step)])


def _update(x: torch.Tensor, assign: torch.Tensor, k: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Member sums (S, K, D) and counts (S, K, 1) per (sub-space, cluster);
    empty clusters keep their previous position via the caller's where()."""
    s, n, d = x.shape
    sums = torch.zeros((s, k, d), dtype=torch.float32, device=x.device)
    sums.scatter_add_(1, assign[..., None].expand(s, n, d), x)
    counts = torch.zeros((s, k), dtype=torch.float32, device=x.device)
    counts.scatter_add_(1, assign, torch.ones_like(assign,
                                                   dtype=torch.float32))
    return sums, counts[..., None]


def _refit(x: torch.Tensor, c: torch.Tensor, assign: torch.Tensor
           ) -> torch.Tensor:
    sums, counts = _update(x, assign, c.shape[1])
    fresh = sums / counts.clamp_min(1.0)
    return torch.where(counts > 0, fresh, c)


def _gather_codewords(c: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    """(S, K, D) centroids at (S, N) ids -> (S, N, D)."""
    return torch.gather(c, 1, assign[..., None].expand(-1, -1, c.shape[2]))


def _init_centroids(gen: torch.Generator, x: torch.Tensor, k: int
                    ) -> torch.Tensor:
    """k-means++ seeding (D² sampling), batched over sub-spaces: the first
    centroid uniform, each next one drawn with probability proportional to
    the squared distance to the nearest chosen one, by inverse CDF as
    JAX's random choice with p= draws (a sub-space whose points all coincide
    with chosen centroids takes its first point, as there)."""
    s, n, d = x.shape
    rows = torch.arange(s, device=x.device)
    xt = x.permute(2, 0, 1).contiguous()                   # (D, S, N)

    def sq_dists(cj):                                      # (S, D) -> (S, N)
        diff = xt - cj.t()[:, :, None]
        return diff.mul_(diff).sum(dim=0)

    idx = torch.randint(0, n, (s,), generator=gen, device=x.device)
    first = x[rows, idx]                                   # (S, D)
    cents = torch.zeros((s, k, d), dtype=x.dtype, device=x.device)
    cents[:, 0] = first
    min_d2 = sq_dists(first)
    for j in range(1, k):
        cdf = min_d2.cumsum(dim=-1)
        u = torch.rand((s, 1), generator=gen, device=x.device)
        idx = torch.searchsorted(cdf, cdf[:, -1:] * (1.0 - u))[:, 0]
        cj = x[rows, idx.clamp_max(n - 1)]
        cents[:, j] = cj
        min_d2 = torch.minimum(min_d2, sq_dists(cj))
    return cents


def _lloyd(x: torch.Tensor, c0: torch.Tensor, iters: int) -> KMeansResult:
    """``iters`` Lloyd iterations from the centroids c0, then the final
    assignment and its mean squared error."""
    c = c0.float()
    for _ in range(iters):
        c = _refit(x, c, _assign(x, c))
    assign = _assign(x, c)
    mse = torch.mean((x - _gather_codewords(c, assign)) ** 2)
    return KMeansResult(c, assign.to(torch.int32), mse)


def subspace_kmeans(
    gen: torch.Generator,
    x: torch.Tensor,
    *,
    num_codewords: int,
    iters: int = 25,
) -> KMeansResult:
    """Cluster each sub-space of x (S, N, D) into ``num_codewords``
    centroids, seeded from ``gen`` (on x's device)."""
    x = x.float()
    return _lloyd(x, _init_centroids(gen, x, num_codewords), iters)


def kmeans_step(c: torch.Tensor, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration (assign + update) from centroids c (S, K, D) on
    x (S, N, D): the new centroids and the mean squared error of x against
    them under the old assignment."""
    assign = _assign(x, c)
    c_new = _refit(x, c, assign)
    mse = torch.mean((x - _gather_codewords(c_new, assign)) ** 2)
    return c_new, mse
