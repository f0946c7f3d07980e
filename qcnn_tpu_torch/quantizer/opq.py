"""OPQ-style input-dimension permutation for product quantization.

A copy of ``qcnn_tpu/quantizer/opq.py`` (NumPy only, so the same weights
give the same permutation in both packages).

The reference quantizes contiguous D-wide slices of the input dimension
(SURVEY.md §2a; the CVPR'16 scheme). Optimized PQ (Ge et al., CVPR'13)
shows PQ error drops when dimensions are *re-allocated* across sub-spaces
so information is balanced; its non-parametric core, a permutation, costs
one int32 vector per layer:

- decode-at-load execution: folded into the decoded dense weight at
  prepare time (``models/prepare.py``), no cost in the step;
- in-step PQ execution (memory modes): one channel gather of the
  activations per layer (``ops/fc.pq_fc``, ``ops/conv.pq_conv``).

Exactness is preserved: PQ(x[perm]) == W̃_perm · x[perm] == W_eq · x with
W_eq = W̃_perm[:, argsort(perm)].

``variance_permutation`` implements balanced allocation: dimensions sorted
by column variance, greedily assigned to the sub-space with the lowest
accumulated log-variance load (the eigenvalue-allocation heuristic of OPQ
applied to raw dimensions).
"""

from __future__ import annotations

import numpy as np


def variance_permutation(
    w_units_in: np.ndarray, num_subspaces: int
) -> np.ndarray:
    """Balanced variance allocation of input dims to sub-spaces.

    Args:
      w_units_in: (N_units, Cin) weight matrix (rows = PQ samples).
      num_subspaces: S; sub-vector width D = ceil(Cin / S).
    Returns:
      perm: (Cin,) int32 — quantize w[:, perm]; sub-space s covers
      perm[s*D:(s+1)*D]. The last sub-space absorbs the Cin % D overhang
      (matching pq._split_subvectors' tail padding).
    """
    w = np.asarray(w_units_in, np.float64)
    n, cin = w.shape
    s = int(num_subspaces)
    d = -(-cin // s)
    # exact capacities: all groups D wide except trailing ones, which are
    # short by the pad amount so the permuted layout matches the contiguous
    # splitter's tail padding (a fully-padded last sub-space is legal, e.g.
    # Cin=60 at S=16/D=4)
    caps = np.full(s, d, np.int64)
    deficit = d * s - cin
    g = s - 1
    while deficit > 0:
        take = min(deficit, int(caps[g]))
        caps[g] -= take
        deficit -= take
        g -= 1

    var = w.var(axis=0) + 1e-12
    order = np.argsort(-var)  # high variance first
    load = np.zeros(s, np.float64)
    fill = np.zeros(s, np.int64)
    groups: list[list[int]] = [[] for _ in range(s)]
    for dim in order:
        open_mask = fill < caps
        # least-loaded open group takes the next-largest dimension
        g = int(np.flatnonzero(open_mask)[np.argmin(load[open_mask])])
        groups[g].append(int(dim))
        fill[g] += 1
        load[g] += np.log(var[dim])
    perm = np.concatenate([np.asarray(g, np.int64) for g in groups])
    return perm.astype(np.int32)


def inverse_permutation(perm) -> np.ndarray:
    """argsort(perm): maps original dimension index -> permuted position."""
    return np.argsort(np.asarray(perm)).astype(np.int32)
