"""The quantizer's sums in a fixed order (quantizer/kmeans.cluster_sums,
quantizer/pq._member_sums) against the scatter-add and index-add they
replace, on the CPU.

On the card a scatter-add or an index-add is atomic float adds in an order
that changes from run to run, so one seed gave other codebooks on every
run. The new sums must give the same values as those adds up to the order
of float32 additions: within 1e-6 of the largest sum (float32 sums of up
to a few hundred terms), with counts exact, on random inputs that leave
clusters empty. The card's run-to-run check is ``chip_smoke.py`` phase 12.
"""

import pathlib

import numpy as np
import pytest
import torch

from qcnn_tpu_torch.quantizer import kmeans, pq

REPO = pathlib.Path(__file__).resolve().parent.parent


def _scatter_add_sums(x, assign, k):
    """The k-means update as the quantizer summed it before."""
    s, n, d = x.shape
    sums = torch.zeros((s, k, d), dtype=torch.float32)
    sums.scatter_add_(1, assign[..., None].expand(s, n, d), x)
    counts = torch.zeros((s, k), dtype=torch.float32)
    counts.scatter_add_(1, assign, torch.ones_like(assign,
                                                   dtype=torch.float32))
    return sums, counts[..., None]


def _index_add_sums(resid, assign, k):
    """The error-corrected refit's sums as the quantizer added them before."""
    counts = torch.zeros(k, dtype=torch.float32)
    counts.index_add_(0, assign, torch.ones(assign.shape[0]))
    sums = torch.zeros((resid.shape[0], k), dtype=torch.float32)
    sums.index_add_(1, assign, resid)
    return counts, sums


def _ids(gen, shape, k):
    """Ids that leave the top three clusters and every other one empty
    (plus any that the draw misses)."""
    ids = torch.randint(0, k - 3, shape, generator=gen)
    return torch.where(ids % 2 == 1, ids - 1, ids)


@pytest.mark.parametrize("s,n,k,d", [(5, 300, 32, 4), (3, 1000, 128, 8),
                                     (7, 64, 16, 3), (1, 4096, 32, 1)])
def test_cluster_sums_match_the_scatter_add(s, n, k, d):
    gen = torch.Generator().manual_seed(s * n + k)
    x = torch.randn((s, n, d), generator=gen) * 3.0
    ids = _ids(gen, (s, n), k)
    sums, counts = kmeans.cluster_sums(x, ids, k)
    want_sums, want_counts = _scatter_add_sums(x, ids, k)
    assert sums.shape == (s, k, d) and counts.shape == (s, k, 1)
    assert sums.dtype == counts.dtype == torch.float32
    assert torch.equal(counts, want_counts)
    assert bool((counts[:, k - 3:] == 0).all())
    err = float((sums - want_sums).abs().max())
    assert err <= 1e-6 * float(want_sums.abs().max())
    # empty clusters sum to exactly zero
    assert bool((sums[counts[..., 0] == 0] == 0).all())


@pytest.mark.parametrize("b,n,k", [(32, 4096, 32), (98, 4608, 128),
                                   (5, 70, 16)])
def test_member_sums_match_the_index_add(b, n, k):
    gen = torch.Generator().manual_seed(b + n + k)
    resid = torch.randn((b, n), generator=gen)
    ids = _ids(gen, (n,), k)
    with pq._no_tf32():
        counts, sums = pq._member_sums(resid, ids, k)
    want_counts, want_sums = _index_add_sums(resid, ids, k)
    assert torch.equal(counts, want_counts)
    assert sums.shape == (b, k)
    err = float((sums - want_sums).abs().max())
    assert err <= 1e-6 * float(want_sums.abs().max())


def test_lloyd_step_is_the_same_bits_twice():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((6, 500, 4), generator=gen)
    c = x[:, :16].clone()
    first = kmeans.kmeans_step(c, x)
    second = kmeans.kmeans_step(c, x)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1],
                                                            second[1])


def test_no_atomic_accumulation_is_left_in_the_quantizer():
    text = "\n".join(p.read_text() for p in
                     sorted((REPO / "qcnn_tpu_torch" / "quantizer")
                            .glob("*.py")))
    for word in ("scatter_add", "index_add", "index_put", "accumulate=True",
                 "bincount"):
        assert word not in text, word


def test_subspace_kmeans_matches_its_scatter_add_version(monkeypatch):
    """A whole k-means run with the old update in place of the new one:
    the same ids and centroids within float32 rounding."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 600, 4)).astype(np.float32))
    got = kmeans.subspace_kmeans(torch.Generator().manual_seed(1), x,
                                 num_codewords=16, iters=10)
    monkeypatch.setattr(kmeans, "cluster_sums", _scatter_add_sums)
    want = kmeans.subspace_kmeans(torch.Generator().manual_seed(1), x,
                                  num_codewords=16, iters=10)
    assert torch.equal(got.assignments, want.assignments)
    np.testing.assert_allclose(got.centroids.numpy(),
                               want.centroids.numpy(), rtol=0, atol=1e-6)
