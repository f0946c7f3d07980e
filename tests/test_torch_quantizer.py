"""The port's quantizer (qcnn_tpu_torch.quantizer: kmeans, pq, opq) against
the JAX package's (qcnn_tpu.quantizer) on the same NumPy inputs, on the CPU.

The random draws cannot match (a torch.Generator against a JAX key), so:

- what is deterministic given its inputs is held to the JAX package: the
  OPQ permutation and the sub-vector split bit for bit; one k-means step,
  the Lloyd loop from the same centroids (assignments equal on >= 99.9 %)
  and the Cholesky transform within 1e-5; the error-corrected rounds fed
  the JAX package's own input-weighted fit (assignments equal on >= 99 %,
  response MSE within 1e-3 relative);
- what draws is held on quality, as tests/test_quantizer.py does: k-means
  recovers separated clusters, the error falls with K, error correction
  beats the input-weighted fit, which beats plain k-means, on response
  error, and the port's plain and error-corrected errors are at most 1.25x
  the JAX package's on the same layer.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.ops import decode_fc_weight, pq_fc
from qcnn_tpu.quantizer import kmeans as jkmeans
from qcnn_tpu.quantizer import opq as jopq
from qcnn_tpu.quantizer import pq as jpq
from qcnn_tpu_torch.models import prepare as tprepare
from qcnn_tpu_torch.ops import fc as tfc
from qcnn_tpu_torch.quantizer import kmeans as tkmeans
from qcnn_tpu_torch.quantizer import opq as topq
from qcnn_tpu_torch.quantizer import pq as tpq
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


def T(a):
    return torch.from_numpy(np.array(a))


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def resp_err(w, xcal, codebooks, assignments):
    """||X (W - Ŵ)ᵀ|| / ||X Wᵀ|| of a PQ fit of the (Cout, Cin) weight."""
    w_hat = np.asarray(decode_fc_weight(
        np.asarray(codebooks, np.float32),
        np.asarray(assignments, np.uint8), w.shape[1])).T
    return (np.linalg.norm(xcal @ (w_hat - w).T)
            / np.linalg.norm(xcal @ w.T))


def anisotropic(rng, b, cin, hi=5.0, lo=0.1):
    scales = np.geomspace(hi, lo, cin).astype(np.float32)
    return rng.standard_normal((b, cin)).astype(np.float32) * scales


# ---- bit-equal -----------------------------------------------------------

@pytest.mark.parametrize("n,cin,s", [(40, 32, 8), (30, 60, 16), (25, 7, 3),
                                     (64, 24, 6)])
def test_variance_permutation_bit_equal(rng, n, cin, s):
    w = rng.standard_normal((n, cin)).astype(np.float32) * rng.uniform(
        0.1, 3.0, cin).astype(np.float32)
    want = jopq.variance_permutation(w, s)
    got = topq.variance_permutation(w, s)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(topq.inverse_permutation(got),
                                  jopq.inverse_permutation(want))


@pytest.mark.parametrize("n,cin,s", [(10, 32, 8), (9, 22, 6), (5, 3, 1),
                                     (7, 60, 16)])
def test_split_subvectors_bit_equal(rng, n, cin, s):
    w = rng.standard_normal((n, cin)).astype(np.float32)
    want = np.asarray(jpq._split_subvectors(jnp.asarray(w), s))
    got = tpq._split_subvectors(T(w), s)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prepare_takes_inverse_permutation_from_the_quantizer():
    """The copy that models/prepare.py held is folded into quantizer/opq."""
    assert tprepare.inverse_permutation is topq.inverse_permutation


# ---- deterministic stages at 1e-5 ------------------------------------------

@pytest.mark.parametrize("s,n,k,d", [(5, 300, 16, 4), (3, 200, 32, 8),
                                     (2, 97, 7, 3)])
def test_kmeans_step_matches_jax(rng, s, n, k, d):
    x = rng.standard_normal((s, n, d)).astype(np.float32)
    c = x[:, rng.choice(n, k, replace=False)].copy()
    cj, mj = jkmeans.kmeans_step(jnp.asarray(c), jnp.asarray(x))
    ct, mt = tkmeans.kmeans_step(T(c), T(x))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(mt) - float(mj)) <= 1e-5 * float(mj)


def _jax_lloyd(c, x, iters):
    """The body of qcnn_tpu.quantizer.kmeans.subspace_kmeans from given
    centroids."""
    x = jnp.asarray(x)
    c = jnp.asarray(c)
    for _ in range(iters):
        a = jkmeans._assign(x, c)
        sums, counts = jkmeans._update(x, a, c.shape[1])
        c = jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), c)
    a = jkmeans._assign(x, c)
    q = jnp.take_along_axis(c, a[..., None], axis=1)
    return np.asarray(c), np.asarray(a), float(jnp.mean((x - q) ** 2))


@pytest.mark.parametrize("s,n,k,d,iters", [(5, 300, 16, 4, 20),
                                           (4, 500, 32, 2, 25)])
def test_lloyd_from_the_same_centroids_matches_jax(rng, s, n, k, d, iters):
    x = rng.standard_normal((s, n, d)).astype(np.float32)
    c0 = x[:, rng.choice(n, k, replace=False)].copy()
    cj, aj, mj = _jax_lloyd(c0, x, iters)
    res = tkmeans._lloyd(T(x), T(c0), iters)
    assert res.assignments.dtype == torch.int32
    assert (res.assignments.numpy() == aj).mean() >= 0.999
    np.testing.assert_allclose(res.centroids.numpy(), cj, rtol=1e-5,
                               atol=1e-5)
    assert abs(float(res.mse) - mj) <= 1e-5 * mj


def test_argmin_takes_the_first_of_equal_distances():
    x = torch.zeros((1, 3, 2))
    c = torch.zeros((1, 4, 2))
    assert tkmeans._assign(x, c).tolist() == [[0, 0, 0]]
    assert np.asarray(jkmeans._assign(jnp.zeros((1, 3, 2)),
                                      jnp.zeros((1, 4, 2)))).tolist() == \
        [[0, 0, 0]]


@pytest.mark.parametrize("ridge", [1e-3, 0.1])
def test_chol_transform_matches_jax(rng, ridge):
    xs = anisotropic(rng, 200, 24, 4.0, 0.2)
    want = np.asarray(jpq._chol_transform(
        jpq._split_subvectors(jnp.asarray(xs), 6), ridge))
    got = tpq._chol_transform(tpq._split_subvectors(T(xs), 6), ridge)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cin,cout,s,k,b", [(24, 48, 6, 8, 200),
                                            (32, 64, 8, 16, 256),
                                            (30, 40, 8, 8, 64)])
def test_error_corrected_rounds_fed_from_jax_match_jax(rng, cin, cout, s, k,
                                                       b):
    """The rounds alone, fed JAX's quantize_input_weighted(key) result,
    against JAX's quantize_error_corrected(key): its init is the same
    call, so both walk the same coordinate descent."""
    w = rng.standard_normal((cout, cin)).astype(np.float32)
    xcal = anisotropic(rng, b, cin)
    key = jax.random.key(int(rng.integers(1 << 30)))
    kw = dict(num_subspaces=s, num_codewords=k, iters=15)
    init = jpq.quantize_input_weighted(key, jnp.asarray(w),
                                       jnp.asarray(xcal), **kw)
    want = jpq.quantize_error_corrected(key, jnp.asarray(w),
                                        jnp.asarray(xcal), rounds=3, **kw)
    got = tpq._error_corrected_rounds(
        T(w), T(xcal), T(init.codebooks), T(init.assignments),
        num_subspaces=s, rounds=3, ridge=1e-3)
    assert got.assignments.dtype == torch.int32
    assert got.assignments.shape == (cout, s)
    agree = (got.assignments.numpy() == np.asarray(want.assignments)).mean()
    assert agree >= 0.99
    assert abs(float(got.output_mse) - float(want.output_mse)) <= \
        1e-3 * float(want.output_mse)


# ---- quality ----------------------------------------------------------------

class TestKMeans:
    def test_recovers_separated_clusters(self, rng):
        s, k, d, per = 3, 4, 2, 50
        centers = rng.standard_normal((s, k, d)).astype(np.float32) * 10
        noise = rng.standard_normal((s, k, per, d)).astype(np.float32) * 0.05
        x = (centers[:, :, None, :] + noise).reshape(s, k * per, d)
        res = tkmeans.subspace_kmeans(gen(0), T(x), num_codewords=k,
                                      iters=30)
        assert float(res.mse) < 0.02
        for si in range(s):
            dists = np.linalg.norm(
                res.centroids.numpy()[si][:, None] - centers[si][None],
                axis=-1)
            assert dists.min(axis=1).max() < 0.5

    def test_mse_decreases_with_more_codewords(self, rng):
        x = T(rng.standard_normal((2, 400, 4), dtype=np.float32))
        mses = [float(tkmeans.subspace_kmeans(gen(1), x, num_codewords=k,
                                              iters=20).mse)
                for k in (2, 8, 32)]
        assert mses[0] > mses[1] > mses[2]

    def test_seed_reproduces_and_split_draws_a_new_stream(self, rng):
        x = T(rng.standard_normal((3, 120, 4), dtype=np.float32))
        a = tkmeans.subspace_kmeans(gen(7), x, num_codewords=8, iters=5)
        b = tkmeans.subspace_kmeans(gen(7), x, num_codewords=8, iters=5)
        assert torch.equal(a.centroids, b.centroids)
        g = gen(7)
        child = tkmeans.split(g)
        assert child.device == g.device
        assert child.initial_seed() != 7
        assert tkmeans.split(gen(7)).initial_seed() == child.initial_seed()


class TestPQQuantize:
    def test_fc_roundtrip_through_engine(self, rng):
        cin, cout, s, k = 32, 48, 8, 16
        w = rng.standard_normal((cout, cin)).astype(np.float32)
        bias = rng.standard_normal(cout).astype(np.float32)
        params = tpq.quantize_fc_layer(gen(2), w, bias, num_subspaces=s,
                                       num_codewords=k)
        assert params["codebooks"].shape == (s, k, cin // s)
        assert params["codebooks"].dtype == np.float32
        assert params["assignments"].shape == (cout, s)
        assert params["assignments"].dtype == np.uint8
        w_hat = np.asarray(decode_fc_weight(params["codebooks"],
                                            params["assignments"], cin))
        rel = np.linalg.norm(w_hat.T - w) / np.linalg.norm(w)
        assert rel < 0.9
        x = rng.standard_normal((4, cin)).astype(np.float32)
        want = x @ w_hat + bias
        got_j = np.asarray(pq_fc(jnp.asarray(x), params, impl="onehot"))
        got_t = tfc.pq_fc(T(x), {n: T(v) for n, v in params.items()},
                          impl="decode").numpy()
        np.testing.assert_allclose(got_j, want, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got_t, want, rtol=1e-3, atol=1e-3)

    def test_conv_layout(self, rng):
        cout, cg, kh, kw, s, k = 16, 12, 3, 3, 3, 8
        kern = rng.standard_normal((cout, cg, kh, kw)).astype(np.float32)
        params = tpq.quantize_conv_layer(gen(3), kern,
                                         np.zeros(cout, np.float32),
                                         num_subspaces=s, num_codewords=k)
        assert params["codebooks"].shape == (s, k, cg // s)
        assert params["assignments"].shape == (cout, kh, kw, s)
        assert params["assignments"].dtype == np.uint8

    def test_structured_weights_quantize_well(self, rng):
        cin, cout, s, k = 16, 64, 4, 8
        d = cin // s
        true_cb = rng.standard_normal((s, k, d)).astype(np.float32)
        true_asmt = rng.integers(0, k, (cout, s))
        w = np.concatenate([true_cb[si, true_asmt[:, si]] for si in
                            range(s)], axis=1).astype(np.float32)
        params = tpq.quantize_fc_layer(gen(4), w, np.zeros(cout, np.float32),
                                       num_subspaces=s, num_codewords=k,
                                       iters=40)
        w_hat = np.asarray(decode_fc_weight(params["codebooks"],
                                            params["assignments"], cin)).T
        assert np.linalg.norm(w_hat - w) / np.linalg.norm(w) < 0.15

    @pytest.mark.parametrize("quantize", ["fc", "conv"])
    def test_more_than_256_codewords_raises(self, quantize):
        """uint8 assignments: K > 256 raises ValueError in both packages
        (qcnn_tpu/quantizer/pq.py:276-283)."""
        if quantize == "fc":
            w, fns = np.ones((4, 8), np.float32), (tpq.quantize_fc_layer,
                                                   jpq.quantize_fc_layer)
        else:
            w, fns = np.ones((4, 8, 1, 1), np.float32), (
                tpq.quantize_conv_layer, jpq.quantize_conv_layer)
        for fn, key in zip(fns, (gen(0), jax.random.key(0))):
            with pytest.raises(ValueError, match="<= 256"):
                fn(key, w, np.zeros(4, np.float32), num_subspaces=2,
                   num_codewords=257)

    def test_unknown_opq_method_raises(self):
        w = np.ones((4, 8), np.float32)
        for fn, key in ((tpq.quantize_fc_layer, gen(0)),
                        (jpq.quantize_fc_layer, jax.random.key(0))):
            with pytest.raises(ValueError, match="unknown opq method"):
                fn(key, w, np.zeros(4, np.float32), num_subspaces=2,
                   num_codewords=2, opq="rotation")

    def test_ec_only_kwargs_are_dropped_without_calibration(self, rng):
        w = rng.standard_normal((12, 8)).astype(np.float32)
        for fn, key in ((tpq.quantize_fc_layer, gen(0)),
                        (jpq.quantize_fc_layer, jax.random.key(0))):
            p = fn(key, w, np.zeros(12, np.float32), num_subspaces=2,
                   num_codewords=4, rounds=5, ridge=0.1, iters=3)
            assert p["assignments"].shape == (12, 2)


class TestErrorCorrected:
    def test_ec_beats_input_weighted_beats_plain(self):
        """On response error: error-corrected < input-weighted < plain, on
        the anisotropic calibration data of tests/test_quantizer.py."""
        rng = np.random.default_rng(20260817)
        cin, cout, s, k, b = 32, 64, 8, 8, 256
        w = rng.standard_normal((cout, cin)).astype(np.float32)
        xcal = anisotropic(rng, b, cin)
        plain = tpq.quantize_plain(gen(5), T(w), num_subspaces=s,
                                   num_codewords=k)
        iw = tpq.quantize_input_weighted(gen(5), T(w), T(xcal),
                                         num_subspaces=s, num_codewords=k)
        ec = tpq.quantize_error_corrected(gen(5), T(w), T(xcal),
                                          num_subspaces=s, num_codewords=k,
                                          rounds=3)
        errs = [resp_err(w, xcal, r.codebooks, r.assignments)
                for r in (ec, iw, plain)]
        assert errs[0] < errs[1] < errs[2], errs
        assert errs[0] < errs[2] * 0.98
        assert np.isfinite(float(iw.output_mse))
        assert iw.codebooks.shape == (s, k, cin // s)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_errors_within_a_quarter_of_jax(self, seed):
        """The port's plain (weight MSE) and error-corrected (response
        error) fits of one layer are at most 1.25x the JAX package's."""
        rng = np.random.default_rng(seed)
        cin, cout, s, k, b = 32, 64, 8, 16, 256
        w = rng.standard_normal((cout, cin)).astype(np.float32)
        xcal = anisotropic(rng, b, cin)
        key = jax.random.key(seed)
        jp = jpq.quantize_plain(key, jnp.asarray(w), num_subspaces=s,
                                num_codewords=k)
        tp = tpq.quantize_plain(gen(seed), T(w), num_subspaces=s,
                                num_codewords=k)
        assert float(tp.output_mse) <= 1.25 * float(jp.output_mse)
        je = jpq.quantize_error_corrected(key, jnp.asarray(w),
                                          jnp.asarray(xcal),
                                          num_subspaces=s, num_codewords=k)
        te = tpq.quantize_error_corrected(gen(seed), T(w), T(xcal),
                                          num_subspaces=s, num_codewords=k)
        assert float(te.output_mse) <= 1.25 * float(je.output_mse)
        assert resp_err(w, xcal, te.codebooks, te.assignments) <= \
            1.25 * resp_err(w, xcal, je.codebooks, je.assignments)


class TestOPQ:
    def test_guard_drops_a_regressing_permutation_with_a_warning(self):
        """A weight whose contiguous split is the right one (each
        sub-space holds exactly k distinct codewords): the variance
        permutation mixes them and loses, so the guard keeps the
        contiguous fit, warns, and stores no perm."""
        rng = np.random.default_rng(3)
        s, k, d, cout = 4, 4, 4, 64
        cb = rng.standard_normal((s, k, d)).astype(np.float32)
        cb *= np.array([8.0, 4.0, 1.0, 0.1], np.float32)[:, None, None]
        asmt = rng.integers(0, k, (cout, s))
        w = np.concatenate([cb[si, asmt[:, si]] for si in range(s)],
                           axis=1).astype(np.float32)
        with pytest.warns(UserWarning, match="regressed"):
            p = tpq.quantize_fc_layer(gen(0), w, np.zeros(cout, np.float32),
                                      num_subspaces=s, num_codewords=k,
                                      opq="variance", iters=30)
        assert "perm" not in p
        with pytest.warns(UserWarning, match="regressed"):
            jp = jpq.quantize_fc_layer(jax.random.key(0), w,
                                       np.zeros(cout, np.float32),
                                       num_subspaces=s, num_codewords=k,
                                       opq="variance", iters=30)
        assert "perm" not in jp

    @pytest.mark.parametrize("calib", [False, True])
    def test_kept_permutation_is_carried_into_prepare(self, rng, calib):
        """A layer whose high-variance dims share one contiguous sub-space:
        the permutation wins and rides in "perm"; the port's decode at
        load folds it back and its forward matches the JAX package's on
        the same params."""
        from qcnn_tpu.core import FCSpec as JFC
        from qcnn_tpu.core import ModelSpec as JSpec
        from qcnn_tpu.core import SoftmaxSpec as JSM
        from qcnn_tpu.models import network as jnet
        from qcnn_tpu_torch.core import FCSpec, ModelSpec, SoftmaxSpec
        from qcnn_tpu_torch.models import network as tnet

        cin, cout, s, k = 16, 48, 4, 4
        scale = np.array([6.0] * 4 + [0.2] * 12, np.float32)
        w = rng.standard_normal((cout, cin)).astype(np.float32) * scale
        xcal = rng.standard_normal((64, cin)).astype(np.float32) \
            if calib else None
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            p = tpq.quantize_fc_layer(gen(1), w, np.zeros(cout, np.float32),
                                      num_subspaces=s, num_codewords=k,
                                      xcal=xcal, opq="variance")
        assert p["perm"].dtype == np.int32
        np.testing.assert_array_equal(p["perm"],
                                      topq.variance_permutation(w, s))
        jspec = JSpec(name="o", in_height=1, in_width=1, in_channels=cin,
                      layers=(JFC(cout), JSM()))
        tspec = ModelSpec(name="o", in_height=1, in_width=1,
                          in_channels=cin,
                          layers=(FCSpec(cout), SoftmaxSpec()))
        x = rng.standard_normal((3, 1, 1, cin)).astype(np.float32)
        want = np.asarray(jnet.forward([p, None], x, spec=jspec))
        prepared, ci, fi = tprepare.prepare_params(
            tspec, [p, None], dtype=torch.float32, device="cpu")
        got = tnet.forward(prepared, x, spec=tspec, conv_impls=ci,
                           fc_impls=fi, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        got = tnet.forward([p, None], x, spec=tspec,
                           fc_impl="indecode", device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
