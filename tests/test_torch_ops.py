"""Layer parity: the port's ops (qcnn_tpu_torch.ops, plain PyTorch on the
CPU) against the JAX package's (qcnn_tpu.ops) on the same NumPy inputs.

Tolerances: float32 paths within 1e-5 relative (sums in another order);
decodes bit-exact; bf16 emits within one bf16 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.ops import conv as jconv
from qcnn_tpu.ops import fc as jfc
from qcnn_tpu.ops import lut as jlut
from qcnn_tpu.ops import misc as jmisc
from qcnn_tpu_torch.ops import conv as tconv
from qcnn_tpu_torch.ops import fc as tfc
from qcnn_tpu_torch.ops import lut as tlut
from qcnn_tpu_torch.ops import misc as tmisc
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, rtol=1e-5):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1e-6, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("h,w,kernel,stride,pad,ceil_mode", [
    (13, 13, 3, 2, 0, True),    # AlexNet pool5
    (55, 54, 3, 2, 0, True),    # ceil adds a clamped border window
    (5, 5, 2, 2, 1, True),      # padded ceil pool: Caffe's clamp fires
    (7, 6, 3, 2, 1, True),
    (8, 8, 3, 2, 1, False),     # floor rule (ResNet stem)
])
def test_caffe_max_pool(rng, h, w, kernel, stride, pad, ceil_mode):
    x = rng.standard_normal((2, h, w, 5)).astype(np.float32)
    want = np.asarray(jmisc.caffe_max_pool(
        x, kernel=kernel, stride=stride, pad=pad, ceil_mode=ceil_mode))
    got = tmisc.caffe_max_pool(T(x), kernel=kernel, stride=stride, pad=pad,
                               ceil_mode=ceil_mode)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["jnp", "band", "auto"])
@pytest.mark.parametrize("beta", [0.75, 0.5, 1.0, 0.6])
def test_lrn_f32(rng, impl, beta):
    x = rng.standard_normal((2, 3, 4, 24)).astype(np.float32) * 3
    kw = dict(size=5, alpha=1e-2, beta=beta, k=2.0)
    want = np.asarray(jmisc.lrn(x, impl=impl, **kw))
    got = tmisc.lrn(T(x), impl=impl, **kw)
    close(got, want)


def test_lrn_band_bf16_window_sum(rng):
    """bf16 input, window sum materialised in bf16 (the band impl's
    sum_dtype, as network.forward passes it)."""
    x = rng.standard_normal((2, 3, 3, 32)).astype(np.float32)
    kw = dict(size=5, alpha=1e-4, beta=0.75, k=1.0, impl="band")
    want = np.asarray(jmisc.lrn(jnp.asarray(x, jnp.bfloat16),
                                sum_dtype=jnp.bfloat16, **kw), np.float32)
    got = tmisc.lrn(T(x).to(torch.bfloat16), sum_dtype=torch.bfloat16, **kw)
    assert got.dtype == torch.bfloat16
    close(got, want, rtol=1e-2)


def test_lrn_channel_map(rng):
    x = rng.standard_normal((1, 2, 2, 8)).astype(np.float32)
    cmap = (0, 1, 2, -1, 3, 4, 5, -1)
    kw = dict(size=3, alpha=1e-1, beta=0.75, k=1.0, channel_map=cmap)
    close(tmisc.lrn(T(x), **kw), np.asarray(jmisc.lrn(x, **kw)))


@pytest.mark.parametrize("mod", [jmisc, tmisc])
def test_lrn_even_size_raises(mod):
    x = np.zeros((1, 1, 1, 8), np.float32)
    arg = T(x) if mod is tmisc else x
    with pytest.raises(ValueError, match="odd window size"):
        mod.lrn(arg, size=4, alpha=1e-4, beta=0.75, k=1.0)


def test_relu_softmax_dropout(rng):
    x = rng.standard_normal((3, 7)).astype(np.float32)
    np.testing.assert_array_equal(tmisc.relu(T(x)).numpy(),
                                  np.asarray(jmisc.relu(x)))
    close(tmisc.softmax(T(x)), np.asarray(jmisc.softmax(x)))
    assert tmisc.dropout_inference(T(x)) is not None
    codes = torch.tensor([-3, 0, 5], dtype=torch.int8)
    assert tmisc.relu(codes).dtype == torch.int8
    assert tmisc.relu(T(x).to(torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("cin,s,k,d", [(64, 16, 32, 4), (58, 15, 32, 4),
                                       (3, 1, 128, 8)])
def test_build_lut(rng, cin, s, k, d):
    x = rng.standard_normal((4, cin)).astype(np.float32)
    cb = rng.standard_normal((s, k, d)).astype(np.float32)
    close(tlut.build_lut(T(x), T(cb)), np.asarray(jlut.build_lut(x, cb)))


def test_pad_features_overhang_raises():
    with pytest.raises(ValueError, match="exceed codebook span"):
        tlut.pad_features(torch.zeros(2, 9), 8)


@pytest.mark.parametrize("cout,s,k,d,cin", [(256, 16, 32, 4, 64),
                                            (250, 15, 32, 4, 58),
                                            (128, 64, 16, 1, 64)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_decode_fc_weight_bit_exact(rng, cout, s, k, d, cin, dtype):
    cb = rng.standard_normal((s, k, d)).astype(np.float32)
    asmt = rng.integers(0, k, size=(cout, s), dtype=np.uint8)
    if dtype == "bfloat16":
        jcb, tcb = jnp.asarray(cb, jnp.bfloat16), T(cb).to(torch.bfloat16)
    else:
        jcb, tcb = jnp.asarray(cb), T(cb)
    want = np.asarray(jlut.decode_fc_weight(jcb, asmt, cin), np.float32)
    got = tlut.decode_fc_weight(tcb, T(asmt), cin)
    assert got.dtype == tcb.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("cout,kh,kw,s,k,d,cg", [(96, 11, 11, 1, 32, 8, 3),
                                                 (64, 3, 3, 16, 128, 4, 64),
                                                 (40, 1, 1, 9, 16, 4, 36)])
def test_decode_conv_kernel_bit_exact(rng, cout, kh, kw, s, k, d, cg):
    cb = rng.standard_normal((s, k, d)).astype(np.float32)
    asmt = rng.integers(0, k, size=(cout, kh, kw, s), dtype=np.uint8)
    want = np.asarray(jlut.decode_conv_kernel(jnp.asarray(cb), asmt, cg))
    got = tlut.decode_conv_kernel(T(cb), T(asmt), cg)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("groups,stride,pad", [(1, 1, 0), (2, 1, 1),
                                               (1, 4, 0), (2, 2, 2)])
def test_conv_dense(rng, groups, stride, pad):
    x = rng.standard_normal((2, 11, 10, 8)).astype(np.float32)
    kern = rng.standard_normal((3, 3, 8 // groups, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    kw = dict(stride=stride, pad=pad, groups=groups)
    want = np.asarray(jconv.conv_dense(x, kern, bias, **kw))
    close(tconv.conv_dense(T(x), T(kern), T(bias), **kw), want)


@pytest.mark.parametrize("layout", ["OHWI", "IOHW", "HWOI"])
def test_conv_dense_kernel_layouts(rng, layout):
    x = rng.standard_normal((2, 7, 7, 4)).astype(np.float32)
    hwio = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    kern = np.transpose(hwio, ["HWIO".index(c) for c in layout])
    want = np.asarray(jconv.conv_dense(x, kern, bias, stride=1, pad=1,
                                       kernel_layout=layout))
    close(tconv.conv_dense(T(x), T(kern), T(bias), stride=1, pad=1,
                           kernel_layout=layout), want)


def test_conv_dense_bf16_out_dtype(rng):
    """bf16 kernel, bf16 emit: the bias adds in bf16 on both sides."""
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    kern = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    want = np.asarray(jconv.conv_dense(
        x, jnp.asarray(kern, jnp.bfloat16), bias, stride=1, pad=1, groups=2,
        out_dtype=jnp.bfloat16), np.float32)
    got = tconv.conv_dense(T(x), T(kern).to(torch.bfloat16), T(bias),
                           stride=1, pad=1, groups=2,
                           out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    close(got, want, rtol=1e-2)


def test_conv_dense_rejects_int8_codes():
    x = torch.zeros((1, 4, 4, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 activation codes"):
        tconv.conv_dense(x, torch.zeros(3, 3, 2, 2), torch.zeros(2),
                         stride=1, pad=1)


def test_fc_dense(rng):
    x = rng.standard_normal((5, 40)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    close(tfc.fc_dense(T(x), T(w), T(b)), np.asarray(jfc.fc_dense(x, w, b)))
    want = np.asarray(jfc.fc_dense(x, jnp.asarray(w, jnp.bfloat16), b,
                                   out_dtype=jnp.bfloat16), np.float32)
    got = tfc.fc_dense(T(x), T(w).to(torch.bfloat16), T(b),
                       out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    close(got, want, rtol=1e-2)


def test_fc_dense_rejects_int8_codes():
    with pytest.raises(ValueError, match="int8 activation codes"):
        tfc.fc_dense(torch.zeros((2, 4), dtype=torch.int8),
                     torch.zeros(4, 3), torch.zeros(3))


def _fc_params(rng, cin, cout, s, k, d, perm):
    p = {
        "codebooks": rng.standard_normal((s, k, d)).astype(np.float32),
        "assignments": rng.integers(0, k, size=(cout, s), dtype=np.uint8),
        "bias": rng.standard_normal(cout).astype(np.float32),
    }
    if perm:
        p["perm"] = rng.permutation(cin).astype(np.int32)
    return p


def _torch_params(p):
    return {k: T(v) for k, v in p.items()}


@pytest.mark.parametrize("impl", ["onehot", "gather", "decode", "indecode",
                                  "gdecode", "lutgather", "fused", "fgather"])
@pytest.mark.parametrize("perm", [False, True])
def test_pq_fc_impls(rng, impl, perm):
    """Every pq_fc impl the port has, with and without the OPQ perm, against
    the JAX impl of the same name (Pallas ones in interpret mode). The fused
    impls compute in bf16 on both sides: 1e-4 relative."""
    x = rng.standard_normal((3, 58)).astype(np.float32)
    p = _fc_params(rng, 58, 70, 15, 32, 4, perm)
    want = np.asarray(jfc.pq_fc(x, p, impl=impl))
    got = tfc.pq_fc(T(x), _torch_params(p), impl=impl)
    close(got, want, rtol=1e-4 if impl in ("fused", "fgather") else 1e-5)


@pytest.mark.parametrize("impl", ["decode", "indecode", "indecode_ohwi",
                                  "indecode_hwoi", "gdecode", "gdecode_iohw"])
@pytest.mark.parametrize("perm", [False, True])
def test_pq_conv_impls(rng, impl, perm):
    s, k, d, cout, groups = 6, 16, 4, 12, 2
    cg = 22  # < S*D: the last sub-space overhangs
    p = {
        "codebooks": rng.standard_normal((s, k, d)).astype(np.float32),
        "assignments": rng.integers(0, k, size=(cout, 3, 3, s),
                                    dtype=np.uint8),
        "bias": rng.standard_normal(cout).astype(np.float32),
    }
    if perm:
        p["perm"] = rng.permutation(cg).astype(np.int32)
    x = rng.standard_normal((2, 9, 8, cg * groups)).astype(np.float32)
    kw = dict(stride=2, pad=1, groups=groups)
    want = np.asarray(jconv.pq_conv(x, p, impl=impl, **kw))
    close(tconv.pq_conv(T(x), _torch_params(p), impl=impl, **kw), want)


@pytest.mark.parametrize("impl", ["lut", "gemm", "memory"])
def test_unported_conv_impls_raise(impl):
    """No conv impl is left unported: 'lut', 'gemm' and 'memory', the last
    three, run and give the JAX package's output (1e-5);
    tests/test_torch_conv_strategies.py holds them at more shapes."""
    p = {"codebooks": np.ones((1, 4, 4), np.float32),
         "bias": np.arange(2, dtype=np.float32),
         "assignments": np.zeros((2, 1, 1, 1), dtype=np.uint8)}
    x = np.arange(16, dtype=np.float32).reshape(1, 2, 2, 4)
    want = np.asarray(jconv.pq_conv(x, p, stride=1, pad=0, impl=impl))
    got = tconv.pq_conv(T(x), _torch_params(p), stride=1, pad=0, impl=impl)
    close(got, want)


@pytest.mark.parametrize("impl", ["onehot"])
def test_unported_fc_impls_raise(impl):
    """No fc impl is left unported: 'onehot', the last, runs and is the
    default, as in the JAX package, and honours out_dtype as there."""
    p = {"codebooks": torch.ones(1, 4, 4), "bias": torch.zeros(2),
         "assignments": torch.zeros((2, 1), dtype=torch.uint8)}
    out = tfc.pq_fc(torch.ones(1, 4), p, impl=impl)
    assert out.tolist() == [[4.0, 4.0]]
    assert tfc.pq_fc(torch.ones(1, 4), p).tolist() == out.tolist()
    bf = tfc.pq_fc(torch.ones(1, 4), p, out_dtype=torch.bfloat16)
    jbf = jfc.pq_fc(jnp.ones((1, 4)), {k: v.numpy() for k, v in p.items()},
                    out_dtype=jnp.bfloat16)
    assert bf.dtype == torch.bfloat16 and str(jbf.dtype) == "bfloat16"


@pytest.mark.parametrize("impl", ["indecode", "gdecode"])
def test_pq_fc_at_256_codewords(rng, impl):
    """K = 256 (uint8 ids): 'indecode' runs the pq_decode kernel's plain
    version and matches the JAX one-hot decode (1e-5); 'gdecode' keeps the
    JAX Pallas gather's K <= 128 and raises on both sides."""
    x = rng.standard_normal((3, 58)).astype(np.float32)
    p = _fc_params(rng, 58, 70, 15, 256, 4, False)
    if impl == "gdecode":
        with pytest.raises(ValueError, match="K <= 128"):
            jfc.pq_fc(x, p, impl=impl)
        with pytest.raises(ValueError, match="K <= 128"):
            tfc.pq_fc(T(x), _torch_params(p), impl=impl)
        return
    want = np.asarray(jfc.pq_fc(x, p, impl=impl))
    close(tfc.pq_fc(T(x), _torch_params(p), impl=impl), want)


@pytest.mark.parametrize("impl", ["indecode_ohwi", "gdecode_iohw"])
def test_pq_conv_at_256_codewords(rng, impl):
    """As above for the conv: 'indecode_ohwi' matches the JAX one-hot decode
    at K = 256, 'gdecode_iohw' raises on both sides."""
    p = {"codebooks": rng.standard_normal((6, 256, 4)).astype(np.float32),
         "assignments": rng.integers(0, 256, size=(12, 3, 3, 6),
                                     dtype=np.uint8),
         "bias": rng.standard_normal(12).astype(np.float32)}
    x = rng.standard_normal((2, 9, 8, 44)).astype(np.float32)
    kw = dict(stride=2, pad=1, groups=2, impl=impl)
    if impl == "gdecode_iohw":
        with pytest.raises(ValueError, match="K <= 128"):
            jconv.pq_conv(x, p, **kw)
        with pytest.raises(ValueError, match="K <= 128"):
            tconv.pq_conv(T(x), _torch_params(p), **kw)
        return
    want = np.asarray(jconv.pq_conv(x, p, **kw))
    close(tconv.pq_conv(T(x), _torch_params(p), **kw), want)


def test_unknown_impls_raise():
    p = {"codebooks": torch.zeros(1, 4, 4), "bias": torch.zeros(2),
         "assignments": torch.zeros((2, 1), dtype=torch.uint8)}
    with pytest.raises(ValueError, match="unknown pq_fc impl"):
        tfc.pq_fc(torch.zeros(1, 4), p, impl="nope")
    with pytest.raises(ValueError, match="unknown pq_conv impl"):
        tconv.pq_conv(torch.zeros(1, 2, 2, 4), p, stride=1, pad=0,
                      impl="nope")
