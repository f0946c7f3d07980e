"""The conv strategies that the port added last (ops/conv.py: 'lut', 'gemm',
the per-op 'memory' mix, conv_dense(space_to_depth=)) against the JAX
package's, on the CPU and the same NumPy inputs.

Tolerances: float32 within 1e-5 of the largest |output| (sums in another
order); bf16 within 2e-2 of the largest |output|. The JAX package's 'lut'
raises for a bf16 out_dtype (its float32 LUT contraction cannot emit a
narrower type, lax.conv_general_dilated's rule), so the port's bf16 'lut'
is held to the JAX package's float32 one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from qcnn_tpu.core import (
    ConvSpec as JConv, FCSpec as JFC, ModelSpec as JSpec, PoolSpec as JPool,
    ReLUSpec as JReLU, SoftmaxSpec as JSM,
)
from qcnn_tpu.models import network as jnet
from qcnn_tpu.models import synth as jsynth
from qcnn_tpu.ops import conv as jconv
from qcnn_tpu.ops import lut as jlut
from qcnn_tpu_torch.core import (
    ConvSpec, FCSpec, ModelSpec, PoolSpec, ReLUSpec, SoftmaxSpec,
)
from qcnn_tpu_torch.models import network as tnet
from qcnn_tpu_torch.ops import conv as tconv
from qcnn_tpu_torch.ops import lut as tlut
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1e-6, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _params(rng, cout, kh, s, k, d, perm_len=0):
    p = {"codebooks": rng.standard_normal((s, k, d)).astype(np.float32),
         "assignments": rng.integers(0, k, size=(cout, kh, kh, s),
                                     dtype=np.uint8),
         "bias": rng.standard_normal(cout).astype(np.float32)}
    if perm_len:
        p["perm"] = rng.permutation(perm_len).astype(np.int32)
    return p


# (impl, groups, stride, pad, kh, K, cg, perm): strided and padded cases,
# groups=2 for 'lut' and 'memory', K = 256 for 'gemm', the OPQ perm
CASES = [
    ("lut", 1, 1, 0, 3, 16, 22, False),
    ("lut", 2, 2, 1, 3, 16, 22, False),
    ("lut", 2, 1, 1, 3, 32, 16, True),
    ("lut", 1, 4, 0, 5, 8, 3, False),
    ("gemm", 1, 1, 1, 3, 16, 22, False),
    ("gemm", 1, 2, 1, 3, 256, 22, False),
    ("gemm", 1, 2, 0, 5, 128, 12, True),
    ("gemm", 1, 1, 0, 1, 16, 24, False),
    ("memory", 1, 1, 1, 3, 16, 22, False),     # gemm wins
    ("memory", 2, 2, 1, 3, 16, 22, False),     # grouped: OHWI decode
    ("memory", 1, 1, 0, 1, 16, 24, True),      # 1x1: OHWI decode
    ("memory", 1, 2, 1, 3, 256, 22, False),
]


@pytest.mark.parametrize("impl,groups,stride,pad,kh,k,cg,perm", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pq_conv_strategy_matches_jax(rng, impl, groups, stride, pad, kh, k,
                                      cg, perm, dtype):
    s, d, cout = -(-cg // 4), 4, 12
    p = _params(rng, cout, kh, s, k, d, cg if perm else 0)
    x = rng.standard_normal((2, 9, 8, cg * groups)).astype(np.float32)
    kw = dict(stride=stride, pad=pad, groups=groups, impl=impl)
    tp = {n: T(v) for n, v in p.items()}
    if dtype == "float32":
        want = np.asarray(jconv.pq_conv(x, p, **kw))
        close(tconv.pq_conv(T(x), tp, **kw), want, 1e-5)
        return
    jp = dict(p, codebooks=jnp.asarray(p["codebooks"], jnp.bfloat16))
    jout = None if impl == "lut" else jnp.bfloat16
    want = jconv.pq_conv(jnp.asarray(x, jnp.bfloat16), jp, out_dtype=jout,
                         **kw)
    tp["codebooks"] = tp["codebooks"].bfloat16()
    got = tconv.pq_conv(T(x).bfloat16(), tp, out_dtype=torch.bfloat16, **kw)
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want, np.float32), 2e-2)


def test_jax_lut_raises_for_a_bf16_out_dtype_where_the_port_emits_it(rng):
    p = _params(rng, 12, 3, 4, 16, 4)
    x = rng.standard_normal((1, 6, 6, 16)).astype(np.float32)
    with pytest.raises(TypeError, match="preferred_element_type"):
        jconv.pq_conv(x, p, stride=1, pad=1, impl="lut",
                      out_dtype=jnp.bfloat16)
    got = tconv.pq_conv(T(x), {n: T(v) for n, v in p.items()}, stride=1,
                        pad=1, impl="lut", out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 6, 6, 12)


def test_gemm_rejects_groups_as_jax(rng):
    p = _params(rng, 12, 3, 6, 16, 4)
    x = rng.standard_normal((1, 6, 6, 44)).astype(np.float32)
    with pytest.raises(ValueError, match="groups == 1"):
        jconv.pq_conv(x, p, stride=1, pad=1, groups=2, impl="gemm")
    with pytest.raises(ValueError, match="groups == 1"):
        tconv.pq_conv(T(x), {n: T(v) for n, v in p.items()}, stride=1,
                      pad=1, groups=2, impl="gemm")


@pytest.mark.parametrize("kh,stride,pad", [(3, 1, 1), (5, 2, 0), (11, 4, 0),
                                           (3, 2, 1)])
def test_unfold_feature_order_is_conv_general_dilated_patches(rng, kh,
                                                              stride, pad):
    """pq_conv_gemm's patches: F.unfold on the NCHW view gives the (C, kh,
    kw) feature order of lax.conv_general_dilated_patches, bit for bit."""
    x = rng.standard_normal((2, 13, 12, 5)).astype(np.float32)
    want = np.asarray(lax.conv_general_dilated_patches(
        x, (kh, kh), (stride, stride), [(pad, pad), (pad, pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    cols = torch.nn.functional.unfold(T(x).permute(0, 3, 1, 2), (kh, kh),
                                      padding=pad, stride=stride)
    got = cols.transpose(1, 2).reshape(want.shape)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gemm_wins_over_a_grid_of_shapes():
    n = 0
    for b in (1, 8, 64):
        for hw in (7, 13, 27, 56):
            for cin, cout in ((3, 96), (64, 64), (256, 384), (512, 512)):
                for kh in (1, 3, 5, 11):
                    for groups in (1, 2):
                        for stride, pad in ((1, 0), (1, 1), (2, 1), (4, 0)):
                            if hw + 2 * pad < kh:
                                continue
                            args = ((b, hw, hw, cin), cout, kh, kh, groups,
                                    stride, pad)
                            assert tconv._gemm_wins(*args) == \
                                jconv._gemm_wins(*args), args
                            n += 1
    assert n > 1000


def test_assignments_one_hot_matches_jax(rng):
    a = rng.integers(0, 16, size=(5, 3, 3, 4), dtype=np.uint8)
    want = np.asarray(jlut.assignments_one_hot(a, 16))
    got = tlut.assignments_one_hot(T(a), 16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# (H, W, Cin, k, stride, pad, groups): the first two take the transform
# (AlexNet conv1's 11x11/s4, a ragged (H - k) % stride); the others do not
# qualify and run the plain conv in both packages
S2D = [(35, 37, 3, 11, 4, 0, 1), (30, 31, 3, 7, 2, 0, 1),
       (35, 37, 3, 11, 4, 1, 1), (16, 16, 8, 3, 2, 0, 1),
       (16, 16, 4, 3, 2, 0, 2), (16, 16, 3, 3, 1, 0, 1)]


@pytest.mark.parametrize("h,w,cin,k,stride,pad,groups", S2D)
def test_conv_dense_space_to_depth_matches_jax(rng, h, w, cin, k, stride,
                                               pad, groups):
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    kern = rng.standard_normal((k, k, cin // groups, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    kw = dict(stride=stride, pad=pad, groups=groups, space_to_depth=True)
    want = np.asarray(jconv.conv_dense(x, kern, b, **kw))
    got = tconv.conv_dense(T(x), T(kern), T(b), **kw)
    close(got, want, 1e-5)
    plain = tconv.conv_dense(T(x), T(kern), T(b), stride=stride, pad=pad,
                             groups=groups)
    close(got, plain.numpy(), 1e-5)


def test_space_to_depth_transform_matches_jax(rng):
    x = rng.standard_normal((1, 35, 37, 3)).astype(np.float32)
    kern = rng.standard_normal((11, 11, 3, 4)).astype(np.float32)
    jx, jk = jconv._space_to_depth_transform(jnp.asarray(x),
                                             jnp.asarray(kern), 4)
    tx, tk = tconv._space_to_depth_transform(T(x), T(kern), 4)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def _specs():
    layers = dict(
        conv=lambda C: (C(kernel=5, out_channels=16, stride=2),
                        C(kernel=3, out_channels=24, pad=1, groups=2),
                        C(kernel=3, out_channels=24, pad=1)))
    j = JSpec(name="a4", in_height=19, in_width=19, in_channels=3, layers=(
        *layers["conv"](JConv)[:1], JReLU(), JPool(kernel=3, stride=2),
        *layers["conv"](JConv)[1:2], JReLU(), *layers["conv"](JConv)[2:],
        JReLU(), JFC(10), JSM()))
    t = ModelSpec(name="a4", in_height=19, in_width=19, in_channels=3,
                  layers=(*layers["conv"](ConvSpec)[:1], ReLUSpec(),
                          PoolSpec(kernel=3, stride=2),
                          *layers["conv"](ConvSpec)[1:2], ReLUSpec(),
                          *layers["conv"](ConvSpec)[2:], ReLUSpec(),
                          FCSpec(10), SoftmaxSpec()))
    return j, t


@pytest.mark.parametrize("conv_impl", ["lut", "memory"])
def test_network_forward_conv_strategy_matches_jax(conv_impl):
    """A small grouped net through network.forward with the strategy for
    every conv, against the JAX package's forward (logits, f32, 1e-5)."""
    jspec, tspec = _specs()
    params = jsynth.random_pq_params(jspec, seed=0)
    x = jsynth.random_input(jspec, batch=2, seed=1)
    want = np.asarray(jnet.forward(params, x, spec=jspec,
                                   conv_impl=conv_impl, with_softmax=False))
    got = tnet.forward(params, x, spec=tspec, conv_impl=conv_impl,
                       with_softmax=False, device="cpu")
    close(got, want, 1e-5)


def test_network_forward_gemm_raises_on_a_grouped_conv_as_jax():
    jspec, tspec = _specs()
    params = jsynth.random_pq_params(jspec, seed=0)
    x = jsynth.random_input(jspec, batch=1, seed=1)
    with pytest.raises(ValueError, match="groups == 1"):
        jnet.forward(params, x, spec=jspec, conv_impl="gemm")
    with pytest.raises(ValueError, match="groups == 1"):
        tnet.forward(params, x, spec=tspec, conv_impl="gemm", device="cpu")


def test_every_conv_strategy_name_runs():
    """No name of CONV_IMPLS raises NotImplementedError any more."""
    p = {"codebooks": torch.ones(1, 4, 4), "bias": torch.zeros(2),
         "assignments": torch.zeros((2, 1, 1, 1), dtype=torch.uint8)}
    x = torch.ones(1, 2, 2, 4)
    for impl in tnet.CONV_IMPLS:
        if impl in ("auto", "fusedconv"):
            continue  # resolved by network / cin >= 256 only
        out = tconv.pq_conv(x, p, stride=1, pad=0, impl=impl)
        assert out.tolist() == [[[[4.0, 4.0]] * 2] * 2], impl
