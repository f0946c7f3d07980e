"""int8 execution of the port (ops.fc / ops.conv int8 ops, ops.misc on int8
codes, models.prepare int8, models.calibrate, the int8 branches of
network.forward and the ResNet family, interop of int8 params) against the
JAX package on the same seeded NumPy inputs, on the CPU: the int8 GEMM is
its float64 plain version there (``ops.fc.int8_matmul_plain``), and the
im2col and every padding for the card's int8 GEMM run as on the card.

Tolerances and what was measured on the CPU with these seeds:
- int32 sums of the int8 GEMM and the int8 conv, activation codes, weight
  codes and scales, int8 pooling and ReLU: bit-equal (integers);
- dequantized float32 outputs: 1e-6 of the largest |output| (measured 0);
- requantized codes: equal on >= 99.9 % of elements and within 1 elsewhere
  (measured: all equal);
- calibrated scales: 1e-2 relative per layer (bf16 forwards on both sides;
  measured 0 on full-width AlexNet);
- full-width AlexNet-PQ and the small ResNets in int8: logits within 1e-2
  of the largest |logit| and top-1 equal, the bf16 tests' limit (measured:
  AlexNet auto B=2 0, int8 convs + fc memory B=1 2.3e-4 and B=3 2.3e-4, the
  same after interop; ResNet decode at load 0 and memory 5.3e-4 at most;
  ResNet-50 B=1 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from qcnn_tpu.models import common as jcommon
from qcnn_tpu.models import network as jnet
from qcnn_tpu.models import resnet as jresnet
from qcnn_tpu.models import synth as jsynth
from qcnn_tpu.models import zoo as jzoo
from qcnn_tpu.models.calibrate import calibrate_act_scales as jcalibrate
from qcnn_tpu.models.prepare import _quantize_weight_int8 as jquantize_w
from qcnn_tpu.models.prepare import int8_out_scales as jplan
from qcnn_tpu.models.prepare import prepare_params as jprepare
from qcnn_tpu.ops import conv as jconv
from qcnn_tpu.ops import fc as jfc
from qcnn_tpu.ops import misc as jmisc
from qcnn_tpu_torch.models import common as tcommon
from qcnn_tpu_torch.models import network as tnet
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models import synth as tsynth
from qcnn_tpu_torch.models import zoo as tzoo
from qcnn_tpu_torch.models.calibrate import calibrate_act_scales as tcalibrate
from qcnn_tpu_torch.models.interop import (
    family_params_from_jax,
    params_from_jax,
)
from qcnn_tpu_torch.models.prepare import _quantize_weight_int8 as tquantize_w
from qcnn_tpu_torch.models.prepare import (
    act_dtype_for,
    int8_conv_kernel_tensor,
    int8_out_scales,
    int8_rows_tensor,
)
from qcnn_tpu_torch.models.prepare import prepare_params as tprepare
from qcnn_tpu_torch.ops import conv as tconv
from qcnn_tpu_torch.ops import fc as tfc
from qcnn_tpu_torch.ops import misc as tmisc
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _codes(rng, shape):
    return rng.integers(-127, 128, size=shape, dtype=np.int8)


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---- ops: quantize, GEMM, conv, requantize, pool ---------------------------

@pytest.mark.parametrize("case", ["static", "dynamic", "zero_static",
                                  "int8_passthrough"])
def test_quantize_activations_matches_jax(rng, case):
    x = (rng.standard_normal((4, 7, 5, 6)) * 3).astype(np.float32)
    scale = {"static": np.float32(0.021), "dynamic": None,
             "zero_static": np.float32(0.0),
             "int8_passthrough": np.float32(0.5)}[case]
    if case == "int8_passthrough":
        x = _codes(rng, x.shape)
    if case == "zero_static":
        x[0] = 0.0  # a calibration-dead input: codes 0, not NaN
    jq, js = jfc.quantize_activations_int8(jnp.asarray(x), scale)
    tq, ts = tfc.quantize_activations_int8(T(x), scale)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    if case == "zero_static":
        assert not tq.numpy()[0].any() and float(ts) > 0


def test_quantize_int8_codes_need_a_static_scale(rng):
    x = _codes(rng, (2, 3))
    with pytest.raises(ValueError, match="static act_scale"):
        jfc.quantize_activations_int8(jnp.asarray(x))
    with pytest.raises(ValueError, match="static act_scale"):
        tfc.quantize_activations_int8(T(x))


@pytest.mark.parametrize("b", [1, 17])
def test_int8_gemm_sums_bit_equal_to_dot_general(rng, b):
    """K = 363 (AlexNet conv1's patch, padded to 368 for the GEMM),
    N = 1000; B = 1 is padded to 17 rows."""
    a, w_oi = _codes(rng, (b, 363)), _codes(rng, (1000, 363))
    want = np.asarray(lax.dot_general(
        jnp.asarray(a), jnp.asarray(w_oi.T), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    for w in (T(w_oi).t(), int8_rows_tensor(w_oi, "cpu").t(), T(w_oi.T)):
        got = tfc.int8_matmul(T(a), w)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tfc.int8_matmul_plain(T(a), T(w_oi.T)).numpy(), want)


def test_int8_weight_padding_is_a_view(rng):
    """The prepared (Cout, Cin) memory is padded in place: the GEMM's K
    padding of the (Cin, Cout) view costs no copy, and an unpadded operand
    is copied into a zeroed column-major buffer."""
    w = int8_rows_tensor(_codes(rng, (40, 363)), "cpu").t()
    assert w.shape == (363, 40) and w.stride() == (1, 368)
    padded = tfc.pad_k_columns(w, 368)
    assert padded.data_ptr() == w.data_ptr() and padded.shape == (368, 40)
    assert not padded[363:].any()
    copied = tfc.pad_k_columns(T(_codes(rng, (363, 40))), 368)
    assert copied.stride() == (1, 368) and not copied[363:].any()
    kernel = int8_conv_kernel_tensor(_codes(rng, (16, 11, 11, 3)), "cpu")
    matrix = tconv.int8_kernel_matrix(kernel)
    assert matrix.data_ptr() == kernel.data_ptr()
    assert matrix.shape == (363, 16) and matrix.stride() == (1, 368)


CONVS = {  # (B, H, W, Cin, Cout, k, stride, pad, groups)
    "alexnet_conv1": (2, 35, 35, 3, 16, 11, 4, 0, 1),
    "alexnet_conv2": (2, 9, 9, 16, 24, 5, 1, 2, 2),
    "conv3x3": (3, 7, 6, 12, 8, 3, 1, 1, 1),
    "strided_3x3_one_row": (1, 4, 4, 8, 16, 3, 2, 1, 1),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_int8_conv_sums_bit_equal_to_lax_conv(rng, name):
    b, h, w, cin, cout, k, stride, pad, groups = CONVS[name]
    xq = _codes(rng, (b, h, w, cin))
    kq = _codes(rng, (k, k, cin // groups, cout))
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(kq), (stride, stride),
        [(pad, pad), (pad, pad)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32))
    kw = dict(stride=stride, pad=pad, groups=groups)
    for kernel in (T(kq), int8_conv_kernel_tensor(kq.transpose(3, 0, 1, 2),
                                                  "cpu")):
        got = tconv.conv_int8_sums(T(xq), kernel, **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tconv.conv_int8_sums_plain(T(xq), T(kq), **kw).numpy(), want)


def _int8_layer(rng, cin, cout, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    wq, scale = jquantize_w(w)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return wq, scale, bias


@pytest.mark.parametrize("out_scale", [None, np.float32(0.05)])
@pytest.mark.parametrize("act_scale", [None, np.float32(0.03)])
def test_int8_conv_and_fc_outputs_match_jax(rng, act_scale, out_scale):
    """Dequantized float32 within 1e-6 of the largest |output|; requantized
    codes equal on >= 99.9 % and within 1 elsewhere (round ties)."""
    x = rng.standard_normal((2, 9, 9, 16)).astype(np.float32)
    kq, ks, kb = _int8_layer(rng, 16, 24, (5, 5, 8, 24))
    kw = dict(stride=1, pad=2, groups=2, act_scale=act_scale,
              out_scale=out_scale)
    want_c = np.asarray(jconv.conv_dense_int8(jnp.asarray(x), kq, ks, kb,
                                              **kw))
    got_c = tconv.conv_dense_int8(T(x), T(kq), T(ks), T(kb), **kw)
    xf = rng.standard_normal((3, 200)).astype(np.float32)
    wq, ws, wb = _int8_layer(rng, 200, 40, (200, 40))
    kw = dict(act_scale=act_scale, out_scale=out_scale)
    want_f = np.asarray(jfc.fc_dense_int8(jnp.asarray(xf), wq, ws, wb, **kw))
    got_f = tfc.fc_dense_int8(T(xf), T(wq), T(ws), T(wb), **kw)
    for got, want in ((got_c, want_c), (got_f, want_f)):
        if out_scale is None:
            assert got.dtype == torch.float32
            assert _rel(got, want) <= 1e-6
        else:
            assert got.dtype == torch.int8
            diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("h,w,kernel,stride,pad,ceil_mode", [
    (13, 13, 3, 2, 0, True),    # AlexNet pool5
    (5, 5, 2, 2, 1, True),      # padded ceil pool: Caffe's clamp fires
    (7, 6, 3, 2, 1, True),
    (8, 8, 3, 2, 1, False),     # floor rule
])
def test_int8_pool_and_relu_bit_equal(rng, h, w, kernel, stride, pad,
                                      ceil_mode):
    x = _codes(rng, (2, h, w, 5))
    x[0, 0, 0, 0] = -127
    kw = dict(kernel=kernel, stride=stride, pad=pad, ceil_mode=ceil_mode)
    want = np.asarray(jmisc.caffe_max_pool(jnp.asarray(x), **kw))
    got = tmisc.caffe_max_pool(T(x), **kw)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    relu = tmisc.relu(T(x))
    assert relu.dtype == torch.int8
    np.testing.assert_array_equal(relu.numpy(),
                                  np.asarray(jmisc.relu(jnp.asarray(x))))


def test_quantize_weight_bit_equal(rng):
    for shape in ((11, 11, 3, 96), (9216, 64), (3, 3, 4, 1)):
        w = rng.standard_normal(shape).astype(np.float32)
        w[..., 0] = 0.0  # a dead channel keeps the 1e-12 floor
        (tq, ts), (jq, js) = tquantize_w(w), jquantize_w(w)
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(ts, js)
    assert act_dtype_for(torch.int8) == torch.bfloat16
    assert act_dtype_for(torch.float32) == torch.float32


# ---- full-width AlexNet-PQ: plan, calibration, the slice -------------------

@pytest.fixture(scope="module")
def alexnet():
    """Specs, params (seed 0) and both packages' calibrated scales (one bf16
    pass over random_input(spec, 4, seed=3), as bench.py does at 32)."""
    jspec, tspec = jzoo.alexnet(), tzoo.alexnet()
    params = jsynth.random_pq_params(jspec, seed=0)
    xc = jsynth.random_input(jspec, 4, seed=3)
    pj, cj, fj = jprepare(jspec, params, dtype=jnp.bfloat16)
    pt, ct, ft = tprepare(tspec, params, dtype=torch.bfloat16, device="cpu")
    scales_j = jcalibrate(jspec, pj, xc, conv_impls=cj, fc_impls=fj)
    scales_t = tcalibrate(tspec, pt, xc, conv_impls=ct, fc_impls=ft,
                          device="cpu")
    return dict(jspec=jspec, tspec=tspec, params=params, scales_j=scales_j,
                scales_t=scales_t, runs={})


def test_calibrated_scales_match_jax(alexnet):
    sj, st = alexnet["scales_j"], alexnet["scales_t"]
    assert sorted(st) == sorted(sj) == [0, 4, 8, 10, 12, 15, 18, 21]
    for i in sj:
        assert abs(st[i] - sj[i]) <= 1e-2 * sj[i]


@pytest.mark.parametrize("fc_impl,plan", [("auto", [8, 10, 12, 15, 18]),
                                          ("memory", [8, 10])])
def test_out_scale_plan_matches_jax(alexnet, fc_impl, plan):
    jspec, tspec, params = alexnet["jspec"], alexnet["tspec"], \
        alexnet["params"]
    scales = alexnet["scales_j"]
    cj, fj = jnet.resolve_strategy(jspec, params, 2, "auto", fc_impl,
                                   dtype=jnp.bfloat16)
    ct, ft = tnet.resolve_strategy(tspec, params, 2, "auto", fc_impl,
                                   dtype=torch.bfloat16)
    want = jplan(jspec, params, cj, fj, scales)
    got = int8_out_scales(tspec, params, ct, ft, scales)
    assert got == want and sorted(got) == plan


def _alexnet_int8(alexnet, fc_impl, batch):
    """Both packages' int8 logits for one config (cached per module), with
    the same act_scales dict, so that both run one program."""
    key = (fc_impl, batch)
    if key not in alexnet["runs"]:
        jspec, tspec, params = (alexnet["jspec"], alexnet["tspec"],
                                alexnet["params"])
        scales = alexnet["scales_j"]
        x = jsynth.random_input(jspec, batch, seed=5)
        pj, cj, fj = jprepare(jspec, params, batch_hint=batch,
                              fc_impl=fc_impl, dtype=jnp.int8,
                              act_scales=scales)
        want = np.asarray(jnet.forward(
            pj, x, spec=jspec, conv_impls=cj, fc_impls=fj,
            compute_dtype=jnp.bfloat16, with_softmax=False), np.float32)
        pt, ct, ft = tprepare(tspec, params, batch_hint=batch,
                              fc_impl=fc_impl, dtype=torch.int8,
                              act_scales=scales, device="cpu")
        assert (ct, ft) == (cj, fj)
        got = tnet.forward(pt, x, spec=tspec, conv_impls=ct, fc_impls=ft,
                           compute_dtype=torch.bfloat16, with_softmax=False,
                           device="cpu")
        alexnet["runs"][key] = dict(want=want, got=got, pj=pj, pt=pt, x=x,
                                    impls=(ct, ft))
    return alexnet["runs"][key]


def _held(got, want):
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-2
    np.testing.assert_array_equal(got.float().numpy().argmax(1),
                                  want.argmax(1))


CONFIGS = [("auto", 2, "dense"), ("memory", 1, "lutgather"),
           ("memory", 3, "fgather")]


@pytest.mark.parametrize("fc_impl,batch,fc_route", CONFIGS)
def test_alexnet_int8_matches_jax(alexnet, fc_impl, batch, fc_route):
    run = _alexnet_int8(alexnet, fc_impl, batch)
    _held(run["got"], run["want"])
    conv_impls, fc_impls = run["impls"]
    assert set(fc_impls) - {"-"} == {fc_route}
    assert set(conv_impls) - {"-"} == {"dense"}
    pt = run["pt"]
    convs = [p for p, c in zip(pt, conv_impls) if c == "dense"]
    assert all(p["kernel_q"].dtype == torch.int8 for p in convs)
    assert pt[0]["kernel_q"].permute(3, 0, 1, 2).stride() == (368, 33, 3, 1)
    if fc_route != "dense":
        assert pt[15]["codebooks"].dtype == torch.bfloat16


@pytest.mark.parametrize("fc_impl,batch,fc_route", CONFIGS)
def test_alexnet_int8_params_from_jax(alexnet, fc_impl, batch, fc_route):
    """JAX-prepared int8 params carried across run unchanged in the port
    and give the port's own prepare's logits."""
    run = _alexnet_int8(alexnet, fc_impl, batch)
    carried = params_from_jax(run["pj"], device="cpu")
    for ours, theirs in zip(run["pt"], carried):
        if ours is None:
            assert theirs is None
            continue
        assert ours.keys() == theirs.keys()
        for key, t in ours.items():
            c = theirs[key]
            assert c.dtype == t.dtype and c.shape == t.shape, key
            assert c.stride() == t.stride(), key
            assert torch.equal(c, t), key
    conv_impls, fc_impls = run["impls"]
    got = tnet.forward(carried, run["x"], spec=alexnet["tspec"],
                       conv_impls=conv_impls, fc_impls=fc_impls,
                       compute_dtype=torch.bfloat16, with_softmax=False,
                       device="cpu")
    _held(got, run["want"])


# ---- the ResNet family ------------------------------------------------------

SMALL = {
    "basic": dict(name="basic", stage_depths=(1, 2),
                  stage_channels=(64, 256), num_classes=10, in_size=32,
                  bottleneck=False),
    "bottleneck": dict(name="bottleneck", stage_depths=(1, 2),
                       stage_channels=(64, 1024), num_classes=10,
                       in_size=32, bottleneck=True),
}


def _resnet_int8(jspec, tspec, batch, memory):
    params = tsynth.random_resnet_pq_params(tspec, seed=0)
    x = np.random.default_rng(1).standard_normal(
        (batch, tspec.in_size, tspec.in_size, 3)).astype(np.float32)
    pj, _, act_j = jcommon.build_family_forward(
        "resnet", jspec, params, memory=memory, compute_dtype=jnp.int8)
    want = np.asarray(jresnet.forward(pj, jnp.asarray(x), spec=jspec,
                                      compute_dtype=act_j), np.float32)
    prepared, fwd, act = tcommon.build_family_forward(
        "resnet", tspec, params, memory=memory, compute_dtype=torch.int8,
        device="cpu")
    assert act == torch.bfloat16
    logits = tresnet.forward(prepared, x, spec=tspec, compute_dtype=act,
                             device="cpu")
    _held(logits, want)
    probs = fwd(prepared, x)
    np.testing.assert_allclose(probs.numpy(), jax.nn.softmax(logits.numpy()),
                               atol=1e-6)
    return pj, prepared, x, want


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
@pytest.mark.parametrize("memory", [False, True])
def test_small_resnet_int8_matches_jax(kind, memory):
    jspec = jresnet.ResNetSpec(**SMALL[kind])
    tspec = tresnet.ResNetSpec(**SMALL[kind])
    pj, prepared, x, want = _resnet_int8(jspec, tspec, 2, memory)
    stem = prepared["stem"]
    assert stem["kernel_q"].dtype == torch.int8
    assert stem["kernel_q"].permute(3, 0, 1, 2).stride()[0] == 152  # 147
    if memory:
        assert prepared["s1b1"]["conv2"]["codebooks"].dtype == torch.bfloat16
    else:
        assert prepared["s1b1"]["conv2"]["kernel_q"].dtype == torch.int8
        assert prepared["fc"]["weight_q"].dtype == torch.int8
    carried = tresnet.forward(family_params_from_jax(pj, device="cpu"), x,
                              spec=tspec, compute_dtype=torch.bfloat16,
                              device="cpu")
    _held(carried, want)


def test_resnet50_int8_full_width_b1():
    _resnet_int8(jresnet.resnet50(), tresnet.resnet50(), 1, False)
