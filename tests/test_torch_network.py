"""Slice parity at a tiny size: prepare_params + forward of the port
(plain versions on the CPU) against the JAX package's, f32, same NumPy
params and inputs; strategy resolution for every zoo spec; the weights
carried across by params_from_jax. f32 probabilities within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qcnn_tpu.core as jcore
import qcnn_tpu_torch.core as tcore
from qcnn_tpu.models import network as jnet
from qcnn_tpu.models import synth as jsynth
from qcnn_tpu.models import zoo as jzoo
from qcnn_tpu.models.prepare import prepare_params as jprepare
from qcnn_tpu_torch.models import network as tnet
from qcnn_tpu_torch.models import zoo as tzoo
from qcnn_tpu_torch.models.interop import params_from_jax
from qcnn_tpu_torch.models.prepare import prepare_params as tprepare
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


def _tiny(core):
    """The tests/test_prepare.py tiny net, in either package's spec types."""
    return core.ModelSpec(
        name="tiny", in_height=15, in_width=15, in_channels=8,
        layers=(
            core.ConvSpec(kernel=3, out_channels=32, pad=1, groups=2,
                          stride=2),
            core.ReLUSpec(),
            core.LRNSpec(5, 1e-4, 0.75, 1.0),
            core.PoolSpec(kernel=3, stride=2),
            core.FCSpec(64),
            core.ReLUSpec(),
            core.DropoutSpec(0.5),
            core.FCSpec(16),
            core.SoftmaxSpec(),
        ),
    )


JSPEC, TSPEC = _tiny(jcore), _tiny(tcore)


def _params(seed=3, perm=False):
    params = jsynth.random_pq_params(JSPEC, seed=seed)
    if perm:
        g = np.random.default_rng(seed)
        params[0]["perm"] = g.permutation(4).astype(np.int32)  # Cg = 4
        params[4]["perm"] = g.permutation(512).astype(np.int32)
    return params


def _close(got, want, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol


STRATEGIES = [
    ("auto", "auto"),
    ("memory", "memory"),
    ("indecode", "indecode"),
    ("indecode_ohwi", "fgather"),
    ("gdecode", "lutgather"),
    ("gdecode_iohw", "fused"),
    ("indecode_hwoi", "gdecode"),
    ("decode", "gather"),
]


@pytest.mark.parametrize("conv_impl,fc_impl", STRATEGIES)
@pytest.mark.parametrize("perm", [False, True])
def test_prepared_forward_matches_jax(conv_impl, fc_impl, perm):
    params = _params(perm=perm)
    x = jsynth.random_input(JSPEC, batch=4, seed=4)
    pj, cj, fj = jprepare(JSPEC, params, batch_hint=4, conv_impl=conv_impl,
                          fc_impl=fc_impl, dtype=jnp.float32)
    pt, ct, ft = tprepare(TSPEC, params, batch_hint=4, conv_impl=conv_impl,
                          fc_impl=fc_impl, dtype=torch.float32, device="cpu")
    assert (ct, ft) == (cj, fj)
    want = jnet.forward(pj, x, spec=JSPEC, conv_impls=cj, fc_impls=fj,
                        compute_dtype=jnp.float32)
    got = tnet.forward(pt, x, spec=TSPEC, conv_impls=ct, fc_impls=ft,
                       compute_dtype=torch.float32, device="cpu")
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("conv_impl,fc_impl", STRATEGIES[:4])
def test_raw_params_forward_matches_jax(conv_impl, fc_impl):
    """forward on unprepared NumPy PQ params (decoded in the step)."""
    params = _params(seed=5)
    x = jsynth.random_input(JSPEC, batch=3, seed=6)
    want = jnet.forward(params, x, spec=JSPEC, conv_impl=conv_impl,
                        fc_impl=fc_impl)
    got = tnet.forward(params, x, spec=TSPEC, conv_impl=conv_impl,
                       fc_impl=fc_impl, device="cpu")
    _close(got, want)


def test_upto_and_collect_act_amax():
    params = _params(seed=7)
    x = jsynth.random_input(JSPEC, batch=2, seed=8)
    for upto in (1, 4, 7):
        want = jnet.forward(params, x, spec=JSPEC, upto=upto)
        got = tnet.forward(params, x, spec=TSPEC, upto=upto, device="cpu")
        _close(got, want)
    pj, aj = jnet.forward(params, x, spec=JSPEC, collect_act_amax=True)
    pt, at = tnet.forward(params, x, spec=TSPEC, collect_act_amax=True,
                          device="cpu")
    _close(pt, pj)
    assert sorted(at) == sorted(aj) == [0, 4, 7]
    for i in aj:
        assert abs(float(at[i]) - float(aj[i])) <= 1e-5 * float(aj[i])


def test_logits_and_make_forward_fn():
    params = _params(seed=9)
    x = jsynth.random_input(JSPEC, batch=2, seed=10)
    want = jnet.forward(params, x, spec=JSPEC, with_softmax=False)
    fn = tnet.make_forward_fn(TSPEC, with_softmax=False, device="cpu",
                              compute_dtype=torch.float32)
    got = fn(params, x)
    _close(got, want, tol=1e-5 * float(np.abs(np.asarray(want)).max()))


def test_top_k_labels():
    """Ties (a saturated softmax has them) put the lower index first, as
    lax.top_k does."""
    probs = np.array([[0.1, 0.5, 0.3, 0.05, 0.05],
                      [0.6, 0.1, 0.05, 0.2, 0.05],
                      [0.2, 0.05, 0.2, 0.2, 0.35],
                      [0.0, 1.0, 0.0, 0.0, 0.0]], np.float32)
    for k in (3, 5):
        want = np.asarray(jnet.top_k_labels(probs, k=k))
        got = tnet.top_k_labels(torch.from_numpy(probs), k=k)
        np.testing.assert_array_equal(got.numpy(), want)
    assert got[2].tolist() == [4, 0, 2, 3, 1]


@pytest.mark.parametrize("name", sorted(jzoo.MODELS))
def test_resolve_strategy_matches_jax_for_every_zoo_spec(name):
    jspec, tspec = jzoo.get_model(name), tzoo.get_model(name)
    params = jsynth.random_pq_params(jspec, seed=0)
    for conv_impl, fc_impl in (("auto", "auto"), ("memory", "memory"),
                               ("gdecode", "lutgather")):
        for batch in (1, 2, 3, 256, 1025):
            for jd, td in ((jnp.bfloat16, torch.bfloat16),
                           (jnp.float32, torch.float32), (None, None)):
                want = jnet.resolve_strategy(jspec, params, batch, conv_impl,
                                             fc_impl, dtype=jd)
                got = tnet.resolve_strategy(tspec, params, batch, conv_impl,
                                            fc_impl, dtype=td)
                assert got == want, (conv_impl, fc_impl, batch, jd)


def test_resolve_strategy_vocabulary():
    assert tnet.CONV_IMPLS == jnet.CONV_IMPLS
    assert tnet.FC_IMPLS == jnet.FC_IMPLS
    with pytest.raises(ValueError, match="unknown conv impl"):
        tnet.resolve_strategy(TSPEC, _params(), 1, conv_impl="nope")
    with pytest.raises(ValueError, match="unknown fc impl"):
        tnet.resolve_strategy(TSPEC, _params(), 1, fc_impl="nope")


def test_unported_strategies_raise_not_implemented():
    """No strategy name is left unported: conv 'lut' (the last conv names),
    fc 'onehot' and int8 give the JAX package's output (f32 within 1e-5;
    int8 with dynamic scales within 1e-2 of the largest |logit|, measured
    0)."""
    params = _params()
    x = jsynth.random_input(JSPEC, batch=2, seed=0)
    want = jnet.forward(params, x, spec=JSPEC, conv_impl="lut")
    _close(tnet.forward(params, x, spec=TSPEC, conv_impl="lut",
                        device="cpu"), want)
    want = jnet.forward(params, x, spec=JSPEC, fc_impl="onehot")
    _close(tnet.forward(params, x, spec=TSPEC, fc_impl="onehot",
                        device="cpu"), want)
    pj, cj, fj = jprepare(JSPEC, params, dtype=jnp.int8)
    pt, ct, ft = tprepare(TSPEC, params, dtype=torch.int8, device="cpu")
    assert (ct, ft) == (cj, fj)
    assert pt[0]["kernel_q"].dtype == torch.int8
    want = np.asarray(jnet.forward(pj, x, spec=JSPEC, conv_impls=cj,
                                   fc_impls=fj, compute_dtype=jnp.bfloat16,
                                   with_softmax=False), np.float32)
    got = tnet.forward(pt, x, spec=TSPEC, conv_impls=ct, fc_impls=ft,
                       compute_dtype=torch.bfloat16, with_softmax=False,
                       device="cpu")
    _close(got, want, tol=1e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("prepared_dtype", [None, "float32", "bfloat16"])
def test_params_from_jax(prepared_dtype):
    """Raw and prepared JAX params (prepared bf16 ones hold ml_dtypes arrays)
    carried across give the JAX forward's output."""
    params = _params(seed=11, perm=True)
    x = jsynth.random_input(JSPEC, batch=3, seed=12)
    if prepared_dtype is None:
        jp, cj, fj = params, None, None
        kw = dict(conv_impl="memory", fc_impl="memory")
        jdt, tdt, tol = jnp.float32, torch.float32, 1e-5
    else:
        jdt = getattr(jnp, prepared_dtype)
        tdt = getattr(torch, prepared_dtype)
        jp, cj, fj = jprepare(JSPEC, params, batch_hint=3, dtype=jdt)
        kw = dict(conv_impls=cj, fc_impls=fj)
        tol = 1e-5 if prepared_dtype == "float32" else 1e-2
    want = jnet.forward(jp, x, spec=JSPEC, compute_dtype=jdt, **kw)
    tp = params_from_jax(jp, device="cpu")
    got = tnet.forward(tp, x, spec=TSPEC, compute_dtype=tdt, device="cpu",
                       **kw)
    _close(got, want, tol=tol)
    if prepared_dtype == "bfloat16":
        assert tp[0]["kernel"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp[0]["kernel"].float().numpy(),
            np.asarray(jp[0]["kernel"], np.float32))
        assert tp[4]["weight"].shape == jp[4]["weight"].shape


# ---- the zoo's other five specs (full width, B=1) ---------------------------

@pytest.mark.parametrize("name", ["caffenet", "vgg_cnn_s", "vgg16",
                                  "caffenet_fgb", "caffenet_fgd"])
def test_zoo_forward_matches_jax(name):
    """f32 decode at load, logits within 1e-5 of the largest |logit|
    (measured 2.2e-6 to 4.1e-6; vgg16 is the slowest case, about 7 s on
    the CPU for both packages)."""
    jspec, tspec = jzoo.get_model(name), tzoo.get_model(name)
    params = jsynth.random_pq_params(jspec, seed=0)
    x = jsynth.random_input(jspec, 1, seed=1)
    pj, cj, fj = jprepare(jspec, params, dtype=jnp.float32)
    want = np.asarray(jnet.forward(pj, x, spec=jspec, conv_impls=cj,
                                   fc_impls=fj, compute_dtype=jnp.float32,
                                   with_softmax=False))
    pt, ct, ft = tprepare(tspec, params, dtype=torch.float32, device="cpu")
    assert (ct, ft) == (cj, fj)
    got = tnet.forward(pt, x, spec=tspec, conv_impls=ct, fc_impls=ft,
                       compute_dtype=torch.float32, with_softmax=False,
                       device="cpu")
    _close(got, want, tol=1e-5 * float(np.abs(want).max()))


def test_caffenet_int8_matches_jax():
    """int8 'auto' (dynamic scales), bf16 activations: logits within 1e-2
    of the largest |logit| (measured 0), top-1 equal."""
    jspec, tspec = jzoo.get_model("caffenet"), tzoo.get_model("caffenet")
    params = jsynth.random_pq_params(jspec, seed=0)
    x = jsynth.random_input(jspec, 1, seed=1)
    pj, cj, fj = jprepare(jspec, params, dtype=jnp.int8)
    want = np.asarray(jnet.forward(pj, x, spec=jspec, conv_impls=cj,
                                   fc_impls=fj, compute_dtype=jnp.bfloat16,
                                   with_softmax=False), np.float32)
    pt, ct, ft = tprepare(tspec, params, dtype=torch.int8, device="cpu")
    got = tnet.forward(pt, x, spec=tspec, conv_impls=ct, fc_impls=ft,
                       compute_dtype=torch.bfloat16, with_softmax=False,
                       device="cpu")
    _close(got, want, tol=1e-2 * float(np.abs(want).max()))
    np.testing.assert_array_equal(got.float().numpy().argmax(1),
                                  want.argmax(1))


# ---- dtype None and the JAX signatures --------------------------------------

def test_prepare_dtype_default_and_none_match_jax():
    """The default dtype is bf16 in both packages; an explicit None keeps
    float32 arrays and resolves strategies with no dtype in both."""
    params = _params(seed=13)
    for kw in ({}, {"dtype": None}):
        pj, cj, fj = jprepare(JSPEC, params, batch_hint=3, conv_impl="memory",
                              fc_impl="memory", **kw)
        pt, ct, ft = tprepare(TSPEC, params, batch_hint=3, conv_impl="memory",
                              fc_impl="memory", device="cpu", **kw)
        assert (ct, ft) == (cj, fj)
        want = np.asarray(pj[0]["codebooks"]).dtype.name
        assert str(pt[0]["codebooks"].dtype) == f"torch.{want}"
    pj, _, _ = jprepare(JSPEC, params)
    pt, _, _ = tprepare(TSPEC, params, device="cpu")
    assert pt[0]["kernel"].dtype == torch.bfloat16
    assert np.asarray(pj[0]["kernel"]).dtype.name == "bfloat16"


def test_forward_compute_dtype_none_matches_jax():
    """None keeps x's dtype and resolves the memory rule as float32 (the
    exact in-step decode): f32 within 1e-5 of the JAX forward, which a bf16
    route would miss by about 1e-3."""
    params = _params(seed=14)
    x = jsynth.random_input(JSPEC, batch=3, seed=15)
    kw = dict(conv_impl="memory", fc_impl="memory")
    want = np.asarray(jnet.forward(params, x, spec=JSPEC, **kw))
    got = tnet.forward(params, x, spec=TSPEC, device="cpu", **kw)
    assert got.dtype == torch.float32
    _close(got, want)
    fn = tnet.make_forward_fn(TSPEC, donate_input=True, device="cpu", **kw)
    _close(fn(params, x), want)
    xb = jnp.asarray(x, jnp.bfloat16)
    for upto in (0, 4):  # bf16 x stays bf16 up to the first conv
        want = jnet.forward(params, xb, spec=JSPEC, upto=upto)
        got = tnet.forward(params, torch.from_numpy(x).to(torch.bfloat16),
                           spec=TSPEC, upto=upto, device="cpu")
        assert str(got.dtype) == f"torch.{want.dtype}"
        _close(got, want)


@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float32, torch.float32, 1e-5),
                                         (jnp.bfloat16, torch.bfloat16, 1e-2)])
def test_memory_mode_at_256_codewords_matches_jax(jdt, tdt, tol):
    """K = 256 (the quantizer's uint8 limit): memory mode decodes every
    layer in the step (fc 'memory' resolves to 'indecode' past K = 128) and
    gives the JAX forward's probabilities (f32 1e-5, bf16 1e-2)."""
    g = np.random.default_rng(16)
    params = _params(seed=16)
    for i in (0, 4, 7):
        s, _, d = params[i]["codebooks"].shape
        params[i] = dict(params[i], codebooks=g.standard_normal(
            (s, 256, d)).astype(np.float32) * 0.3, assignments=g.integers(
                0, 256, size=params[i]["assignments"].shape, dtype=np.uint8))
    x = jsynth.random_input(JSPEC, batch=3, seed=17)
    pj, cj, fj = jprepare(JSPEC, params, batch_hint=3, conv_impl="memory",
                          fc_impl="memory", dtype=jdt)
    pt, ct, ft = tprepare(TSPEC, params, batch_hint=3, conv_impl="memory",
                          fc_impl="memory", dtype=tdt, device="cpu")
    assert (ct, ft) == (cj, fj) and set(ft) == {"-", "indecode"}
    want = jnet.forward(pj, x, spec=JSPEC, conv_impls=cj, fc_impls=fj,
                        compute_dtype=jdt)
    got = tnet.forward(pt, x, spec=TSPEC, conv_impls=ct, fc_impls=ft,
                       compute_dtype=tdt, device="cpu")
    _close(got, want, tol=tol)
