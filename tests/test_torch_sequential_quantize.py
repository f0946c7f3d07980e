"""Whole-network quantization in the port (quantizer/sequential.py,
resnet/vit quantize_params, the quantize / make-family / serve --model CLI
paths) against the JAX package's, on the CPU.

Bit-equal: the calibration samples (_conv_xcal / _fc_xcal, NumPy's
default_rng on the same activations), the first FC's calibration rows (the
NCHW flatten), the structure, shapes and dtypes of quantize_params for
ResNet-18 and ViT-S at tiny widths, and checkpoints across the packages
both ways. On quality, as tests/test_sequential_quantize.py: sequential
error correction approximates the dense logits better than plain k-means
(zoo net, ResNet, ViT). The port runs with device "cpu" (the CLI with
--device cpu or --cpu).
"""

import os

import jax
import numpy as np
import pytest
import torch

from qcnn_tpu.core import (
    ConvSpec as JConv, FCSpec as JFC, ModelSpec as JSpec, PoolSpec as JPool,
    ReLUSpec as JReLU, SoftmaxSpec as JSM, dense_conv_params,
    dense_fc_params,
)
from qcnn_tpu.formats import checkpoint as jckpt
from qcnn_tpu.models import resnet as jresnet
from qcnn_tpu.models import vit as jvit
from qcnn_tpu.quantizer import sequential as jseq
from qcnn_tpu_torch import cli as tcli
from qcnn_tpu_torch.core import is_pq
from qcnn_tpu_torch.formats import checkpoint as tckpt
from qcnn_tpu_torch.models import network as tnet
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models import vit as tvit
from qcnn_tpu_torch.models import zoo as tzoo
from qcnn_tpu_torch.quantizer import sequential as tseq
from qcnn_tpu_torch.quantizer.sequential import quantize_network
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def tspec_of(jspec):
    """The port's ModelSpec of a JAX package ModelSpec."""
    return tckpt.spec_from_dict(jckpt.spec_to_dict(jspec))


@pytest.fixture(scope="module")
def setup():
    """tests/test_sequential_quantize.py's net: conv, pool, two FCs."""
    jspec = JSpec(
        name="seq-test", in_height=12, in_width=12, in_channels=8,
        layers=(JConv(kernel=3, out_channels=16, pad=1), JReLU(),
                JPool(kernel=2, stride=2), JFC(48), JReLU(), JFC(10),
                JSM()),
    )
    rng = np.random.default_rng(0)
    params = [
        dense_conv_params(
            rng.standard_normal((3, 3, 8, 16)).astype(np.float32) / 8,
            rng.standard_normal(16).astype(np.float32) * 0.05),
        None, None,
        dense_fc_params(
            rng.standard_normal((6 * 6 * 16, 48)).astype(np.float32) / 24,
            rng.standard_normal(48).astype(np.float32) * 0.05),
        None,
        dense_fc_params(
            rng.standard_normal((48, 10)).astype(np.float32) / 7,
            rng.standard_normal(10).astype(np.float32) * 0.05),
        None,
    ]
    x = rng.standard_normal((16, 12, 12, 8)).astype(np.float32)
    return jspec, tspec_of(jspec), params, x


GEOM = dict(conv_subvec_len=4, conv_codewords=8, fc_subvec_len=4,
            fc_codewords=8)


def logits(params, x, spec):
    return tnet.forward(params, x, spec=spec, with_softmax=False,
                        device="cpu").numpy()


# ---- bit-equal ------------------------------------------------------------

@pytest.mark.parametrize("groups,max_samples", [(1, 100), (2, 64),
                                                (1, 10_000), (4, 7)])
def test_conv_xcal_bit_equal(rng, groups, max_samples):
    a = rng.standard_normal((3, 5, 6, 8)).astype(np.float32)
    want = jseq._conv_xcal(a, groups, max_samples,
                           np.random.default_rng(11))
    got = tseq._conv_xcal(a, groups, max_samples, np.random.default_rng(11))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,max_samples", [((40, 12), 16), ((40, 12), 64),
                                               ((3, 7, 12), 5)])
def test_fc_xcal_bit_equal(rng, shape, max_samples):
    a = rng.standard_normal(shape).astype(np.float32)
    want = jseq._fc_xcal(a, max_samples, np.random.default_rng(12))
    got = tseq._fc_xcal(a, max_samples, np.random.default_rng(12))
    np.testing.assert_array_equal(got, want)


def test_first_fc_calibration_rows_are_the_nchw_flatten(setup, monkeypatch):
    """With the conv already PQ (passed through), the first FC is the first
    layer quantized: its calibration rows are the NCHW-flattened
    activations entering it, the same in both packages (1e-5)."""
    jspec, tspec, params, x = setup
    pq_conv = jseq.quantize_network(jax.random.key(0), jspec, params,
                                    **GEOM)[0]
    params = [pq_conv, *params[1:]]
    seen = {}

    def capture(tag, real):
        def fn(key, weight, bias, **kw):
            seen.setdefault(tag, kw["xcal"])
            return real(key, weight, bias, **kw)
        return fn

    monkeypatch.setattr(jseq, "quantize_fc_layer",
                        capture("jax", jseq.quantize_fc_layer))
    monkeypatch.setattr(tseq, "quantize_fc_layer",
                        capture("port", tseq.quantize_fc_layer))
    jseq.quantize_network(jax.random.key(0), jspec, params, x_calib=x,
                          **GEOM)
    quantize_network(gen(0), tspec, params, x_calib=x, **GEOM)
    assert seen["port"].shape == seen["jax"].shape == (16, 576)
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=1e-5,
                               atol=1e-5)


def _tree(t, prefix=""):
    """{path: (shape, dtype)} of every array of a nested params dict."""
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_tree(v, f"{prefix}{k}."))
        else:
            a = np.asarray(v)
            out[prefix + k] = (a.shape, a.dtype)
    return out


@pytest.mark.parametrize("family", ["resnet18", "vit_s16"])
def test_quantize_params_structure_matches_jax(family):
    """ResNet-18's and ViT-S's layouts at tiny widths: the same leaves
    quantized (the min_cin stem rule, every projection GEMM), with the
    JAX package's shapes and dtypes."""
    if family == "resnet18":
        kw = dict(name="r18", stage_depths=(2, 2, 2, 2),
                  stage_channels=(16, 32, 32, 64), num_classes=10,
                  in_size=32, bottleneck=False)
        jspec, tspec = jresnet.ResNetSpec(**kw), tresnet.ResNetSpec(**kw)
        jmod, tmod = jresnet, tresnet
    else:
        kw = dict(name="vits", patch=8, image_size=32, dim=48, depth=2,
                  heads=3, num_classes=10)
        jspec, tspec = jvit.ViTSpec(**kw), tvit.ViTSpec(**kw)
        jmod, tmod = jvit, tvit
    dense = jmod.init_dense_params(jspec, seed=1)
    geo = (dict(conv_codewords=16, fc_codewords=8) if family == "resnet18"
           else dict(num_codewords=8))
    want = _tree(jmod.quantize_params(jspec, dense, **geo))
    got = _tree(tmod.quantize_params(tspec, dense, device="cpu", **geo))
    assert got == want


# ---- quality -----------------------------------------------------------------

def test_plain_quantizes_all_layers(setup):
    _, tspec, params, _ = setup
    out = quantize_network(gen(0), tspec, params, **GEOM)
    learnable = [p for p in out if p is not None]
    assert len(learnable) == 3 and all(is_pq(p) for p in learnable)
    probs = tnet.forward(out, np.zeros((2, 12, 12, 8), np.float32),
                         spec=tspec, device="cpu")
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_error_corrected_beats_plain_on_calib(setup):
    """At aggressive compression, sequential EC approximates the dense
    logits better than weight-only k-means (the paper's core claim)."""
    _, tspec, params, x = setup
    want = logits(params, x, tspec)
    plain = quantize_network(gen(0), tspec, params, **GEOM)
    ec = quantize_network(gen(0), tspec, params, x_calib=x, **GEOM)
    err_p = np.linalg.norm(logits(plain, x, tspec) - want)
    err_e = np.linalg.norm(logits(ec, x, tspec) - want)
    assert err_e < err_p, (err_e, err_p)


def _family_logits(fam, spec, params, x):
    prepared = fam.prepare_params(spec, params, dtype=torch.float32,
                                  device="cpu")
    return fam.forward(prepared, x, spec=spec, device="cpu").numpy()


def test_resnet_ec_beats_plain():
    spec = tresnet.ResNetSpec("tiny", (1, 1), (16, 32), num_classes=7,
                              in_size=32, bottleneck=False)
    dense = tresnet.init_dense_params(spec, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    want = _family_logits(tresnet, spec, dense, x)
    geom = dict(conv_subvec_len=4, conv_codewords=8, fc_subvec_len=4,
                fc_codewords=8)
    plain = tresnet.quantize_params(spec, dense, device="cpu", **geom)
    ec = tseq.quantize_resnet_ec(gen(0), spec, dense, x, **geom)
    assert _tree(ec) == _tree(plain)  # policy parity incl. the stem rule
    err_p = np.linalg.norm(_family_logits(tresnet, spec, plain, x) - want)
    err_e = np.linalg.norm(_family_logits(tresnet, spec, ec, x) - want)
    assert err_e < err_p, (err_e, err_p)


def test_resnet_bottleneck_ec_beats_plain():
    spec = tresnet.ResNetSpec("tinyb", (1, 1), (64, 128), num_classes=7,
                              in_size=32, bottleneck=True)
    dense = tresnet.init_dense_params(spec, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    want = _family_logits(tresnet, spec, dense, x)
    geom = dict(conv_subvec_len=4, conv_codewords=8, fc_subvec_len=4,
                fc_codewords=8)
    plain = tresnet.quantize_params(spec, dense, device="cpu", **geom)
    ec = tseq.quantize_resnet_ec(gen(0), spec, dense, x, **geom)
    assert _tree(ec) == _tree(plain)
    err_p = np.linalg.norm(_family_logits(tresnet, spec, plain, x) - want)
    err_e = np.linalg.norm(_family_logits(tresnet, spec, ec, x) - want)
    assert err_e < err_p, (err_e, err_p)


def test_vit_ec_beats_plain():
    spec = tvit.vit_tiny_test()
    dense = tvit.init_dense_params(spec, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (8, spec.image_size, spec.image_size, 3)).astype(np.float32)
    want = _family_logits(tvit, spec, dense, x)
    plain = tvit.quantize_params(spec, dense, subvec_len=4, num_codewords=8,
                                 device="cpu")
    ec = tseq.quantize_vit_ec(gen(0), spec, dense, x, subvec_len=4,
                              num_codewords=8)
    assert set(ec) == set(plain)
    assert _tree(ec) == _tree(plain)
    err_p = np.linalg.norm(_family_logits(tvit, spec, plain, x) - want)
    err_e = np.linalg.norm(_family_logits(tvit, spec, ec, x) - want)
    assert err_e < err_p, (err_e, err_p)


# ---- CLI and checkpoints across the packages ---------------------------------

def test_quantize_cli_calib_random_and_jax_loads_it(tmp_path, monkeypatch,
                                                    setup):
    """`quantize <native dense ckpt> out --calib-random 8` writes a PQ
    checkpoint that the JAX package loads with the port's arrays; the
    --cpu alias and --device cpu both run on the CPU."""
    jspec, tspec, params, _ = setup
    monkeypatch.setitem(tzoo.MODELS, "seqtest", lambda: tspec)
    src = str(tmp_path / "dense")
    tckpt.save_checkpoint(src, tspec, params)
    for flag in (["--cpu"], ["--device", "cpu"]):
        out = str(tmp_path / f"pq{len(flag)}")
        assert tcli.main(["quantize", src, out, *flag, "--calib-random",
                          "8", "--conv-subvec-len", "4",
                          "--conv-codewords", "8", "--fc-subvec-len", "4",
                          "--fc-codewords", "8"]) == 0
        spec_t, qt = tckpt.load_checkpoint(out)
        spec_j, qj = jckpt.load_checkpoint(out)
        assert spec_j == jspec and spec_t == tspec
        assert all(is_pq(p) for p in qt if p is not None)
        for pt, pj in zip(qt, qj):
            assert (pt is None) == (pj is None)
            for key in pt or {}:
                np.testing.assert_array_equal(np.asarray(pt[key]),
                                              np.asarray(pj[key]))


def test_jax_quantized_checkpoint_loads_in_the_port(tmp_path, setup):
    jspec, tspec, params, x = setup
    q = jseq.quantize_network(jax.random.key(0), jspec, params, x_calib=x,
                              opq="variance", **GEOM)
    path = str(tmp_path / "jq")
    jckpt.save_checkpoint(path, jspec, q)
    spec_t, qt = tckpt.load_checkpoint(path)
    assert spec_t == tspec
    for pt, pj in zip(qt, q):
        for key in pj or {}:
            np.testing.assert_array_equal(np.asarray(pt[key]),
                                          np.asarray(pj[key]))
    from qcnn_tpu.models import network as jnet

    want = np.asarray(jnet.forward(q, x, spec=jspec, with_softmax=False))
    np.testing.assert_allclose(logits(qt, x, tspec), want, rtol=1e-5,
                               atol=1e-5)


def test_make_family_cli_calib(tmp_path):
    """make-family --calib-random: ResNet-18 error-corrected end to end
    through the CLI on the CPU, with class names embedded; the JAX package
    loads the checkpoint."""
    names = tmp_path / "names.txt"
    names.write_text("".join(f"c{i}\n" for i in range(1000)))
    out = str(tmp_path / "r18ec")
    assert tcli.main(["make-family", "resnet18", out, "--device", "cpu",
                      "--calib-random", "2", "--class-names",
                      str(names)]) == 0
    family, spec, params = tckpt.load_family_checkpoint(out)
    assert family == "resnet" and spec.name == "ResNet18"
    assert "codebooks" in params["s3b1"]["conv1"]
    assert "kernel" in params["stem"]
    jfamily, jspec, jparams = jckpt.load_family_checkpoint(out)
    assert jfamily == "resnet"
    np.testing.assert_array_equal(
        np.asarray(jparams["s3b1"]["conv1"]["assignments"]),
        np.asarray(params["s3b1"]["conv1"]["assignments"]))
    assert os.path.exists(os.path.join(out, "class_names.txt"))
    assert tckpt.load_preprocessor(out).crop == 224


def test_make_family_cli_dense_from_torch(tmp_path):
    """--from-torch with --dense: the torchvision-format weights land in
    the family checkpoint bit for bit as the JAX package imports them."""
    from qcnn_tpu.models.torch_import import resnet_from_torch_state_dict
    from tests.test_torch_import import _mk_state_dict

    spec = jresnet.RESNETS["resnet18"]()
    sd = _mk_state_dict(spec, np.random.default_rng(5))
    pt = str(tmp_path / "weights.pth")
    torch.save(sd, pt)
    out = str(tmp_path / "ckpt")
    assert tcli.main(["make-family", "resnet18", out, "--from-torch", pt,
                      "--dense", "--cpu"]) == 0
    family, _, params = tckpt.load_family_checkpoint(out)
    assert family == "resnet"
    want = _tree(resnet_from_torch_state_dict(spec, sd))
    assert _tree(params) == want
    ref = resnet_from_torch_state_dict(spec, sd)
    np.testing.assert_array_equal(params["s2b0"]["proj"]["kernel"],
                                  ref["s2b0"]["proj"]["kernel"])


def test_serve_model_family_builds_its_engine(monkeypatch):
    """serve --model resnet18 (a tiny spec under the name) quantizes the
    seed-0 dense init on the serving device and serves the engine it
    builds; the engine answers with the probabilities of the same params
    through build_family_forward."""
    from qcnn_tpu_torch.models import common
    from qcnn_tpu_torch.serve import http

    spec = tresnet.ResNetSpec("ResNet18", (1, 1), (16, 32), num_classes=5,
                              in_size=32, bottleneck=False)
    monkeypatch.setitem(tresnet.RESNETS, "resnet18", lambda: spec)
    served = {}

    def fake_serve(engine, **kw):
        x = np.random.default_rng(0).standard_normal(
            (32, 32, 3)).astype(np.float32)
        served["probs"] = engine.submit(x).result(timeout=60)
        served["x"] = x
        engine.stop()

    monkeypatch.setattr(http, "serve", fake_serve)
    assert tcli.main(["serve", "--model", "resnet18", "--device", "cpu",
                      "--max-batch", "2"]) == 0
    pq = tresnet.quantize_params(spec, tresnet.init_dense_params(spec, 0),
                                 device="cpu")
    prepared, fwd, _ = common.build_family_forward("resnet", spec, pq,
                                                   device="cpu")
    want = fwd(prepared, served["x"][None]).numpy()[0]
    np.testing.assert_allclose(served["probs"], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("conv_impl", ["auto", "memory", "gemm", "lut"])
def test_opq_network_matches_jax_forward(setup, conv_impl):
    """quantize_network(opq="variance") keeps or drops the permutation per
    layer; whatever it keeps rides into prepare (decode at load) and into
    the in-step strategies (the conv's x permuted once, the fc's rows
    permuted), with the JAX package's logits on the same params (f32,
    1e-5 of the largest)."""
    from qcnn_tpu.models import network as jnet
    from qcnn_tpu_torch.models import prepare as tprepare

    jspec, tspec, params, x = setup
    q = quantize_network(gen(2), tspec, params, x_calib=x, opq="variance",
                         **GEOM)
    assert any("perm" in p for p in q if p is not None)
    want = np.asarray(jnet.forward(q, x, spec=jspec, conv_impl=conv_impl,
                                   with_softmax=False))
    prepared, ci, fi = tprepare.prepare_params(
        tspec, q, conv_impl=conv_impl, dtype=torch.float32, device="cpu")
    got = tnet.forward(prepared, x, spec=tspec, conv_impls=ci, fc_impls=fi,
                       with_softmax=False, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
