"""The ResNet family (models/resnet.py, models/common.build_family_forward,
models/synth.random_resnet_pq_params, models/interop.family_params_from_jax)
against the JAX package on the same NumPy PQ params.

The JAX side prepares the params and runs ``qcnn_tpu.models.resnet.forward``
(Pallas in interpret mode); the port runs both the JAX-prepared params,
carried across by ``family_params_from_jax``, and its own
``build_family_forward`` on the raw params.

Tolerances and what was measured on the CPU with these seeds:
- float32 decode at load: logits 1e-5 of their largest magnitude (measured
  4e-7 on the small specs, 1.3e-6 on ResNet-50), probabilities 1e-6;
- bfloat16 memory mode: logits 1e-2 of their largest magnitude (measured
  1.1e-3 on the small specs, 2.2e-3 on ResNet-50: bf16 rounds at other
  places in the two frameworks, through 10 to 53 convs), probabilities 2e-3
  (measured 2.2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.models import common as jcommon
from qcnn_tpu.models import resnet as jresnet
from qcnn_tpu_torch.models import common as tcommon
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models import synth
from qcnn_tpu_torch.models.interop import family_params_from_jax
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

SMALL = {
    # stage 1's stride-1 3x3 convs take 256 channels: memory mode fuses them
    "basic": dict(name="basic", stage_depths=(1, 2),
                  stage_channels=(64, 256), num_classes=10, in_size=32,
                  bottleneck=False),
    "bottleneck": dict(name="bottleneck", stage_depths=(1, 2),
                       stage_channels=(64, 1024), num_classes=10,
                       in_size=32, bottleneck=True),
}
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (1e-2, 2e-3)}


def _compare(jspec, tspec, params, batch, memory, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(1).standard_normal(
        (batch, tspec.in_size, tspec.in_size, 3)).astype(np.float32)
    pj = jresnet.prepare_params(jspec, params, dtype=jdt, memory=memory)
    want = np.asarray(jresnet.forward(pj, jnp.asarray(x), spec=jspec,
                                      compute_dtype=jdt), np.float32)
    carried = tresnet.forward(family_params_from_jax(pj, device="cpu"), x,
                              spec=tspec, compute_dtype=tdt, device="cpu")
    prepared, fwd, act = tcommon.build_family_forward(
        "resnet", tspec, params, memory=memory, compute_dtype=tdt,
        device="cpu")
    assert act == tdt
    probs = fwd(prepared, x)
    logit_tol, prob_tol = TOL[dtype]
    scale = float(np.abs(want).max())
    assert carried.shape == (batch, tspec.num_classes)
    assert float(np.abs(carried.numpy() - want).max()) <= logit_tol * scale
    p_want = np.asarray(jax.nn.softmax(want))
    assert probs.dtype == torch.float32 and torch.isfinite(probs).all()
    assert float(np.abs(probs.numpy() - p_want).max()) <= prob_tol
    np.testing.assert_array_equal(probs.numpy().argmax(1), want.argmax(1))
    return prepared


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
@pytest.mark.parametrize("memory,dtype", [(True, "bfloat16"),
                                          (False, "float32")])
def test_small_resnet_matches_jax(kind, memory, dtype):
    jspec = jresnet.ResNetSpec(**SMALL[kind])
    tspec = tresnet.ResNetSpec(**SMALL[kind])
    params = synth.random_resnet_pq_params(tspec, seed=0)
    prepared = _compare(jspec, tspec, params, 3, memory, dtype)
    if memory:
        # compressed: codebooks in bf16, uint8 ids, no dense kernel but the
        # stem's
        conv = prepared["s1b1"]["conv2"]
        assert conv["codebooks"].dtype == torch.bfloat16
        assert conv["assignments"].dtype == torch.uint8
        assert "kernel" in prepared["stem"]
    else:
        assert "kernel" in prepared["s1b1"]["conv2"]


@pytest.mark.parametrize("memory,dtype", [(False, "float32"),
                                          (True, "bfloat16")])
def test_full_width_resnet50_matches_jax(memory, dtype):
    """Full-width ResNet-50 (224x224, 1000 classes) at B=1."""
    params = synth.random_resnet_pq_params(tresnet.resnet50(), seed=0)
    _compare(jresnet.resnet50(), tresnet.resnet50(), params, 1, memory,
             dtype)


def test_opq_perm_is_folded_at_load_and_applied_in_step(rng):
    spec_kw = SMALL["basic"]
    tspec = tresnet.ResNetSpec(**spec_kw)
    params = synth.random_resnet_pq_params(tspec, seed=0)
    conv = params["s1b1"]["conv1"]
    conv["perm"] = rng.permutation(256).astype(np.int32)
    fc = params["fc"]
    fc["perm"] = rng.permutation(256).astype(np.int32)
    jspec = jresnet.ResNetSpec(**spec_kw)
    _compare(jspec, tspec, params, 2, False, "float32")
    _compare(jspec, tspec, params, 2, True, "bfloat16")


def test_synth_geometry_matches_quantize_params():
    """The layout and codebook geometry of resnet.quantize_params: convs
    with cin >= 16 get D=4, K=128; the stem stays dense; the fc D=4, K=32;
    the same keys as init_dense_params."""
    spec = tresnet.resnet50()
    params = synth.random_resnet_pq_params(spec, seed=0)
    dense = jresnet.init_dense_params(jresnet.resnet50(), seed=0)
    assert params.keys() == dense.keys()
    assert "kernel" in params["stem"]
    cins = tresnet._conv_cin_map(spec)
    for key, block in dense.items():
        if key in ("stem", "fc"):
            continue
        assert params[key].keys() == block.keys()
        for name, p in block.items():
            kh, _, cin, cout = p["kernel"].shape
            q = params[key][name]
            assert cins[f"{key}.{name}"] == cin
            assert q["codebooks"].shape == (-(-cin // 4), 128, 4)
            assert q["assignments"].shape == (cout, kh, kh, -(-cin // 4))
            assert q["assignments"].dtype == np.uint8
            # decoded weights have init_dense_params' scale
            assert abs(q["codebooks"].std() * np.sqrt(kh * kh * cin) - 1) < .2
    assert params["fc"]["codebooks"].shape == (512, 32, 4)
    assert params["fc"]["assignments"].shape == (1000, 512)
    np.testing.assert_array_equal(
        synth.random_resnet_pq_params(spec, seed=0)["s0b0"]["conv1"][
            "assignments"], params["s0b0"]["conv1"]["assignments"])


def _assert_same_tree(ours, theirs):
    if isinstance(theirs, dict):
        assert ours.keys() == theirs.keys()
        for key in theirs:
            _assert_same_tree(ours[key], theirs[key])
    else:
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("model", ["resnet18", "resnet50"])
def test_copies_match_the_jax_package(model):
    tspec, jspec = tresnet.RESNETS[model](), jresnet.RESNETS[model]()
    assert tspec.__dict__ == jspec.__dict__
    assert tresnet._conv_cin_map(tspec) == {
        k: v for k, v in jresnet._conv_cin_map(jspec).items()
        if k in tresnet._conv_cin_map(tspec)}
    _assert_same_tree(tresnet.init_dense_params(tspec, seed=3),
                      jresnet.init_dense_params(jspec, seed=3))
    for name in ("resnet50", "resnet101", "resnet152", "vit_b16", "alexnet"):
        assert (tcommon.serving_defaults(name)
                == jcommon.serving_defaults(name))


def test_fold_batchnorm_matches(rng):
    conv = {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
            "bias": rng.standard_normal(8).astype(np.float32)}
    bn = [rng.standard_normal(8).astype(np.float32) for _ in range(3)]
    var = rng.random(8).astype(np.float32) + 0.5
    ours = tresnet.fold_batchnorm(conv, *bn, var)
    theirs = jresnet.fold_batchnorm(conv, *bn, var)
    for key in theirs:
        np.testing.assert_array_equal(ours[key], theirs[key])


def test_forward_segments_compose_to_forward():
    tspec = tresnet.ResNetSpec(**SMALL["bottleneck"])
    params = synth.random_resnet_pq_params(tspec, seed=0)
    prepared = tresnet.prepare_params(tspec, params, dtype=torch.float32,
                                      device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    segs = tresnet.forward_segments(tspec, compute_dtype=torch.float32)
    assert [n for n, _ in segs] == ["stem+pool", "stage0", "stage1", "head"]
    y = x
    for _, fn in segs:
        y = fn(y, prepared)
    want = tresnet.forward(prepared, x, spec=tspec,
                           compute_dtype=torch.float32, device="cpu")
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_unported_parts_raise_naming_the_roadmap():
    """Nothing here is left unported. The quantizer (A11) runs: without a
    card it raises rather than run on the CPU unasked, and on the CPU it
    quantizes the JAX package's leaves with its shapes and dtypes
    (tests/test_torch_sequential_quantize.py holds it further). int8 is
    ported: its prepare quantizes and build_family_forward runs it with
    bf16 activations. ViT is ported: build_family_forward("vit") runs."""
    spec = tresnet.ResNetSpec(**SMALL["basic"])
    params = synth.random_resnet_pq_params(spec, seed=0)
    dense = tresnet.init_dense_params(spec)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tresnet.quantize_params(spec, dense)
    got = tresnet.quantize_params(spec, dense, conv_codewords=8,
                                  fc_codewords=8, device="cpu")
    want = jresnet.quantize_params(jresnet.ResNetSpec(**SMALL["basic"]),
                                   dense, conv_codewords=8, fc_codewords=8)
    for key in want:
        for name, leaf in want[key].items():
            if isinstance(leaf, dict):
                assert {n: np.asarray(v).shape for n, v in leaf.items()} == \
                    {n: v.shape for n, v in got[key][name].items()}
            else:
                assert np.asarray(leaf).shape == got[key][name].shape
    prepared = tresnet.prepare_params(spec, params, dtype=torch.int8,
                                      device="cpu")
    assert prepared["s0b0"]["conv1"]["kernel_q"].dtype == torch.int8
    assert prepared["fc"]["scale"].dtype == torch.float32
    prepared, fwd, act = tcommon.build_family_forward(
        "resnet", spec, params, compute_dtype=torch.int8, device="cpu")
    assert act == torch.bfloat16
    probs = fwd(prepared, np.zeros((1, 32, 32, 3), np.float32))
    assert probs.shape == (1, 10) and torch.isfinite(probs).all()
    from qcnn_tpu_torch.models import vit as tvit

    vspec = tvit.vit_tiny_test()
    prepared, fwd, act = tcommon.build_family_forward(
        "vit", vspec, synth.random_vit_pq_params(vspec, seed=0),
        memory=True, device="cpu")
    assert act == torch.float32 and tcommon.FAMILIES == ("resnet", "vit",
                                                         "swin", "maxvit")
    probs = fwd(prepared, np.zeros((2, 32, 32, 3), np.float32))
    assert probs.shape == (2, 10) and torch.isfinite(probs).all()
    torch.testing.assert_close(probs.sum(1), torch.ones(2))
    with pytest.raises(ValueError, match="unknown model family"):
        tcommon.build_family_forward("vgg", spec, params, device="cpu")


def test_family_interop_keeps_bf16_bits_and_layouts():
    jspec = jresnet.ResNetSpec(**SMALL["basic"])
    tspec = tresnet.ResNetSpec(**SMALL["basic"])
    params = synth.random_resnet_pq_params(tspec, seed=0)
    for memory in (False, True):
        pj = jresnet.prepare_params(jspec, params, dtype=jnp.bfloat16,
                                    memory=memory)
        carried = family_params_from_jax(pj, device="cpu")
        ours = tresnet.prepare_params(tspec, params, dtype=torch.bfloat16,
                                      memory=memory, device="cpu")
        assert carried.keys() == ours.keys()
        for name in ours:
            layers = ({name: ours[name]} if name in ("stem", "fc")
                      else ours[name])
            got = ({name: carried[name]} if name in ("stem", "fc")
                   else carried[name])
            for key, layer in layers.items():
                for leaf, t in layer.items():
                    c = got[key][leaf]
                    assert c.dtype == t.dtype and c.shape == t.shape, leaf
                    assert c.stride() == t.stride(), (name, key, leaf)
                    assert torch.equal(c, t), (name, key, leaf)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_family_interop_carries_vit_params(dtype):
    """JAX-prepared ViT params carry across with their bits and the port's
    layouts: the bare top-level ``cls_token`` and ``pos_embed`` arrays, a
    LayerNorm's ``scale`` as float32 beside an int8 GEMM's per-channel
    ``scale``, decode at load and memory mode."""
    from qcnn_tpu.models import vit as jvit

    from qcnn_tpu_torch.models import vit as tvit

    jspec, tspec = jvit.vit_tiny_test(), tvit.vit_tiny_test()
    params = synth.random_vit_pq_params(tspec, seed=0)
    for memory in (False, True):
        pj = jvit.prepare_params(jspec, params, dtype=getattr(jnp, dtype),
                                 memory=memory)
        carried = family_params_from_jax(pj, device="cpu")
        ours = tvit.prepare_params(tspec, params,
                                   dtype=getattr(torch, dtype),
                                   memory=memory, device="cpu")

        def same(c, t, where):
            if isinstance(t, dict):
                assert c.keys() == t.keys(), where
                for key in t:
                    same(c[key], t[key], f"{where}.{key}")
                return
            assert c.dtype == t.dtype and c.shape == t.shape, where
            assert c.stride() == t.stride(), where
            assert torch.equal(c, t), where

        same(carried, ours, f"{dtype} memory={memory}")
        np.testing.assert_array_equal(carried["cls_token"].numpy(),
                                      params["cls_token"])
        assert carried["pos_embed"].shape == (1, 17, 64)
        assert carried["blk0"]["ln1"]["scale"].dtype == torch.float32
        if dtype == "int8" and not memory:
            assert carried["blk0"]["qkv"]["weight_q"].dtype == torch.int8
            assert carried["blk0"]["qkv"]["scale"].shape == (192,)


def test_prepare_takes_a_bare_top_level_conv():
    """A top-level entry that is a conv (PQ or dense), not a block, is
    prepared as one, as the JAX package does (qcnn_tpu/models/resnet.py:
    373-374): bit-equal bf16 weights, the decode's Cin taken from S*D."""
    jspec = jresnet.ResNetSpec(**SMALL["basic"])
    tspec = tresnet.ResNetSpec(**SMALL["basic"])
    params = synth.random_resnet_pq_params(tspec, seed=0)
    params["extra"] = params["s1b0"]["conv2"]   # PQ, S*D = 256
    params["extra_dense"] = params["stem"]      # dense
    pj = jresnet.prepare_params(jspec, params, dtype=jnp.bfloat16)
    carried = family_params_from_jax(pj, device="cpu")
    ours = tresnet.prepare_params(tspec, params, dtype=torch.bfloat16,
                                  device="cpu")
    for name in ("extra", "extra_dense"):
        for leaf, t in ours[name].items():
            assert torch.equal(t, carried[name][leaf]), (name, leaf)
            assert t.stride() == carried[name][leaf].stride()
