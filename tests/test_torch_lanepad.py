"""The port's lane pad (``qcnn_tpu_torch/models/lanepad.py``) against the JAX
package's (``qcnn_tpu/models/lanepad.py``), on the CPU, from the same NumPy
PQ params prepared by each package: the same padded spec (the LRN
``channel_map`` tuples equal), the same padded arrays in f32 and int8, the
padded forward equal to the unpadded one (probabilities at rtol 1e-5 /
atol 1e-6 in f32, as ``tests/test_lanepad.py``, and 1e-4 / 1e-5 in int8) and
to the JAX padded forward (1e-4 in f32), the port's memory layouts kept,
and no-ops where the JAX pass is one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.formats import checkpoint as jckpt
from qcnn_tpu.models import network as jnet
from qcnn_tpu.models import zoo as jzoo
from qcnn_tpu.models.lanepad import lane_pad as jlane_pad
from qcnn_tpu.models.prepare import prepare_params as jprepare
from qcnn_tpu.ops.pallas._common import ceil_to as jceil_to
from qcnn_tpu_torch.core import ConvSpec, LRNSpec
from qcnn_tpu_torch.formats import checkpoint as tckpt
from qcnn_tpu_torch.models import network as tnet
from qcnn_tpu_torch.models import synth as tsynth
from qcnn_tpu_torch.models import zoo as tzoo
from qcnn_tpu_torch.models.lanepad import ceil_to, lane_pad
from qcnn_tpu_torch.models.prepare import prepare_params as tprepare
from qcnn_tpu_torch.ops.fc import padded_k
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

B = 2


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _prepared(model, dtype, **kw):
    """(params, the port's (spec, prepared, impls), the JAX package's)."""
    params = tsynth.random_pq_params(tzoo.MODELS[model](), seed=3)
    tdt = {"f32": torch.float32, "int8": torch.int8}[dtype]
    jdt = {"f32": jnp.float32, "int8": jnp.int8}[dtype]
    tspec, jspec = tzoo.MODELS[model](), jzoo.MODELS[model]()
    tp, tci, tfi = tprepare(tspec, params, batch_hint=B, dtype=tdt,
                            device="cpu", **kw)
    jp, jci, jfi = jprepare(jspec, params, batch_hint=B, dtype=jdt, **kw)
    return params, (tspec, tp, tci, tfi), (jspec, jp, jci, jfi)


def _input(spec, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (B, spec.in_height, spec.in_width, spec.in_channels)).astype(
            np.float32)


def test_ceil_to_matches():
    for x in (1, 96, 127, 128, 129, 383):
        for m in (8, 128):
            assert ceil_to(x, m) == jceil_to(x, m)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("model", ["alexnet", "caffenet", "vgg_cnn_s"])
def test_padded_spec_and_arrays_match_jax(model, dtype):
    _, (tspec, tp, _, _), (jspec, jp, _, _) = _prepared(model, dtype)
    tspec2, tp2 = lane_pad(tspec, tp)
    jspec2, jp2 = jlane_pad(jspec, jp)
    assert tspec2 is not tspec and jspec2 is not jspec
    assert tckpt.spec_to_dict(tspec2) == jckpt.spec_to_dict(jspec2)
    maps = [(tl.channel_map, jl.channel_map)
            for tl, jl in zip(tspec2.layers, jspec2.layers)
            if isinstance(tl, LRNSpec) and tl.channel_map is not None]
    assert maps
    for tmap, jmap in maps:
        assert isinstance(tmap, tuple) and tmap == jmap
    for i, (t, j) in enumerate(zip(tp2, jp2)):
        assert (t is None) == (j is None)
        if t is None:
            continue
        assert sorted(t) == sorted(j), i
        for key in t:
            got, want = _np(t[key]), np.asarray(j[key])
            assert got.shape == want.shape, (i, key)
            np.testing.assert_array_equal(got, want, err_msg=f"{i} {key}")


def _kernel_key(p):
    return "kernel" if "kernel" in p else "kernel_q"


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_padded_kernels_keep_the_ports_memory(dtype):
    """Each padded kernel is OHWI in memory (int8: its rows padded to a
    multiple of 8 for the int8 GEMM, with the gap zero), on the input's
    device in the input's dtype; the input params are not changed."""
    _, (spec, tp, _, _), _ = _prepared("alexnet", dtype)
    before = [None if p is None else {k: v.clone() for k, v in p.items()}
              for p in tp]
    spec2, tp2 = lane_pad(spec, tp)
    convs = [i for i, layer in enumerate(spec2.layers)
             if isinstance(layer, ConvSpec)][:2]
    for i in convs:
        key = _kernel_key(tp2[i])
        k = tp2[i][key]
        assert k.dtype == tp[i][key].dtype and k.device == tp[i][key].device
        kh, kw, cg, cout = k.shape
        ohwi = k.permute(3, 0, 1, 2)
        if dtype == "f32":
            assert ohwi.is_contiguous()
            continue
        row = padded_k(kh * kw * cg)
        assert ohwi.stride() == (row, kw * cg, cg, 1)
        rows = torch.as_strided(ohwi, (cout, row), (row, 1))
        assert not rows[:, kh * kw * cg:].any()
    assert tp2[convs[0]][_kernel_key(tp2[convs[0]])].shape[-1] == 128
    assert tp2[convs[1]][_kernel_key(tp2[convs[1]])].shape[2] == 64
    if dtype == "int8":
        scale = tp2[convs[0]]["scale"]
        assert scale.shape == (128,) and scale.dtype == torch.float32
        assert int((scale == 1.0).sum()) >= 32
        for key in ("act_scale", "out_scale"):
            for i in convs:
                if key in tp[i]:
                    assert tp2[i][key] is tp[i][key]
    for p, q in zip(tp, before):
        for key in p or {}:
            assert torch.equal(p[key], q[key])


@pytest.mark.parametrize("model", ["alexnet", "caffenet", "vgg_cnn_s"])
def test_padded_forward_equals_unpadded_f32(model):
    _, (spec, tp, ci, fi), _ = _prepared(model, "f32")
    spec2, tp2 = lane_pad(spec, tp)
    conv1 = next(layer for layer in spec2.layers
                 if isinstance(layer, ConvSpec))
    assert conv1.out_channels == 128
    x = _input(spec)
    want = tnet.forward(tp, x, spec=spec, conv_impls=ci, fc_impls=fi,
                        device="cpu").numpy()
    got = tnet.forward(tp2, x, spec=spec2, conv_impls=ci, fc_impls=fi,
                       device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_padded_forward_equals_unpadded_int8():
    _, (spec, tp, ci, fi), _ = _prepared("alexnet", "int8")
    spec2, tp2 = lane_pad(spec, tp)
    assert spec2 is not spec
    x = _input(spec)
    kw = dict(conv_impls=ci, fc_impls=fi, compute_dtype=torch.bfloat16,
              device="cpu")
    want = tnet.forward(tp, x, spec=spec, **kw).float().numpy()
    got = tnet.forward(tp2, x, spec=spec2, **kw).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_padded_forward_equals_the_jax_padded_forward():
    _, (tspec, tp, tci, tfi), (jspec, jp, jci, jfi) = _prepared("alexnet",
                                                                "f32")
    tspec2, tp2 = lane_pad(tspec, tp)
    jspec2, jp2 = jlane_pad(jspec, jp)
    x = _input(tspec, seed=8)
    want = np.asarray(jnet.forward(jp2, jnp.asarray(x), spec=jspec2,
                                   conv_impls=jci, fc_impls=jfi,
                                   with_softmax=False))
    got = tnet.forward(tp2, x, spec=tspec2, conv_impls=tci, fc_impls=tfi,
                       with_softmax=False, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_noop_when_memory_mode():
    """PQ-kept layers (memory mode) must not be touched: the subspace
    structure of compressed params cannot absorb the pad."""
    _, (spec, tp, ci, fi), _ = _prepared("alexnet", "f32",
                                         conv_impl="memory",
                                         fc_impl="memory")
    assert "codebooks" in tp[0]
    spec2, tp2 = lane_pad(spec, tp)
    assert spec2 is spec
    assert all(a is b for a, b in zip(tp2, tp))


def test_noop_when_aligned():
    """A model whose convs are already 128-aligned is untouched (VGG16's
    64 -> 128 would double the MACs: the 3/2 guard)."""
    spec = tzoo.vgg16()
    params = tsynth.random_pq_params(spec, seed=0)
    tp, _, _ = tprepare(spec, params, batch_hint=1, device="cpu")
    spec2, _ = lane_pad(spec, tp)
    assert spec2 is spec
