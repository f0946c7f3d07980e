"""The fused decode-conv (ops/cuda/pq_conv_fused.py), the memory-mode conv
route (ops/conv.memory_fused_route) and the conv impls fusedconv,
memory_fused and fc1x1, against the JAX package on the same NumPy inputs.
The JAX kernels run in interpret mode.

Tolerances: the kernel's plain version rtol 1e-4 of the largest |output|
(bf16 operands on both sides, products exact in f32, f32 sums in another
order); the impls the same, 1e-4, where both sides run a bf16 kernel, and
1e-5 where the route keeps an f32 caller on the exact decode."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.models import resnet as jresnet
from qcnn_tpu.ops import conv as jconv
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models import synth
from qcnn_tpu_torch.ops import conv as tconv
from qcnn_tpu_torch.ops.cuda import pq_conv_fused, pq_decode
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

# the module (the package re-exports its entry point under the same name)
jfused = importlib.import_module("qcnn_tpu.ops.pallas.pq_conv_fused")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv(rng, b, h, w, cin, cout, kh, s, k, d, scale=0.3):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    p = {
        "codebooks": (rng.standard_normal((s, k, d)) * scale).astype(
            np.float32),
        "assignments": rng.integers(0, k, size=(cout, kh, kh, s),
                                    dtype=np.uint8),
        "bias": rng.standard_normal(cout).astype(np.float32),
    }
    return x, p


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(1e-6,
                                                 float(np.abs(want).max()))


@pytest.mark.parametrize("b,h,w,cin,cout,kh,pad,s,k,d", [
    (2, 7, 7, 64, 96, 3, 1, 16, 16, 4),      # the JAX tests' cases
    (3, 9, 11, 32, 128, 3, 1, 8, 32, 4),
    (1, 14, 14, 48, 64, 5, 2, 24, 128, 2),
    (2, 7, 7, 50, 70, 3, 1, 13, 16, 4),
    (3, 6, 5, 40, 200, 3, 0, 40, 64, 1),     # pad 0, D=1, Cout ragged > 128
    (1, 5, 5, 300, 33, 3, 1, 75, 128, 4),    # Cin not a multiple of 128
    (2, 4, 6, 130, 129, 3, 1, 33, 8, 4),     # codebook overhang S*D > Cin
])
def test_plain_matches_pallas(rng, b, h, w, cin, cout, kh, pad, s, k, d):
    x, p = _conv(rng, b, h, w, cin, cout, kh, s, k, d)
    want = jfused.pq_conv_fused(jnp.asarray(x, jnp.bfloat16), p, stride=1,
                                pad=pad, interpret=True)
    got = pq_conv_fused.pq_conv_fused(T(x).to(torch.bfloat16),
                                      {k_: T(v) for k_, v in p.items()},
                                      stride=1, pad=pad)
    assert got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= 1e-4


def test_guards_raise_as_the_jax_entry(rng):
    x, p = _conv(rng, 1, 7, 7, 256, 40, 3, 64, 16, 4)
    tp = {k: T(v) for k, v in p.items()}
    xj, xt = jnp.asarray(x, jnp.bfloat16), T(x)

    def both(match, params, tparams, xs=(xj, xt), **kw):
        with pytest.raises(ValueError, match=match):
            jfused.pq_conv_fused(xs[0], params, interpret=True, **kw)
        with pytest.raises(ValueError, match=match):
            pq_conv_fused.pq_conv_fused(xs[1], tparams, **kw)

    # unsupported geometry: stride, groups, 1x1, K > 128, D = 8
    both("unsupported geometry", p, tp, stride=2, pad=1)
    both("unsupported geometry", p, tp, stride=1, pad=1, groups=2)
    one = dict(p, assignments=p["assignments"][:, :1, :1])
    both("unsupported geometry", one, {k: T(v) for k, v in one.items()},
         stride=1, pad=0)
    for cb in (np.zeros((64, 256, 4), np.float32),
               np.zeros((32, 16, 8), np.float32)):
        bad = dict(p, codebooks=cb,
                   assignments=p["assignments"][..., :cb.shape[0]])
        both("unsupported geometry", bad, {k: T(v) for k, v in bad.items()},
             stride=1, pad=1)
    # S mismatch
    bad = dict(p, assignments=p["assignments"][..., :60])
    both("S=60 != codebooks", bad, {k: T(v) for k, v in bad.items()},
         stride=1, pad=1)
    # codebooks covering fewer channels than Cin
    wide = rng.standard_normal((1, 7, 7, 512)).astype(np.float32)
    both("cover 256 channels < Cin=512", p, tp,
         xs=(jnp.asarray(wide, jnp.bfloat16), T(wide)), stride=1, pad=1)
    # one image too large for the TPU kernel's VMEM block
    big = np.zeros((1, 96, 96, 256), np.float32)
    both("exceeds the VMEM block budget", p, tp,
         xs=(jnp.asarray(big, jnp.bfloat16), T(big)), stride=1, pad=1)


def test_gates_match_the_jax_copies(rng):
    for h, w, pad, kh in ((7, 7, 1, 3), (14, 14, 1, 3), (56, 56, 1, 3),
                          (96, 96, 1, 3), (40, 40, 2, 5), (9, 11, 0, 3)):
        assert (pq_conv_fused._grid_geometry(h, w, pad, kh, kh)
                == jfused._grid_geometry(h, w, pad, kh, kh))
        assert (pq_conv_fused.fits_vmem(h, w, pad, kh, kh)
                == jfused.fits_vmem(h, w, pad, kh, kh))
    for s, k, d, kh in ((64, 128, 4, 3), (64, 16, 2, 3), (64, 16, 1, 5),
                        (16, 128, 8, 3), (64, 256, 4, 3), (64, 128, 4, 1)):
        p = {"codebooks": np.zeros((s, k, d)),
             "assignments": np.zeros((8, kh, kh, s), np.uint8)}
        for stride, groups, cin in ((1, 1, None), (1, 1, 256), (1, 1, 128),
                                    (2, 1, 256), (1, 2, 512)):
            assert (pq_conv_fused.supports(p, stride=stride, groups=groups,
                                           cin=cin)
                    == jfused.supports(p, stride=stride, groups=groups,
                                       cin=cin))


def _resnet_convs(spec, params, batch):
    """(name, params, x_shape, stride, pad) of every PQ conv of a ResNet
    forward, in order."""
    hw = spec.in_size // 4  # stem stride 2, pool stride 2
    out = []
    for key, stride, convs in tresnet.block_layout(spec):
        for name, kh, cin, _ in convs:
            # the strided conv of a block, and the convs after it
            strided = name == "proj" or name == (
                "conv2" if spec.bottleneck else "conv1")
            after = name == ("conv3" if spec.bottleneck else "conv2")
            size = hw // stride if after else hw
            out.append((f"{key}.{name}", params[key][name],
                        (batch, size, size, cin), stride if strided else 1,
                        kh // 2))
        hw //= stride
    return out


@pytest.mark.parametrize("model", ["resnet50", "resnet18"])
def test_memory_fused_route_matches_jax_on_resnet(model):
    tspec = tresnet.RESNETS[model]()
    params = synth.random_resnet_pq_params(tspec, seed=0)
    convs = _resnet_convs(tspec, params, 1)
    assert len(convs) == (52 if model == "resnet50" else 19)
    for batch in (64, 1):
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                         (torch.float32, jnp.float32)):
            routes = []
            for name, p, shape, stride, pad in convs:
                shape = (batch, *shape[1:])
                got = tconv.memory_fused_route(p, shape, tdt, stride=stride,
                                               pad=pad)
                want = jconv.memory_fused_route(p, shape, jdt, stride=stride,
                                                pad=pad)
                assert got == want, (name, batch, tdt)
                routes.append(got)
            if tdt == torch.float32:
                assert set(routes) == {"indecode_ohwi"}
            elif model == "resnet50":
                # conv2 of stage 2 blocks 1-5 and stage 3 blocks 1-2
                fused = [n for (n, *_), r in zip(convs, routes)
                         if r == "fusedconv"]
                assert fused == [f"s2b{b}.conv2" for b in range(1, 6)] + [
                    "s3b1.conv2", "s3b2.conv2"]
                assert routes.count("indecode_ohwi") == 45
            else:  # ResNet-18: the stride-1 3x3 convs of stages 2 and 3
                fused = [n for (n, *_), r in zip(convs, routes)
                         if r == "fusedconv"]
                assert fused == ["s2b0.conv2", "s2b1.conv1", "s2b1.conv2",
                                 "s3b0.conv2", "s3b1.conv1", "s3b1.conv2"]


def test_memory_fused_route_other_geometries(rng):
    bf16 = (torch.bfloat16, jnp.bfloat16)
    f32 = (torch.float32, jnp.float32)
    _, p3 = _conv(rng, 1, 1, 1, 256, 64, 3, 64, 16, 4)
    _, p1 = _conv(rng, 1, 1, 1, 256, 64, 1, 64, 16, 4)
    cases = [(p3, (1, 96, 96, 256), bf16, 1, 1, "indecode_ohwi"),  # VMEM
             (p3, (1, 7, 7, 256), bf16, 1, 1, "fusedconv"),
             (p3, (1, 7, 7, 256), f32, 1, 1, "indecode_ohwi"),
             (p3, (1, 8, 8, 256), bf16, 2, 1, "indecode_ohwi"),    # stride 2
             (p3, (1, 7, 7, 128), bf16, 1, 1, "indecode_ohwi"),    # cin 128
             (p1, (1, 8, 8, 256), bf16, 1, 0, "indecode_ohwi"),    # 1x1
             (p1, (4, 8, 8, 256), bf16, 2, 0, "indecode_ohwi")]
    for p, shape, (tdt, jdt), stride, pad, want in cases:
        assert tconv.memory_fused_route(p, shape, tdt, stride=stride,
                                        pad=pad) == want
        assert jconv.memory_fused_route(p, shape, jdt, stride=stride,
                                        pad=pad) == want
    # with the (TPU-measured, off) 1x1 reroute toggled on, as the JAX
    # package's tests do, both gates agree at its boundaries
    saved = (tconv._FC1X1_MAX_ROWS, jconv._FC1X1_MAX_ROWS)
    try:
        tconv._FC1X1_MAX_ROWS = jconv._FC1X1_MAX_ROWS = 4096
        for shape, stride, pad in (((1, 8, 8, 256), 1, 0),
                                   ((1, 8, 8, 255), 1, 0),
                                   ((64, 8, 8, 256), 1, 0),
                                   ((65, 8, 8, 256), 1, 0),
                                   ((163, 9, 9, 256), 2, 0),
                                   ((164, 9, 9, 256), 2, 0),
                                   ((1, 8, 8, 256), 1, 1)):
            assert (tconv.memory_fused_route(p1, shape, torch.bfloat16,
                                             stride=stride, pad=pad)
                    == jconv.memory_fused_route(p1, shape, jnp.bfloat16,
                                                stride=stride, pad=pad))
        assert tconv.memory_fused_route(p1, (1, 8, 8, 256), torch.bfloat16,
                                        stride=1, pad=0) == "fc1x1"
    finally:
        tconv._FC1X1_MAX_ROWS, jconv._FC1X1_MAX_ROWS = saved


@pytest.mark.parametrize("impl,b,hw,cin,cout,kh,stride,pad,dtype", [
    ("fusedconv", 2, 5, 256, 40, 3, 1, 1, "bfloat16"),
    ("fusedconv", 2, 5, 256, 40, 3, 1, 1, "float32"),   # any dtype
    ("memory_fused", 2, 5, 256, 40, 3, 1, 1, "bfloat16"),  # -> fused
    ("memory_fused", 2, 5, 256, 40, 3, 1, 1, "float32"),   # -> decode
    ("memory_fused", 2, 5, 256, 40, 3, 2, 1, "bfloat16"),  # -> decode
    ("memory_fused", 2, 5, 64, 16, 1, 1, 0, "bfloat16"),   # 1x1 -> decode
    ("fc1x1", 2, 5, 64, 16, 1, 1, 0, "bfloat16"),
    ("fc1x1", 2, 5, 64, 16, 1, 2, 0, "bfloat16"),
    ("fc1x1", 2, 7, 64, 16, 1, 2, 0, "bfloat16"),       # odd: ceil rows
])
def test_conv_impls_match_jax(rng, impl, b, hw, cin, cout, kh, stride, pad,
                              dtype):
    x, p = _conv(rng, b, hw, hw, cin, cout, kh, cin // 4, 16, 4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # codebooks in the compute dtype, as memory-mode prepare leaves them
    pj = dict(p, codebooks=jnp.asarray(p["codebooks"], jdt))
    tp = {k: T(v) for k, v in p.items()}
    tp["codebooks"] = tp["codebooks"].to(tdt)
    want = jconv.pq_conv(jnp.asarray(x, jdt), pj, stride=stride, pad=pad,
                         impl=impl, out_dtype=jdt)
    got = tconv.pq_conv(T(x).to(tdt), tp, stride=stride, pad=pad, impl=impl,
                        out_dtype=tdt)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" and impl == "memory_fused" else 1e-4
    if dtype == "bfloat16":
        tol = 1e-2  # both emit bf16: one rounding of the output apart
    assert _rel_err(got.float().numpy(), np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("kh,cin,cout", [(3, 256, 40), (1, 64, 16)])
def test_memory_fused_applies_an_opq_perm_once(rng, kh, cin, cout):
    """x is permuted before the route; the recursion into the fused kernel
    (or, with the 1x1 reroute on, fc1x1) must not permute it again."""
    x, p = _conv(rng, 2, 5, 5, cin, cout, kh, cin // 4, 16, 4)
    p["perm"] = rng.permutation(cin).astype(np.int32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = T(x).to(torch.bfloat16)
    tp = {k: T(v) for k, v in p.items()}
    pad = kh // 2
    saved = (tconv._FC1X1_MAX_ROWS, jconv._FC1X1_MAX_ROWS)
    try:
        tconv._FC1X1_MAX_ROWS = jconv._FC1X1_MAX_ROWS = 4096
        assert tconv.memory_fused_route(
            p, xt.shape, xt.dtype, stride=1, pad=pad) in ("fusedconv",
                                                          "fc1x1")
        want = jconv.pq_conv(xj, p, stride=1, pad=pad, impl="memory_fused")
        got = tconv.pq_conv(xt, tp, stride=1, pad=pad, impl="memory_fused")
    finally:
        tconv._FC1X1_MAX_ROWS, jconv._FC1X1_MAX_ROWS = saved
    assert _rel_err(got.numpy(), want) <= 1e-4
    decoded = tconv.pq_conv(xt.float(), tp, stride=1, pad=pad, impl="decode")
    assert _rel_err(got.numpy(), decoded.numpy()) <= 2e-2  # bf16 operands


def test_fused_impl_errors_match_jax(rng):
    x, p = _conv(rng, 1, 5, 5, 256, 40, 3, 64, 16, 4)
    tp = {k: T(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="use 'memory_fused'"):
        jconv.pq_conv(jnp.asarray(x), p, stride=2, pad=1, impl="fusedconv")
    with pytest.raises(ValueError, match="use 'memory_fused'"):
        tconv.pq_conv(T(x), tp, stride=2, pad=1, impl="fusedconv")
    with pytest.raises(ValueError, match="fc1x1 requires"):
        jconv.pq_conv(jnp.asarray(x), p, stride=1, pad=1, impl="fc1x1")
    with pytest.raises(ValueError, match="fc1x1 requires"):
        tconv.pq_conv(T(x), tp, stride=1, pad=1, impl="fc1x1")


def test_memory_forward_runs_the_fused_kernel_on_seven_convs(monkeypatch):
    """ResNet-50 in bf16 memory mode on the CPU: the entry points that
    launch pq_conv_fused and pq_decode on the card are called 7 and 17
    times a forward (chip_smoke.py holds the card's counts to these): the
    46 weights on the decode route go in one grouped launch at the head of
    each of the 16 blocks, and one for the fc head."""
    from qcnn_tpu_torch.models import common

    calls = {"fused": 0, "decode": 0, "decoded weights": 0}
    fused, decode = pq_conv_fused.pq_conv_fused, pq_decode.decode_rows_many

    def count_fused(*a, **kw):
        calls["fused"] += 1
        return fused(*a, **kw)

    def count_decode(items):
        items = list(items)
        calls["decode"] += 1
        calls["decoded weights"] += len(items)
        return decode(items)

    monkeypatch.setattr(pq_conv_fused, "pq_conv_fused", count_fused)
    monkeypatch.setattr(pq_decode, "decode_rows_many", count_decode)
    spec = tresnet.resnet50()
    params = synth.random_resnet_pq_params(spec, seed=0)
    prepared, fwd, _ = common.build_family_forward(
        "resnet", spec, params, memory=True, compute_dtype=torch.bfloat16,
        device="cpu")
    x = np.random.default_rng(1).standard_normal((1, 224, 224, 3)).astype(
        np.float32)
    out = fwd(prepared, x)
    assert out.shape == (1, 1000) and torch.isfinite(out).all()
    assert calls == {"fused": 7, "decode": 17, "decoded weights": 46}
    # the JAX package routes the same layers (spot check: the spec agrees)
    assert jresnet.resnet50().stage_channels == spec.stage_channels


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU takes the kernel path, which checks for a CUDA
    device and raises (a 'meta' tensor stands in for a device tensor)."""
    meta = {"codebooks": torch.empty((64, 16, 4), device="meta"),
            "assignments": torch.empty((40, 3, 3, 64), dtype=torch.uint8,
                                       device="meta"),
            "bias": torch.empty(40, device="meta")}
    x = torch.empty((1, 7, 7, 256), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        pq_conv_fused.pq_conv_fused(x, meta, stride=1, pad=1)
