"""The weighted-layer seam (``ops.conv.conv_layer``, ``ops.fc.fc_layer``)
and the one walk of a ModelSpec (``models.network.layer_plan``), on the
CPU at small sizes.

The seam is the only forward-time reader of a conv's or FC's param format,
and it emits the activation dtype on every route: the float32 that the
fused kernels' and the gather routes' plain versions return is cast there,
once; int8 codes (an ``out_scale``) stay codes. A residual and an
activation join the product's epilogue there. The walk is the one that
``network.forward``, ``make_sharded_forward`` and ``profile_layers`` run:
each executes, layer by layer, the strategies ``resolve_strategy`` gives
for the global batch and the activation dtype."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from qcnn_tpu_torch import core
from qcnn_tpu_torch.eval import profiler
from qcnn_tpu_torch.models import network, synth
from qcnn_tpu_torch.models.prepare import dense_layer
from qcnn_tpu_torch.ops import conv as conv_ops
from qcnn_tpu_torch.ops import fc as fc_ops
from qcnn_tpu_torch.parallel import sharding
from qcnn_tpu_torch.parallel.mesh import make_mesh
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
S, K, D = 4, 16, 4  # sub-spaces, codewords, sub-vector length: Cin 16
COUT = 8


def _pq(rng, assignments_shape, dtype) -> dict:
    return {
        "codebooks": torch.as_tensor(
            rng.standard_normal((S, K, D)).astype(np.float32)).to(dtype),
        "assignments": torch.as_tensor(
            rng.integers(0, K, assignments_shape).astype(np.uint8)),
        "bias": torch.as_tensor(
            rng.standard_normal(COUT).astype(np.float32)),
    }


def _dense(rng, kind: str, rows_shape, dtype, out_scale=None) -> dict:
    rows = rng.standard_normal(rows_shape).astype(np.float32) / 4
    p = dense_layer(kind, rows, np.linspace(-1, 1, COUT, dtype=np.float32),
                    dtype, "cpu")
    if out_scale is not None:
        p["out_scale"] = torch.tensor(np.float32(out_scale))
    return p


# a conv layer's formats and PQ impls, each with the tap count it needs
CONV_ROUTES = ([(impl, 3) for impl in conv_ops._IMPLS if impl != "fc1x1"]
               + [("fc1x1", 1), ("dense", 3), ("int8", 3),
                  ("int8-codes", 3)])
FC_ROUTES = ["onehot", "gather", "decode", "indecode", "gdecode", "pallas",
             "lutgather", "fused", "fgather", "dense", "int8", "int8-codes"]


def _conv_case(route, taps, dtype):
    """(x, params, impl, the product of the op the route names)."""
    rng = np.random.default_rng(taps)
    x = torch.as_tensor(
        rng.standard_normal((2, 6, 6, S * D)).astype(np.float32)).to(dtype)
    pad = taps // 2
    geo = dict(stride=1, pad=pad, groups=1)
    if route.startswith("int8"):
        p = _dense(rng, "kernel", (COUT, taps, taps, S * D), torch.int8,
                   0.05 if route == "int8-codes" else None)
        want = conv_ops.conv_dense_int8(
            x, p["kernel_q"], p["scale"], p["bias"],
            out_scale=p.get("out_scale"), **geo)
        return x, p, "dense", want
    if route == "dense":
        p = _dense(rng, "kernel", (COUT, taps, taps, S * D), dtype)
        return x, p, "dense", conv_ops.conv_dense(
            x, p["kernel"], p["bias"], out_dtype=dtype, **geo)
    p = _pq(rng, (COUT, taps, taps, S), dtype)
    return x, p, route, conv_ops.pq_conv(x, p, impl=route, out_dtype=dtype,
                                         **geo)


def _fc_case(route, dtype):
    rng = np.random.default_rng(7)
    x = torch.as_tensor(
        rng.standard_normal((3, S * D)).astype(np.float32)).to(dtype)
    if route.startswith("int8"):
        p = _dense(rng, "weight", (COUT, S * D), torch.int8,
                   0.05 if route == "int8-codes" else None)
        want = fc_ops.fc_dense_int8(x, p["weight_q"], p["scale"], p["bias"],
                                    out_scale=p.get("out_scale"))
        return x, p, "dense", want
    if route == "dense":
        p = _dense(rng, "weight", (COUT, S * D), dtype)
        return x, p, "dense", fc_ops.fc_dense(x, p["weight"], p["bias"],
                                              out_dtype=dtype)
    p = _pq(rng, (COUT, S), dtype)
    return x, p, route, fc_ops.pq_fc(x, p, impl=route, out_dtype=dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layer,route", [("conv", r) for r in CONV_ROUTES]
                         + [("fc", r) for r in FC_ROUTES],
                         ids=lambda v: v if isinstance(v, str) else
                         f"{v[0]}-{v[1]}x{v[1]}")
def test_seam_emits_the_activation_dtype_on_every_route(layer, route,
                                                        dtype):
    """The seam's output is the op's own product in ``out_dtype``, cast
    once where the op returns float32 (the plain versions of the kernel
    routes, the gather, int8 values); int8 codes stay codes."""
    dt = DTYPES[dtype]
    if layer == "conv":
        (route, taps) = route
        x, p, impl, want = _conv_case(route, taps, dt)
        got = conv_ops.conv_layer(x, p, impl=impl, stride=1, pad=taps // 2,
                                  out_dtype=dt)
    else:
        x, p, impl, want = _fc_case(route, dt)
        got = fc_ops.fc_layer(x, p, impl=impl, out_dtype=dt)
    codes = route == "int8-codes"
    assert got.dtype == (torch.int8 if codes else dt)
    assert torch.equal(got, want if codes else want.to(dt))
    # out_dtype None keeps whatever the product is
    if layer == "fc":
        kept = fc_ops.fc_layer(x, p, impl=impl)
        assert kept.dtype == (torch.int8 if codes else torch.float32)


TAILS = {"relu": dict(act="relu"), "gelu": dict(act="gelu"),
         "residual": dict(residual=True),
         "residual-relu": dict(act="relu", residual=True)}
ACTS = {None: lambda v: v, "relu": torch.relu,
        "gelu": torch.nn.functional.gelu}


@pytest.mark.parametrize("tail", sorted(TAILS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layer,route",
                         [("conv", r) for r in CONV_ROUTES
                          if r[0] != "int8-codes"]
                         + [("fc", r) for r in FC_ROUTES
                            if r != "int8-codes"],
                         ids=lambda v: v if isinstance(v, str) else
                         f"{v[0]}-{v[1]}x{v[1]}")
def test_seam_adds_the_residual_then_the_activation_on_every_route(
        layer, route, dtype, tail):
    """With ``residual`` and ``act`` the seam's output is its emitted
    product, then the residual added in the activation dtype, then the
    activation, as the forwards ran them after the seam; an int8 conv's
    float32 values take the activation before their cast where no residual
    joins, as ResNet's int8 convs always did."""
    dt = DTYPES[dtype]
    kw = TAILS[tail]
    if layer == "conv":
        (route, taps) = route
        x, p, impl, want = _conv_case(route, taps, dt)
    else:
        x, p, impl, want = _fc_case(route, dt)
    gen = torch.Generator().manual_seed(len(tail))
    res = torch.randn(want.shape, generator=gen).to(dt)
    act = ACTS[kw.get("act")]
    if route == "int8" and layer == "conv" and "residual" not in kw:
        expected = act(want).to(dt)
    else:
        expected = want.to(dt)
        if "residual" in kw:
            expected = expected + res
        expected = act(expected)
    tail_kw = dict(act=kw.get("act"),
                   residual=res if "residual" in kw else None)
    if layer == "conv":
        got = conv_ops.conv_layer(x, p, impl=impl, stride=1, pad=taps // 2,
                                  out_dtype=dt, **tail_kw)
    else:
        got = fc_ops.fc_layer(x, p, impl=impl, out_dtype=dt, **tail_kw)
    assert got.dtype == dt
    assert torch.equal(got, expected)


# --- the one walk --------------------------------------------------------

# an fc6-class first FC (S*D = 4096 features): its memory route depends on
# the batch (fgather at 4 rows, lutgather at 1), the second decodes in step
SPEC = core.ModelSpec(
    name="walk", in_height=8, in_width=8, in_channels=8,
    layers=(core.ConvSpec(kernel=3, out_channels=64, pad=1),
            core.ReLUSpec(), core.FCSpec(64), core.ReLUSpec(),
            core.DropoutSpec(0.5), core.FCSpec(16), core.SoftmaxSpec()))
BATCH = 4


def _want_plan(params):
    conv_r, fc_r = network.resolve_strategy(SPEC, params, BATCH, "memory",
                                            "memory", dtype=torch.bfloat16)
    first_fc = next(i for i, layer in enumerate(SPEC.layers)
                    if isinstance(layer, core.FCSpec))
    plan = [(i, conv_r[i] if isinstance(layer, core.ConvSpec) else fc_r[i]
             if isinstance(layer, core.FCSpec) else "-", i == first_fc)
            for i, layer in enumerate(SPEC.layers)]
    assert [impl for _, impl, _ in plan if impl != "-"] == [
        "indecode_ohwi", "fgather", "indecode"]
    return plan


def _spy(monkeypatch, params):
    """(plans each walk took, {layer index: impl run}) recorded from
    ``network.layer_plan`` and the layer calls of the walks."""
    plans, ran = [], {}
    real_plan, real_apply = network.layer_plan, network.apply_layer

    def plan(*a, **kw):
        plans.append(real_plan(*a, **kw))
        return plans[-1]

    def apply(layer, p, x, impl, *, index, **kw):
        if isinstance(layer, (core.ConvSpec, core.FCSpec)):
            ran[index] = impl
        return real_apply(layer, p, x, impl, index=index, **kw)

    def sharded(real):
        def fc(x, p, impl, *a, **kw):
            ran[next(i for i, q in enumerate(params) if q is p)] = impl
            return real(x, p, impl, *a, **kw)
        return fc

    monkeypatch.setattr(network, "layer_plan", plan)
    monkeypatch.setattr(network, "apply_layer", apply)
    monkeypatch.setattr(sharding, "column_fc", sharded(sharding.column_fc))
    monkeypatch.setattr(sharding, "row_fc", sharded(sharding.row_fc))
    return plans, ran


def _check(plans, ran, want):
    assert len(plans) == 1
    assert [(i, impl, first) for i, _, impl, first in plans[0]] == want
    assert ran == {i: impl for i, impl, _ in want if impl != "-"}


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank gloo group on a file store and its (1, 1) mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield make_mesh(dp=1, tp=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("walker", ["forward", "profile_layers",
                                    "sharded-column", "sharded-row",
                                    "sharded-replicated"])
def test_every_walk_runs_the_plan_of_resolve_strategy(monkeypatch, request,
                                                      walker):
    """Each walk takes its plan from ``network.layer_plan`` once and runs
    every conv and FC with the strategy ``resolve_strategy`` resolves for
    the global batch in bf16, the first FC flattening; the sharded forward
    resolves on the global shapes, and takes the global batch."""
    params = synth.random_pq_params(SPEC, seed=1)
    x = synth.random_input(SPEC, BATCH, seed=2)
    want = _want_plan(params)
    kw = dict(conv_impl="memory", fc_impl="memory",
              compute_dtype=torch.bfloat16)
    if walker.startswith("sharded"):
        mode = walker.split("-")[1]
        mesh = request.getfixturevalue("world_of_one")
        sharded = sharding.shard_params(SPEC, params, mesh, fc_mode=mode,
                                        device="cpu")
        plans, ran = _spy(monkeypatch, sharded)
        fwd = sharding.make_sharded_forward(SPEC, mesh, fc_mode=mode,
                                            device="cpu", **kw)
        got = fwd(sharded, x)
    else:
        plans, ran = _spy(monkeypatch, params)
        if walker == "forward":
            got = network.forward(params, x, spec=SPEC, device="cpu", **kw)
        else:
            profiler.profile_layers(SPEC, params, x, reps=1, verbose=False,
                                    device="cpu", **kw)
            got = None
    _check(plans, ran, want)
    # the row-parallel FC sums in float32 and adds the bias after its
    # all_reduce: other roundings than the unsharded GEMM's
    if got is not None and walker != "sharded-row":
        monkeypatch.undo()
        ref = network.forward(params, x, spec=SPEC, device="cpu", **kw)
        assert torch.equal(got, ref)
