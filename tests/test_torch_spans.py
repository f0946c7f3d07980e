"""The ``qcnn.*`` spans of the port's forwards (``utils/spans.py``), on the
CPU at small sizes: the names that ``network.forward``,
``resnet.forward`` and ``swin.forward`` emit under ``torch.profiler`` and
their nesting, every
aten operator of a forward under a leaf span, nothing recorded with no
profiler running, and the same output bits with and without one."""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from qcnn_tpu_torch import core
from qcnn_tpu_torch.models import (
    common,
    network,
    prepare,
    resnet,
    swin,
    synth,
)
from qcnn_tpu_torch.utils import spans
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

LEAF_KINDS = {"decode", "conv", "fc", "epilogue", "lrn", "pool", "relu",
              "softmax", "residual", "embed", "layernorm", "attention",
              "window", "merge"}

ALEXNET = core.ModelSpec(
    name="tiny", in_height=15, in_width=15, in_channels=8,
    layers=(
        core.ConvSpec(kernel=3, out_channels=32, pad=1, groups=2, stride=2),
        core.ReLUSpec(),
        core.LRNSpec(5, 1e-4, 0.75, 1.0),
        core.PoolSpec(kernel=3, stride=2),
        core.FCSpec(64),
        core.ReLUSpec(),
        core.DropoutSpec(0.5),
        core.FCSpec(16),
        core.SoftmaxSpec(),
    ))
ALEXNET_SPANS = {"qcnn.forward", "qcnn.decode", "qcnn.conv:0",
                 "qcnn.relu:1", "qcnn.lrn:2", "qcnn.pool:3", "qcnn.fc:4",
                 "qcnn.relu:5", "qcnn.fc:7", "qcnn.softmax:8"}
# stage 1's first block projects and strides
RESNET = resnet.ResNetSpec("tiny", (1, 1), (64, 256), num_classes=10,
                           in_size=32, bottleneck=True)


def _resnet_spans():
    """The ReLUs and the shortcut adds run in the convs' epilogues, so the
    ResNet forward opens no ``relu`` or ``residual`` span."""
    names = {"qcnn.forward", "qcnn.decode", "qcnn.conv:stem",
             "qcnn.pool:stem", "qcnn.pool:head", "qcnn.fc:head",
             "qcnn.softmax:head"}
    for key, _, convs in resnet.block_layout(RESNET):
        for conv, *_ in convs:
            names.add(f"qcnn.conv:{key}.{conv}")
    return names


SWIN = swin.swin_tiny_test()


def _swin_spans():
    """Each block's window partition and reverse, attention, LayerNorms
    and four projections (the GELU and residual adds in their epilogues),
    each merge's gather and LayerNorm beside its reduction."""
    names = {"qcnn.forward", "qcnn.decode", "qcnn.embed",
             "qcnn.layernorm:final", "qcnn.pool:head", "qcnn.fc:head",
             "qcnn.softmax:head"}
    for blk in swin.block_layout(SWIN):
        k = blk.key
        names |= {f"qcnn.layernorm:{k}.ln1", f"qcnn.layernorm:{k}.ln2",
                  f"qcnn.window:{k}.partition", f"qcnn.window:{k}.reverse",
                  f"qcnn.attention:{k}"}
        names |= {f"qcnn.fc:{k}.{n}" for n in ("qkv", "out", "mlp1", "mlp2")}
    for i in range(len(SWIN.depths) - 1):
        names |= {f"qcnn.merge:s{i}", f"qcnn.fc:s{i}.reduction"}
    return names


def _alexnet(dtype):
    """AlexNet-like forward as the classifier runs it, in memory mode (int8:
    decoded at load): (fn(), spans it must emit)."""
    params = synth.random_pq_params(ALEXNET, seed=3)
    impl = "auto" if dtype == torch.int8 else "memory"
    prepared, conv_i, fc_i = prepare.prepare_params(
        ALEXNET, params, batch_hint=4, conv_impl=impl, fc_impl=impl,
        dtype=dtype, device="cpu")
    fwd = network.make_forward_fn(
        ALEXNET, conv_impls=conv_i, fc_impls=fc_i,
        compute_dtype=prepare.act_dtype_for(dtype), device="cpu")
    x = torch.as_tensor(synth.random_input(ALEXNET, 4, seed=1))
    # a conv decoded at load runs no in-step decode
    want = ALEXNET_SPANS - ({"qcnn.decode"} if dtype == torch.int8 else set())
    return (lambda: fwd(prepared, x)), want


def _resnet(dtype):
    params = synth.random_resnet_pq_params(RESNET, seed=0)
    prepared, fwd, _ = common.build_family_forward(
        "resnet", RESNET, params, memory=dtype != torch.int8,
        compute_dtype=dtype, device="cpu")
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    want = _resnet_spans() - ({"qcnn.decode"} if dtype == torch.int8
                              else set())
    return (lambda: fwd(prepared, x)), want


def _swin(dtype):
    params = synth.random_swin_pq_params(SWIN, seed=0)
    prepared, fwd, _ = common.build_family_forward(
        "swin", SWIN, params, memory=dtype != torch.int8,
        compute_dtype=dtype, device="cpu")
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    want = _swin_spans() - ({"qcnn.decode"} if dtype == torch.int8
                            else set())
    return (lambda: fwd(prepared, x)), want


CASES = {
    "alexnet-f32": (_alexnet, torch.float32),
    "alexnet-bf16": (_alexnet, torch.bfloat16),
    "alexnet-int8": (_alexnet, torch.int8),
    "resnet-f32": (_resnet, torch.float32),
    "resnet-bf16": (_resnet, torch.bfloat16),
    "resnet-int8": (_resnet, torch.int8),
    "swin-f32": (_swin, torch.float32),
    "swin-bf16": (_swin, torch.bfloat16),
    "swin-int8": (_swin, torch.int8),
}


def _case(name):
    make, dtype = CASES[name]
    return make(dtype)


def _traced(fn):
    """(output, CPU events sorted by start, outer first) of one call under
    the profiler."""
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    events.sort(key=lambda e: (e[0], -e[1]))
    return out, events


def _kind(name):
    return name[len(spans.PREFIX):].split(":", 1)[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_emits_the_span_names_properly_nested(name):
    fn, want = _case(name)
    _, events = _traced(fn)
    got = [e for e in events if e[2].startswith(spans.PREFIX)]
    names = {n for _, _, n in got}
    assert names - {"qcnn.epilogue"} == want
    assert "qcnn.epilogue" in names
    forwards = [e for e in got if e[2] == "qcnn.forward"]
    assert len(forwards) == 1
    f0, f1, _ = forwards[0]
    stack = []
    for start, end, n in got:
        while stack and stack[-1][1] <= start:
            stack.pop()
        # each range lies whole inside the one it starts in
        assert not stack or end <= stack[-1][1], (n, stack[-1][2])
        parent = stack[-1][2] if stack else None
        if n == "qcnn.forward":
            assert parent is None
        elif _kind(n) == "epilogue":
            # a product's: a conv, an FC, or Swin's patch embedding
            assert _kind(parent) in ("conv", "fc", "embed"), parent
        else:
            assert parent == "qcnn.forward", (n, parent)
            assert f0 <= start and end <= f1
        stack.append((start, end, n))


def _no_work(op, events, i):
    """An operator that launches nothing: a cast to the dtype it has (no
    child operator) or a tensor made from host data."""
    start, end, name = op
    if name == "aten::lift_fresh":
        return True
    inner = events[i + 1] if i + 1 < len(events) else None
    return name == "aten::to" and not (inner and inner[0] < end)


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_aten_operator_of_a_forward_lies_in_a_leaf_span(name):
    fn, _ = _case(name)
    _, events = _traced(fn)
    span_ranges = [e for e in events if e[2].startswith(spans.PREFIX)]
    leaves = [e for e in span_ranges if _kind(e[2]) in LEAF_KINDS]
    forward = next(e for e in span_ranges if e[2] == "qcnn.forward")
    first_leaf = min(s for s, _, _ in leaves)
    stray = []
    for i, op in enumerate(events):
        start, _, opname = op
        if not opname.startswith("aten::"):
            continue
        assert forward[0] <= start < forward[1], opname
        if any(s <= start < e for s, e, _ in leaves):
            continue
        # the forward's own input cast, before its first layer
        if start < first_leaf and opname in ("aten::to", "aten::_to_copy",
                                             "aten::empty_strided",
                                             "aten::copy_"):
            continue
        if not _no_work(op, events, i):
            stray.append(opname)
    assert stray == []


@pytest.mark.parametrize("name", ["alexnet-bf16", "alexnet-f32",
                                  "alexnet-int8"])
def test_bias_adds_after_a_conv_lie_in_epilogue_spans(name):
    """The convs decode (or hold) their weight and run the library's
    convolution, so every add under a conv span is a pass after the
    product."""
    fn, _ = _case(name)
    _, events = _traced(fn)
    convs = [e for e in events if e[2].startswith("qcnn.conv:")]
    epilogues = [e for e in events if e[2] == "qcnn.epilogue"]
    adds = [s for s, _, n in events if n == "aten::add"
            and any(c0 <= s < c1 for c0, c1, _ in convs)]
    assert adds
    for s in adds:
        assert any(e0 <= s < e1 for e0, e1, _ in epilogues)


@pytest.mark.parametrize("name", ["resnet-bf16", "resnet-f32",
                                  "resnet-int8"])
def test_relus_and_shortcuts_of_a_resnet_lie_in_epilogue_spans(name):
    """Each ReLU (``clamp_min`` on the CPU) and each bias or shortcut add
    under a ResNet conv span is a pass of the product's epilogue."""
    fn, _ = _case(name)
    _, events = _traced(fn)
    convs = [e for e in events if e[2].startswith("qcnn.conv:")]
    epilogues = [e for e in events if e[2] == "qcnn.epilogue"]
    ops = {}
    for s, _, n in events:
        if n in ("aten::add", "aten::clamp_min") and any(
                c0 <= s < c1 for c0, c1, _ in convs):
            ops.setdefault(n, []).append(s)
    # the stem, every conv1 and conv2 and each block's last conv
    n_blocks = len(resnet.block_layout(RESNET))
    relus = [s for s in ops["aten::clamp_min"]
             if any(e0 <= s < e1 for e0, e1, _ in epilogues)]
    assert len(relus) == 1 + 3 * n_blocks
    for s in ops["aten::add"]:
        assert any(e0 <= s < e1 for e0, e1, _ in epilogues)


def test_span_is_the_shared_no_op_without_a_profiler(monkeypatch):
    def fail(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(spans, "_Range", fail)
    assert spans.span("conv", "s1b0", "conv2") is spans.NO_SPAN
    assert spans.span("forward") is spans.NO_SPAN
    for name in ("alexnet-bf16", "resnet-bf16"):
        fn, _ = _case(name)
        fn()


def test_span_names_its_parts_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("conv", "s1b0", "conv2"):
            pass
        with spans.span("lrn", 6):
            pass
        with spans.span("forward"):
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith(spans.PREFIX)]
    assert names == ["qcnn.conv:s1b0.conv2", "qcnn.lrn:6", "qcnn.forward"]
    assert spans.span("forward") is spans.NO_SPAN


@pytest.mark.parametrize("name", sorted(CASES))
def test_spans_are_not_user_annotations(name):
    """kineto mirrors user-annotation ranges onto the device's timeline,
    where a reduction of device activity would count them as device work;
    the spans record at the function scope, which it does not mirror."""
    fn, _ = _case(name)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    got = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith(spans.PREFIX)]
    assert got
    assert not any(e.is_user_annotation() for e in got)


@pytest.mark.parametrize("name", sorted(CASES))
def test_output_bits_are_the_same_under_a_profiler(name):
    fn, _ = _case(name)
    plain = fn()
    traced, _ = _traced(fn)
    assert plain.dtype == traced.dtype
    assert torch.equal(plain, traced)
