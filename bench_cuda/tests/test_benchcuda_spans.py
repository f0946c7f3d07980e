"""The span reduction of a traced slice (``spans.py``) on synthetic kineto
event lists, what it gives (``kind_share``, ``host_wait_share``,
``slowdown``) and the per-layer metrics that read it, and
``trace.summarize`` with the program's spans in the slice."""

from __future__ import annotations

import os

import pytest
from torch.autograd import DeviceType

from bench_cuda import harness, spans, trace
from conftest import ROOT

US = 1000  # ns


class Ev:
    """What ``trace.summarize`` and ``spans.reduce`` read of a kineto
    event."""

    def __init__(self, name, device, start, dur, corr=0, tid=1,
                 annotation=False, stream=7):
        self._v = (name, device, start, dur, corr, tid, annotation, stream)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]

    def device_resource_id(self):
        return self._v[7]


def cpu(name, start, dur, corr=0, tid=1):
    return Ev(name, DeviceType.CPU, start * US, dur * US, corr, tid)


def gpu(name, start, dur, corr, stream=7):
    return Ev(name, DeviceType.CUDA, start * US, dur * US, corr,
              stream=stream)


def annotation(name, start, dur, stream=7):
    return Ev(name, DeviceType.CUDA, start * US, dur * US, 0,
              annotation=True, stream=stream)


class FakeSlice:
    def __init__(self, events, seconds=1e-3):
        self.events = events
        self.t0, self.t1 = 0.0, seconds


def step():
    """One forward: a decode, conv 3 (product, then its bias add under an
    epilogue), an LRN launched late (the device waits for it), a ReLU; a
    read-back copy after the forward; a kernel whose launch the trace lost.
    Correlation ids of aten operators repeat those of launches, as kineto's
    two counters do."""
    return [
        cpu("qcnn.forward", 0, 100),
        cpu("aten::to", 1, 3, corr=11),
        cpu("cudaLaunchKernel", 2, 1, corr=10),
        cpu("qcnn.decode", 5, 5),
        cpu("cudaLaunchKernel", 6, 1, corr=11),
        cpu("qcnn.conv:3", 12, 20),
        cpu("aten::conv2d", 13, 8, corr=12),
        cpu("cuLaunchKernelEx", 14, 2, corr=12),
        cpu("qcnn.epilogue", 24, 6),
        cpu("aten::add", 25, 4, corr=14),
        cpu("cudaLaunchKernel", 26, 1, corr=13),
        cpu("qcnn.lrn:2", 40, 30),
        cpu("cudaLaunchKernel", 65, 1, corr=14),
        cpu("qcnn.relu:1", 75, 5),
        cpu("cudaLaunchKernel", 76, 1, corr=15),
        cpu("cudaMemcpyAsync", 110, 2, corr=16),
        # the device: ranges mirrored on its timeline, then the work
        annotation("qcnn.forward", 20, 90),
        annotation("qcnn.decode", 22, 3),
        annotation("qcnn.conv:3", 30, 20),
        gpu("void at::native::vectorized_elementwise_kernel<8>(int)", 20, 2,
            corr=10),
        gpu("void (anonymous namespace)::pq_decode_kernel(Item*)", 22, 3,
            corr=11),
        gpu("pq::decode_gemm_kernel<128, 4, false>", 30, 10, corr=12),
        gpu("pq::split_reduce_kernel(float*)", 40, 2, corr=99),
        gpu("at::native::vectorized_elementwise_kernel<4, add>", 42, 4,
            corr=13),
        # a gap from 46: the LRN's launch at 65 came after it began
        gpu("at::native::elementwise_kernel<128, lrn>", 70, 20, corr=14),
        # a gap from 90: the ReLU was queued at 76, before it began
        gpu("at::native::vectorized_elementwise_kernel<8, clamp>", 92, 3,
            corr=15),
        gpu("Memcpy DtoH (Device -> Pinned)", 115, 5, corr=16),
    ]


def test_host_spans_leave_the_device_reductions_unchanged():
    """The port's spans are host events (``utils/spans.py`` records them at
    the function scope, which kineto does not mirror onto the device's
    timeline): ``trace.summarize`` reads the device as it would without
    them, and names by the innermost span a gap that no operator covers."""
    table = trace.kernel_table(os.path.join(ROOT, "bench_cuda"))
    counted = {"pq_decode": 1, "pq_fc_fused": 1}
    device_only = [e for e in step() if not (e.device_type() == DeviceType.CUDA
                                             and e.is_user_annotation())]
    bare = [e for e in device_only if not e.name().startswith(spans.PREFIX)]
    a = trace.summarize(FakeSlice(bare), table, counted)
    b = trace.summarize(FakeSlice(device_only), table, counted)
    for key in ("busy_s", "device_ops", "kernels", "launch_check"):
        assert a[key] == b[key], key
    assert b["kernels"]["pq_fc_fused"]["launches"] == 1
    assert b["kernels"]["pq_fc_fused"]["seconds"] == pytest.approx(12e-6)
    assert not any(name.startswith(spans.PREFIX)
                   for name, _ in b["device_ops"])
    # 25-30 under an add; 46-70 under the LRN's span, 90-92 under the
    # forward's, 95-115 after it
    assert dict(a["idle_gaps"]) == {
        "aten::add": pytest.approx(5e-6),
        "no host operation traced": pytest.approx(46e-6)}
    assert dict(b["idle_gaps"]) == {
        "aten::add": pytest.approx(5e-6),
        "qcnn.lrn:2": pytest.approx(24e-6),
        "qcnn.forward": pytest.approx(2e-6),
        "no host operation traced": pytest.approx(20e-6)}


def test_summary_keeps_the_span_reduction_beside_the_device_keys():
    """``summarize`` stores ``spans.reduce`` of the slice's events under
    "spans", and reads every other key as it did before it kept them."""
    table = trace.kernel_table(os.path.join(ROOT, "bench_cuda"))
    events = [e for e in step() if not (e.device_type() == DeviceType.CUDA
                                        and e.is_user_annotation())]
    got = trace.summarize(FakeSlice(events), table,
                          {"pq_decode": 1, "pq_fc_fused": 1})
    assert got.pop("spans") == spans.reduce(events)
    kernels = {name: {"launches": 0, "seconds": 0.0} for name in table}
    kernels["pq_decode"] = {"launches": 1, "seconds": pytest.approx(3e-6)}
    kernels["pq_fc_fused"] = {"launches": 1,
                              "seconds": pytest.approx(12e-6)}
    assert got == {
        "busy_s": pytest.approx(49e-6), "window_s": 1e-3,
        "kernels": kernels,
        "device_ops": [
            ["at::native::elementwise_kernel<128, lrn>", pytest.approx(2e-5)],
            ["pq::decode_gemm_kernel<128, 4, false>", pytest.approx(1e-5)],
            ["Memcpy DtoH ", pytest.approx(5e-6)],
            ["at::native::vectorized_elementwise_kernel<4, add>",
             pytest.approx(4e-6)],
            ["{anonymous}::pq_decode_kernel", pytest.approx(3e-6)],
            ["at::native::vectorized_elementwise_kernel<8, clamp>",
             pytest.approx(3e-6)],
            ["at::native::vectorized_elementwise_kernel<8>",
             pytest.approx(2e-6)],
            ["pq::split_reduce_kernel", pytest.approx(2e-6)]],
        "idle_gaps": [["qcnn.lrn:2", pytest.approx(2.4e-5)],
                      ["no host operation traced", pytest.approx(2e-5)],
                      ["aten::add", pytest.approx(5e-6)],
                      ["qcnn.forward", pytest.approx(2e-6)]],
        "launch_check": {"pq_decode": [1, 1], "pq_fc_fused": [1, 1]}}


def test_device_copies_of_ranges_are_not_kernels():
    """A ``gpu_user_annotation`` event (a user-scope range mirrored onto the
    device's timeline) is no device work of the reduction."""
    plain = [e for e in step() if not (e.device_type() == DeviceType.CUDA
                                       and e.is_user_annotation())]
    more = step() + [annotation("qcnn.fc:5", 39, 2),
                     annotation("qcnn.lrn:2", 0, 200, stream=3)]
    assert spans.reduce(more) == spans.reduce(plain)


def test_kernels_go_to_the_innermost_span_of_their_launch():
    got = spans.reduce(step())
    kinds = got["kinds"]
    assert got["forwards"] == 1
    # the input cast is the forward's own
    assert kinds["forward"] == {"seconds": pytest.approx(2e-6), "kernels": 1}
    assert kinds["decode"] == {"seconds": pytest.approx(3e-6), "kernels": 1}
    assert kinds["conv"] == {"seconds": pytest.approx(10e-6), "kernels": 1}
    assert kinds["epilogue"] == {"seconds": pytest.approx(4e-6),
                                 "kernels": 1}
    assert kinds["lrn"] == {"seconds": pytest.approx(20e-6), "kernels": 1}
    assert kinds["relu"] == {"seconds": pytest.approx(3e-6), "kernels": 1}
    assert got["names"]["qcnn.conv:3"] == [pytest.approx(10e-6), 1]
    assert got["names"]["qcnn.lrn:2"] == [pytest.approx(20e-6), 1]


def test_outside_and_unlinked_kernels_are_counted():
    got = spans.reduce(step())
    assert got["outside"] == {"seconds": pytest.approx(5e-6), "kernels": 1}
    assert got["unlinked"] == {"seconds": pytest.approx(2e-6),
                               "kernels": 1}
    total = (sum(v["seconds"] for v in got["kinds"].values())
             + got["outside"]["seconds"] + got["unlinked"]["seconds"])
    assert total == pytest.approx(got["kernel_s"])
    assert got["kernel_s"] == pytest.approx(49e-6)


def test_a_late_launch_is_a_host_wait_and_a_queued_one_is_not():
    got = spans.reduce(step())
    # 46-70 (LRN launched at 65) and 95-115 (the copy, launched at 110);
    # not 90-92 (the ReLU was queued at 76)
    assert got["host_wait"] == {"lrn": pytest.approx(24e-6),
                                "outside": pytest.approx(20e-6)}
    assert got["host_wait_s"] == pytest.approx(44e-6)


def test_spans_of_another_thread_do_not_own_a_launch():
    events = step() + [cpu("qcnn.pool:9", 0, 200, tid=2)]
    assert spans.reduce(events)["kinds"] == spans.reduce(step())["kinds"]
    # with no span on the launching thread, the kernels are outside
    moved = [cpu(e.name(), e.start_ns() // US, e.duration_ns() // US,
                 e.correlation_id(), tid=3)
             if e.name().startswith("cu") else e for e in step()]
    got = spans.reduce(moved)
    assert got["kinds"] == {}
    assert got["outside"]["kernels"] == 7


def renamed(events, names: dict):
    """The events with the host spans of ``names`` renamed."""
    return [cpu(names[e.name()], e.start_ns() // US, e.duration_ns() // US,
                e.correlation_id(), e.start_thread_id())
            if e.name() in names else e for e in events]


# the step with its conv and LRN spans as a transformer's or MaxViT's
ATTENTION = {"qcnn.conv:3": "qcnn.attention:blk3",
             "qcnn.lrn:2": "qcnn.window:s0b1.partition"}
DWCONV_SE = {"qcnn.conv:3": "qcnn.dwconv:s0b0", "qcnn.lrn:2": "qcnn.se:s0b0"}


def _ctx(events, busy_s=49e-6, window_s=200e-6):
    tr = {"busy_s": busy_s, "window_s": window_s,
          "spans": spans.reduce(events)}
    # the untraced window's rate: 1 forward of 4 images in 400 us
    return {"kind": "offline", "batch": 4, "images_per_s": 1e4, "trace": tr}


def reader(metric: str):
    return harness.load_module(
        os.path.join(ROOT, "bench_cuda", "metrics", metric + ".py"),
        "t_metric_" + metric.replace(".", "_")).read


# {case: (read, the spans it reads, its reading on them)}
SHARES = {
    "lrn": (lambda ctx: spans.kind_share(ctx, ("lrn",)), {},
            100 * 20 / 49),
    "pointwise": (lambda ctx: spans.kind_share(
        ctx, ("epilogue", "relu", "residual")), {}, 100 * 7 / 49),
    "host_wait": (spans.host_wait_share, {}, 100 * 44 / 200),
    "pointwise_share.offline": (reader("pointwise_share.offline"), {},
                                100 * 7 / 49),
    "attention_share.offline": (reader("attention_share.offline"),
                                ATTENTION, 100 * 30 / 49),
    "dwconv_se_share.offline": (reader("dwconv_se_share.offline"),
                                DWCONV_SE, 100 * 30 / 49),
    "host_wait_share.offline": (reader("host_wait_share.offline"), {},
                                100 * 44 / 200),
    # the slice: 1 forward of 4 images in 200 us, twice the window's rate
    "trace_slowdown.offline": (reader("trace_slowdown.offline"), {},
                               100 * (1 - 2e4 / 1e4)),
}


@pytest.mark.parametrize("share", sorted(SHARES))
def test_shares_read_none_on_a_slice_without_spans(share):
    read, names, _ = SHARES[share]
    events = renamed(step(), names)
    bare = [e for e in events if not e.name().startswith(spans.PREFIX)]
    assert read(_ctx(bare)) is None
    assert read({"kind": "offline", "trace": {
        "busy_s": 1.0, "window_s": 1.0}}) is None  # no reduction in it
    assert read({"kind": "offline"}) is None
    assert read(dict(_ctx(events), kind="served")) is None
    assert read(_ctx(events)) is not None


def test_shares_read_their_kinds():
    for share, (read, names, want) in SHARES.items():
        got = read(_ctx(renamed(step(), names)))
        assert got == pytest.approx(want), share


def test_a_share_of_kinds_that_ran_nothing_reads_none():
    """A slice whose spans hold no kernel of the kinds asked for (the
    attention share on AlexNet's step) has nothing to read."""
    ctx = _ctx(step())
    assert spans.kind_share(ctx, ("attention", "window")) is None
    assert reader("dwconv_se_share.offline")(ctx) is None


def test_trace_slowdown_is_zero_where_the_slice_keeps_the_window_s_rate():
    read = reader("trace_slowdown.offline")
    assert read(dict(_ctx(step()), images_per_s=2e4)) == pytest.approx(0.0)
    # a slice of half the window's rate
    assert read(_ctx(step(), window_s=800e-6)) == pytest.approx(50.0)
