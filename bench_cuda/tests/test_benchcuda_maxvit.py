"""The MaxViT configuration of the benchmark (``builders/maxvit_pq.py``,
``reference/maxvit.py``, ``configs/maxvitl-384-pq-mem.json``): its frozen
generator, the spec, FLOPs and kernel work of the builder, the plain
reference against the port's forward through the builder, the roofline
reader on a synthetic trace, the cell's limits against the controls, and
faults in the mechanisms that make MaxViT what it is (the grid partition,
the relative-position bias, the squeeze-excite gate, the tanh GELU), which
the cell's comparison must see or PERF.md must list as unseen.

On the CPU at a small MaxViT (128x128, partition 4, widths 32-128, grids
32, 16, 8 and 4); on the card (marked ``card``) at the cell's own size."""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from bench_cuda import control, harness
from conftest import ROOT, write_bench

CPU = torch.device("cpu")
CELL = "maxvitl-384-pq-mem.offline-b128"


def config(name: str = "maxvitl-384-pq-mem") -> dict:
    with open(os.path.join(ROOT, "bench_cuda", "configs",
                           name + ".json")) as f:
        return json.load(f)


def tiny(dtype: str = "float32") -> dict:
    """The configuration cut to a small MaxViT, with the tiny limits of
    ``conftest.TINY_CONFIGS``: float32 agrees with the reference to its
    rounding."""
    return dict(config(), name="tiny-maxvit", model="MaxViT-tiny",
                dtype=dtype, input=[128, 128, 3], stem_width=32,
                embed_dim=[32, 64, 96, 128], depths=[2, 2, 2, 2],
                partition_size=4, head_hidden_size=128, num_classes=64,
                check={"logp_err_median": 0.012, "logp_err_p99": 0.02})


def builder():
    return harness.load_module(
        os.path.join(ROOT, "bench_cuda", "builders", "maxvit_pq.py"),
        "t_maxvit_pq")


def weights_and_images(cfg, seed: int, n: int):
    b = builder()
    gen = harness.generator(seed, CPU)
    w = b.make_weights(cfg, gen, CPU)
    x = harness.device_pool(gen, 1, n, b.input_shape(cfg), CPU)[0]
    return b, w, x


def tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for k in sorted(tree) for t in tensors(tree[k])]


def test_generator_is_reproducible_and_moves_with_the_seed():
    cfg = tiny()
    _, w1, x1 = weights_and_images(cfg, 2**31 + 3, 2)
    _, w2, x2 = weights_and_images(cfg, 2**31 + 3, 2)
    _, w3, _ = weights_and_images(cfg, 2**31 + 4, 2)
    flat = tensors(w1)
    assert all(torch.equal(a, b) for a, b in zip(flat, tensors(w2)))
    assert torch.equal(x1, x2)
    assert not any(torch.equal(a, b) for a, b in zip(flat, tensors(w3)))
    for t in flat:
        assert torch.isfinite(t.float()).all()


def test_generator_draws_the_synthetic_scales():
    """The frozen copy of ``synth.random_maxvit_pq_params``: the 1x1 convs
    K=128, the FCs K=32, D=4, weights N(0, 1/fan-in), the dense kernels in
    the served dtype, the tables' shapes and scale."""
    cfg = tiny("bfloat16")
    _, w, _ = weights_and_images(cfg, 2**31 + 5, 1)
    mb = w["s1b0"]["mbconv"]
    assert mb["conv1"]["codebooks"].shape == (8, 128, 4)
    assert mb["conv1"]["assignments"].shape == (256, 1, 1, 8)
    assert int(mb["conv1"]["assignments"].max()) == 127
    assert mb["se1"]["codebooks"].shape == (64, 32, 4)
    assert int(mb["se1"]["assignments"].max()) == 31
    assert mb["dw"]["kernel"].shape == (3, 3, 1, 256)
    assert mb["dw"]["kernel"].dtype == torch.bfloat16
    assert abs(mb["dw"]["kernel"].float().std().item() * 3 - 1) < 0.1
    assert abs(mb["conv3"]["codebooks"].float().std().item() * 16 - 1) < 0.1
    assert w["stem"]["conv1"]["kernel"].shape == (3, 3, 3, 32)
    assert w["s0b1"]["grid"]["rel_table"].shape == (1, 7, 7)
    table = torch.cat([w[f"s{i}b{j}"][p]["rel_table"].flatten()
                       for i in range(4) for j in range(2)
                       for p in ("block", "grid")])
    assert abs(table.std().item() - cfg["pq"]["rel_bias_scale"]) < 0.1
    assert abs(w["s0b0"]["block"]["ln1"]["scale"].mean().item() - 1) < 0.03


def test_generator_has_the_layout_of_the_ports_synthetic_params():
    from qcnn_tpu_torch.models import maxvit, synth

    cfg = tiny()
    b, w, _ = weights_and_images(cfg, 7, 1)
    want = synth.random_maxvit_pq_params(b.spec(cfg), seed=7)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(np.shape(tree))
    assert shapes(w) == shapes(want)
    assert b.spec(cfg) == maxvit.MaxViTSpec(
        "MaxViT-tiny", image_size=128, stem_width=32, dims=(32, 64, 96, 128),
        depths=(2, 2, 2, 2), partition=4, num_classes=64)


def test_spec_flops_and_kernel_work_of_the_cell():
    """MaxViT-L at 384: the registry's spec, 263.72 GFLOP an image, and
    the 48 ``window_attention_fused`` launches of a forward (24 block, 24
    grid) with each one's operations (4 N C a token) and bytes (q, k, v
    read, o written, bf16, and the float32 bias)."""
    from qcnn_tpu_torch.models import maxvit

    b, cfg = builder(), config()
    assert b.spec(cfg) == maxvit.MaxViTSpec(
        cfg["model"], **{k: v for k, v in maxvit.maxvit_l384().__dict__
                         .items() if k != "name"})
    assert b.flops_per_image(cfg) == 263_720_353_792
    work = b.kernel_work(cfg, 128)["window_attention_fused"]
    assert len(work) == 48
    first = work[0]
    t = 128 * 96 * 96
    assert first == (4.0 * 144 * t * 128, 8.0 * t * 128 + 4.0 * 4 * 144 ** 2)
    assert work[0] == work[1] and work[-1] == work[-2]
    assert sum(ops for ops, _ in work) == pytest.approx(
        128 * 4 * 144 * sum(2 * d * g * g * c for d, g, c in (
            (2, 96, 128), (6, 48, 256), (14, 24, 512), (2, 12, 1024))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_agrees_with_the_port_through_the_builder(dtype):
    """float32: to float32 rounding. bfloat16: the program's bf16
    activations against the float32 reference, the median of three answers
    within the cell's own p99 limit: at this small size a median of three
    swings (0.0073-0.0266 over seeds 8-19 on the CPU, seed 11 the
    largest), above the cell's median limit on some seeds."""
    tol = 1e-5 if dtype == "float32" else config()["check"]["logp_err_p99"]
    cfg = tiny(dtype)
    b, w, x = weights_and_images(cfg, 11, 3)
    probs = b.offline_forward(cfg, w, 3, CPU)(x).double()
    z = b.reference_logits(cfg, w, x).double()
    assert probs.shape == (3, 64)
    logp = torch.log_softmax(z, 1).numpy()
    ids, p5 = harness.top5(probs.float().numpy())
    got = harness.compare({"ids": ids, "probs": p5, "image": np.arange(3)},
                          logp, z.std(1).numpy())
    assert got["logp_err_median"] < tol
    assert got["top1_outside_ref_top5"] == 0
    if dtype == "float32":
        assert torch.allclose(probs, torch.softmax(z, 1), rtol=1e-4,
                              atol=1e-6)


def _roofline_ctx(launches: int, seconds: float, kind: str = "offline"):
    from bench_cuda import peaks

    return {"kind": kind, "batch": 128, "cfg": config(), "builder": builder(),
            "peaks": peaks.peaks_for("NVIDIA H100 80GB HBM3"),
            "trace": {"busy_s": 1.0, "window_s": 1.0, "kernels": {
                "window_attention_fused": {"launches": launches,
                                           "seconds": seconds}}}}


def test_roofline_reader_on_a_synthetic_trace():
    """``window_attention_fused_roofline``: the least time of a forward's
    48 launches (by bytes at 3.35 TB/s) over their traced time; None for
    a slice that holds no launch, a part of a forward, or no offline
    cell."""
    from bench_cuda.peaks import bound_s

    reader = harness.load_module(
        os.path.join(ROOT, "bench_cuda", "metrics",
                     "window_attention_fused_roofline.py"), "t_wa_roof")
    work = builder().kernel_work(config(), 128)["window_attention_fused"]
    ctx = _roofline_ctx(96, 0.0)
    least = sum(bound_s(b, o, ctx["peaks"]["bf16"], ctx["peaks"])
                for o, b in work)
    assert least == pytest.approx(sum(b for _, b in work) / 3.35e12)
    ctx = _roofline_ctx(96, 2 * least / 0.4)
    assert reader.read(ctx) == pytest.approx(40.0)
    assert reader.read(_roofline_ctx(0, 0.0)) is None
    assert reader.read(_roofline_ctx(47, 0.01)) is None
    assert reader.read(_roofline_ctx(48, 0.01, kind="served")) is None


@pytest.mark.parametrize("entry", ["offline_forward",
                                   *sorted(control.CONTROLS.values())])
def test_cell_limits_hold_the_controls_at_a_small_size(tmp_path, entry):
    """The cell's own limits (its configuration's ``check``) at a small
    bf16 MaxViT: the program's bf16 forward reads correct, its int8 path
    and the reference with fp8 operands do not."""
    cfg = dict(tiny("bfloat16"), check=config()["check"],
               num_classes=1000)
    write_bench(str(tmp_path), {"small-maxvit": cfg},
                {"offline-b8": {"load": "offline", "batch": 8,
                                "pool_batches": 2}},
                [("small-maxvit", "offline-b8")])
    r = harness.run_cell(str(tmp_path), "small-maxvit.offline-b8",
                         2**31 + 21, 0.01, False, CPU, harness.now(),
                         entry=entry)
    assert r["correct"] == (entry == "offline_forward"), r["checks"]


# --- faults in the program --------------------------------------------------

@contextlib.contextmanager
def swapped(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def grid_as_block(maxvit):
    """The grid attention attends over block windows: each block's two
    partition blocks both take the contiguous windows."""
    attention = maxvit.partition_attention
    return swapped(maxvit, "partition_attention",
                   lambda qkv, bias, geo, part, od: attention(
                       qkv, bias, geo, "block", od))


def bias_dropped(maxvit):
    """No relative-position bias in either partition."""
    attention = maxvit.partition_attention
    return swapped(maxvit, "partition_attention",
                   lambda qkv, bias, geo, part, od: attention(
                       qkv, torch.zeros_like(bias), geo, part, od))


def se_dropped(maxvit):
    """The squeeze-excite gate left out: the depthwise output goes to
    conv3 unscaled."""
    return swapped(maxvit, "squeeze_excite", lambda y, fc, inner: y)


def erf_gelu(maxvit):
    """The exact (erf) GELU in place of the tanh form, everywhere."""
    return swapped(maxvit, "ACT", "gelu")


FAULTS = [grid_as_block, bias_dropped, se_dropped]
# at the cell's own size its comparison sees the gate dropped (median 4.05
# at seed 2^31 + 41); the grid attention on block windows and the bias
# dropped read 0.0265 / 0.0424 and 0.0260 / 0.0405 there, inside the
# limits (sound 0.0170 / 0.0275): PERF.md section 7 lists them as unseen
CARD_FAULTS = [se_dropped]
# a fault the comparison does not see, even at the small float32 size
# (median 0.0005 against 0.012): the two GELUs differ by at most ~1e-3 of
# a unit activation (PERF.md section 7)
UNSEEN = [erf_gelu]


@pytest.fixture
def maxvit_root(tmp_path):
    write_bench(str(tmp_path), {"tiny-maxvit": tiny()},
                {"offline-b4": {"load": "offline", "batch": 4,
                                "pool_batches": 2}},
                [("tiny-maxvit", "offline-b4")])
    return str(tmp_path)


def run_tiny(root: str) -> dict:
    return harness.run_cell(root, "tiny-maxvit.offline-b4", 2**31 + 77, 0.3,
                            False, CPU, harness.now())


def test_sound_run_is_correct(maxvit_root):
    r = run_tiny(maxvit_root)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct(maxvit_root, fault):
    from qcnn_tpu_torch.models import maxvit

    with fault(maxvit):
        r = run_tiny(maxvit_root)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", UNSEEN, ids=lambda f: f.__name__)
def test_unseen_fault_reads_correct(maxvit_root, fault):
    """A fault PERF.md lists as unseen reads correct: should the comparison
    come to see it, the list is out of date."""
    from qcnn_tpu_torch.models import maxvit

    with fault(maxvit):
        r = run_tiny(maxvit_root)
    assert r["correct"], r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("fault", CARD_FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct_on_the_card(card, fault):
    """At the cell's own size, under the cell's limits."""
    from qcnn_tpu_torch.models import maxvit

    with fault(maxvit):
        r = harness.run_cell(ROOT, CELL, 2**31 + 41, 2.0, False, card,
                             harness.now())
    print(fault.__name__, json.dumps(r["checks"]))
    assert not r["correct"], r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("fault", [grid_as_block, bias_dropped, *UNSEEN],
                         ids=lambda f: f.__name__)
def test_unseen_fault_reads_correct_on_the_card(card, fault):
    """A fault PERF.md lists as unseen reads correct at the cell's size:
    should the comparison come to see it, the list is out of date."""
    from qcnn_tpu_torch.models import maxvit

    with fault(maxvit):
        r = harness.run_cell(ROOT, CELL, 2**31 + 41, 2.0, False, card,
                             harness.now())
    print(fault.__name__, json.dumps(r["checks"]))
    assert r["correct"], r["checks"]
