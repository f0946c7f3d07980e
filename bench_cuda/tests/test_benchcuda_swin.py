"""The Swin configuration of the benchmark (``builders/swin_pq.py``,
``reference/swin.py``, ``configs/swinl-384-pq-mem.json``): its frozen
generator, the plain reference against the port's forward through the
builder, the cell's limits against the controls, and faults in the
mechanisms that make Swin what it is (the cyclic shift, the shift mask,
the relative-position bias, the merge order), which the cell's comparison
must see, in every block and (on the card) in one of the first blocks.

On the CPU at a small Swin (64x64, patch 4, window 4, width 32, grids 16,
8, 4 and 2); on the card (marked ``card``) at the cell's own size."""

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
CELL = "swinl-384-pq-mem.offline-b128"


def config(name: str = "swinl-384-pq-mem") -> dict:
    with open(os.path.join(ROOT, "bench_cuda", "configs",
                           name + ".json")) as f:
        return json.load(f)


def tiny(dtype: str = "float32") -> dict:
    """The configuration cut to a small Swin, with the tiny limits of
    ``conftest.TINY_CONFIGS``: float32 agrees with the reference to its
    rounding."""
    return dict(config(), name="tiny-swin", model="Swin-tiny", dtype=dtype,
                input=[64, 64, 3], embed_dim=32, depths=[2, 2, 2, 2],
                num_heads=[2, 4, 8, 16], window_size=4, num_classes=64,
                check={"logp_err_median": 0.012, "logp_err_p99": 0.02})


def builder():
    return harness.load_module(
        os.path.join(ROOT, "bench_cuda", "builders", "swin_pq.py"),
        "t_swin_pq")


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
    moved = [not torch.equal(a, b) for a, b in zip(flat, tensors(w3))]
    # the reductions' biases are zero on every seed
    assert sum(not m for m in moved) == 3
    for t in flat:
        assert torch.isfinite(t.float()).all()


def test_generator_draws_the_synthetic_scales():
    """The frozen copy of ``synth.random_swin_pq_params``: D=4, K=32,
    codewords N(0, 1/Cin), the served dtypes, the tables' shapes and
    scale, no bias on the reductions."""
    cfg = tiny("bfloat16")
    _, w, _ = weights_and_images(cfg, 2**31 + 5, 1)
    mlp2 = w["s1b1"]["mlp2"]
    assert mlp2["codebooks"].shape == (64, 32, 4)
    assert mlp2["codebooks"].dtype == torch.bfloat16
    assert mlp2["assignments"].dtype == torch.uint8
    assert int(mlp2["assignments"].max()) == 31
    assert abs(mlp2["codebooks"].float().std().item() * 16 - 1) < 0.1
    assert w["s0b1"]["rel_table"].shape == (49, 2)
    assert w["s3b0"]["rel_table"].shape == (9, 16)
    table = torch.cat([w[f"s{i}b{j}"]["rel_table"].flatten()
                       for i in range(4) for j in range(2)])
    assert abs(table.std().item() - cfg["pq"]["rel_bias_scale"]) < 0.1
    assert w["s2merge"]["reduction"]["codebooks"].shape == (128, 32, 4)
    assert not w["s2merge"]["reduction"]["bias"].any()
    assert abs(w["s0b0"]["ln1"]["scale"].mean().item() - 1) < 0.03


def test_generator_has_the_layout_of_the_ports_synthetic_params():
    from qcnn_tpu_torch.models import swin, synth

    cfg = tiny()
    b, w, _ = weights_and_images(cfg, 7, 1)
    want = synth.random_swin_pq_params(b.spec(cfg), seed=7)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(np.shape(tree))
    assert shapes(w) == shapes(want)
    assert b.spec(cfg) == swin.SwinSpec(
        "Swin-tiny", patch=4, image_size=64, embed_dim=32,
        depths=(2, 2, 2, 2), heads=(2, 4, 8, 16), window=4, num_classes=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_agrees_with_the_port_through_the_builder(dtype):
    """float32: to float32 rounding. bfloat16: the program's bf16
    activations against the float32 reference, within the cell's own
    median limit."""
    tol = 1e-5 if dtype == "float32" else config()["check"][
        "logp_err_median"]
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


@pytest.mark.parametrize("entry", ["offline_forward",
                                   *sorted(control.CONTROLS.values())])
def test_cell_limits_hold_the_controls_at_a_small_size(tmp_path, entry):
    """The cell's own limits (its configuration's ``check``) at a small
    bf16 Swin: the program's bf16 forward reads correct, its int8 path and
    the reference with fp8 operands do not."""
    cfg = dict(tiny("bfloat16"), check=config()["check"],
               num_classes=1000)
    write_bench(str(tmp_path), {"small-swin": cfg},
                {"offline-b8": {"load": "offline", "batch": 8,
                                "pool_batches": 2}},
                [("small-swin", "offline-b8")])
    r = harness.run_cell(str(tmp_path), "small-swin.offline-b8", 2**31 + 21,
                         0.01, False, CPU, harness.now(), entry=entry)
    assert r["correct"] == (entry == "offline_forward"), r["checks"]


# --- faults in the program --------------------------------------------------

@contextlib.contextmanager
def swapped(module, name, fn):
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def no_shift(swin):
    """The odd blocks do not roll the grid (nor roll it back); the mask
    stays."""
    return swapped(swin, "_roll", lambda x, shift: x)


def mask_dropped(swin):
    """The shifted blocks add the relative-position bias but not the -100
    mask: tokens of different regions attend to each other."""
    return swapped(swin, "_window_bias", lambda blk: blk["rel_bias"])


def bias_dropped(swin):
    """No relative-position bias: only the mask of a shifted block."""
    def mask_only(blk):
        if "shift_mask" in blk:
            return blk["shift_mask"][:, None]
        return torch.zeros_like(blk["rel_bias"])
    return swapped(swin, "_window_bias", mask_only)


def merge_swapped(swin):
    """The patch merging concatenates (0, 1) before (1, 0): the row-major
    order of the 2x2 neighbourhood, not the published one."""
    def gather(x):
        b, _, _, c = x.shape
        return torch.cat([x[:, 0::2, 0::2], x[:, 0::2, 1::2],
                          x[:, 1::2, 0::2], x[:, 1::2, 1::2]], -1).view(
                              b, -1, 4 * c)
    return swapped(swin, "merge_gather", gather)


FAULTS = [no_shift, mask_dropped, bias_dropped, merge_swapped]


@pytest.fixture
def swin_root(tmp_path):
    write_bench(str(tmp_path), {"tiny-swin": tiny()},
                {"offline-b4": {"load": "offline", "batch": 4,
                                "pool_batches": 2}},
                [("tiny-swin", "offline-b4")])
    return str(tmp_path)


def run_tiny(root: str) -> dict:
    return harness.run_cell(root, "tiny-swin.offline-b4", 2**31 + 77, 0.3,
                            False, CPU, harness.now())


def test_sound_run_is_correct(swin_root):
    r = run_tiny(swin_root)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct(swin_root, fault):
    from qcnn_tpu_torch.models import swin

    with fault(swin):
        r = run_tiny(swin_root)
    assert not r["correct"], r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct_on_the_card(card, fault):
    """At the cell's own size, under the cell's limits."""
    from qcnn_tpu_torch.models import swin

    with fault(swin):
        r = harness.run_cell(ROOT, CELL, 2**31 + 41, 2.0, False, card,
                             harness.now())
    print(fault.__name__, json.dumps(r["checks"]))
    assert not r["correct"], r["checks"]


@contextlib.contextmanager
def in_one_block(swin, fault, target: str):
    """``fault`` in block ``target`` ("s0b1") alone: the other blocks run
    as they are."""
    run_block = swin._run_block

    def broken(x, blk, geo, spec, cast):
        if geo.key != target:
            return run_block(x, blk, geo, spec, cast)
        with fault(swin):
            return run_block(x, blk, geo, spec, cast)
    with swapped(swin, "_run_block", broken):
        yield


# the faults in one block that the cell's comparison sees at its size and
# seed (each by its p99); the same faults deeper, and the mask dropped in
# any one block, read correct there (PERF.md section 7)
ONE_BLOCK = [(no_shift, "s0b1"), (no_shift, "s1b1"), (bias_dropped, "s0b1")]


@pytest.mark.card
@pytest.mark.parametrize("fault,target", ONE_BLOCK,
                         ids=lambda v: getattr(v, "__name__", v))
def test_fault_in_one_block_is_not_correct_on_the_card(card, fault, target):
    from qcnn_tpu_torch.models import swin

    with in_one_block(swin, fault, target):
        r = harness.run_cell(ROOT, CELL, 2**31 + 41, 2.0, False, card,
                             harness.now())
    print(fault.__name__, target, json.dumps(r["checks"]))
    assert not r["correct"], r["checks"]
