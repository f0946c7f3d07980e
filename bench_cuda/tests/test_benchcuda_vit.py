"""The ViT configuration of the benchmark (``builders/vit_pq.py``,
``reference/vit.py``, ``configs/vitl16-384-pq-mem.json``): its frozen
generator, the plain reference against the port's forward through the
builder, and faults in the attention and the MLP of one block that the
cell's comparison must see.

On the CPU at a small ViT (patch 8, 48x48, width 64, 2 blocks, 4 heads,
37 tokens); on the card (marked ``card``) at the cell's own size."""

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
CELL = "vitl16-384-pq-mem.offline-b128"


def config(name: str = "vitl16-384-pq-mem") -> dict:
    with open(os.path.join(ROOT, "bench_cuda", "configs",
                           name + ".json")) as f:
        return json.load(f)


def tiny(dtype: str = "float32") -> dict:
    """The configuration cut to a small ViT, with the tiny limits of
    ``conftest.TINY_CONFIGS``: float32 agrees with the reference to its
    rounding."""
    return dict(config(), name="tiny-vit", model="ViT-tiny", dtype=dtype,
                input=[48, 48, 3], patch_size=8, hidden_size=64,
                num_layers=2, num_heads=4, mlp_dim=256, num_classes=64,
                check={"logp_err_median": 0.012, "logp_err_p99": 0.02})


def builder():
    return harness.load_module(
        os.path.join(ROOT, "bench_cuda", "builders", "vit_pq.py"),
        "t_vit_pq")


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
    """The frozen copy of ``synth.random_vit_pq_params``: D=4, K=32,
    codewords N(0, 1/Cin), the served dtypes, 37 position rows."""
    cfg = tiny("bfloat16")
    _, w, _ = weights_and_images(cfg, 2**31 + 5, 1)
    mlp2 = w["blk1"]["mlp2"]
    assert mlp2["codebooks"].shape == (64, 32, 4)
    assert mlp2["codebooks"].dtype == torch.bfloat16
    assert mlp2["assignments"].dtype == torch.uint8
    assert int(mlp2["assignments"].max()) == 31
    assert abs(mlp2["codebooks"].float().std().item() * 16 - 1) < 0.1
    assert w["pos_embed"].shape == (1, 37, 64)
    assert w["pos_embed"].dtype == torch.float32
    assert abs(w["blk0"]["ln1"]["scale"].mean().item() - 1) < 0.03


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_agrees_with_the_port_through_the_builder(dtype):
    """float32: to float32 rounding. bfloat16: the program's bf16
    activations and bf16 attention logits against the float32 reference,
    within the cell's own median limit."""
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
    bf16 ViT: the program's bf16 forward reads correct, its int8 path and
    the reference with fp8 operands do not."""
    cfg = dict(tiny("bfloat16"), check=config()["check"],
               num_classes=1000)
    write_bench(str(tmp_path), {"small-vit": cfg},
                {"offline-b8": {"load": "offline", "batch": 8,
                                "pool_batches": 2}},
                [("small-vit", "offline-b8")])
    r = harness.run_cell(str(tmp_path), "small-vit.offline-b8", 2**31 + 21,
                         0.01, False, CPU, harness.now(), entry=entry)
    assert r["correct"] == (entry == "offline_forward"), r["checks"]


# --- faults in one block ----------------------------------------------------
#
# A fault acts on whichever route the block's attention takes: the kernel's
# entry (``attention_fused.attention_fused``, the card's bf16 route) and the
# plain chain's logits (``vit._logits``, the CPU's), and notes in ``seen``
# the route it broke.

@contextlib.contextmanager
def swapped(module, name, fn):
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def attention_fault(vit, seen, kernel_fault, logits_fault):
    kernel, logits = vit.attn_kernel.attention_fused, vit._logits

    def broken_kernel(q, k, v, *, scale, out_dtype):
        seen.append("kernel")
        return kernel_fault(kernel, q, k, v, scale, out_dtype)

    def broken_logits(q, k_t, hd, dt):
        seen.append("plain")
        return logits_fault(logits, q, k_t, hd, dt)

    with swapped(vit.attn_kernel, "attention_fused", broken_kernel), \
            swapped(vit, "_logits", broken_logits):
        yield


def unscaled(vit, blk, seen):
    """The attention logits without the 1/sqrt(head dim) scale: scale 1."""
    return attention_fault(
        vit, seen,
        lambda kernel, q, k, v, scale, od: kernel(q, k, v, scale=1.0,
                                                  out_dtype=od),
        lambda logits, q, k_t, hd, dt: logits(q, k_t, 1, dt))


def uniform(vit, blk, seen):
    """Uniform attention: q zeroed before the kernel, so every logit is 0;
    the softmax of zero logits in the chain."""
    return attention_fault(
        vit, seen,
        lambda kernel, q, k, v, scale, od: kernel(
            torch.zeros_like(q), k, v, scale=scale, out_dtype=od),
        lambda logits, q, k_t, hd, dt: torch.zeros_like(
            logits(q, k_t, hd, dt)))


def mlp_dropped(vit, blk, seen):
    """The block's MLP adds only its bias: mlp2's product is zero before
    its epilogue, which still adds the bias and the residual."""
    proj = vit._proj

    def broken(v, p, **kw):
        if p is blk["mlp2"]:
            seen.append("mlp2")
            v = torch.zeros_like(v)
        return proj(v, p, **kw)
    return swapped(vit, "_proj", broken)


FAULTS = [unscaled, uniform, mlp_dropped]


def break_block(monkeypatch, fault, target: str) -> list:
    """Run block ``target`` of every forward with ``fault`` in place; the
    list returned gathers what the fault broke, one entry a call."""
    from qcnn_tpu_torch.models import vit

    run_block = vit._run_block
    seen = []

    def broken(x, blk, spec, cast, dt, key="blk"):
        if key != target:
            return run_block(x, blk, spec, cast, dt, key)
        with fault(vit, blk, seen):
            return run_block(x, blk, spec, cast, dt, key)
    monkeypatch.setattr(vit, "_run_block", broken)
    return seen


@pytest.fixture
def vit_root(tmp_path):
    cfgs = {"tiny-vit": tiny()}
    write_bench(str(tmp_path), cfgs,
                {"offline-b4": {"load": "offline", "batch": 4,
                                "pool_batches": 2}},
                [("tiny-vit", "offline-b4")])
    return str(tmp_path)


def run_tiny(root: str) -> dict:
    return harness.run_cell(root, "tiny-vit.offline-b4", 2**31 + 77, 0.3,
                            False, CPU, harness.now())


def test_sound_run_is_correct(vit_root):
    r = run_tiny(vit_root)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("target", ["blk0", "blk1"])
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_in_one_block_is_not_correct(vit_root, monkeypatch, fault,
                                           target):
    seen = break_block(monkeypatch, fault, target)
    r = run_tiny(vit_root)
    assert set(seen) == ({"mlp2"} if fault is mlp_dropped else {"plain"})
    assert not r["correct"], r["checks"]


# At the cell's own size a uniform attention reads not correct in the first
# blocks only: the random weights give attention logits of about unit
# spread, whose softmax is already near uniform, and a block's change fades
# over the blocks after it (PERF.md gives the readings of each block).
CARD_FAULTS = [(unscaled, "blk12"), (unscaled, "blk23"), (uniform, "blk0"),
               (uniform, "blk3"), (mlp_dropped, "blk12"),
               (mlp_dropped, "blk23")]


@pytest.mark.card
@pytest.mark.parametrize("fault,target", CARD_FAULTS,
                         ids=lambda v: getattr(v, "__name__", v))
def test_fault_in_one_block_is_not_correct_on_the_card(card, monkeypatch,
                                                       fault, target):
    """At the cell's own size: the fault in one block of 24, the attention
    faults through the kernel route."""
    seen = break_block(monkeypatch, fault, target)
    r = harness.run_cell(ROOT, CELL, 2**31 + 41, 2.0, False, card,
                         harness.now())
    print(fault.__name__, target, json.dumps(r["checks"]))
    assert set(seen) == ({"mlp2"} if fault is mlp_dropped else {"kernel"})
    assert not r["correct"], r["checks"]
