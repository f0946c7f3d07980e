"""The route of Swin's window attention (``models.swin.window_attention_route``):
the ``window_attention_fused`` kernel for bf16 qkv on a CUDA device with a
head dimension of 32 and windows of at most 144 tokens, the plain version
(the window partition, the materialized float32 chain and the window
reverse) everywhere else. MaxViT's grid attention takes the same route
with its grid partition (windows of tokens G / window apart), which the
kernel addresses in place too.

The CPU tests hold the plain version to the chain the Swin block ran
before the kernel (partition, chain, reverse, as written out here) bit for
bit, the route's table, the wrapper's argument checks (it refuses a CPU
tensor too), the block's calls through the route, and the Swin forward's
output bits against a block that partitions before the qkv projection.
The tests marked ``card`` hold the kernel to the plain version on the card
at Swin-L's four stage shapes and at other window sizes, check that it
reads the bias of each window's own position, and skip without a card.
The file imports no JAX and nothing from ``tests``, so on a machine with
a card and without JAX they run without the suite's conftest:

    python -m pytest tests/test_torch_window_attention_route.py --noconftest -m card -q
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from qcnn_tpu_torch.models import common, swin, synth, transformer
from qcnn_tpu_torch.ops import cuda as cuda_ops
from qcnn_tpu_torch.ops import fc as fc_ops
from qcnn_tpu_torch.ops.cuda import window_attention_fused as wa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU, CUDA, META = (torch.device(t) for t in ("cpu", "cuda", "meta"))
BF16, F32 = torch.bfloat16, torch.float32
SMALL = swin.swin_tiny_test()


@pytest.mark.parametrize("device, dtype, hd, n, want", [
    (CUDA, BF16, 32, 144, "kernel"),
    (CUDA, BF16, 32, 49, "kernel"),
    (CUDA, BF16, 32, 1, "kernel"),
    (CUDA, BF16, 32, 169, "plain"),
    (CUDA, BF16, 32, 256, "plain"),
    (CUDA, BF16, 32, 289, "plain"),
    (CUDA, BF16, 64, 144, "plain"),
    (CUDA, BF16, 16, 144, "plain"),
    (CUDA, F32, 32, 144, "plain"),
    (CUDA, torch.float16, 32, 144, "plain"),
    (CPU, BF16, 32, 144, "plain"),
    (CPU, F32, 32, 144, "plain"),
    (META, BF16, 32, 144, "plain"),
])
def test_route_table(device, dtype, hd, n, want):
    assert swin.window_attention_route(device, dtype, hd, n) == want


@pytest.mark.parametrize("device, dtype, n, partition, want", [
    (CUDA, BF16, 144, "grid", "kernel"),
    (CUDA, BF16, 16, "grid", "kernel"),
    (CUDA, BF16, 144, "block", "kernel"),
    (CUDA, BF16, 169, "grid", "plain"),
    (CUDA, BF16, 144, "dilated", "plain"),
    (CUDA, F32, 144, "grid", "plain"),
    (CPU, BF16, 144, "grid", "plain"),
])
def test_route_table_of_the_partitions(device, dtype, n, partition, want):
    assert swin.window_attention_route(device, dtype, 32, n,
                                       partition) == want


def _grid_windows(x, g):
    """MaxViT's grid partition as published (timm's grid_partition):
    ``x.view(B, g, H/g, g, W/g, C).permute(0, 2, 4, 1, 3, 5)``."""
    b, h, w, c = x.shape
    return x.view(b, g, h // g, g, w // g, c).permute(
        0, 2, 4, 1, 3, 5).reshape(-1, g * g, c)


def _grid_chain(qkv, bias, heads, window, out_dtype):
    """MaxViT's grid attention as a chain, written out: the published grid
    partition of qkv, the float32 logits of ``transformer.logits`` plus the
    bias, the float32 softmax rounded once to v's dtype, the product with v
    in ``out_dtype``, then each window's token (i, j) put back at row
    i (G / window) + a, column j (G / window) + b of the grid, the heads
    merged."""
    b, grid = qkv.shape[:2]
    n_side = grid // window
    x = _grid_windows(qkv, window)
    bw, n, c3 = x.shape
    hd = c3 // (3 * heads)
    q, k, v = x.view(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    att = transformer.logits(q, k.transpose(-1, -2), hd, torch.float32)
    att.view(-1, 1, heads, n, n).add_(bias)
    probs = torch.softmax(att, dim=-1, dtype=torch.float32)
    o = fc_ops.matmul(probs.to(v.dtype), v, out_dtype)
    out = torch.empty(b, grid, grid, heads * hd, dtype=o.dtype)
    o = o.transpose(1, 2).reshape(b, n_side, n_side, window, window, -1)
    for a in range(n_side):
        for bb in range(n_side):
            out[:, a::n_side, bb::n_side] = o[:, a, bb]
    return out


@pytest.mark.parametrize("grid, window, heads", [(8, 4, 1), (16, 4, 2),
                                                 (12, 3, 2), (4, 4, 2)])
@pytest.mark.parametrize("dtype, out_dtype", [(BF16, BF16), (F32, F32)])
def test_plain_grid_attention_is_the_published_partition(grid, window, heads,
                                                         dtype, out_dtype):
    """The plain version's grid partition, bit for bit, against the chain
    over timm's grid_partition; where the grid is one window (4, 4) both
    partitions are the same."""
    gen = torch.Generator().manual_seed(grid + window)
    qkv = torch.randn((2, grid, grid, 3 * heads * 32), generator=gen).to(
        dtype)
    bias = torch.randn((heads, window ** 2, window ** 2), generator=gen)
    kw = {"heads": heads, "window": window, "out_dtype": out_dtype}
    got = swin.window_attention_plain(qkv, bias, partition="grid", **kw)
    assert torch.equal(got, _grid_chain(qkv, bias, heads, window,
                                        out_dtype))
    if grid == window:
        assert torch.equal(got, swin.window_attention_plain(qkv, bias, **kw))
    else:
        block = swin.window_attention_plain(qkv, bias, **kw)
        assert not torch.equal(got, block)


def test_grid_partition_and_reverse_round_trip():
    """The grid partition is timm's, and the reverse puts each token back:
    window (a, b), token (i, j) at row i (G / w) + a, column j (G / w) +
    b."""
    b, g, w, heads, hd = 2, 12, 4, 2, 3
    x = torch.randn(b, g, g, heads * hd)
    win = swin.window_partition(x, w, "grid")
    assert torch.equal(win, _grid_windows(x, w))
    n = g // w
    assert torch.equal(win[n + 2].view(w, w, -1), x[0, 1::n, 2::n])
    o = win.view(b * n * n, w * w, heads, hd).transpose(1, 2)
    assert torch.equal(swin.window_reverse(o, w, g, "grid"), x)


def _bias(blk: swin.Block, form: str, seed: int = 0):
    """A block's bias: "3d" the relative-position bias (heads, N, N),
    "4d" one a window (windows, heads, N, N), plus the block's -100 shift
    mask where it shifts, "head1" the shift mask alone with a size-1 heads
    axis (windows, 1, N, N)."""
    gen = torch.Generator().manual_seed(seed)
    n, windows = blk.window ** 2, (blk.grid // blk.window) ** 2
    rel = torch.randn((blk.heads, n, n), generator=gen)
    mask = (swin.shift_mask(blk.grid, blk.window, blk.shift) if blk.shift
            else torch.zeros(windows, n, n))
    if form == "3d":
        return rel
    if form == "head1":
        return mask[:, None]
    return rel + torch.randn((windows, 1, 1, 1), generator=gen) + mask[:, None]


def _qkv(b, blk: swin.Block, dtype, seed=1, device=CPU):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((b, blk.grid, blk.grid, 3 * blk.dim), generator=gen,
                       device=device).to(dtype)


def _chain(qkv, bias, heads, window, out_dtype):
    """The block's attention as it ran before the kernel, written out: the
    window partition of qkv, the float32 logits of ``transformer.logits``,
    the bias added over the windows of each image, the float32 softmax
    rounded once to v's dtype, the product with v in ``out_dtype``, the
    window reverse with the heads merged."""
    grid = qkv.shape[1]
    x = swin.window_partition(qkv, window)
    bw, n, c3 = x.shape
    hd = c3 // (3 * heads)
    q, k, v = x.view(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    att = transformer.logits(q, k.transpose(-1, -2), hd, torch.float32)
    windows = bias.shape[0] if bias.dim() == 4 else 1
    att.view(-1, windows, heads, n, n).add_(bias)
    probs = torch.softmax(att, dim=-1, dtype=torch.float32)
    o = fc_ops.matmul(probs.to(v.dtype), v, out_dtype)
    return swin.window_reverse(o, window, grid)


# the tiny spec's blocks: s0b0 (grid 16, no shift), s0b1 (shifted),
# s1b1 (grid 8, shifted), s3b0 (grid 2, the grid is the window)
SMALL_BLOCKS = {b.key: b for b in swin.block_layout(SMALL)}


@pytest.mark.parametrize("key", ["s0b0", "s0b1", "s1b1", "s3b0"])
@pytest.mark.parametrize("form", ["3d", "4d", "head1"])
@pytest.mark.parametrize("dtype, out_dtype", [(BF16, BF16), (F32, F32),
                                              (BF16, None)])
def test_plain_version_is_the_chain_bit_for_bit(key, form, dtype, out_dtype):
    blk = SMALL_BLOCKS[key]
    qkv, bias = _qkv(3, blk, dtype), _bias(blk, form)
    got = swin.window_attention_plain(qkv, bias, heads=blk.heads,
                                      window=blk.window, out_dtype=out_dtype)
    want = _chain(qkv, bias, blk.heads, blk.window, out_dtype)
    assert got.shape == (3, blk.grid, blk.grid, blk.dim)
    assert got.dtype == (out_dtype or F32)
    assert torch.equal(got, want)
    # the kernel's wrapper refuses these CPU tensors, and counts none
    before = cuda_ops.launches()
    with pytest.raises(ValueError, match="window_attention_fused"):
        wa.window_attention_fused(qkv, bias, heads=blk.heads,
                                  window=blk.window, out_dtype=out_dtype)
    assert cuda_ops.launches() == before


def _refuse(*args, **kwargs):
    raise AssertionError("window_attention_fused called off its route")


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cpu_block_takes_the_plain_version(monkeypatch, dtype):
    """On the CPU every block asks the route once, with qkv's device and
    dtype, its head dimension and its window's tokens, and never calls the
    kernel's entry point."""
    monkeypatch.setattr(wa, "window_attention_fused", _refuse)
    asked, route = [], swin.window_attention_route

    def spy(*args):
        asked.append(args)
        return route(*args)

    monkeypatch.setattr(swin, "window_attention_route", spy)
    prepared, fwd, _ = common.build_family_forward(
        "swin", SMALL, synth.random_swin_pq_params(SMALL, seed=1),
        memory=True, compute_dtype=dtype, device="cpu")
    fwd(prepared, torch.randn(2, 64, 64, 3))
    assert asked == [(CPU, dtype, 16, blk.window ** 2)
                     for blk in swin.block_layout(SMALL)]


def test_kernel_route_hands_the_grid_to_the_kernel(monkeypatch):
    """Where the route says "kernel", a block passes the qkv projection's
    output on its rolled grid, the block's bias as ``_window_bias`` gives
    it, its heads and window and the activation dtype to
    ``window_attention_fused``, and rolls its result back."""
    calls = []

    def fake(qkv, bias, *, heads, window, out_dtype):
        calls.append((qkv.shape, bias, heads, window, out_dtype))
        return swin.window_attention_plain(qkv, bias, heads=heads,
                                           window=window, out_dtype=out_dtype)

    monkeypatch.setattr(wa, "window_attention_fused", fake)
    prepared, fwd, _ = common.build_family_forward(
        "swin", SMALL, synth.random_swin_pq_params(SMALL, seed=2),
        memory=True, compute_dtype=BF16, device="cpu")
    x = torch.randn(2, 64, 64, 3)
    want = fwd(prepared, x)
    monkeypatch.setattr(swin, "window_attention_route", lambda *a: "kernel")
    biases = []
    window_bias = swin._window_bias
    monkeypatch.setattr(swin, "_window_bias",
                        lambda blk: biases.append(window_bias(blk))
                        or biases[-1])
    got = fwd(prepared, x)
    layout = swin.block_layout(SMALL)
    assert [(c[0], c[2], c[3], c[4]) for c in calls] == [
        ((2, b.grid, b.grid, 3 * b.dim), b.heads, b.window, BF16)
        for b in layout]
    assert all(c[1] is bias for c, bias in zip(calls, biases))
    assert torch.equal(got, want)


def _parent_run_block(x, blk, geo, spec, cast):
    """A Swin block as it ran before the kernel: the roll and the window
    partition before the qkv projection, the chain on the windows, the
    window reverse and the roll back before the out projection."""
    b = x.shape[0]
    key, od = geo.key, cast.dtype
    run = transformer.block_projections(x, blk, od, key)
    y = transformer.layernorm(x, blk["ln1"], swin.LN_EPS)
    y = swin.window_partition(swin._roll(
        y.view(b, geo.grid, geo.grid, -1), -geo.shift), geo.window)
    qkv = run(y, "qkv")  # (B x windows, N, 3C)
    bw, n, c3 = qkv.shape
    hd = c3 // (3 * geo.heads)
    q, k, v = qkv.view(bw, n, 3, geo.heads, hd).permute(
        2, 0, 3, 1, 4).unbind(0)
    att = transformer.logits(q, k.transpose(-1, -2), hd, torch.float32)
    bias = swin._window_bias(blk)
    windows = bias.shape[0] if bias.dim() == 4 else 1
    att.view(-1, windows, geo.heads, n, n).add_(bias)
    probs = torch.softmax(att, dim=-1, dtype=torch.float32)
    o = fc_ops.matmul(probs.to(v.dtype), v, od)
    o = swin._roll(swin.window_reverse(o, geo.window, geo.grid), geo.shift)
    o = cast(o.reshape(b, -1, geo.dim))
    x = run(o, "out", residual=x)
    y = transformer.layernorm(x, blk["ln2"], swin.LN_EPS)
    y = run(y, "mlp1", act="gelu")
    return run(y, "mlp2", residual=x)


@pytest.mark.parametrize("dtype, memory", [(BF16, True), (BF16, False),
                                           (F32, True)])
def test_forward_bits_are_the_parent_blocks(monkeypatch, dtype, memory):
    """The qkv projection on the rolled grid and the attention's partition
    and reverse inside it give the forward's output bits of the block that
    partitioned first: the projections treat every token alike."""
    prepared, fwd, _ = common.build_family_forward(
        "swin", SMALL, synth.random_swin_pq_params(SMALL, seed=3),
        memory=memory, compute_dtype=dtype, device="cpu")
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    got = fwd(prepared, x)
    monkeypatch.setattr(swin, "_run_block", _parent_run_block)
    want = fwd(prepared, x)
    assert torch.equal(got, want)


def _meta(shape, dtype=BF16, device=META):
    return torch.empty(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("qkv, bias, kw, match", [
    ((2, 24, 24, 288), (3, 144, 144), {"out_dtype": F32}, "CUDA device"),
    ((2, 24, 24, 288), (4, 3, 144, 144), {"out_dtype": BF16}, "CUDA device"),
    ((2, 24, 24, 288), (4, 1, 144, 144), {}, "CUDA device"),
    ((2, 24, 24, 288), (3, 144, 144), {"device": CPU}, "CUDA device"),
    ((2, 24, 24, 288), (3, 144, 144), {"qkv_dtype": F32}, "bfloat16"),
    ((2, 24, 24, 288), (3, 144, 144), {"bias_dtype": BF16}, "float32"),
    ((2, 24, 24, 288), (3, 144, 144), {"out_dtype": torch.float16},
     "out_dtype"),
    ((2, 24, 24), (3, 144, 144), {}, r"\(B, G, G, 3C\)"),
    ((2, 24, 12, 288), (3, 144, 144), {}, r"\(B, G, G, 3C\)"),
    ((2, 24, 24, 290), (3, 144, 144), {}, "do not split"),
    ((2, 24, 24, 576), (3, 144, 144), {}, "head dimension 64"),
    ((2, 24, 24, 288), (3, 144, 144), {"window": 10}, "must divide"),
    ((2, 26, 26, 288), (3, 169, 169), {"window": 13}, "at most 144"),
    ((2, 32, 32, 192), (2, 256, 256), {"window": 16, "heads": 2},
     "at most 144"),
    ((2, 24, 24, 288), (3, 144, 144), {"window": 0}, "must divide"),
    ((2, 24, 24, 288), (2, 144, 144), {}, "bias must be"),
    ((2, 24, 24, 288), (3, 3, 144, 144), {}, "bias must be"),
    ((2, 24, 24, 288), (4, 2, 144, 144), {}, "bias must be"),
    ((2, 24, 24, 288), (144, 144), {}, "bias must be"),
    ((2, 24, 24, 288), (3, 144, 144), {"partition": "grid"}, "CUDA device"),
    ((2, 24, 24, 288), (3, 144, 144), {"partition": "dilated"},
     "partition must be"),
])
def test_wrapper_checks_raise_value_error(qkv, bias, kw, match):
    """The wrapper's checks raise ValueError on what the kernel does not
    take, the device last: a 'meta' tensor stands in for a device tensor,
    so a call that passes every other check meets the device check, and a
    CPU tensor is refused there too, never run another way."""
    kw = dict(kw)
    device = kw.pop("device", META)
    q = _meta(qkv, kw.pop("qkv_dtype", BF16), device)
    b = _meta(bias, kw.pop("bias_dtype", F32), device)
    with pytest.raises(ValueError, match=match):
        wa.window_attention_fused(q, b, heads=kw.pop("heads", 3),
                                  window=kw.pop("window", 12), **kw)


def test_scale_is_the_cards_reciprocal():
    """The kernel multiplies the float32 sums by the float32 reciprocal of
    sqrt(hd), as torch divides a CUDA tensor by a scalar; on the CPU the
    chain divides. Both differ from 1/sqrt(32) in float64 by a float32
    rounding."""
    s = wa.scale_of(32)
    assert s == float(torch.tensor(1.0) / torch.tensor(32 ** 0.5))
    assert abs(s - 32 ** -0.5) <= 2 ** -24 * 32 ** -0.5


def test_kernel_module_imports_without_a_card():
    """Importing the module (and the Swin forward) builds and loads
    nothing, on a machine where CUDA sees no device."""
    code = ("import torch\n"
            "from qcnn_tpu_torch.models import swin\n"
            "from qcnn_tpu_torch.ops.cuda import _build\n"
            "from qcnn_tpu_torch.ops.cuda import window_attention_fused as wa\n"
            "assert not torch.cuda.is_available()\n"
            "assert _build._LIB is None\n"
            "assert wa.KERNEL.launches == 0\n"
            "print(wa.HEAD_DIMS, wa.MAX_TOKENS)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(32,) 144"


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _exact(qkv, bias, heads, window):
    """softmax(q k^T / sqrt(32) + bias) v in float64 from the same bf16
    inputs and float32 bias, on the grid."""
    grid = qkv.shape[1]
    x = swin.window_partition(qkv.double(), window)
    bw, n, c3 = x.shape
    hd = c3 // (3 * heads)
    q, k, v = x.view(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    att = q @ k.transpose(-1, -2) / hd ** 0.5
    windows = bias.shape[0] if bias.dim() == 4 else 1
    att = att.view(-1, windows, heads, n, n) + bias.double()
    o = torch.softmax(att.view(bw, heads, n, n), dim=-1) @ v
    return swin.window_reverse(o, window, grid)


def _rms(d):
    return d.double().pow(2).mean().sqrt().item()


def _card_case(card, b, grid, window, heads, shifted, seed):
    """qkv (B, G, G, 3 heads 32) bf16 with N(0, 1) entries, so the logits
    spread by about 1 as the benchmark's random weights give, and the
    block's bias: a relative-position bias N(0, 1) (the benchmark's
    tables' scale), plus the -100 shift mask of a shifted block."""
    geo = swin.Block("t", 0, heads * 32, heads, grid, window,
                     window // 2 if shifted else 0)
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, grid, grid, 3 * geo.dim), generator=gen).to(BF16)
    n = window * window
    bias = torch.randn((heads, n, n), generator=gen)
    if shifted:
        bias = bias + swin.shift_mask(grid, window, geo.shift)[:, None]
    return geo, qkv.to(card), bias.to(card)


# Swin-L/4-w12@384's stage shapes (grid, heads; window 12) and other
# windows: 7 (Swin-T/S/B at 224, 49 tokens), 8 (64), 10 (100) and 11 (121),
# each padded to the kernel's 144 tokens
STAGES = [(96, 6), (48, 12), (24, 24), (12, 48)]
OTHERS = [(14, 7, 3), (16, 8, 2), (20, 10, 2), (22, 11, 2)]


@pytest.mark.card
@pytest.mark.parametrize("out_dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("shape", [(g, 12, h) for g, h in STAGES] + OTHERS,
                         ids=lambda s: "g{}w{}h{}".format(*s))
def test_kernel_is_the_plain_version_on_the_card(card, shape, shifted,
                                                 out_dtype):
    """The kernel against the plain version (the chain, both on the card)
    on qkv read in place from one grid tensor, at a batch of 4 (2 at the
    largest grids).

    Tolerance, as ``attention_fused``'s card tests: at most 1/32 of the
    largest |o| against the chain, and an RMS error against float64
    attention on the same inputs at most 1.25x the chain's. Both sum the
    float32 logits in other orders; the kernel's exp is ``ex2`` and its
    division a product with the row's reciprocal, so a probability on a
    bf16 rounding boundary may round the other way (first card runs: at
    most 2^-7 of the largest |o| in bf16, 5e-4 of it in float32)."""
    grid, window, heads = shape
    b = 2 if grid >= 96 else 4
    geo, qkv, bias = _card_case(card, b, grid, window, heads, shifted,
                                seed=grid + window)
    before = cuda_ops.launches()["window_attention_fused"]
    got = wa.window_attention_fused(qkv, bias, heads=heads, window=window,
                                    out_dtype=out_dtype)
    torch.cuda.synchronize(card)
    assert cuda_ops.launches()["window_attention_fused"] == before + 1
    assert got.shape == (b, grid, grid, geo.dim) and got.dtype == out_dtype
    assert got.is_contiguous() and torch.isfinite(got).all()
    want = swin.window_attention_plain(qkv, bias, heads=heads,
                                       window=window, out_dtype=out_dtype)
    exact = _exact(qkv, bias, heads, window)
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    e_kernel, e_chain = _rms(got - exact), _rms(want - exact)
    print(json.dumps({"shape": [b, grid, window, heads], "shifted": shifted,
                      "out": str(out_dtype), "max_abs_vs_chain": err,
                      "max_abs_o": top,
                      "rms_vs_exact": [e_kernel, e_chain]}))
    assert err <= top / 32
    assert e_kernel <= 1.25 * e_chain


# MaxViT-L/384's stage shapes (grid, heads; partition 12): block and grid
# attention over the same qkv
MAXVIT_STAGES = [(96, 4), (48, 8), (24, 16), (12, 32)]


@pytest.mark.card
@pytest.mark.parametrize("partition", ["block", "grid"])
@pytest.mark.parametrize("grid, heads", MAXVIT_STAGES,
                         ids=lambda v: str(v))
def test_kernel_is_the_plain_version_at_maxvit_shapes_on_the_card(
        card, grid, heads, partition):
    """The kernel in either partition against the plain version of the
    same partition on the card, bf16 out, at a batch of 4 (2 at grid 96),
    with the tolerance of :func:`test_kernel_is_the_plain_version_on_the_card`;
    where the map is more than one window the grid answer is far from the
    block answer, so the partition is not ignored."""
    b = 2 if grid >= 96 else 4
    geo, qkv, bias = _card_case(card, b, grid, 12, heads, False,
                                seed=grid + 1)
    kw = {"heads": heads, "window": 12, "out_dtype": BF16}
    before = cuda_ops.launches()["window_attention_fused"]
    got = wa.window_attention_fused(qkv, bias, partition=partition,
                                    **kw).float()
    torch.cuda.synchronize(card)
    assert cuda_ops.launches()["window_attention_fused"] == before + 1
    want = swin.window_attention_plain(qkv, bias, partition=partition,
                                       **kw).float()
    other = swin.window_attention_plain(
        qkv, bias, partition="grid" if partition == "block" else "block",
        **kw).float()
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    apart = (got - other).abs().max().item()
    print(json.dumps({"shape": [b, grid, heads], "partition": partition,
                      "max_abs_vs_chain": err, "max_abs_o": top,
                      "vs_other_partition": apart}))
    assert err <= top / 32
    if grid > 12:
        assert apart > top / 4


@pytest.mark.card
@pytest.mark.parametrize("grid, heads", STAGES[:3],
                         ids=lambda v: str(v))
def test_kernel_reads_each_windows_own_bias_on_the_card(card, grid, heads):
    """Given the bias of the wrong window positions (the windows of a
    shifted block's bias rolled by one), the kernel's answer moves far past
    the tolerance from the right one, and is the plain version's answer to
    the same wrong bias: the kernel indexes the bias by window position."""
    geo, qkv, bias = _card_case(card, 2, grid, 12, heads, True, seed=grid)
    kw = {"heads": heads, "window": 12, "out_dtype": BF16}
    right = swin.window_attention_plain(qkv, bias, **kw).float()
    wrong = bias.roll(1, 0)
    got = wa.window_attention_fused(qkv, wrong, **kw).float()
    want = swin.window_attention_plain(qkv, wrong, **kw).float()
    top = right.abs().max().item()
    print(json.dumps({"grid": grid, "vs_right": (got - right).abs().max()
                      .item(), "vs_wrong": (got - want).abs().max().item(),
                      "max_abs_o": top}))
    assert (got - right).abs().max().item() > top / 4
    assert (got - want).abs().max().item() <= top / 32


# a small Swin with 32 channels a head: grids 16 and 8, window 4, stage 0's
# odd block shifted
SMALL32 = swin.SwinSpec("Swin-test-hd32", patch=4, image_size=64,
                        embed_dim=64, depths=(2, 2), heads=(2, 4), window=4,
                        num_classes=10)


@pytest.mark.card
def test_swin_forward_takes_the_kernel_on_the_card(card, monkeypatch):
    """A bf16 Swin forward with 32 channels a head launches the kernel once
    a block, and its probabilities are the plain version's within the
    bf16 forward's rounding."""
    prepared, fwd, _ = common.build_family_forward(
        "swin", SMALL32, synth.random_swin_pq_params(SMALL32, seed=5),
        memory=True, compute_dtype=BF16, device=card)
    x = torch.randn(4, 64, 64, 3, device=card)
    before = cuda_ops.launches()["window_attention_fused"]
    got = fwd(prepared, x)
    torch.cuda.synchronize(card)
    assert cuda_ops.launches()["window_attention_fused"] == before + len(
        swin.block_layout(SMALL32))
    monkeypatch.setattr(swin, "window_attention_route", lambda *a: "plain")
    want = fwd(prepared, x)
    assert cuda_ops.launches()["window_attention_fused"] == before + len(
        swin.block_layout(SMALL32))
    print(json.dumps({"max_abs_dprob": (got - want).abs().max().item()}))
    assert (got - want).abs().max().item() <= 5e-3
