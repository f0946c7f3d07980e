"""The route of ViT attention (``models.vit.attention_route``): the
``attention_fused`` kernel for bf16 q/k/v on a CUDA device with bf16 logits
and a head dimension of 64, the materialized chain everywhere else.

The CPU tests hold the route's table, the CPU route to the plain chain bit
for bit, and the kernel module's import on a machine without a card. The
tests marked ``card`` hold the kernel to the plain chain on the card, at
the benchmark cell's shape and at ragged token counts, and check that the
cell's comparison sees faults injected through the kernel route; they skip
without a card. The file imports no JAX and nothing from ``tests``, so on
a machine with a card and without JAX they run without the suite's
conftest:

    python -m pytest tests/test_torch_attention_route.py --noconftest -m card -q
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from qcnn_tpu_torch.models import vit
from qcnn_tpu_torch.ops import cuda as cuda_ops
from qcnn_tpu_torch.ops.cuda import attention_fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU, CUDA, META = (torch.device(t) for t in ("cpu", "cuda", "meta"))
BF16, F32 = torch.bfloat16, torch.float32
CELL = "vitl16-384-pq-mem.offline-b128"


@pytest.mark.parametrize("device, dtype, logits_dtype, hd, want", [
    (CUDA, BF16, BF16, 64, "kernel"),
    (CUDA, BF16, F32, 64, "plain"),
    (CUDA, F32, BF16, 64, "plain"),
    (CUDA, F32, F32, 64, "plain"),
    (CUDA, torch.float16, torch.float16, 64, "plain"),
    (CUDA, BF16, BF16, 16, "plain"),
    (CUDA, BF16, BF16, 32, "plain"),
    (CUDA, BF16, BF16, 128, "plain"),
    (CUDA, BF16, BF16, 96, "plain"),
    (CPU, BF16, BF16, 64, "plain"),
    (CPU, F32, F32, 64, "plain"),
    (META, BF16, BF16, 64, "plain"),
])
def test_route_table(device, dtype, logits_dtype, hd, want):
    assert vit.attention_route(device, dtype, logits_dtype, hd) == want


def _qkv(b, n, h, hd, dtype, seed=0, device=CPU):
    """q, k, v as (B, N, H, hd) views of one (B, N, 3 H hd) tensor, the qkv
    projection's layout; entries N(0, 1), so the logits q k^T / sqrt(hd)
    spread by about 1, as the benchmark's random weights give."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, n, 3 * h * hd), generator=gen,
                      device=device).to(dtype)
    return tuple(t.reshape(b, n, h, hd) for t in qkv.chunk(3, dim=-1))


def _chain(q, k, v, n_pad, logits_dtype, out_dtype):
    """The materialized chain, written out: float32 sums divided by
    sqrt(hd) in float32 (or, where 1/sqrt(hd) is a power of two and q is in
    the logits' dtype, the product in that dtype times 1/sqrt(hd), which is
    exact), rounded to logits_dtype, padded keys masked to -inf, the softmax
    in float32 cast to v's dtype, the product with v in out_dtype."""
    hd = q.shape[-1]
    if n_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, n_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n_pad))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    root = math.isqrt(hd)
    if root * root == hd and root & (root - 1) == 0 and q.dtype == \
            logits_dtype:
        att = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / root)
    else:
        att = (torch.matmul(q.float(), k.float().transpose(-1, -2))
               / math.sqrt(hd)).to(logits_dtype)
    if n_pad:
        mask = torch.zeros(k.shape[2], dtype=logits_dtype)
        mask[-n_pad:] = -math.inf
        att = att + mask
    att = torch.softmax(att, dim=-1, dtype=torch.float32).to(v.dtype)
    out_dtype = out_dtype or torch.float32
    if out_dtype == v.dtype and v.dtype != torch.float32:
        o = torch.matmul(att, v)
    else:
        o = torch.matmul(att.float(), v.float()).to(out_dtype)
    return o.transpose(1, 2)


def _refuse(*args, **kwargs):
    raise AssertionError("attention_fused called off its route")


@pytest.mark.parametrize("n_pad", [0, 3])
@pytest.mark.parametrize("dtype, logits_dtype, out_dtype", [
    (BF16, BF16, BF16), (BF16, BF16, None), (F32, F32, None),
    (F32, BF16, F32)])
@pytest.mark.parametrize("hd", [64, 16])
def test_cpu_route_is_the_plain_chain_bit_for_bit(monkeypatch, n_pad, dtype,
                                                  logits_dtype, out_dtype,
                                                  hd):
    monkeypatch.setattr(attention_fused, "attention_fused", _refuse)
    q, k, v = _qkv(2, 37, 3, hd, dtype, seed=hd + n_pad)
    before = cuda_ops.launches()
    got = vit._masked_attention(q, k, v, n_pad, logits_dtype, out_dtype)
    assert cuda_ops.launches() == before
    want = _chain(q, k, v, n_pad, logits_dtype, out_dtype)
    assert got.dtype == (out_dtype or torch.float32)
    assert got.shape == q.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", [BF16, F32, None])
def test_plain_version_is_the_chain_with_bf16_logits(out_dtype):
    """The kernel module's plain version, which the wrapper runs on a CPU
    tensor, is the chain's function at scale 1/sqrt(hd): the same bits."""
    q, k, v = _qkv(2, 65, 2, 64, BF16, seed=5)
    want = vit._masked_attention(q, k, v, 0, BF16, out_dtype)
    for got in (attention_fused.attention_plain(q, k, v, scale=0.125,
                                                out_dtype=out_dtype),
                attention_fused.attention_fused(q, k, v, scale=0.125,
                                                out_dtype=out_dtype)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_plain_version_takes_the_scale(scale):
    """scale 1 leaves the logits unscaled: the chain at hd = 1; any power
    of two scales the rounded bf16 product exactly."""
    q, k, v = _qkv(1, 20, 2, 64, BF16, seed=6)
    got = attention_fused.attention_plain(q, k, v, scale=scale)
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    s = (qt @ kt.transpose(-1, -2)).to(BF16) * scale
    want = (torch.softmax(s, -1, dtype=F32).to(BF16).float() @ vt)
    assert torch.equal(got, want.transpose(1, 2))


@pytest.mark.parametrize("scale", [0.3, 0.0, -0.125, math.inf, math.nan])
@pytest.mark.parametrize("device", [CPU, META])
def test_scale_must_be_a_power_of_two(scale, device):
    q = torch.zeros((1, 4, 1, 64), dtype=BF16, device=device)
    with pytest.raises(ValueError, match="power of two"):
        attention_fused.attention_fused(q, q, q, scale=scale)


def test_kernel_route_hands_q_k_v_to_the_kernel(monkeypatch):
    """Where the route says "kernel", _masked_attention passes q, k, v
    unpadded, the scale 1/sqrt(hd) and out_dtype to ``attention_fused``
    and returns its result."""
    calls = []

    def fake(q, k, v, *, scale, out_dtype):
        calls.append((q, k, v, scale, out_dtype))
        return attention_fused.attention_plain(q, k, v, scale=scale,
                                               out_dtype=out_dtype)

    monkeypatch.setattr(attention_fused, "attention_fused", fake)
    monkeypatch.setattr(vit, "attention_route", lambda *a: "kernel")
    q, k, v = _qkv(2, 9, 2, 64, BF16, seed=7)
    got = vit._masked_attention(q, k, v, 5, BF16, BF16)
    assert len(calls) == 1
    cq, ck, cv, scale, out_dtype = calls[0]
    assert cq is q and ck is k and cv is v
    assert scale == 0.125 and out_dtype == BF16
    assert torch.equal(got, _chain(q, k, v, 0, BF16, BF16))


def test_vit_block_takes_the_route_of_its_logits(monkeypatch):
    """A ViT block asks the route with its activations' dtype, its logits'
    dtype and its head dimension, once a block."""
    from qcnn_tpu_torch.models import synth

    spec = vit.ViTSpec("ViT-route-test", patch=8, image_size=16, dim=128,
                       depth=2, heads=2, num_classes=8)
    params = vit.prepare_params(spec, synth.random_vit_pq_params(spec),
                                dtype=BF16, memory=True, device="cpu")
    asked, route = [], vit.attention_route

    def spy(*args):
        asked.append(args)
        return route(*args)

    monkeypatch.setattr(vit, "attention_route", spy)
    x = torch.randn(2, 16, 16, 3)
    vit.forward(params, x, spec=spec, compute_dtype=BF16, device="cpu")
    assert asked == [(CPU, BF16, BF16, 64)] * spec.depth


def test_kernel_module_imports_without_a_card():
    """Importing the module (and the package's forwards) builds and loads
    nothing, on a machine where CUDA sees no device."""
    code = ("import torch\n"
            "from qcnn_tpu_torch.models import vit\n"
            "from qcnn_tpu_torch.ops.cuda import _build, attention_fused\n"
            "assert not torch.cuda.is_available()\n"
            "assert _build._LIB is None\n"
            "assert attention_fused.KERNEL.launches == 0\n"
            "print(attention_fused.HEAD_DIMS)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(64,)"


@pytest.mark.parametrize("bad, match", [
    ("meta", "CUDA device"), ("f32", "CUDA device")])
def test_off_cpu_tensors_never_fall_back(bad, match):
    """A tensor off the CPU takes the kernel path, which checks for a CUDA
    device and raises: no silent plain version (a 'meta' tensor stands in
    for a device tensor here)."""
    dtype = F32 if bad == "f32" else BF16
    q = torch.empty((2, 5, 2, 64), dtype=dtype, device=META)
    with pytest.raises(ValueError, match=match):
        attention_fused.attention_fused(q, q, q, scale=0.125)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _exact(q, k, v, chunk=16):
    """softmax(q k^T / 8) v in float64 from the same bf16 inputs, a batch
    chunk at a time."""
    outs = []
    for i in range(0, q.shape[0], chunk):
        qc, kc, vc = (t[i:i + chunk].transpose(1, 2).double()
                      for t in (q, k, v))
        att = torch.softmax(qc @ kc.transpose(-1, -2) / 8, dim=-1)
        outs.append((att @ vc).transpose(1, 2))
    return torch.cat(outs)


def _rms(d):
    return d.double().pow(2).mean().sqrt().item()


@pytest.mark.card
@pytest.mark.parametrize("out_dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b, n, h", [
    (128, 577, 16), (32, 197, 12), (3, 1, 4), (3, 63, 4), (3, 65, 4),
    (5, 577, 2)], ids=lambda v: str(v))
def test_kernel_is_the_plain_chain_on_the_card(card, b, n, h, out_dtype):
    """The kernel against the plain chain (``attention_plain``), both on
    the card, on q/k/v read in place from one (B, N, 3 H 64) tensor.

    Tolerance: both round the logits to bf16 from float32 sums taken in
    different orders, so a logit on a rounding boundary can differ by one
    bf16 ulp (2^-8 of it), and the kernel rounds each probability to bf16
    before the division by its row's sum where the chain divides first
    (2^-9 of it either way). A CPU emulation of the kernel's rounding at
    these shapes reads at most 7.7e-3 of the largest |o| against the chain;
    the limit is 2^-5. The kernel must be no less precise than the chain:
    its RMS error against float64 attention on the same bf16 inputs at
    most 1.25x the chain's (the emulation reads 0.97-0.98x)."""
    q, k, v = _qkv(b, n, h, 64, BF16, seed=n, device=card)
    before = cuda_ops.launches()["attention_fused"]
    got = attention_fused.attention_fused(q, k, v, scale=0.125,
                                          out_dtype=out_dtype)
    torch.cuda.synchronize(card)
    assert cuda_ops.launches()["attention_fused"] == before + 1
    assert got.shape == q.shape and got.dtype == out_dtype
    assert got.is_contiguous() and torch.isfinite(got).all()
    want = attention_fused.attention_plain(q, k, v, scale=0.125,
                                           out_dtype=out_dtype)
    exact = _exact(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    e_kernel, e_chain = _rms(got - exact), _rms(want - exact)
    print(json.dumps({"shape": [b, n, h], "out": str(out_dtype),
                      "max_abs_vs_chain": err, "max_abs_o": scale,
                      "rms_vs_exact": [e_kernel, e_chain]}))
    assert err <= scale / 32
    assert e_kernel <= 1.25 * e_chain


@pytest.mark.card
def test_vit_attention_takes_the_kernel_on_the_card(card, monkeypatch):
    """A bf16 block's attention launches the kernel once and no library
    attention: ``F.scaled_dot_product_attention`` is never called, and the
    output is the kernel's."""
    calls = []
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        lambda *a, **kw: calls.append(a))
    q, k, v = _qkv(4, 197, 12, 64, BF16, seed=3, device=card)
    before = cuda_ops.launches()["attention_fused"]
    got = vit._masked_attention(q, k, v, 0, BF16, BF16)
    torch.cuda.synchronize(card)
    assert cuda_ops.launches()["attention_fused"] == before + 1
    assert calls == []
    assert torch.equal(got, attention_fused.attention_fused(
        q, k, v, scale=0.125, out_dtype=BF16))


# Faults injected through the kernel route at the cell's own size: the
# cell's comparison must read them not correct (PERF.md section 6 gives
# each block's readings through the chain)

def _unscaled(entry):
    """The logits without the 1/sqrt(head dim) scale: scale 1."""
    return lambda q, k, v, *, scale, out_dtype: entry(
        q, k, v, scale=1.0, out_dtype=out_dtype)


def _uniform(entry):
    """Uniform attention: q zeroed before the kernel, so every logit is
    0."""
    return lambda q, k, v, *, scale, out_dtype: entry(
        torch.zeros_like(q), k, v, scale=scale, out_dtype=out_dtype)


@pytest.mark.card
@pytest.mark.parametrize("fault, target", [
    (_unscaled, "blk12"), (_unscaled, "blk23"), (_uniform, "blk0"),
    (_uniform, "blk3")], ids=lambda v: getattr(v, "__name__", v))
def test_kernel_route_fault_is_not_correct_on_the_card(card, monkeypatch,
                                                       fault, target):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench_cuda import harness

    entry, run_block = attention_fused.attention_fused, vit._run_block
    engaged = []

    def broken(x, blk, spec, cast, dt, key="blk"):
        if key != target:
            return run_block(x, blk, spec, cast, dt, key)
        attention_fused.attention_fused = fault(entry)
        try:
            before = cuda_ops.launches()["attention_fused"]
            y = run_block(x, blk, spec, cast, dt, key)
            engaged.append(cuda_ops.launches()["attention_fused"] - before)
            return y
        finally:
            attention_fused.attention_fused = entry

    monkeypatch.setattr(vit, "_run_block", broken)
    r = harness.run_cell(ROOT, CELL, 2**31 + 41, 2.0, False, card,
                         harness.now())
    print(fault.__name__, target, json.dumps(r["checks"]))
    assert engaged and set(engaged) == {1}
    assert not r["correct"], r["checks"]

