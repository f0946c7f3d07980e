"""The LayerNorm of the ViT, Swin and MaxViT families
(``models.transformer.layernorm``) and its route to the ``layernorm_fused``
kernel (``ops.cuda.layernorm_fused.route``).

The CPU tests hold the route's conditions one by one, ``transformer.layernorm``
on the CPU to the float32 form the forwards ran before the kernel (x widened
to float32, ``F.layer_norm``, cast back) bit for bit, and each family
forward's LayerNorms to the calls that reach the route (49 for ViT-L/16's
depth, 53 for Swin-L's, 97 for MaxViT-L's). The tests marked ``card`` hold
the kernel to the float32 form at every LayerNorm shape of the benchmark's
three transformer cells (within one bf16 step in every element, far fewer
than 1 % of the elements apart at all; :func:`_step`) and both to a float64
LayerNorm, and each cell's forward at B=2 to its launches and to the
answers of the same forward with the route held on the float32 form; they
skip without a card.
The file imports no JAX and nothing from ``tests``, so on a machine with a
card and without JAX they run without the suite's conftest:

    python -m pytest tests/test_torch_layernorm_route.py --noconftest -m card -q
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qcnn_tpu_torch.models import common, maxvit, swin, synth, transformer, vit
from qcnn_tpu_torch.ops import cuda as cuda_ops
from qcnn_tpu_torch.ops.cuda import layernorm_fused as ln

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True, scope="module")
def _thread_share():
    """torch's intra-op threads: the host's cores over the xdist workers,
    restored after the module."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(1, workers)))
    yield
    torch.set_num_threads(before)


def _operands(rows, c, seed=0, device="cpu", offset=0.0):
    """(bf16 x of rows x c, {"scale", "shift"} float32 of c) as the cells
    draw them: x N(offset, 1), scale 1 + 0.05 N(0, 1), shift 0.02 N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((*rows, c), generator=gen, device=device)
         + offset).to(BF16)
    p = {"scale": 1 + 0.05 * torch.randn(c, generator=gen, device=device),
         "shift": 0.02 * torch.randn(c, generator=gen, device=device)}
    return x, p


def _parent_form(x, p, eps):
    """``transformer.layernorm`` as the forwards ran it before the kernel."""
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"], p["shift"],
                        eps).to(x.dtype)


# --- the float32 form on the CPU --------------------------------------------

@pytest.mark.parametrize("dtype", [BF16, F32], ids=str)
@pytest.mark.parametrize("shape,eps", [((2, 5, 64), 1e-6),
                                       ((3, 7, 7, 192), 1e-5),
                                       ((4, 12), 1e-5), ((6, 1024), 1e-6)],
                         ids=lambda v: str(v).replace(" ", ""))
def test_cpu_layernorm_is_the_parents_float32_form_bit_for_bit(shape, eps,
                                                                dtype):
    x, p = _operands(shape[:-1], shape[-1], seed=shape[-1], offset=0.5)
    x = x.to(dtype)
    got = transformer.layernorm(x, p, eps)
    want = _parent_form(x, p, eps)
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(ln.layernorm_plain(x, p, eps), want)


def test_cpu_layernorm_launches_nothing():
    before = cuda_ops.launches()
    x, p = _operands((4, 9), 256)
    transformer.layernorm(x, p, 1e-5)
    assert cuda_ops.launches() == before
    assert "layernorm_fused" in before


def test_off_card_calls_of_the_kernel_entry_raise():
    x, p = _operands((4,), 64)
    with pytest.raises(ValueError, match="does not take"):
        ln.layernorm_fused(x, p, 1e-5)


# --- the route ---------------------------------------------------------------

class _OnCard:
    """What :func:`ln.route` reads of a tensor, with a CUDA device: a CPU
    tensor's dtype, shape and layout at a chosen address."""

    def __init__(self, t: torch.Tensor, offset: int = 0,
                 device: str = "cuda"):
        self.t, self.offset = t, offset
        self.device = torch.device(device, 0)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self.t.dim()

    def numel(self):
        return self.t.numel()

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return (1 << 21) + self.offset


def _route_case(**change):
    """route()'s answer for a Swin stage-0 LayerNorm (bf16 x of 192
    channels, float32 scale and shift) with one thing changed."""
    shape = change.pop("shape", (2, 9, 192))
    x = _OnCard(torch.empty(shape, dtype=change.pop("x_dtype", BF16)),
                change.pop("x_offset", 0), change.pop("x_device", "cuda"))
    if change.pop("x_strided", False):
        x.t = torch.empty(shape[::-1], dtype=x.dtype).permute(
            *range(len(shape))[::-1])
    c = shape[-1]
    p = {"scale": _OnCard(torch.empty(change.pop("scale_len", c),
                                      dtype=change.pop("scale_dtype", F32)),
                          change.pop("scale_offset", 0),
                          change.pop("scale_device", "cuda")),
         "shift": _OnCard(torch.empty(c, dtype=change.pop("shift_dtype",
                                                          F32)))}
    assert not change
    return ln.route(x, p)


ROUTES = {
    "swin-stage0": ({}, "kernel"),
    "vit-1024": (dict(shape=(2, 577, 1024)), "kernel"),
    "maxvit-128": (dict(shape=(2, 96, 96, 128)), "kernel"),
    "head-rank-2": (dict(shape=(128, 1024)), "kernel"),
    "merge-3072": (dict(shape=(2, 36, 3072)), "kernel"),
    "general-width-200": (dict(shape=(5, 200)), "kernel"),
    "widest": (dict(shape=(3, 4096)), "kernel"),
    "cpu": (dict(x_device="cpu"), "plain"),
    "meta": (dict(x_device="meta"), "plain"),
    "f32-x": (dict(x_dtype=F32), "plain"),
    "f16-x": (dict(x_dtype=torch.float16), "plain"),
    "width-not-a-multiple-of-8": (dict(shape=(2, 9, 196)), "plain"),
    "too-wide": (dict(shape=(3, 4104)), "plain"),
    "non-contiguous": (dict(x_strided=True), "plain"),
    "misaligned": (dict(x_offset=8), "plain"),
    "empty": (dict(shape=(0, 192)), "plain"),
    "bf16-scale": (dict(scale_dtype=BF16), "plain"),
    "bf16-shift": (dict(shift_dtype=BF16), "plain"),
    "short-scale": (dict(scale_len=96), "plain"),
    "scale-on-the-cpu": (dict(scale_device="cpu"), "plain"),
    "scale-misaligned": (dict(scale_offset=4), "plain"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_takes_the_kernel_only_under_its_conditions(case):
    change, want = ROUTES[case]
    assert _route_case(**dict(change)) == want


# --- the LayerNorms of each family forward ----------------------------------

def _routed(run, monkeypatch) -> list:
    """(width, dtype) of every call of the route in one call of ``run``."""
    calls = []
    entry = ln.route

    def record(x, p):
        calls.append((x.shape[-1], x.dtype))
        return entry(x, p)

    monkeypatch.setattr(ln, "route", record)
    run()
    return calls


def _family(family, spec, params, image):
    prepared, fwd, _ = common.build_family_forward(
        family, spec, params, memory=True, compute_dtype=BF16, device="cpu")
    x = torch.randn(1, image, image, 3,
                    generator=torch.Generator().manual_seed(1))
    return lambda: fwd(prepared, x)


def test_vitl16_forward_asks_the_route_49_times(monkeypatch):
    """ViT-L/16's 24 blocks (ln1, ln2) and the final LayerNorm, all bf16,
    at the published width (the image cut to 32x32: the count follows the
    depth)."""
    spec = vit.ViTSpec("ViT-L/16-32px", patch=16, image_size=32, dim=1024,
                       depth=24, heads=16)
    run = _family("vit", spec, synth.random_vit_pq_params(spec, seed=0), 32)
    assert _routed(run, monkeypatch) == [(1024, BF16)] * 49


def test_swinl_forward_asks_the_route_53_times(monkeypatch):
    """Swin-L's depths (2, 2, 18, 2): the patch embedding's LayerNorm, two
    a block (48), one a patch merging at 4 C (3) and the final one, all
    bf16 (widths and image cut: embed 32, window 4, 64x64)."""
    spec = swin.SwinSpec("Swin-L-depths-64px", patch=4, image_size=64,
                         embed_dim=32, depths=(2, 2, 18, 2),
                         heads=(1, 2, 4, 8), window=4)
    run = _family("swin", spec, synth.random_swin_pq_params(spec, seed=0),
                  64)
    got = _routed(run, monkeypatch)
    assert len(got) == 53
    assert {dt for _, dt in got} == {BF16}
    widths = [c for c, _ in got]
    assert widths == ([32] + [32] * 4 + [128] + [64] * 4 + [256]
                      + [128] * 36 + [512] + [256] * 4 + [256])


def test_maxvitl_forward_asks_the_route_97_times(monkeypatch):
    """MaxViT-L's depths (2, 6, 14, 2): two LayerNorms in each of the 48
    partition blocks and the head's, all bf16 (widths and image cut:
    widths 32-128, partition 2, 64x64)."""
    spec = maxvit.MaxViTSpec("MaxViT-L-depths-64px", image_size=64,
                             stem_width=32, dims=(32, 32, 64, 128),
                             depths=(2, 6, 14, 2), partition=2)
    run = _family("maxvit", spec,
                  synth.random_maxvit_pq_params(spec, seed=0), 64)
    got = _routed(run, monkeypatch)
    assert got == ([(32, BF16)] * 32 + [(64, BF16)] * 56
                   + [(128, BF16)] * 8 + [(128, BF16)])


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


# every LayerNorm shape of the three cells at B=128: (rows, C, eps)
CELL_LAYERNORMS = {
    "vitl16": [(128 * 577, 1024, 1e-6)],
    # the patch embedding's and stage 0's, then each merge's at 4 C and
    # the next stage's, the final one at stage 3's width
    "swinl": [(128 * 96 * 96, 192, 1e-5), (128 * 48 * 48, 768, 1e-5),
              (128 * 48 * 48, 384, 1e-5), (128 * 24 * 24, 1536, 1e-5),
              (128 * 24 * 24, 768, 1e-5), (128 * 12 * 12, 3072, 1e-5),
              (128 * 12 * 12, 1536, 1e-5)],
    # each stage's blocks, then the head's on the pooled map
    "maxvitl": [(128 * 96 * 96, 128, 1e-5), (128 * 48 * 48, 256, 1e-5),
                (128 * 24 * 24, 512, 1e-5), (128 * 12 * 12, 1024, 1e-5),
                (128, 1024, 1e-5)],
    # ragged row counts, and widths the general instance takes
    "ragged": [(1031, 192, 1e-5), (77, 128, 1e-5), (333, 1024, 1e-6),
               (5, 3072, 1e-5), (1001, 200, 1e-5), (17, 4096, 1e-5),
               (3, 8, 1e-5)],
}
CARD_CASES = [(cell, *case) for cell, cases in CELL_LAYERNORMS.items()
              for case in cases]


def _step(a, b, x, p, eps) -> torch.Tensor:
    """One bf16 step of each output element (float64): 2^-7 of the larger
    of |a| and |b|, which bounds a bf16 step of either from above, or,
    where more, 4 float32 steps (2^-21) of the element's float32 terms,
    |scale| rstd (|x| + |mean|) + |shift|. Two float32 LayerNorms whose
    statistics are summed in other orders differ by a few float32 steps of
    those terms, whatever the result's size: an output that the shift
    nearly cancels may lie many of its own bf16 steps apart (torch's CPU
    and card kernels differ so too)."""
    xd = x.double()
    mean = xd.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xd - mean) ** 2).mean(-1, keepdim=True) + eps)
    floor = 2.0 ** -21 * (p["scale"].double().abs() * rstd
                          * (xd.abs() + mean.abs())
                          + p["shift"].double().abs())
    top = torch.maximum(a.double().abs(), b.double().abs())
    return torch.maximum(top * 2.0 ** -7, floor)


@pytest.mark.card
@pytest.mark.parametrize("cell,rows,c,eps", CARD_CASES,
                         ids=lambda v: str(v))
def test_kernel_is_the_float32_form_at_the_cells_shapes(card, cell, rows, c,
                                                        eps):
    """One launch; every element within one bf16 step (:func:`_step`) of
    the float32 form, and under 1 % of them apart at all (their statistics
    are summed in other orders); the count is printed. Both against a
    float64 LayerNorm: the kernel's error is the float32 form's, plus one
    bf16 step at most."""
    x, p = _operands((rows,), c, seed=c + rows % 997, device=card,
                     offset=0.25)
    before = cuda_ops.launches()["layernorm_fused"]
    got = ln.layernorm_fused(x, p, eps)
    torch.cuda.synchronize(card)
    assert cuda_ops.launches()["layernorm_fused"] == before + 1
    want = ln.layernorm_plain(x, p, eps)
    assert got.dtype == want.dtype == BF16 and got.shape == x.shape
    g, w = got.double(), want.double()
    differ = int((g != w).sum())
    step = _step(g, w, x, p, eps)
    worst = float(((g - w).abs() / step).max())
    exact = F.layer_norm(x.double(), (c,), p["scale"].double(),
                         p["shift"].double(), eps)
    err_k, err_f = (g - exact).abs(), (w - exact).abs()
    over = float(((err_k - err_f) / step).max())
    print(json.dumps({"cell": cell, "rows": rows, "c": c, "differ": differ,
                      "of": got.numel(), "largest_steps": worst,
                      "beyond_own_step": int(((g - w).abs() > torch.maximum(
                          g.abs(), w.abs()) * 2.0 ** -7).sum()),
                      "max_err_kernel": float(err_k.max()),
                      "max_err_float32_form": float(err_f.max()),
                      "largest_excess_steps": over}))
    assert bool(torch.isfinite(g).all())
    assert worst <= 1.0
    assert differ < 0.01 * got.numel()
    assert over <= 1.0


def _cell(name: str, card, batch: int):
    """The benchmark cell's timed forward at ``batch``, a batch of its
    inputs, and its configuration."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench_cuda import harness

    cfg_name, builder = {
        "vitl16": ("vitl16-384-pq-mem", "vit_pq"),
        "swinl": ("swinl-384-pq-mem", "swin_pq"),
        "maxvitl": ("maxvitl-384-pq-mem", "maxvit_pq")}[name]
    with open(os.path.join(ROOT, "bench_cuda", "configs",
                           f"{cfg_name}.json")) as f:
        cfg = json.load(f)
    b = harness.load_module(os.path.join(ROOT, "bench_cuda", "builders",
                                         f"{builder}.py"), f"t_{builder}")
    gen = torch.Generator(device=card).manual_seed(2**31 + 25)
    weights = b.make_weights(cfg, gen, card)
    fwd = b.offline_forward(cfg, weights, batch, card)
    x = torch.randn((batch, *b.input_shape(cfg)), generator=gen, device=card)
    return fwd, x, cfg


@pytest.mark.card
@pytest.mark.parametrize("name,launches", [("vitl16", 49), ("swinl", 53),
                                           ("maxvitl", 97)])
def test_cell_forward_launches_the_kernel_and_keeps_its_answers(
        card, monkeypatch, name, launches):
    """The cell's forward at B=2 launches ``layernorm_fused`` once a
    LayerNorm (ViT-L/16: 2 a block and the final one; Swin-L: 2 a block,
    the final one, the 3 merges' and the patch embedding's; MaxViT-L: 2 a
    partition block and the head's), and its probabilities are those of
    the same forward with the route held on the float32 form within the
    cell's ``correct`` limits (the harness's numbers, the float32 form's
    answers in the reference's place)."""
    from bench_cuda import harness

    fwd, x, cfg = _cell(name, card, 2)
    fwd(x)
    torch.cuda.synchronize(card)
    before = cuda_ops.launches()["layernorm_fused"]
    got = fwd(x).double().cpu()
    torch.cuda.synchronize(card)
    assert cuda_ops.launches()["layernorm_fused"] - before == launches
    monkeypatch.setattr(ln, "route", lambda *a, **k: "plain")
    want = fwd(x).double().cpu()
    assert cuda_ops.launches()["layernorm_fused"] - before == launches
    ref_logp = torch.log(want.clamp_min(np.finfo(np.float32).tiny)).numpy()
    ids, probs = harness.top5(got.numpy())
    numbers = harness.compare(
        {"ids": ids, "probs": probs, "image": np.arange(got.shape[0])},
        ref_logp, ref_logp.std(axis=1))
    print(json.dumps({"cell": name, **numbers}))
    for key, limit in cfg["check"].items():
        assert numbers[key] <= limit, (key, numbers[key], limit)
    assert numbers["top1_outside_ref_top5"] == 0
