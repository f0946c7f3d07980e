"""The one epilogue after each product (``ops.fc.emit``) and its route to
the ``epilogue_fused`` kernel (``ops.cuda.epilogue_fused.route``).

The CPU tests hold the plain chain to the ops the forwards ran before it
was one place (the conv's and the FC's bias adds, ResNet's ``clamp_min``
and shortcut, ViT's residual adds and exact GELU), bit for bit; the
route's conditions; and the forms each family forward asks of the
epilogue. The tests marked ``card`` hold the kernel to the plain chain at
every epilogue shape of the benchmark's four cells, and each cell's
forward to its launches and to the bits of the same forward with the
route held on the plain chain; they skip without a card. The file imports
no JAX and nothing from ``tests``, so on a machine with a card and without
JAX they run without the suite's conftest:

    python -m pytest tests/test_torch_epilogue_route.py --noconftest -m card -q
"""

import collections
import json
import os
import sys

import pytest
import torch
import torch.nn.functional as F

from qcnn_tpu_torch.models import (
    common,
    maxvit,
    network,
    prepare,
    resnet,
    swin,
    synth,
    vit,
)
from qcnn_tpu_torch.ops import fc as fc_ops
from qcnn_tpu_torch.ops.cuda import epilogue_fused as ep

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


def _operands(shape, y_dtype, seed=0, device="cpu", special=True):
    """(product, float32 bias, bf16 residual) of a (..., C) epilogue, the
    product with a few NaNs, infinities, signed zeros and subnormals."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    y = torch.randn(shape, generator=gen, device=device) * 2
    if special:
        flat = y.view(-1)
        picks = [float("nan"), float("inf"), float("-inf"), -0.0, 0.0,
                 -1e-40, 1e-40, -3e-39, 65504.0, -1e30]
        for i, v in enumerate(picks):
            flat[(i * 7919) % flat.numel()] = v
    bias = torch.randn(c, generator=gen, device=device) * 0.1
    res = (torch.randn(shape, generator=gen, device=device)).to(BF16)
    return y.to(y_dtype), bias, res


def same_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Where two bf16 tensors hold the same bits, any NaN counting as one."""
    return (a.view(torch.int16) == b.view(torch.int16)) | (a.isnan()
                                                           & b.isnan())


# --- the plain chain is the ops the forwards ran ----------------------------

def _nchw_bias(y, od, bias):
    """``ops.conv.conv_dense``'s epilogue before it was ``emit``: the cast
    and the bias add over the channels-last NCHW view, then NHWC."""
    yn = y.permute(0, 3, 1, 2)
    return (yn.to(od) + bias.to(od)[:, None, None]).permute(0, 2, 3, 1)


# (form, ``emit`` keywords, the parent's chain on (y, od, bias, residual))
FORMS = {
    "bias": (dict(bias=True),
             lambda y, od, b, r: _nchw_bias(y, od, b)),
    "bias-relu": (dict(bias=True, act="relu"),
                  lambda y, od, b, r: torch.clamp_min(_nchw_bias(y, od, b),
                                                      0)),
    "bias-residual-relu": (dict(bias=True, residual=True, act="relu"),
                           lambda y, od, b, r: torch.clamp_min(
                               _nchw_bias(y, od, b) + r, 0)),
    "bias-gelu": (dict(bias=True, act="gelu"),
                  lambda y, od, b, r: F.gelu(y.to(od) + b.to(od))),
    "bias-gelu_tanh": (dict(bias=True, act="gelu_tanh"),
                       lambda y, od, b, r: F.gelu(y.to(od) + b.to(od),
                                                  approximate="tanh")),
    "bias-residual": (dict(bias=True, residual=True),
                      lambda y, od, b, r: r + (y.to(od) + b.to(od))),
    "relu": (dict(act="relu"),
             lambda y, od, b, r: torch.clamp_min(y.to(od), 0)),
}


@pytest.mark.parametrize("y_dtype,od", [(BF16, BF16), (F32, BF16),
                                        (F32, F32)], ids=str)
@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_epilogue_is_the_parents_chain_bit_for_bit(form, y_dtype, od):
    kw, chain = FORMS[form]
    y, bias, res = _operands((2, 5, 3, 24), y_dtype, seed=len(form))
    res = res.to(od)
    got = fc_ops.emit(y, od, bias=bias if kw.get("bias") else None,
                      act=kw.get("act"),
                      residual=res if kw.get("residual") else None)
    want = chain(y, od, bias, res)
    assert got.dtype == want.dtype == od
    assert got.shape == want.shape
    if od == BF16:
        assert same_bits(got, want).all()
    else:
        assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


def test_emit_of_a_cast_alone_is_one_cast():
    y, _, _ = _operands((4, 16), F32)
    assert fc_ops.emit(y, None) is y
    assert fc_ops.emit(y, F32) is y
    assert same_bits(fc_ops.emit(y, BF16), y.to(BF16)).all()
    codes = torch.randint(-127, 128, (4, 16), dtype=torch.int8)
    assert fc_ops.emit(codes, BF16) is codes


def test_unknown_activation_raises():
    y, _, _ = _operands((4, 16), BF16)
    with pytest.raises(ValueError, match="activation"):
        fc_ops.emit(y, BF16, act="tanh")


def test_off_cpu_calls_of_the_kernel_entry_raise():
    y, bias, _ = _operands((4, 16), BF16)
    with pytest.raises(ValueError, match="does not take"):
        ep.epilogue_fused(y, bias=bias)


# --- the route ---------------------------------------------------------------

class _OnCard:
    """What :func:`route` reads of a tensor, with a CUDA device: a CPU
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


def _strided(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` whose axes lie in reverse order in memory."""
    axes = list(range(len(shape)))[::-1]
    return torch.empty(shape[::-1], dtype=dtype).permute(*axes)


def _route_case(**change):
    """route()'s answer for a ResNet conv3's epilogue (bf16 product, float32
    bias, bf16 residual, ReLU, bf16 out) with one thing changed."""
    shape = change.pop("shape", (2, 7, 7, 64))
    y = _OnCard(torch.empty(shape, dtype=change.pop("y_dtype", BF16)),
                change.pop("y_offset", 0), change.pop("y_device", "cuda"))
    if change.pop("y_strided", False):
        y.t = _strided(shape, y.dtype)
    bias = _OnCard(torch.empty(change.pop("bias_len", shape[-1]),
                               dtype=change.pop("bias_dtype", F32)))
    res = _OnCard(torch.empty(change.pop("res_shape", shape),
                              dtype=change.pop("res_dtype", BF16)),
                  change.pop("res_offset", 0))
    if change.pop("res_strided", False):
        res.t = _strided(shape, res.dtype)
    kw = dict(bias=bias, act="relu", residual=res, int8=False)
    kw.update(change.pop("kw", {}))
    od = change.pop("od", BF16)
    assert not change
    return ep.route(y, od, **kw)


ROUTES = {
    "conv3": ({}, "kernel"),
    "bias-only": (dict(kw=dict(act=None, residual=None)), "kernel"),
    "gelu": (dict(kw=dict(act="gelu", residual=None)), "kernel"),
    "gelu_tanh": (dict(kw=dict(act="gelu_tanh", residual=None)), "kernel"),
    "gelu_tanh-residual": (dict(kw=dict(act="gelu_tanh")), "kernel"),
    "f32-product-relu": (dict(y_dtype=F32, kw=dict(bias=None,
                                                   residual=None)),
                         "kernel"),
    "residual-only": (dict(kw=dict(bias=None, act=None)), "kernel"),
    "rank-2": (dict(shape=(96, 4096)), "kernel"),
    "cast-alone": (dict(y_dtype=F32, kw=dict(bias=None, act=None,
                                             residual=None)), "plain"),
    "cpu": (dict(y_device="cpu"), "plain"),
    "meta": (dict(y_device="meta"), "plain"),
    "f32-out": (dict(od=F32), "plain"),
    "kept-dtype": (dict(od=None), "plain"),
    "int8-layer": (dict(kw=dict(int8=True)), "plain"),
    "f16-product": (dict(y_dtype=torch.float16), "plain"),
    "odd-width": (dict(shape=(2, 7, 7, 60)), "plain"),
    "width-12": (dict(shape=(3, 12)), "plain"),
    "strided": (dict(y_strided=True), "plain"),
    "misaligned": (dict(y_offset=8), "plain"),
    "bf16-bias": (dict(bias_dtype=BF16), "plain"),
    "short-bias": (dict(bias_len=32), "plain"),
    "f32-residual": (dict(res_dtype=F32), "plain"),
    "residual-shape": (dict(res_shape=(2, 7, 1, 64)), "plain"),
    "residual-strided": (dict(res_strided=True), "plain"),
    "residual-misaligned": (dict(res_offset=2), "plain"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_takes_the_kernel_only_under_its_conditions(case):
    change, want = ROUTES[case]
    assert _route_case(**dict(change)) == want


def test_cpu_epilogue_launches_nothing():
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    before = cuda_ops.launches()
    y, bias, res = _operands((2, 3, 3, 64), BF16)
    fc_ops.emit(y, BF16, bias=bias, act="relu", residual=res)
    assert cuda_ops.launches() == before


# --- the forms each forward asks for ----------------------------------------

def _recorded_forms(run, monkeypatch, bias=False) -> collections.Counter:
    """{(emitted dtype, act, residual?): calls} of ``emit``'s epilogues in
    one call of ``run``, with the bias or without (the routes that sum in
    float32 add it inside); ``bias`` adds whether a bias came to the key."""
    forms = collections.Counter()
    entry = ep.epilogue

    def record(y, out_dtype, b=None, act=None, residual=None, **kw):
        key = (out_dtype, act, residual is not None)
        forms[(*key, b is not None) if bias else key] += 1
        return entry(y, out_dtype, b, act, residual, **kw)

    monkeypatch.setattr(ep, "epilogue", record)
    run()
    return forms


def test_resnet50_forward_forms(monkeypatch):
    """ResNet-50 in memory mode, bf16: the stem, every conv1 and conv2 ReLU
    (33: the 3x3 convs that take the fused decode-conv bring their float32
    sums with the bias inside), every conv3 the shortcut and a ReLU (16),
    the 4 projections the bias alone, and the float32 head."""
    spec = resnet.resnet50()
    params = synth.random_resnet_pq_params(spec, seed=0)
    prepared, fwd, _ = common.build_family_forward(
        "resnet", spec, params, memory=True, compute_dtype=BF16,
        device="cpu")
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    forms = _recorded_forms(lambda: fwd(prepared, x), monkeypatch)
    assert forms == {(BF16, "relu", False): 33, (BF16, "relu", True): 16,
                     (BF16, None, False): 4,
                     (F32, None, False): 1}  # the head


def test_vitl16_forward_forms(monkeypatch):
    """ViT-L/16 in memory mode, bf16: 24 blocks of qkv (the bias alone),
    out and mlp2 (the residual), mlp1 (exact GELU), the patch embedding's
    bias, and the float32 head. The image is cut to 32x32 (4 patches):
    the forms follow the depth, not the tokens (at 5 rows mlp1 and mlp2
    take the fused decode-GEMM, which adds the bias inside)."""
    spec = vit.ViTSpec("ViT-L/16-32px", patch=16, image_size=32, dim=1024,
                       depth=24, heads=16)
    params = synth.random_vit_pq_params(spec, seed=0)
    prepared, fwd, _ = common.build_family_forward(
        "vit", spec, params, memory=True, compute_dtype=BF16, device="cpu")
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    forms = _recorded_forms(lambda: fwd(prepared, x), monkeypatch)
    assert forms == {(BF16, None, False): 25,  # qkv 24, embedding
                     (BF16, "gelu", False): 24, (BF16, None, True): 48,
                     (F32, None, False): 1}


def test_swinl_forward_forms(monkeypatch):
    """Swin-L in memory mode, bf16: the 24 blocks of depths (2, 2, 18, 2)
    each with qkv (the bias alone), out and mlp2 (the residual), mlp1
    (exact GELU), the patch embedding's bias, the three reductions' (zero)
    bias and the float32 head. The widths and the image are cut (64x64,
    embed 32, window 4): the forms follow the depth and the stages, not
    the widths."""
    spec = swin.SwinSpec("Swin-L-depths-64px", patch=4, image_size=64,
                         embed_dim=32, depths=(2, 2, 18, 2),
                         heads=(1, 2, 4, 8), window=4)
    params = synth.random_swin_pq_params(spec, seed=0)
    prepared, fwd, _ = common.build_family_forward(
        "swin", spec, params, memory=True, compute_dtype=BF16, device="cpu")
    x = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    forms = _recorded_forms(lambda: fwd(prepared, x), monkeypatch)
    assert forms == {(BF16, None, False): 28,  # qkv 24, embedding, merges
                     (BF16, "gelu", False): 24, (BF16, None, True): 48,
                     (F32, None, False): 1}


def test_maxvitl_forward_forms(monkeypatch):
    """MaxViT-L in memory mode, bf16: the stem's conv1 (tanh GELU) and
    conv2 (the bias alone); each of the 24 MBConvs' conv1 and depthwise
    conv (tanh GELU), conv3 (the shortcut) and in each stage's first block
    proj (the bias alone), and its two squeeze-excite FCs in float32; each
    of the 48 partition blocks' qkv (the bias alone), out and mlp2 (the
    residual), mlp1 (tanh GELU); the head's pre-logits (the bias alone)
    and float32 classifier. The widths and the image are cut (64x64,
    widths 32-128, partition 2): the forms follow the depths."""
    spec = maxvit.MaxViTSpec("MaxViT-L-depths-64px", image_size=64,
                             stem_width=32, dims=(32, 32, 64, 128),
                             depths=(2, 6, 14, 2), partition=2)
    params = synth.random_maxvit_pq_params(spec, seed=0)
    prepared, fwd, _ = common.build_family_forward(
        "maxvit", spec, params, memory=True, compute_dtype=BF16,
        device="cpu")
    x = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    forms = _recorded_forms(lambda: fwd(prepared, x), monkeypatch)
    assert forms == {(BF16, "gelu_tanh", False): 1 + 2 * 24 + 48,
                     (BF16, None, False): 1 + 4 + 48 + 1,
                     (BF16, None, True): 24 + 2 * 48,
                     (F32, None, False): 2 * 24 + 1}


def test_alexnet_forward_forms(monkeypatch):
    """AlexNet in memory mode, bf16, B=4: the 5 convs' bias alone (their
    ReLUs stay layers of the spec); fc6-8 bring float32 sums with the bias
    inside, cast alone, which the route leaves to torch's cast."""
    from qcnn_tpu_torch.models import zoo

    spec = zoo.alexnet()
    params = synth.random_pq_params(spec, seed=3)
    prepared, conv_i, fc_i = prepare.prepare_params(
        spec, params, batch_hint=4, conv_impl="memory", fc_impl="memory",
        dtype=BF16, device="cpu")
    fwd = network.make_forward_fn(spec, conv_impls=conv_i, fc_impls=fc_i,
                                  compute_dtype=BF16, device="cpu")
    x = torch.as_tensor(synth.random_input(spec, 4, seed=1))
    forms = _recorded_forms(lambda: fwd(prepared, x), monkeypatch, bias=True)
    assert forms == {(BF16, None, False, True): 5,
                     (BF16, None, False, False): 3}


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


# every epilogue shape and form of the four cells' forwards:
# (rows, C, product dtype, form)
CELL_EPILOGUES = {
    "alexnet": [((256, 55, 55), 96, BF16, "bias"),
                ((256, 27, 27), 256, BF16, "bias"),
                ((256, 13, 13), 384, BF16, "bias"),
                ((256, 13, 13), 256, BF16, "bias")],
    "resnet50": [((256, 112, 112), 64, BF16, "bias-relu"),
                 ((256, 56, 56), 64, BF16, "bias-relu"),
                 ((256, 56, 56), 256, BF16, "bias-residual-relu"),
                 ((256, 56, 56), 256, BF16, "bias"),
                 ((256, 56, 56), 128, BF16, "bias-relu"),
                 ((256, 28, 28), 128, BF16, "bias-relu"),
                 ((256, 28, 28), 512, BF16, "bias-residual-relu"),
                 ((256, 28, 28), 512, BF16, "bias"),
                 ((256, 28, 28), 256, BF16, "bias-relu"),
                 ((256, 14, 14), 256, BF16, "bias-relu"),
                 ((256, 14, 14), 256, F32, "relu"),
                 ((256, 14, 14), 1024, BF16, "bias-residual-relu"),
                 ((256, 14, 14), 1024, BF16, "bias"),
                 ((256, 14, 14), 512, BF16, "bias-relu"),
                 ((256, 7, 7), 512, BF16, "bias-relu"),
                 ((256, 7, 7), 512, F32, "relu"),
                 ((256, 7, 7), 2048, BF16, "bias-residual-relu"),
                 ((256, 7, 7), 2048, BF16, "bias")],
    "vitl16": [((128 * 576,), 1024, BF16, "bias"),
               ((128 * 577,), 3072, BF16, "bias"),
               ((128 * 577,), 1024, BF16, "bias-residual"),
               ((128 * 577,), 4096, BF16, "bias-gelu"),
               ((128 * 577,), 1024, BF16, "bias-residual")],
    # the patch embedding; each stage's qkv, out and mlp2, mlp1; the
    # reductions, whose bias is zero in the model
    "swinl": [((128 * 96 * 96,), 192, BF16, "bias"),
              *[((128 * g * g,), c, BF16, form)
                for g, d in ((96, 192), (48, 384), (24, 768), (12, 1536))
                for c, form in ((3 * d, "bias"), (d, "bias-residual"),
                                (4 * d, "bias-gelu"))],
              ((128 * 48 * 48,), 384, BF16, "bias"),
              ((128 * 24 * 24,), 768, BF16, "bias"),
              ((128 * 12 * 12,), 1536, BF16, "bias")],
    # the stem's two convs; each stage's first-block expansion (at the
    # input map), proj, depthwise conv (at the output map) and conv3;
    # each stage's qkv, out and mlp2, mlp1; the pre-logits
    "maxvitl": [((128, 192, 192), 128, BF16, "bias-gelu_tanh"),
                ((128, 192, 192), 128, BF16, "bias"),
                *[case for g, c in ((96, 128), (48, 256), (24, 512),
                                    (12, 1024))
                  for case in (((128, 2 * g, 2 * g), 4 * c, BF16,
                                "bias-gelu_tanh"),
                               ((128, g, g), c, BF16, "bias"),
                               ((128, g, g), 4 * c, BF16, "bias-gelu_tanh"),
                               ((128, g, g), c, BF16, "bias-residual"),
                               ((128 * g * g,), 3 * c, BF16, "bias"),
                               ((128 * g * g,), 4 * c, BF16,
                                "bias-gelu_tanh"))],
                ((128,), 1024, BF16, "bias")],
}
CARD_CASES = [(cell, *case) for cell, cases in CELL_EPILOGUES.items()
              for case in cases]


@pytest.mark.card
@pytest.mark.parametrize("cell,rows,c,y_dtype,form", CARD_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_kernel_is_the_plain_chain_at_the_cells_shapes(card, cell, rows, c,
                                                       y_dtype, form):
    """One launch, the chain's bits. GELU may differ where the card's erff
    (tanhf for gelu_tanh) and torch's differ, by one bf16 step at most;
    the count is printed."""
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    kw, _ = FORMS[form]
    y, bias, res = _operands((*rows, c), y_dtype, seed=c, device=card)
    args = dict(bias=bias if kw.get("bias") else None, act=kw.get("act"),
                residual=res if kw.get("residual") else None)
    before = cuda_ops.launches()["epilogue_fused"]
    got = ep.epilogue_fused(y, **args)
    torch.cuda.synchronize(card)
    assert cuda_ops.launches()["epilogue_fused"] == before + 1
    want = ep.epilogue_plain(y, BF16, **args)
    same = same_bits(got, want)
    differ = int((~same).sum())
    print(json.dumps({"cell": cell, "shape": [*rows, c], "form": form,
                      "differ": differ}))
    if kw.get("act") not in ("gelu", "gelu_tanh"):
        assert differ == 0
    else:
        step = (got.float() - want.float()).abs()[~same]
        ulp = want.float().abs()[~same].clamp_min(1e-38) * 2.0 ** -7
        assert bool((step <= ulp).all()), differ


def _cell(name: str, card):
    """The benchmark cell's timed forward and a batch of its inputs."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench_cuda import harness

    cfg_name, builder, batch = {
        "alexnet": ("alexnet-pq-mem", "alexnet_pq", 256),
        "resnet50": ("resnet50-pq-mem", "resnet_pq", 256),
        "vitl16": ("vitl16-384-pq-mem", "vit_pq", 128),
        "swinl": ("swinl-384-pq-mem", "swin_pq", 128),
        "maxvitl": ("maxvitl-384-pq-mem", "maxvit_pq", 128)}[name]
    with open(os.path.join(ROOT, "bench_cuda", "configs",
                           f"{cfg_name}.json")) as f:
        cfg = json.load(f)
    b = harness.load_module(os.path.join(ROOT, "bench_cuda", "builders",
                                         f"{builder}.py"), f"t_{builder}")
    gen = torch.Generator(device=card).manual_seed(2**31 + 11)
    weights = b.make_weights(cfg, gen, card)
    fwd = b.offline_forward(cfg, weights, batch, card)
    x = torch.randn((batch, *b.input_shape(cfg)), generator=gen, device=card)
    return fwd, x


@pytest.mark.card
@pytest.mark.parametrize("name,launches", [("alexnet", 5), ("resnet50", 53),
                                           ("vitl16", 97), ("swinl", 100),
                                           ("maxvitl", 271)])
def test_cell_forward_launches_the_kernel_and_keeps_the_bits(
        card, monkeypatch, name, launches):
    """The cell's forward launches ``epilogue_fused`` once an epilogue that
    fuses something (ViT: the 96 of its blocks and the patch embedding's
    bias; Swin-L: the 96 of its blocks, the patch embedding's and the
    three reductions'), and its output is the bits of the same forward
    with every epilogue on the plain chain, torch's ops as before the
    kernel."""
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    fwd, x = _cell(name, card)
    fwd(x)
    torch.cuda.synchronize(card)
    before = cuda_ops.launches()["epilogue_fused"]
    got = fwd(x)
    torch.cuda.synchronize(card)
    assert cuda_ops.launches()["epilogue_fused"] - before == launches
    monkeypatch.setattr(ep, "route", lambda *a, **k: "plain")
    want = fwd(x)
    torch.cuda.synchronize(card)
    assert cuda_ops.launches()["epilogue_fused"] - before == launches
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
