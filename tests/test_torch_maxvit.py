"""MaxViT-L at 384x384 in memory mode, the benchmark's hybrid of
convolution and attention (``bench_cuda/configs/maxvitl-384-pq-mem.json``):
the port's MaxViT forward against the benchmark's plain float32 reference
(``bench_cuda/reference/maxvit.py``), the block and grid partitions, the
relative-position bias, the TF 'same' pad and the BatchNorm folds against
their published or explicit forms, the spec's parameter and FLOP counts,
the memory-mode routing at the cell's rows, the family wiring (checkpoint,
CLI) and the ``qcnn.*`` spans of a MaxViT forward. The grid partition's
route and kernel are tested beside Swin's, in
``tests/test_torch_window_attention_route.py``.

The CPU tests run a small MaxViT (128x128, partition 4, widths 32-128 with
32 channels a head, grids 32, 16, 8 and 4: block and grid windows differ
in stages 0-2 and coincide in stage 3). The tests marked ``card`` run the
cell's own size on the card and skip without one. The file imports no JAX
and nothing from ``tests``, so on a machine with a card and without JAX
they run without the suite's conftest:

    python -m pytest tests/test_torch_maxvit.py --noconftest -m card -q
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from qcnn_tpu_torch.models import common, maxvit, resnet, swin, synth
from qcnn_tpu_torch.ops import conv as conv_ops
from qcnn_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "bench_cuda", "configs",
                      "maxvitl-384-pq-mem.json")
SMALL = maxvit.maxvit_tiny_test()
CELL_BATCH = 128


@pytest.fixture(autouse=True, scope="module")
def _thread_share():
    """torch's intra-op threads: the host's cores over the xdist workers,
    restored after the module."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(1, workers)))
    yield
    torch.set_num_threads(before)


def _bench():
    """The benchmark's builder and reference modules."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench_cuda import harness
    from bench_cuda.reference import maxvit as ref

    b = harness.load_module(os.path.join(ROOT, "bench_cuda", "builders",
                                         "maxvit_pq.py"), "t_maxvit_pq")
    return b, ref


def _config() -> dict:
    with open(CONFIG) as f:
        return json.load(f)


def _small_config(spec: maxvit.MaxViTSpec) -> dict:
    """The benchmark configuration at ``spec``'s sizes."""
    return dict(_config(), model=spec.name,
                input=[spec.image_size, spec.image_size, 3],
                stem_width=spec.stem_width, embed_dim=list(spec.dims),
                depths=list(spec.depths), partition_size=spec.partition,
                head_hidden_size=spec.dims[-1],
                num_classes=spec.num_classes)


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


def _image(n, spec, seed=1):
    return torch.randn(n, spec.image_size, spec.image_size, 3,
                       generator=torch.Generator().manual_seed(seed))


def _reference_logits(params, x):
    _, ref = _bench()
    return ref.logits(_small_config(SMALL), _as_tensors(params), x).double()


# --- the port against the plain reference ----------------------------------

@pytest.mark.parametrize("memory", [True, False], ids=["memory", "at_load"])
@pytest.mark.parametrize("seed", [0, 7])
def test_float32_forward_is_the_reference(seed, memory):
    """float32 in memory mode and decoded at load: the reference's logits
    to float32 rounding, 1e-5 of the largest as for ViT and Swin (the two
    sum every product in other orders: NHWC against NCHW convs, an explicit
    pad against the 'same' one, a gathered bias against timm's one-hot
    einsums; first runs read under 4e-7)."""
    params = synth.random_maxvit_pq_params(SMALL, seed=seed)
    prepared, fwd, _ = common.build_family_forward(
        "maxvit", SMALL, params, memory=memory, compute_dtype=torch.float32,
        device="cpu")
    x = _image(3, SMALL)
    got = maxvit.forward(prepared, x, spec=SMALL,
                         compute_dtype=torch.float32, device="cpu").double()
    want = _reference_logits(params, x)
    assert got.shape == (3, 10)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    probs = fwd(prepared, x).double()
    assert torch.allclose(probs, torch.softmax(want, 1), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_bfloat16_memory_forward_is_near_the_reference(seed):
    """bf16 memory mode against the float32 reference: logits within 3e-2
    of the largest, the first class among the reference's three best, as
    Swin's bf16 forward is held. bf16 activations carry 8 bits; the port
    rounds after each conv, product, LayerNorm and the squeeze-excite gate;
    the logits, bias and softmax of attention stay float32. Seeds 0 and 7
    read 1.3e-2 and 8.0e-3 here."""
    params = synth.random_maxvit_pq_params(SMALL, seed=seed)
    prepared, _, _ = common.build_family_forward(
        "maxvit", SMALL, params, memory=True, compute_dtype=torch.bfloat16,
        device="cpu")
    x = _image(4, SMALL, seed=seed + 2)
    got = maxvit.forward(prepared, x, spec=SMALL,
                         compute_dtype=torch.bfloat16, device="cpu").double()
    want = _reference_logits(params, x)
    assert (got - want).abs().max() <= 3e-2 * want.abs().max()
    top3 = want.topk(3, dim=1).indices
    assert (top3 == got.argmax(1, keepdim=True)).any(1).all()


def test_int8_forward_runs_near_bf16():
    """The family's int8 path (decoded at load, weights per output
    channel, bf16 activations quantized per tensor at each product; the
    stem's conv1 and the depthwise convs stay bf16)."""
    params = synth.random_maxvit_pq_params(SMALL, seed=2)
    x = _image(2, SMALL)
    out = {}
    for dtype in (torch.int8, torch.bfloat16):
        prepared, fwd, act = common.build_family_forward(
            "maxvit", SMALL, params, compute_dtype=dtype, device="cpu")
        assert act == torch.bfloat16
        out[dtype] = fwd(prepared, x)
        if dtype == torch.int8:
            assert prepared["s0b0"]["mbconv"]["dw"]["kernel"].dtype == \
                torch.bfloat16
            assert "kernel_q" in prepared["s0b0"]["mbconv"]["conv1"]
    assert torch.isfinite(out[torch.int8]).all()
    rel = (out[torch.int8] - out[torch.bfloat16]).norm() / \
        out[torch.bfloat16].norm()
    assert rel < 0.2


def test_forward_segments_compose_to_forward():
    params = synth.random_maxvit_pq_params(SMALL, seed=5)
    prepared = maxvit.prepare_params(SMALL, params, dtype=torch.float32,
                                     memory=True, device="cpu")
    x = _image(2, SMALL)
    segs = maxvit.forward_segments(SMALL, compute_dtype=torch.float32)
    assert [n for n, _ in segs] == ["stem", "s0b0", "s0b1", "s1b0", "s1b1",
                                    "s2b0", "s2b1", "s3b0", "s3b1", "head"]
    y = x
    for _, fn in segs:
        y = fn(y, prepared)
    want = maxvit.forward(prepared, x, spec=SMALL,
                          compute_dtype=torch.float32, device="cpu")
    torch.testing.assert_close(y, want, rtol=0, atol=0)


# --- the published constructions ---------------------------------------------

def _timm_block(x, p):
    """timm's window_partition."""
    b, h, w, c = x.shape
    return x.view(b, h // p, p, w // p, p, c).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, p * p, c)


def _timm_grid(x, g):
    """timm's grid_partition."""
    b, h, w, c = x.shape
    return x.view(b, g, h // g, g, w // g, c).permute(
        0, 2, 4, 1, 3, 5).reshape(-1, g * g, c)


@pytest.mark.parametrize("h, p", [(32, 4), (16, 4), (8, 4), (4, 4),
                                  (96, 12), (24, 12)])
def test_partitions_are_the_published_views(h, p):
    """Both partitions are timm's view/permute forms; on a map of one
    window they coincide."""
    x = torch.randn(2, h, h, 5)
    block = swin.window_partition(x, p, "block")
    grid = swin.window_partition(x, p, "grid")
    assert torch.equal(block, _timm_block(x, p))
    assert torch.equal(grid, _timm_grid(x, p))
    assert torch.equal(block, grid) == (h == p)


def _timm_lookup(length):
    """timm's generate_lookup_tensor."""
    ret = torch.zeros(length, length, 2 * length - 1)
    for i in range(length):
        for x in range(length):
            ret[i, x, x - i + length - 1] = 1
    return ret


def _timm_bias_tf(table):
    """timm's RelPosBiasTf.get_bias: reindex_2d_einsum_kronecker."""
    p = (table.shape[1] + 1) // 2
    look = _timm_lookup(p)
    t = torch.einsum("nhw,ixh->nixw", table, look)
    t = torch.einsum("nixw,jyw->nijxy", t, look)
    return t.reshape(table.shape[0], p * p, p * p)


@pytest.mark.parametrize("p", [1, 2, 4, 7, 12])
def test_relative_position_bias_is_bias_tf(p):
    """The gathered bias is timm's bias_tf: query (qy, qx) and key (ky, kx)
    read table[h, ky - qy + p - 1, kx - qx + p - 1], Swin's index
    (``transformer.relative_position_index``) read backwards."""
    table = torch.randn(3, 2 * p - 1, 2 * p - 1)
    got = maxvit.relative_position_bias(table)
    assert got.shape == (3, p * p, p * p)
    assert torch.equal(got, _timm_bias_tf(table))
    assert torch.equal(swin.relative_position_index(p),
                       maxvit.relative_position_index(p))
    if p > 1:  # the first query's bias to the last key: the table's corner
        assert got[0, 0, -1] == table[0, -1, -1]


@pytest.mark.parametrize("k, s, size, want", [
    (3, 2, 384, (0, 1)), (3, 2, 192, (0, 1)), (3, 2, 12, (0, 1)),
    (3, 1, 96, 1), (1, 1, 96, 0), (3, 2, 7, 1), (2, 2, 8, 0),
])
def test_same_pad_is_tensorflows(k, s, size, want):
    assert conv_ops.same_pad(k, s, size) == want


@pytest.mark.parametrize("groups", [1, 8])
def test_uneven_pad_is_an_explicit_pad(groups):
    """A (0, 1) pad in ``conv_layer`` is the conv of the map padded one
    pixel after on both axes: the stride-2 stem conv and a stride-2
    depthwise conv, against float64 to float32 rounding (sums of up to 72
    products of N(0, 1) values: 2e-5 absolute); an even pair is the int
    pad, bit for bit."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 12, 12, 8, generator=gen)
    p = {"kernel": torch.randn(3, 3, 8 // groups, 16, generator=gen),
         "bias": torch.randn(16, generator=gen)}
    got = conv_ops.conv_layer(x, p, impl="dense", stride=2, pad=(0, 1),
                              groups=groups)
    want = F.conv2d(F.pad(x.permute(0, 3, 1, 2).double(), (0, 1, 0, 1)),
                    p["kernel"].permute(3, 2, 0, 1).double(),
                    p["bias"].double(), stride=2, groups=groups)
    assert got.shape == (2, 6, 6, 16)
    torch.testing.assert_close(got.double(), want.permute(0, 2, 3, 1),
                               rtol=1e-5, atol=2e-5)
    even = conv_ops.conv_layer(x, p, impl="dense", stride=2, pad=(1, 1),
                               groups=groups)
    assert torch.equal(even, conv_ops.conv_layer(x, p, impl="dense",
                                                 stride=2, pad=1,
                                                 groups=groups))


def _bn_apply(y, bn, eps):
    """Inference BatchNorm over the last (channel) axis, float64."""
    g, b, m, v = (torch.as_tensor(t, dtype=torch.float64) for t in bn)
    return (y - m) / torch.sqrt(v + eps) * g + b


def _conv64(x, p, groups=1):
    k = torch.as_tensor(p["kernel"], dtype=torch.float64)
    return F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                    torch.as_tensor(p["bias"], dtype=torch.float64),
                    padding=k.shape[0] // 2, groups=groups).permute(0, 2, 3,
                                                                    1)


def test_batchnorm_folds_are_exact():
    """BN1(conv1(BN0(x))) is the folded conv1 of x, and BN2(dw(y)) the
    folded depthwise conv of y, to float64 rounding of the float32 folded
    weights (1e-6 relative): the input-side fold is exact for a 1x1 conv
    without padding."""
    rng = np.random.default_rng(4)
    cin, mid = 16, 32
    conv1 = resnet._conv_param(rng, 1, 1, cin, mid)
    dw = resnet._conv_param(rng, 3, 3, 1, mid)
    bn0, bn1, bn2 = (maxvit._bn(rng, c) for c in (cin, mid, mid))
    x = torch.randn(2, 6, 6, cin, dtype=torch.float64)
    want = _bn_apply(_conv64(_bn_apply(x, bn0, maxvit.BN_EPS), conv1), bn1,
                     maxvit.BN_EPS)
    folded = resnet.fold_batchnorm(maxvit.fold_batchnorm_in(conv1, *bn0),
                                   *bn1, eps=maxvit.BN_EPS)
    got = _conv64(x, folded)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    y = torch.randn(2, 6, 6, mid, dtype=torch.float64)
    want = _bn_apply(_conv64(y, dw, groups=mid), bn2, maxvit.BN_EPS)
    got = _conv64(y, resnet.fold_batchnorm(dw, *bn2, eps=maxvit.BN_EPS),
                  groups=mid)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="1x1"):
        maxvit.fold_batchnorm_in(dw, *bn2)


# --- the benchmark's configuration -----------------------------------------

def test_spec_counts_maxvit_l_at_384():
    """``builders/maxvit_pq.py``'s spec is the registry's MaxViT-L at 384,
    with 212,049,752 parameters by the published shapes (212.05 M; timm
    lists 212.03 M) and 263.72 GFLOP an image (paper: about 133 G
    multiply-adds)."""
    b, ref = _bench()
    cfg = _config()
    got = b.spec(cfg)
    assert got == maxvit.maxvit_l384().__class__(
        **{**maxvit.maxvit_l384().__dict__, "name": cfg["model"]})
    assert maxvit.parameter_count(got) == 212_049_752
    assert b.flops_per_image(cfg) == 263_720_353_792
    assert cfg["reduced"] == [] and cfg["dtype"] == "bfloat16"
    assert cfg["batchnorm_epsilon"] == maxvit.BN_EPS
    assert cfg["layernorm_epsilon"] == maxvit.LN_EPS
    layout = maxvit.block_layout(got)
    assert [(blk.grid, blk.heads, blk.mid, blk.se) for blk in layout
            if blk.stride == 2] == [(96, 4, 512, 32), (48, 8, 1024, 64),
                                    (24, 16, 2048, 128), (12, 32, 4096, 256)]
    assert len(layout) == 24 and {blk.window for blk in layout} == {12}


def test_dense_init_holds_the_folded_layout():
    """``init_dense_params`` at the small spec: the served layout, every
    BatchNorm folded away (the parameter count less each BatchNorm's two
    a channel, plus the biases the folds give conv1 and the depthwise
    conv)."""
    dense = maxvit.init_dense_params(SMALL, seed=0)
    assert set(dense) == {"stem", "head",
                          *(b.key for b in maxvit.block_layout(SMALL))}
    mb = dense["s1b0"]["mbconv"]
    assert set(mb) == {"proj", "conv1", "dw", "se1", "se2", "conv3"}
    assert "proj" not in dense["s1b1"]["mbconv"]
    assert mb["dw"]["kernel"].shape == (3, 3, 1, 256)
    assert dense["s1b0"]["grid"]["rel_table"].shape == (2, 7, 7)

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return int(np.size(tree))
    folded = maxvit.parameter_count(SMALL) - 2 * SMALL.stem_width - sum(
        2 * b.cin + 2 * b.mid for b in maxvit.block_layout(SMALL))
    assert count(dense) == folded


def _meta_pq(shape, k, kind):
    meta = torch.device("meta")
    cin = shape[-1] if kind == "fc" else shape[2]
    s = -(-cin // 4)
    cout = shape[0] if kind == "fc" else shape[3]
    a = (cout, s) if kind == "fc" else (cout, shape[0], shape[1], s)
    return {"codebooks": torch.empty(s, k, 4, dtype=torch.bfloat16,
                                     device=meta),
            "assignments": torch.empty(a, dtype=torch.uint8, device=meta),
            "bias": torch.empty(cout, device=meta)}


def _group_impls(inputs, layers):
    """{layer: impl} that ``maxvit.layer_group`` decides, read from the
    group it hands to ``instep_decodes`` (meta tensors decode nothing)."""
    seen = {}
    real = conv_ops.instep_decodes

    def spy(routes):
        seen.update({n: impl for n, (_, impl, _) in routes.items()})
        return {}
    conv_ops.instep_decodes = spy
    try:
        maxvit.layer_group(inputs, layers, "t")
    finally:
        conv_ops.instep_decodes = real
    return seen


def test_routes_at_the_cell_rows():
    """At B=128: every 1x1 conv and the stem's conv2 decode in the step
    (``indecode_ohwi``), every projection and the head's two FCs too
    (``indecode``: at least 18,432 rows, or narrow), and the squeeze-excite
    FCs of stages 0-2; stage 3's (4,096 wide) take the fused decode-GEMM
    (``fgather``): 74 grouped decodes and 4 ``pq_fc_fused`` a forward."""
    from qcnn_tpu_torch.models import transformer

    spec = maxvit.maxvit_l384()
    bf, meta = torch.bfloat16, torch.device("meta")
    stem2 = _meta_pq((3, 3, 128, 128), 128, "conv")
    assert maxvit._conv_route(stem2, (CELL_BATCH, 192, 192, 128), bf) == \
        "indecode_ohwi"
    fused = 0
    for blk in maxvit.block_layout(spec):
        c, m, r = blk.dim, blk.mid, blk.se
        mb = {"conv1": _meta_pq((1, 1, blk.cin, m), 128, "conv"),
              "conv3": _meta_pq((1, 1, m, c), 128, "conv"),
              "se1": _meta_pq((r, m), 32, "fc"),
              "se2": _meta_pq((m, r), 32, "fc")}
        if blk.stride == 2:
            mb["proj"] = _meta_pq((1, 1, blk.cin, c), 128, "conv")
        side = blk.grid * blk.stride
        x = torch.empty(CELL_BATCH, side, side, blk.cin,
                        dtype=bf, device=meta)
        impls = _group_impls(maxvit._mbconv_inputs(x, mb, blk, bf), mb)
        want_se = "fgather" if blk.stage == 3 else "indecode"
        assert impls == {**{n: "indecode_ohwi" for n in mb
                            if not n.startswith("se")},
                         "se1": want_se, "se2": want_se}, blk.key
        fused += 2 * (want_se == "fgather")
        p = {"qkv": _meta_pq((3 * c, c), 32, "fc"),
             "out": _meta_pq((c, c), 32, "fc"),
             "mlp1": _meta_pq((4 * c, c), 32, "fc"),
             "mlp2": _meta_pq((c, 4 * c), 32, "fc")}
        y = torch.empty(CELL_BATCH, blk.grid ** 2, c, dtype=bf, device=meta)
        routes = transformer.block_routes(
            transformer.block_inputs(y, p, bf), p)
        assert {name: impl for name, (_, impl, _) in routes.items()} == {
            name: "indecode" for name in p}, blk.key
    assert fused == 4
    head = {"pre": _meta_pq((1024, 1024), 32, "fc"),
            "fc": _meta_pq((1000, 1024), 32, "fc")}
    assert _group_impls({"pre": ((CELL_BATCH, 1024), bf),
                         "fc": ((CELL_BATCH, 1024), bf)}, head) == {
        "pre": "indecode", "fc": "indecode"}


# --- the family wiring -------------------------------------------------------

def test_family_registries_name_maxvit():
    from qcnn_tpu_torch import cli
    from qcnn_tpu_torch.formats import checkpoint

    assert "maxvit" in common.FAMILIES
    assert common.serving_defaults("maxvit_l384") == \
        common.serving_defaults("vit_l16")
    assert "maxvit_l384" in cli._FAMILY_MODELS
    family, fam, spec = cli._family_module("maxvit_l384")
    assert (family, fam, spec) == ("maxvit", maxvit, maxvit.maxvit_l384())
    assert checkpoint._family_spec_cls("maxvit") is maxvit.MaxViTSpec


def test_family_checkpoint_round_trip_serves_the_same_answers(tmp_path):
    from qcnn_tpu_torch.eval import FamilyClassifier
    from qcnn_tpu_torch.formats.checkpoint import (
        load_family_checkpoint,
        save_family_checkpoint,
        save_preprocessor,
    )
    from qcnn_tpu_torch.preproc import TorchPreprocessor

    params = synth.random_maxvit_pq_params(SMALL, seed=6)
    save_family_checkpoint(str(tmp_path), "maxvit", SMALL, params)
    save_preprocessor(str(tmp_path), TorchPreprocessor.imagenet(crop=128,
                                                                resize=256))
    family, spec, loaded = load_family_checkpoint(str(tmp_path))
    assert family == "maxvit" and spec == SMALL
    x = _image(2, SMALL)
    clf = FamilyClassifier.from_checkpoint(str(tmp_path), memory=True,
                                           device="cpu",
                                           compute_dtype=torch.float32)
    got = clf._fwd(clf.params, x)
    prepared, fwd, _ = common.build_family_forward(
        "maxvit", SMALL, params, memory=True, compute_dtype=torch.float32,
        device="cpu")
    assert torch.equal(got, fwd(prepared, x))


def test_make_family_writes_a_maxvit_checkpoint(tmp_path, monkeypatch):
    """``make-family maxvit_l384`` folds and quantizes the dense init and
    writes a family checkpoint; here with the registry's entry pointed at
    the small spec, so that the k-means runs in seconds."""
    from qcnn_tpu_torch import cli
    from qcnn_tpu_torch.formats.checkpoint import load_family_checkpoint

    monkeypatch.setitem(maxvit.MAXVITS, "maxvit_l384",
                        maxvit.maxvit_tiny_test)
    out = str(tmp_path / "ck")
    assert cli.main(["make-family", "maxvit_l384", out, "--cpu"]) == 0
    family, spec, params = load_family_checkpoint(out)
    assert family == "maxvit" and spec == SMALL
    mb = params["s0b0"]["mbconv"]
    assert mb["conv1"]["codebooks"].shape == (8, 128, 4)
    assert mb["se1"]["codebooks"].shape == (32, 32, 4)
    assert mb["dw"]["kernel"].shape == (3, 3, 1, 128)
    assert params["stem"]["conv1"]["kernel"].shape == (3, 3, 3, 32)
    assert params["s0b1"]["block"]["rel_table"].shape == (1, 7, 7)
    assert cli.main(["make-family", "maxvit_l384", out, "--cpu",
                     "--calib-random", "2"]) == 2


# --- spans -------------------------------------------------------------------

def _block_spans(blk):
    key = blk.key
    out = {f"qcnn.conv:{key}.conv1", f"qcnn.conv:{key}.conv3",
           f"qcnn.dwconv:{key}", f"qcnn.se:{key}"}
    if blk.stride == 2:
        out |= {f"qcnn.conv:{key}.proj", f"qcnn.pool:{key}.shortcut"}
    for part in maxvit.PARTS:
        k = f"{key}.{part}"
        out |= {f"qcnn.layernorm:{k}.ln1", f"qcnn.layernorm:{k}.ln2",
                f"qcnn.fc:{k}.qkv", f"qcnn.fc:{k}.out", f"qcnn.fc:{k}.mlp1",
                f"qcnn.fc:{k}.mlp2", f"qcnn.attention:{k}"}
    return out


def _span_events(fn):
    """(start, end, name) of the ``qcnn.*`` ranges of one call under the
    profiler, sorted by start, outer first."""
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    got = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU
           and e.name().startswith(spans.PREFIX)]
    return sorted(got, key=lambda e: (e[0], -e[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_memory_forward_opens_the_spans_once_a_block(dtype):
    params = synth.random_maxvit_pq_params(SMALL, seed=3)
    prepared, fwd, _ = common.build_family_forward(
        "maxvit", SMALL, params, memory=True, compute_dtype=dtype,
        device="cpu")
    x = _image(2, SMALL)
    events = _span_events(lambda: fwd(prepared, x))
    names = [n for _, _, n in events]
    once = {"qcnn.forward", "qcnn.conv:stem.conv1", "qcnn.conv:stem.conv2",
            "qcnn.pool:head", "qcnn.layernorm:head", "qcnn.fc:head.pre",
            "qcnn.fc:head", "qcnn.softmax:head"}
    layout = maxvit.block_layout(SMALL)
    for blk in layout:
        once |= _block_spans(blk)
    for name in once:
        assert names.count(name) == 1, name
    # one grouped decode an MBConv, a partition block and the head; the
    # stem's conv2 decodes under its conv span
    assert names.count("qcnn.decode") == 3 * len(layout) + 1
    assert set(names) - once - {"qcnn.decode", "qcnn.epilogue"} == set()
    # every range lies in the forward; the decodes and epilogues in a
    # layer's span or directly in the forward
    stack = []
    for start, end, n in events:
        while stack and stack[-1][1] <= start:
            stack.pop()
        assert not stack or end <= stack[-1][1], (n, stack[-1][2])
        parent = stack[-1][2] if stack else None
        if n == "qcnn.forward":
            assert parent is None
        elif n == "qcnn.epilogue":
            assert parent.startswith(("qcnn.conv:", "qcnn.fc:",
                                      "qcnn.dwconv:", "qcnn.se:")), parent
        elif n == "qcnn.decode" and parent != "qcnn.forward":
            assert parent == "qcnn.conv:stem.conv2", parent
        else:
            assert parent == "qcnn.forward", (n, parent)
        stack.append((start, end, n))


def test_spans_leave_the_output_bits_unchanged():
    params = synth.random_maxvit_pq_params(SMALL, seed=4)
    prepared, fwd, _ = common.build_family_forward(
        "maxvit", SMALL, params, memory=True, compute_dtype=torch.bfloat16,
        device="cpu")
    x = _image(2, SMALL)
    plain = fwd(prepared, x)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = fwd(prepared, x)
    assert torch.equal(plain, traced)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _cell_forward(card):
    """The cell's timed forward at its own size and a batch of its
    inputs."""
    b, _ = _bench()
    cfg = _config()
    gen = torch.Generator(device=card).manual_seed(2**31 + 5)
    weights = b.make_weights(cfg, gen, card)
    fwd = b.offline_forward(cfg, weights, CELL_BATCH, card)
    x = torch.randn((CELL_BATCH, 384, 384, 3), generator=gen, device=card)
    return fwd, x


@pytest.mark.card
def test_cell_forward_launches_on_the_card(card):
    """74 ``pq_decode`` launches a forward (the stem's conv2, one grouped
    decode an MBConv and a partition block, the head's), 4
    ``pq_fc_fused`` (stage 3's squeeze-excite), 271 ``epilogue_fused``,
    48 ``window_attention_fused`` (24 block, 24 grid), 97
    ``layernorm_fused`` (two a partition block, the head's) and nothing
    else."""
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    fwd, x = _cell_forward(card)
    fwd(x)
    torch.cuda.synchronize(card)
    before = dict(cuda_ops.launches())
    probs = fwd(x)
    torch.cuda.synchronize(card)
    after = cuda_ops.launches()
    got = {k: after[k] - before.get(k, 0) for k in after
           if after[k] != before.get(k, 0)}
    assert got == {"pq_decode": 74, "pq_fc_fused": 4,
                   "epilogue_fused": 271, "window_attention_fused": 48,
                   "layernorm_fused": 97}, got
    assert probs.shape == (CELL_BATCH, 1000) and torch.isfinite(probs).all()


@pytest.mark.card
def test_every_kernel_of_a_traced_step_lies_in_a_span(card):
    """Each device activity of a traced step, joined to its launch, lies
    under a ``qcnn.*`` span narrower than the forward; only the read-back
    of the probabilities is outside. The attention kind holds one
    ``window_attention_fused`` a partition block (48); the dwconv kind the
    24 depthwise convs with their 'same' pads and epilogues; the se kind
    the squeeze-excite."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench_cuda import spans as bench_spans

    fwd, x = _cell_forward(card)
    fwd(x).cpu()
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd(x).float().cpu()
        torch.cuda.synchronize(card)
    got = bench_spans.reduce(list(prof.profiler.kineto_results.events()))
    print(json.dumps({k: v for k, v in got.items() if k != "names"}))
    assert got["forwards"] == 1
    assert got["unlinked"]["kernels"] == 0
    assert got["outside"]["kernels"] == 1  # the copy to the host
    assert "forward" not in got["kinds"]
    assert {"attention", "conv", "dwconv", "se", "layernorm", "fc",
            "epilogue", "decode", "pool", "softmax"} <= set(got["kinds"])
    assert got["kinds"]["attention"]["kernels"] == 48
    assert got["kinds"]["layernorm"]["kernels"] == 97
    assert got["kinds"]["dwconv"]["kernels"] >= 24
    assert got["kinds"]["se"]["kernels"] >= 24
