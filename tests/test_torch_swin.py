"""Swin-L/4-w12 at 384x384 in memory mode, the benchmark's hierarchical
transformer (``bench_cuda/configs/swinl-384-pq-mem.json``): the port's
Swin forward against the benchmark's plain float32 reference
(``bench_cuda/reference/swin.py``), the shift mask, the relative-position
index and the merge order against the published construction, the spec,
parameter and FLOP count of ``bench_cuda/builders/swin_pq.py``, the
memory-mode routing at the cell's rows, the family wiring (checkpoint,
CLI) and the ``qcnn.*`` spans of a Swin forward. The window attention's
route and kernel have their own file,
``tests/test_torch_window_attention_route.py``.

The CPU tests run a small Swin (64x64, patch 4, window 4, width 32, grids
16, 8, 4 and 2: stages 0-1 shift and mask, stage 2 is one window and
stage 3 takes its smaller grid as the window). The tests marked ``card``
run the cell's own size on the card and skip without one. The file
imports no JAX and nothing from ``tests``, so on a machine with a card and
without JAX they run without the suite's conftest:

    python -m pytest tests/test_torch_swin.py --noconftest -m card -q
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from qcnn_tpu_torch.models import common, swin, synth
from qcnn_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "bench_cuda", "configs", "swinl-384-pq-mem.json")
SMALL = swin.swin_tiny_test()
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
    from bench_cuda.reference import swin as ref

    b = harness.load_module(os.path.join(ROOT, "bench_cuda", "builders",
                                         "swin_pq.py"), "t_swin_pq")
    return b, ref


def _config() -> dict:
    with open(CONFIG) as f:
        return json.load(f)


def _small_config(spec: swin.SwinSpec) -> dict:
    """The benchmark configuration at ``spec``'s sizes."""
    return dict(_config(), model=spec.name,
                input=[spec.image_size, spec.image_size, 3],
                patch_size=spec.patch, embed_dim=spec.embed_dim,
                depths=list(spec.depths), num_heads=list(spec.heads),
                window_size=spec.window, mlp_ratio=spec.mlp_ratio,
                num_classes=spec.num_classes, layernorm_epsilon=swin.LN_EPS)


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
    to float32 rounding (1e-5 of the largest, as for ViT)."""
    params = synth.random_swin_pq_params(SMALL, seed=seed)
    prepared, fwd, _ = common.build_family_forward(
        "swin", SMALL, params, memory=memory, compute_dtype=torch.float32,
        device="cpu")
    x = _image(3, SMALL)
    got = swin.forward(prepared, x, spec=SMALL, compute_dtype=torch.float32,
                       device="cpu").double()
    want = _reference_logits(params, x)
    assert got.shape == (3, 10)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    probs = fwd(prepared, x).double()
    assert torch.allclose(probs, torch.softmax(want, 1), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_bfloat16_memory_forward_is_near_the_reference(seed):
    """bf16 memory mode against the float32 reference: logits within 3e-2
    of the largest, the first class among the reference's three best, as
    ViT's bf16 forward is held. bf16 activations carry 8 bits and the
    port rounds after each product and LayerNorm, and the probabilities
    before the value product; the logits, bias and softmax stay float32.
    Seeds 0-9 read 7.4e-3 to 1.7e-2 here (seeds 0 and 7: 1.67e-2 and
    8.1e-3), and at one of them a near tie swaps the first two classes."""
    params = synth.random_swin_pq_params(SMALL, seed=seed)
    prepared, _, _ = common.build_family_forward(
        "swin", SMALL, params, memory=True, compute_dtype=torch.bfloat16,
        device="cpu")
    x = _image(4, SMALL, seed=seed + 2)
    got = swin.forward(prepared, x, spec=SMALL,
                       compute_dtype=torch.bfloat16, device="cpu").double()
    want = _reference_logits(params, x)
    assert (got - want).abs().max() <= 3e-2 * want.abs().max()
    top3 = want.topk(3, dim=1).indices
    assert (top3 == got.argmax(1, keepdim=True)).any(1).all()


def test_int8_forward_runs_near_bf16():
    """The family's int8 path (decoded at load, weights per output
    channel, bf16 activations quantized per tensor at each product)."""
    params = synth.random_swin_pq_params(SMALL, seed=2)
    x = _image(2, SMALL)
    out = {}
    for dtype in (torch.int8, torch.bfloat16):
        prepared, fwd, act = common.build_family_forward(
            "swin", SMALL, params, compute_dtype=dtype, device="cpu")
        assert act == torch.bfloat16
        out[dtype] = fwd(prepared, x)
    assert torch.isfinite(out[torch.int8]).all()
    rel = (out[torch.int8] - out[torch.bfloat16]).norm() / \
        out[torch.bfloat16].norm()
    assert rel < 0.2


def test_forward_segments_compose_to_forward():
    params = synth.random_swin_pq_params(SMALL, seed=5)
    prepared = swin.prepare_params(SMALL, params, dtype=torch.float32,
                                   memory=True, device="cpu")
    x = _image(2, SMALL)
    segs = swin.forward_segments(SMALL, compute_dtype=torch.float32)
    names = [n for n, _ in segs]
    assert names == ["embed", "s0b0", "s0b1", "s0merge", "s1b0", "s1b1",
                     "s1merge", "s2b0", "s2b1", "s2merge", "s3b0", "s3b1",
                     "head"]
    y = x
    for _, fn in segs:
        y = fn(y, prepared)
    want = swin.forward(prepared, x, spec=SMALL,
                        compute_dtype=torch.float32, device="cpu")
    torch.testing.assert_close(y, want, rtol=0, atol=0)


# --- the published constructions ---------------------------------------------

def _published_mask(res, ws, shift):
    """SwinTransformerBlock.__init__'s attn_mask, as published."""
    img_mask = torch.zeros((1, res, res, 1))
    h_slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    w_slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for h in h_slices:
        for w in w_slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    x = img_mask.view(1, res // ws, ws, res // ws, ws, 1)
    mask_windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(
        attn_mask == 0, float(0.0))


def _published_index(ws):
    """WindowAttention.__init__'s relative_position_index, as published."""
    coords_h = torch.arange(ws)
    coords_w = torch.arange(ws)
    coords = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += ws - 1
    relative_coords[:, :, 1] += ws - 1
    relative_coords[:, :, 0] *= 2 * ws - 1
    return relative_coords.sum(-1)


@pytest.mark.parametrize("res,ws,shift", [(96, 12, 6), (48, 12, 6),
                                          (24, 12, 6), (16, 4, 2),
                                          (8, 4, 2), (15, 5, 2)])
def test_shift_mask_is_the_published_construction(res, ws, shift):
    got = swin.shift_mask(res, ws, shift)
    want = _published_mask(res, ws, shift)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    # the last window mixes all four corners' regions; the first none
    assert (got[0] == 0).all() and (got[-1] == -100).any()


@pytest.mark.parametrize("ws", [1, 2, 4, 7, 12])
def test_relative_position_index_is_the_published_formula(ws):
    got = swin.relative_position_index(ws)
    assert torch.equal(got, _published_index(ws))
    assert int(got.max()) == (2 * ws - 1) ** 2 - 1


def test_merge_order_is_the_published_one():
    """x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2] along
    the channels: a (row, column) offset of (1, 0) before (0, 1)."""
    x = torch.arange(2 * 4 * 4 * 3, dtype=torch.float32).view(2, 4, 4, 3)
    got = swin.merge_gather(x).view(2, 2, 2, 4, 3)
    for r in range(2):
        for c in range(2):
            for k, (dr, dc) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
                assert torch.equal(got[:, r, c, k], x[:, 2 * r + dr,
                                                      2 * c + dc])


def test_windows_partition_and_reverse_round_trip():
    b, g, ws, heads, hd = 2, 8, 4, 2, 3
    x = torch.randn(b, g, g, heads * hd)
    w = swin.window_partition(x, ws)
    assert w.shape == (b * 4, ws * ws, heads * hd)
    # the first window of the second image is its top-left 4x4
    assert torch.equal(w[4].view(ws, ws, -1), x[1, :ws, :ws])
    o = w.view(b * 4, ws * ws, heads, hd).transpose(1, 2)
    assert torch.equal(swin.window_reverse(o, ws, g), x)


def test_window_rule_at_384_and_at_the_small_size():
    """Swin-L at 384: grids 96, 48, 24 and 12, every window 12, the odd
    blocks of stages 0-2 shifted by 6 and none of stage 3; the small spec
    takes stage 3's grid of 2 as its window."""
    got = {(b.stage, b.grid, b.window, b.shift)
           for b in swin.block_layout(swin.swin_l384())}
    assert got == {(0, 96, 12, 0), (0, 96, 12, 6), (1, 48, 12, 0),
                   (1, 48, 12, 6), (2, 24, 12, 0), (2, 24, 12, 6),
                   (3, 12, 12, 0)}
    layout = swin.block_layout(SMALL)
    assert [(b.key, b.grid, b.window, b.shift) for b in layout] == [
        ("s0b0", 16, 4, 0), ("s0b1", 16, 4, 2), ("s1b0", 8, 4, 0),
        ("s1b1", 8, 4, 2), ("s2b0", 4, 4, 0), ("s2b1", 4, 4, 0),
        ("s3b0", 2, 2, 0), ("s3b1", 2, 2, 0)]
    prepared = swin.prepare_params(
        SMALL, synth.random_swin_pq_params(SMALL, seed=0),
        dtype=torch.float32, memory=True, device="cpu")
    assert prepared["s0b1"]["shift_mask"].shape == (16, 16, 16)
    assert prepared["s0b1"]["rel_bias"].shape == (2, 16, 16)
    assert "shift_mask" not in prepared["s2b1"]
    assert prepared["s3b1"]["rel_bias"].shape == (16, 4, 4)
    assert "rel_table" not in prepared["s3b1"]


# --- the benchmark's configuration -----------------------------------------

def test_builder_spec_is_swin_l_at_384():
    """``builders/swin_pq.py``'s spec is the registry's Swin-L/4-w12 at
    384, with 196.7 M parameters (published: 197 M) and 207.84 GFLOP an
    image (published: 103.9 G multiply-adds)."""
    b, ref = _bench()
    cfg = _config()
    got, want = b.spec(cfg), swin.swin_l384()
    assert got == dataclasses.replace(want, name=cfg["model"])
    assert (4, 384, 192, (2, 2, 18, 2), (6, 12, 24, 48), 12, 1000) == (
        got.patch, got.image_size, got.embed_dim, got.depths, got.heads,
        got.window, got.num_classes)
    assert cfg["layernorm_epsilon"] == swin.LN_EPS == 1e-5
    assert cfg["reduced"] == [] and cfg["dtype"] == "bfloat16"
    z = ref.sizes(cfg)
    n = sum(cin * cout + (0 if path[-1] == "reduction" else cout)
            for path, cin, cout, _ in ref.gemms(cfg))
    n += 2 * z["dims"][0] + 2 * z["dims"][-1]  # patch and final norms
    for i, depth in enumerate(z["depths"]):
        n += depth * (4 * z["dims"][i]
                      + (2 * z["windows"][i] - 1) ** 2 * z["heads"][i])
        if i + 1 < len(z["depths"]):
            n += 8 * z["dims"][i]
    assert n == 196_735_516
    assert b.flops_per_image(cfg) == 207_838_175_232


def test_dense_init_has_the_published_parameter_count():
    """``init_dense_params`` at a small spec holds the tensors the
    reference's layout names, and at Swin-L counts 196,735,516 by their
    shapes (the same count as ``builders/swin_pq.py``'s)."""
    dense = swin.init_dense_params(SMALL, seed=0)
    assert set(dense) == {"patch_embed", "patch_norm", "ln_final", "head",
                          "s0merge", "s1merge", "s2merge",
                          *(b.key for b in swin.block_layout(SMALL))}
    assert dense["s1merge"]["reduction"]["weight"].shape == (256, 128)
    assert not dense["s1merge"]["reduction"]["bias"].any()
    spec = swin.swin_l384()
    count = spec.patch ** 2 * 3 * 192 + 192 + 2 * 192
    for blk in swin.block_layout(spec):
        d = blk.dim
        count += 12 * d * d + 9 * d + 4 * d + 23 ** 2 * blk.heads
    count += sum(8 * d * d + 8 * d for d in (192, 384, 768))
    count += 1536 * 1000 + 1000 + 2 * 1536
    assert count == 196_735_516


def _meta_pq(cin, cout):
    s = -(-cin // 4)
    meta = torch.device("meta")
    return {"codebooks": torch.empty(s, 32, 4, dtype=torch.bfloat16,
                                     device=meta),
            "assignments": torch.empty(cout, s, dtype=torch.uint8,
                                       device=meta),
            "bias": torch.empty(cout, device=meta)}


def test_every_projection_decodes_in_the_step_at_the_cell_rows():
    """At B=128 every projection of every block sees 128 x grid^2 rows
    (18,432 at the smallest, stage 3): each resolves to 'indecode', so a
    forward runs one grouped decode a block and the embedding's, the three
    reductions' and the head's own (29) and no fused kernel."""
    from qcnn_tpu_torch.models import transformer

    spec = swin.swin_l384()
    meta = torch.device("meta")
    for blk in swin.block_layout(spec):
        d = blk.dim
        p = {"qkv": _meta_pq(d, 3 * d), "out": _meta_pq(d, d),
             "mlp1": _meta_pq(d, 4 * d), "mlp2": _meta_pq(4 * d, d)}
        x = torch.empty(CELL_BATCH, blk.grid ** 2, d, dtype=torch.bfloat16,
                        device=meta)
        inputs = transformer.block_inputs(x, p, torch.bfloat16)
        assert {rows for rows, _, _ in inputs.values()} == {
            CELL_BATCH * blk.grid ** 2}
        routes = transformer.block_routes(inputs, p)
        assert {name: impl for name, (_, impl, _) in routes.items()} == {
            name: "indecode" for name in p}, blk.key
    for i, d in enumerate((192, 384, 768)):
        rows = CELL_BATCH * (96 // 2 ** (i + 1)) ** 2
        assert common.fc_memory_impl(rows, _meta_pq(4 * d, 2 * d),
                                     torch.bfloat16) == "indecode"
    assert common.fc_memory_impl(CELL_BATCH * 96 ** 2, _meta_pq(48, 192),
                                 torch.bfloat16) == "indecode"
    assert common.fc_memory_impl(CELL_BATCH, _meta_pq(1536, 1000),
                                 torch.bfloat16) == "indecode"


# --- the family wiring -------------------------------------------------------

def test_family_registries_name_swin():
    from qcnn_tpu_torch import cli
    from qcnn_tpu_torch.formats import checkpoint

    assert "swin" in common.FAMILIES
    assert common.serving_defaults("swin_l384") == \
        common.serving_defaults("vit_l16")
    assert "swin_l384" in cli._FAMILY_MODELS
    family, fam, spec = cli._family_module("swin_l384")
    assert (family, fam, spec) == ("swin", swin, swin.swin_l384())
    assert checkpoint._family_spec_cls("swin") is swin.SwinSpec


def test_family_checkpoint_round_trip_serves_the_same_answers(tmp_path):
    from qcnn_tpu_torch.eval import FamilyClassifier
    from qcnn_tpu_torch.formats.checkpoint import (
        load_family_checkpoint,
        save_family_checkpoint,
        save_preprocessor,
    )
    from qcnn_tpu_torch.preproc import TorchPreprocessor

    params = synth.random_swin_pq_params(SMALL, seed=6)
    save_family_checkpoint(str(tmp_path), "swin", SMALL, params)
    save_preprocessor(str(tmp_path), TorchPreprocessor.imagenet(crop=64,
                                                                resize=256))
    family, spec, loaded = load_family_checkpoint(str(tmp_path))
    assert family == "swin" and spec == SMALL
    x = _image(2, SMALL)
    clf = FamilyClassifier.from_checkpoint(str(tmp_path), memory=True,
                                           device="cpu",
                                           compute_dtype=torch.float32)
    got = clf._fwd(clf.params, x)
    prepared, fwd, _ = common.build_family_forward(
        "swin", SMALL, params, memory=True, compute_dtype=torch.float32,
        device="cpu")
    assert torch.equal(got, fwd(prepared, x))


def test_make_family_writes_a_swin_checkpoint(tmp_path, monkeypatch):
    """``make-family swin_l384`` quantizes the dense init and writes a
    family checkpoint; here with the registry's entry pointed at the small
    spec, so that the k-means runs in seconds."""
    from qcnn_tpu_torch import cli
    from qcnn_tpu_torch.formats.checkpoint import load_family_checkpoint

    monkeypatch.setitem(swin.SWINS, "swin_l384", swin.swin_tiny_test)
    out = str(tmp_path / "ck")
    assert cli.main(["make-family", "swin_l384", out, "--cpu"]) == 0
    family, spec, params = load_family_checkpoint(out)
    assert family == "swin" and spec == SMALL
    assert params["s0b1"]["qkv"]["codebooks"].shape == (8, 32, 4)
    assert params["s0b1"]["rel_table"].shape == (49, 2)
    assert cli.main(["make-family", "swin_l384", out, "--cpu",
                     "--calib-random", "2"]) == 2


# --- spans -------------------------------------------------------------------

def _block_spans(key):
    """The GELU and the two residual adds run in the epilogues of mlp1,
    out and mlp2, under their ``fc`` spans."""
    return {f"qcnn.layernorm:{key}.ln1", f"qcnn.layernorm:{key}.ln2",
            f"qcnn.window:{key}.partition", f"qcnn.window:{key}.reverse",
            f"qcnn.fc:{key}.qkv", f"qcnn.fc:{key}.out",
            f"qcnn.fc:{key}.mlp1", f"qcnn.fc:{key}.mlp2",
            f"qcnn.attention:{key}"}


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
    params = synth.random_swin_pq_params(SMALL, seed=3)
    prepared, fwd, _ = common.build_family_forward(
        "swin", SMALL, params, memory=True, compute_dtype=dtype,
        device="cpu")
    x = _image(2, SMALL)
    events = _span_events(lambda: fwd(prepared, x))
    names = [n for _, _, n in events]
    once = {"qcnn.forward", "qcnn.embed", "qcnn.layernorm:final",
            "qcnn.pool:head", "qcnn.fc:head", "qcnn.softmax:head"}
    for blk in swin.block_layout(SMALL):
        once |= _block_spans(blk.key)
    for i in range(len(SMALL.depths) - 1):
        once |= {f"qcnn.merge:s{i}", f"qcnn.fc:s{i}.reduction"}
    for name in once:
        assert names.count(name) == 1, name
    # one grouped decode a block
    assert names.count("qcnn.decode") == len(swin.block_layout(SMALL))
    assert set(names) - once - {"qcnn.decode", "qcnn.epilogue"} == set()
    # every range lies in the forward, and the leaves directly under it
    stack = []
    for start, end, n in events:
        while stack and stack[-1][1] <= start:
            stack.pop()
        assert not stack or end <= stack[-1][1], (n, stack[-1][2])
        parent = stack[-1][2] if stack else None
        if n == "qcnn.forward":
            assert parent is None
        elif n == "qcnn.epilogue":
            assert parent.startswith(("qcnn.fc:", "qcnn.embed")), parent
        else:
            assert parent == "qcnn.forward", (n, parent)
        stack.append((start, end, n))


def test_spans_leave_the_output_bits_unchanged():
    params = synth.random_swin_pq_params(SMALL, seed=4)
    prepared, fwd, _ = common.build_family_forward(
        "swin", SMALL, params, memory=True, compute_dtype=torch.bfloat16,
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
    """29 ``pq_decode`` launches a forward (one grouped decode a block, the
    patch embedding's, the three reductions', the head's), one
    ``epilogue_fused`` for each of the 96 projections of the blocks, the
    patch embedding and the three reductions, one
    ``window_attention_fused`` a block (24), one ``layernorm_fused`` a
    LayerNorm (53: two a block, the final one, the three merges' and the
    patch embedding's), and no ViT attention or fused decode-GEMM
    kernel."""
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
    assert got == {"pq_decode": 29, "epilogue_fused": 100,
                   "window_attention_fused": 24, "layernorm_fused": 53}, got
    assert probs.shape == (CELL_BATCH, 1000) and torch.isfinite(probs).all()


@pytest.mark.card
def test_every_kernel_of_a_traced_step_lies_in_a_span(card):
    """Each device activity of a traced step, joined to its launch, lies
    under a ``qcnn.*`` span narrower than the forward; only the read-back
    of the probabilities is outside. The window kind holds the rolls of
    the 11 shifted blocks (two kernels a roll of two axes, one roll each
    way: 44), the partition and reverse being the attention kernel's
    addressing; the attention kind one ``window_attention_fused`` a block
    and, in each shifted block, the sum of its bias and mask; the merge
    kind the three gathers and their LayerNorms."""
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
    assert {"attention", "window", "merge", "layernorm", "fc", "epilogue",
            "decode", "embed", "pool", "softmax"} <= set(got["kinds"])
    assert got["kinds"]["decode"]["kernels"] == 24
    assert got["kinds"]["merge"]["kernels"] >= 3
    assert got["kinds"]["window"]["kernels"] == 2 * 2 * 11
    assert got["kinds"]["attention"]["kernels"] == 24 + 11
    # one layernorm_fused launch a block's LayerNorm and the final one
    assert got["kinds"]["layernorm"]["kernels"] == 49
