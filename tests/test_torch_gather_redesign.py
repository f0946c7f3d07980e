"""The redesigned gathers of the port, on the CPU: the launch plans of
``pq_fc`` and ``pq_decode`` (pure functions of the shape), the split-S sum
order of ``pq_fc`` emulated in PyTorch, the grouped decode, and the forwards
that decode a group of convs in one launch.

Tolerances: the split-S emulation within 1e-5 of the largest |output| of
``lut_gather_plain`` and of the JAX ``pq_fc_pallas`` in interpret mode (the
same f32 LUT summed in another order); every decode bit-equal; the grouped
forwards bit-equal to the per-conv forwards, and against the JAX forwards
within the tolerances of tests/test_torch_network.py (f32 probabilities
1e-5), tests/test_torch_alexnet.py (bf16 probabilities 1e-2) and
tests/test_torch_resnet.py (logits 1e-5 / 1e-2 of their largest magnitude,
probabilities 1e-6 / 2e-3 for f32 / bf16). The kernels themselves run only
on the card: chip_smoke.py holds them against these plain versions there.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qcnn_tpu.core as jcore
import qcnn_tpu_torch.core as tcore
from qcnn_tpu.models import network as jnet
from qcnn_tpu.models import resnet as jresnet
from qcnn_tpu.models import synth as jsynth
from qcnn_tpu.models.prepare import prepare_params as jprepare
from qcnn_tpu.ops import lut as jlut
from qcnn_tpu_torch.models import network as tnet
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models import synth as tsynth
from qcnn_tpu_torch.models.prepare import prepare_params as tprepare
from qcnn_tpu_torch.ops import conv as conv_ops
from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.cuda import _plan, pq_decode, pq_fc
from qcnn_tpu_torch.ops.misc import relu
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

jpq_fc = importlib.import_module("qcnn_tpu.ops.pallas.pq_fc")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- (a) the pq_fc plan ---------------------------------------------------

ALEXNET_FC = {"fc6": (2304, 32, 4096), "fc7": (1024, 32, 4096),
              "fc8": (4096, 16, 1000)}
GATHER_SHAPES = [(b, *ALEXNET_FC[name]) for name in ALEXNET_FC
                 for b in (256, 64, 3, 1)] + [
    (5, 33, 256, 70),        # K = 256, S not a multiple of 16
    (3, 15, 32, 250),        # S under one chunk
    (9, 7, 3, 5),            # K not a multiple of 4
    (70, 40, 20, 300),       # ragged everything
    (12, 1024, 32, 4096),    # more than 8 rows, fewer than 16
    (600000, 16, 32, 100),   # more 8-row tiles than a launch's grid has
    (1, 0, 32, 10),          # an empty sum
]


@pytest.mark.parametrize("b,s,k,cout", GATHER_SHAPES)
def test_gather_plan_invariants(b, s, k, cout):
    pl = _plan.plan_gather(b, s, k, cout)
    assert pl.rows in _plan.GATHER_ROWS
    assert pl.rows >= min(b, _plan.GATHER_ROWS[-1])
    assert pl.rows == 1 or pl.rows // 2 < min(b, _plan.GATHER_ROWS[-1])
    assert pl.outputs in (_plan.GATHER_THREADS, 2 * _plan.GATHER_THREADS)
    assert 1 <= pl.chunk <= _plan.GATHER_MAX_CHUNK
    assert pl.chunk * k <= _plan.GATHER_LUT_ROW
    n_chunks = _plan.ceil_div(s, pl.chunk)
    # the splits cover S, and none is empty
    assert pl.splits * pl.chunks_per_split >= n_chunks
    assert pl.splits == 1 or (pl.splits - 1) * pl.chunks_per_split < n_chunks
    out_tiles = _plan.ceil_div(cout, pl.outputs)
    b_tiles = _plan.ceil_div(b, pl.rows)
    assert pl.grid == (out_tiles, b_tiles, pl.splits)
    assert pl.grid[1] <= _plan.MAX_GRID_YZ and pl.splits <= _plan.MAX_GRID_YZ
    # a split plan stays inside one wave of blocks
    assert pl.splits == 1 or out_tiles * b_tiles * pl.splits <= _plan.SM_COUNT
    stage = (pl.rows * _plan.GATHER_LUT_ROW * 4
             + pl.outputs * _plan.gather_id_pitch(pl.chunk))
    assert 2 <= pl.stages <= _plan.GATHER_MAX_STAGES
    assert pl.smem_bytes == pl.stages * stage <= _plan.SMEM_LIMIT
    assert pl.workspace_bytes == (pl.splits * b * cout * 4
                                  if pl.splits > 1 else 0)


@pytest.mark.parametrize("name,b,rows,splits,grid", [
    ("fc6", 256, 16, 2, (4, 16, 2)),
    ("fc7", 256, 16, 2, (4, 16, 2)),
    ("fc8", 256, 16, 8, (1, 16, 8)),
    ("fc6", 64, 16, 8, (4, 4, 8)),
    ("fc8", 64, 16, 32, (1, 4, 32)),
    ("fc6", 3, 4, 24, (4, 1, 24)),
    ("fc7", 3, 4, 32, (4, 1, 32)),
    ("fc8", 3, 4, 128, (1, 1, 128)),
    ("fc6", 1, 1, 24, (4, 1, 24)),
    ("fc8", 1, 1, 128, (1, 1, 128)),
])
def test_gather_plan_of_the_alexnet_layers(name, b, rows, splits, grid):
    """A small batch does only its own rows, and every AlexNet layer is
    split to about one wave of blocks: no launch of 4 to 16 blocks."""
    pl = pq_fc.plan(b, *ALEXNET_FC[name])
    assert (pl.rows, pl.outputs, pl.chunk) == (rows, 1024, 32)
    assert (pl.splits, pl.grid) == (splits, grid)
    assert 96 <= grid[0] * grid[1] * grid[2] <= _plan.SM_COUNT


@pytest.mark.parametrize("chunk,pitch", [(32, 48), (16, 48), (4, 48),
                                         (15, 48), (1, 48), (48, 80)])
def test_gather_id_pitch_is_an_odd_number_of_units(chunk, pitch):
    got = _plan.gather_id_pitch(chunk)
    assert got == pitch and got >= chunk + 16 - chunk % 16 \
        and (got // 16) % 2 == 1


# ---- (b) the split-S sum order -------------------------------------------

def _fc(rng, b, cin, cout, s, k, d):
    x = rng.standard_normal((b, cin)).astype(np.float32)
    p = {
        "codebooks": rng.standard_normal((s, k, d)).astype(np.float32),
        "assignments": rng.integers(0, k, size=(cout, s), dtype=np.uint8),
        "bias": rng.standard_normal(cout).astype(np.float32),
    }
    return x, p


@pytest.mark.parametrize("b,cin,cout,s,k,d,splits", [
    (3, 384, 300, 96, 32, 4, 3),     # one tile, three chunks, three splits
    (20, 80, 600, 40, 20, 2, 2),     # K = 20: the chunk rounds to 32
    (2, 130, 70, 33, 256, 4, 9),     # K = 256: chunks of 4 sub-spaces
    (9, 58, 250, 15, 32, 4, 1),      # S under a chunk: one split
    (2, 4096, 1000, 4096, 16, 1, 128),  # AlexNet fc8, full width
])
def test_split_sum_order_matches_plain_and_pallas(rng, b, cin, cout, s, k, d,
                                                  splits):
    x, p = _fc(rng, b, cin, cout, s, k, d)
    lut = lut_ops.build_lut(T(x), T(p["codebooks"]))
    pl = pq_fc.plan(b, s, k, cout)
    assert pl.splits == splits
    got = pq_fc.split_sum_plain(lut, T(p["assignments"]), T(p["bias"]), pl)
    plain = pq_fc.lut_gather_plain(lut, T(p["assignments"]), T(p["bias"]))
    pallas = np.asarray(jpq_fc.pq_fc_pallas(jnp.asarray(x), p,
                                            interpret=True))
    scale = float(plain.abs().max())
    assert got.dtype == torch.float32 and got.shape == (b, cout)
    assert float((got - plain).abs().max()) <= 1e-5 * scale
    assert float(np.abs(got.numpy() - pallas).max()) <= 1e-5 * scale


def test_split_sum_is_the_same_bits_twice(rng):
    x, p = _fc(rng, 3, 384, 300, 96, 32, 4)
    lut = lut_ops.build_lut(T(x), T(p["codebooks"]))
    pl = pq_fc.plan(3, 96, 32, 300)
    args = (lut, T(p["assignments"]), T(p["bias"]), pl)
    assert torch.equal(pq_fc.split_sum_plain(*args),
                       pq_fc.split_sum_plain(*args))


# ---- (c) the pq_decode plan ------------------------------------------------

@pytest.mark.parametrize("label,n,s,k,d,row_len,esize,variant,ids,blocks", [
    # AlexNet conv1-5 in bf16: conv1's 3-channel rows are no whole vector
    ("conv1", 11616, 1, 128, 8, 3, 2, "general", 0, 137),
    ("conv2", 6400, 6, 128, 8, 48, 2, "vector", 1, 38),
    ("conv3", 3456, 32, 128, 8, 256, 2, "vector", 1, 108),
    ("conv4", 3456, 24, 128, 8, 192, 2, "vector", 1, 81),
    ("conv5", 2304, 24, 128, 8, 192, 2, "vector", 1, 54),
    # and in f32: a 32-byte codeword is two vectors
    ("conv3 f32", 3456, 32, 128, 8, 256, 4, "vector", 1, 216),
    # AlexNet fc6 (D=4) and fc8 (D=1), f32 and bf16
    ("fc6 f32", 4096, 2304, 32, 4, 9216, 4, "vector", 1, 9216),
    ("fc6 bf16", 4096, 2304, 32, 4, 9216, 2, "vector", 2, 4608),
    ("fc8 f32", 1000, 4096, 16, 1, 4096, 4, "vector", 4, 1000),
    ("fc8 bf16", 1000, 4096, 16, 1, 4096, 2, "vector", 8, 500),
    # ResNet-50: D=4 everywhere, a 1x1, a 3x3 and the head
    ("s0b0.conv1", 64, 16, 128, 4, 64, 2, "vector", 2, 1),
    ("s3b0.conv2", 4608, 128, 128, 4, 512, 2, "vector", 2, 288),
    ("resnet fc", 1000, 512, 32, 4, 2048, 2, "vector", 2, 250),
    # ViT-B/16: a block's qkv and mlp2, the patch embedding, the head
    ("vit qkv", 2304, 192, 32, 4, 768, 2, "vector", 2, 216),
    ("vit mlp2", 768, 768, 32, 4, 3072, 2, "vector", 2, 288),
    ("vit patch", 768, 192, 32, 4, 768, 2, "vector", 2, 72),
    ("vit head", 1000, 192, 32, 4, 768, 2, "vector", 2, 94),
    # a row length that cuts a codeword, a codeword of 6 bytes, D=2 bf16
    ("cut row", 250, 15, 32, 4, 58, 2, "general", 0, 57),
    ("odd D", 40, 9, 16, 3, 27, 2, "general", 0, 5),
    ("whole rows, cut span", 64, 16, 32, 4, 56, 2, "vector", 2, 1),
    ("D=2 bf16", 64, 32, 16, 2, 64, 2, "vector", 4, 1),
    ("empty", 0, 4, 16, 4, 16, 2, "vector", 2, 0),
])
def test_decode_plan(label, n, s, k, d, row_len, esize, variant, ids, blocks):
    pl = _plan.plan_decode(n, s, k, d, row_len, esize)
    assert (pl.variant, pl.ids_per_vector, pl.blocks) == (variant, ids,
                                                          blocks), label
    general = _plan.plan_decode(n, s, k, d, row_len, esize, vector=False)
    assert general.variant == "general"
    assert general.units == n * row_len
    assert general.blocks == _plan.ceil_div(n * row_len,
                                            _plan.DECODE_ELEMENTS)
    if variant == "vector":
        assert pl.units * 16 == n * row_len * esize


def test_decode_plan_keeps_32_bit_offsets():
    """Sizes the vector kernel cannot index with 32 bits go to the general
    kernel."""
    assert _plan.plan_decode(2 ** 20, 2 ** 11, 16, 4, 2 ** 13, 2).variant \
        == "general"
    assert _plan.plan_decode(2 ** 20, 2 ** 10, 16, 4, 2 ** 12, 2).variant \
        == "vector"


# ---- (d) the grouped decode ----------------------------------------------

def _decode_items(rng, dtype):
    """Conv- and fc-shaped items: AlexNet conv1's geometry, a D=4 conv, a
    cut span, an fc with D=1."""
    shapes = [(96 * 11 * 11, 1, 128, 8, 3), (64 * 9, 16, 128, 4, 64),
              (250, 15, 32, 4, 58), (100, 64, 16, 1, 64)]
    return [(T(rng.standard_normal((s, k, d)).astype(np.float32)).to(dtype),
             T(rng.integers(0, k, size=(n, s), dtype=np.uint8)), row_len)
            for n, s, k, d, row_len in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_rows_many_is_bit_equal_per_item(rng, dtype):
    items = _decode_items(rng, dtype)
    many = pq_decode.decode_rows_many(items)
    assert len(many) == len(items)
    for got, (cb, ids, row_len) in zip(many, items):
        assert got.dtype == dtype and got.shape == (ids.shape[0], row_len)
        assert torch.equal(got, lut_ops.decode_rows(cb, ids, row_len))
        assert torch.equal(got, pq_decode.decode_rows(cb, ids, row_len))
        want = np.asarray(jlut.decode_fc_weight(
            jnp.asarray(cb.float().numpy()), jnp.asarray(ids.numpy()),
            row_len))  # (row_len, N), f32 of the same values
        np.testing.assert_array_equal(got.float().numpy(), want.T)
    assert pq_decode.decode_rows_many([]) == []


def test_decode_conv_kernels_many_matches_jax(rng):
    convs = [(96, 11, 1, 128, 8, 3), (64, 3, 16, 128, 4, 64),
             (40, 1, 9, 16, 4, 36)]
    items = [(T(rng.standard_normal((s, k, d)).astype(np.float32)),
              T(rng.integers(0, k, size=(cout, kh, kh, s), dtype=np.uint8)),
              cg) for cout, kh, s, k, d, cg in convs]
    for ohwi, (cb, a, cg) in zip(pq_decode.decode_conv_kernels_many(items),
                                 items):
        assert ohwi.shape == (*a.shape[:3], cg)
        want = np.asarray(jlut.decode_conv_kernel(
            jnp.asarray(cb.numpy()), jnp.asarray(a.numpy()), cg))  # HWIO
        np.testing.assert_array_equal(
            pq_decode.conv_kernel_view(ohwi, "hwio").numpy(), want)
        assert torch.equal(
            pq_decode.conv_kernel_view(ohwi, "iohw"),
            pq_decode.decode_conv_kernel_gather(cb, a, cg, layout="iohw"))


def test_grouped_decode_guards(rng):
    (cb, ids, row_len), *_ = _decode_items(rng, torch.float32)
    # ids are uint8: any K up to 256 decodes, past it the items are refused
    with pytest.raises(ValueError, match="K <= 256"):
        pq_decode.decode_rows_many([(torch.zeros(1, 257, 8), ids, 3)])
    (wide,) = pq_decode.decode_rows_many([(torch.ones(1, 200, 8), ids, 3)])
    assert wide.shape == (ids.shape[0], 3) and bool((wide == 1).all())
    with pytest.raises(ValueError, match="subspace mismatch"):
        pq_decode.decode_rows_many([(torch.zeros(2, 16, 8), ids, 3)])
    with pytest.raises(ValueError, match="row length"):
        pq_decode.decode_rows_many([(cb, ids, 9)])
    # an item off the CPU takes the kernel path and raises without a card
    with pytest.raises(ValueError, match="CUDA device"):
        pq_decode.decode_rows_many([(cb.to("meta"), ids.to("meta"), row_len)])
    with pytest.raises(ValueError, match="unknown decode layout"):
        pq_decode.conv_kernel_view(torch.zeros(2, 1, 1, 4), "oihw")


# ---- (e) the grouped forwards ----------------------------------------------

def _tiny(core):
    """Two PQ convs (the first grouped), an LRN, a pool and two PQ FCs."""
    return core.ModelSpec(
        name="tiny2", in_height=15, in_width=15, in_channels=8,
        layers=(
            core.ConvSpec(kernel=3, out_channels=32, pad=1, groups=2,
                          stride=2),
            core.ReLUSpec(),
            core.LRNSpec(5, 1e-4, 0.75, 1.0),
            core.ConvSpec(kernel=3, out_channels=16, pad=1),
            core.ReLUSpec(),
            core.PoolSpec(kernel=3, stride=2),
            core.FCSpec(64),
            core.ReLUSpec(),
            core.FCSpec(16),
            core.SoftmaxSpec(),
        ),
    )


JSPEC, TSPEC = _tiny(jcore), _tiny(tcore)


class _CountDecodes:
    """Counts the calls of ``pq_decode.decode_rows_many`` (one launch each
    on the card) and the items of each."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = pq_decode.decode_rows_many

        def counted(items):
            items = list(items)
            self.calls.append(len(items))
            return real(items)

        monkeypatch.setattr(pq_decode, "decode_rows_many", counted)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_network_memory_forward_decodes_its_convs_in_one_launch(
        monkeypatch, dtype, tol):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    params = jsynth.random_pq_params(JSPEC, seed=3)
    x = jsynth.random_input(JSPEC, batch=4, seed=4)
    pt, ct, ft = tprepare(TSPEC, params, batch_hint=4, conv_impl="memory",
                          fc_impl="lutgather", dtype=tdt, device="cpu")
    kw = dict(spec=TSPEC, conv_impls=ct, fc_impls=ft, compute_dtype=tdt,
              device="cpu")
    counter = _CountDecodes(monkeypatch)
    got = tnet.forward(pt, x, **kw)
    assert counter.calls == [2]  # both convs, one launch
    # the forward as it was: every conv decodes for itself
    monkeypatch.setattr(tnet, "instep_decodes", lambda convs: {})
    counter.calls.clear()
    per_conv = tnet.forward(pt, x, **kw)
    assert counter.calls == [1, 1]
    assert torch.equal(got, per_conv)
    # upto stops before the second conv: only the first is decoded
    monkeypatch.undo()
    counter = _CountDecodes(monkeypatch)
    tnet.forward(pt, x, upto=3, **kw)
    assert counter.calls == [1]
    pj, cj, fj = jprepare(JSPEC, params, batch_hint=4, conv_impl="memory",
                          fc_impl="lutgather", dtype=jdt)
    assert (ct, ft) == (cj, fj)
    want = np.asarray(jnet.forward(pj, x, spec=JSPEC, conv_impls=cj,
                                   fc_impls=fj, compute_dtype=jdt),
                      np.float32)
    assert float(np.abs(got.float().numpy() - want).max()) <= tol


SMALL = {
    "basic": dict(name="basic", stage_depths=(1, 2),
                  stage_channels=(64, 256), num_classes=10, in_size=32,
                  bottleneck=False),
    "bottleneck": dict(name="bottleneck", stage_depths=(1, 2),
                       stage_channels=(64, 1024), num_classes=10,
                       in_size=32, bottleneck=True),
}
RESNET_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (1e-2, 2e-3)}


def _block_per_conv(x, block, stride, bottleneck, cast, key):
    """A residual block in which every conv resolves 'memory_fused' and
    decodes for itself: the forward before the grouped decode (``key``, the
    block's name in its spans, is unused)."""
    od = getattr(cast, "dtype", None)

    def conv(v, p, **kw):
        if "codebooks" in p:
            return conv_ops.pq_conv(v, p, impl="memory_fused",
                                    out_dtype=od, **kw)
        return conv_ops.conv_dense(v, p["kernel"], p["bias"], out_dtype=od,
                                   **kw)

    shortcut = x
    if "proj" in block:
        shortcut = cast(conv(x, block["proj"], stride=stride, pad=0))
    if bottleneck:
        y = cast(relu(conv(x, block["conv1"], stride=1, pad=0)))
        y = cast(relu(conv(y, block["conv2"], stride=stride, pad=1)))
        y = cast(conv(y, block["conv3"], stride=1, pad=0))
    else:
        y = cast(relu(conv(x, block["conv1"], stride=stride, pad=1)))
        y = cast(conv(y, block["conv2"], stride=1, pad=1))
    return relu(y + shortcut)


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_memory_forward_decodes_once_per_block(monkeypatch, kind,
                                                      dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jspec = jresnet.ResNetSpec(**SMALL[kind])
    tspec = tresnet.ResNetSpec(**SMALL[kind])
    params = tsynth.random_resnet_pq_params(tspec, seed=0)
    x = np.random.default_rng(1).standard_normal(
        (3, tspec.in_size, tspec.in_size, 3)).astype(np.float32)
    prepared = tresnet.prepare_params(tspec, params, dtype=tdt, memory=True,
                                      device="cpu")
    kw = dict(spec=tspec, compute_dtype=tdt, device="cpu")
    counter = _CountDecodes(monkeypatch)
    got = tresnet.forward(prepared, x, **kw)
    # one launch a block (all three here have a conv on the decode route)
    # and one for the fc head
    n_blocks = sum(tspec.stage_depths)
    assert len(counter.calls) == n_blocks + 1 and counter.calls[-1] == 1
    fused = sum(
        conv_ops.memory_fused_route(prepared[key][name], shape, dt,
                                    stride=st, pad=pad) == "fusedconv"
        for key, stride, _ in tresnet.block_layout(tspec)
        for name, (shape, dt, st, pad) in _shapes_of(
            tspec, prepared, key, stride, tdt).items())
    n_convs = sum(len(convs) for _, _, convs in tresnet.block_layout(tspec))
    assert sum(counter.calls[:-1]) == n_convs - fused
    # bf16 fuses the stride-1 3x3 convs of 256 channels; f32 decodes all
    assert (fused > 0) == (dtype == "bfloat16")
    # against the per-conv forward: the same bits
    monkeypatch.setattr(tresnet, "_run_block", _block_per_conv)
    counter.calls.clear()
    per_conv = tresnet.forward(prepared, x, **kw)
    assert counter.calls == [1] * (n_convs - fused + 1)
    assert torch.equal(got, per_conv)
    # forward_segments composes the same blocks
    monkeypatch.undo()
    y = torch.as_tensor(x)
    for _, fn in tresnet.forward_segments(tspec, compute_dtype=tdt):
        y = fn(y, prepared)
    assert torch.equal(y, got)
    # against the JAX forward
    pj = jresnet.prepare_params(jspec, params, dtype=jdt, memory=True)
    want = np.asarray(jresnet.forward(pj, jnp.asarray(x), spec=jspec,
                                      compute_dtype=jdt), np.float32)
    logit_tol, prob_tol = RESNET_TOL[dtype]
    assert float(np.abs(got.numpy() - want).max()) \
        <= logit_tol * float(np.abs(want).max())
    assert float(np.abs(torch.softmax(got, -1).numpy()
                        - np.asarray(jax.nn.softmax(want))).max()) <= prob_tol


def _shapes_of(spec, prepared, key, stride, dtype):
    """The inputs of block `key`'s convs (``resnet._block_inputs``) for a
    batch of 3 at the spec's input size."""
    stage = int(key[1])
    hw = spec.in_size // 4 // (2 ** stage) * (stride if stride > 1 else 1)
    cin = 64 if key == "s0b0" else (
        spec.stage_channels[stage - 1] if key.endswith("b0")
        else spec.stage_channels[stage])
    x = torch.empty((3, hw, hw, cin), dtype=dtype, device="meta")
    return tresnet._block_inputs(x, prepared[key], stride, spec.bottleneck,
                                 dtype)


def test_block_inputs_follow_the_block_input():
    spec = tresnet.resnet50()
    block = {name: {"bias": torch.zeros(co)} for name, co in
             (("conv1", 128), ("conv2", 128), ("conv3", 512), ("proj", 512))}
    x = torch.empty((2, 56, 56, 256), dtype=torch.bfloat16, device="meta")
    got = tresnet._block_inputs(x, block, 2, spec.bottleneck, torch.bfloat16)
    bf = torch.bfloat16
    assert got == {"conv1": ((2, 56, 56, 256), bf, 1, 0),
                   "conv2": ((2, 56, 56, 128), bf, 2, 1),
                   "conv3": ((2, 28, 28, 128), bf, 1, 0),
                   "proj": ((2, 56, 56, 256), bf, 2, 0)}
    # without a compute dtype a conv emits float32, whatever it was given
    got = tresnet._block_inputs(x, block, 1, True, None)
    assert got["conv1"][1] == bf and got["conv2"][1] == torch.float32
    basic = {"conv1": {"bias": torch.zeros(128)},
             "conv2": {"bias": torch.zeros(128)}}
    got = tresnet._block_inputs(x, basic, 2, False, bf)
    assert got == {"conv1": ((2, 56, 56, 256), bf, 2, 1),
                   "conv2": ((2, 28, 28, 128), bf, 1, 1)}


def test_resnet50_memory_forward_launches(monkeypatch):
    """Full-width ResNet-50 in bf16 memory mode: 16 grouped decodes and the
    head's, 45 convs in them, 7 convs on the fused route (the counts
    chip_smoke.py holds the card to)."""
    spec = tresnet.resnet50()
    params = tsynth.random_resnet_pq_params(spec, seed=0)
    prepared = tresnet.prepare_params(spec, params, dtype=torch.bfloat16,
                                      memory=True, device="cpu")
    groups, fused = [], 0
    shape, dtype = (1, 56, 56, 64), torch.bfloat16
    for key, stride, _ in tresnet.block_layout(spec):
        x = torch.empty(shape, dtype=dtype, device="meta")
        routes = tresnet._block_routes(
            tresnet._block_inputs(x, prepared[key], stride, True, dtype),
            prepared[key])
        impls = [impl for _, impl, _ in routes.values()]
        fused += impls.count("fusedconv")
        groups.append(len(impls) - impls.count("fusedconv"))
        cout = prepared[key]["conv3"]["bias"].shape[0]
        shape = (1, -(-shape[1] // stride), -(-shape[2] // stride), cout)
    assert len(groups) == 16 and all(groups)
    assert (sum(groups), fused) == (45, 7)
