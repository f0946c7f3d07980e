"""The wgmma decode-GEMMs behind pq_fc_fused and pq_conv_fused, as far as
the CPU can hold them:

(a) the launch planner (ops/cuda/_plan.py), a pure function of the shape:
    the models' shapes take the wgmma kernel, ragged ones the general
    kernel, grids stay under CUDA's limits, the workspace is sized for the
    split contraction;
(b) an emulation of the split contraction (bf16 operands, one float32
    partial sum per split, the splits added in order, then the bias) held
    against the plain versions and against the JAX package on the same
    NumPy inputs. Tolerance 1e-4 of the largest |output|: the operands are
    the same bf16 values on every side and only the order of the float32
    additions differs. This is the reason for chip_smoke.py's limit on the
    kernels under their summation order;
(c) the Python mirror of the 128-byte swizzle the kernels write X tiles
    with;
and that the build's library name follows the shared headers.

The kernels themselves run only on the card (chip_smoke.py)."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.ops import conv as jconv
from qcnn_tpu.ops.pallas import pq_fc_fused as j_fused
from qcnn_tpu_torch.ops import lut
from qcnn_tpu_torch.ops.cuda import _build, _plan, pq_conv_fused, pq_fc_fused
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# AlexNet fc6-8: (Cin, Cout, S, K, D)
ALEXNET_FC = {"fc6": (9216, 4096, 2304, 32, 4),
              "fc7": (4096, 4096, 1024, 32, 4),
              "fc8": (4096, 1000, 4096, 16, 1)}
# ResNet-50's fused convs: (H=W, Cin=Cout, S, K, D), 3x3, pad 1
RESNET_CONV = {"14x14x256": (14, 256, 64, 128, 4),
               "7x7x512": (7, 512, 128, 128, 4)}
FC_TILES = (8, 32, 64, 128, 256)
CONV_TILES = (64, 128, 256)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check_wgmma_plan(plan, rows, cout, n_its, tiles):
    assert plan.variant == "wgmma"
    assert plan.tile_rows in tiles and plan.tile_channels == 128
    row_tiles = -(-rows // plan.tile_rows)
    assert plan.grid == (row_tiles, -(-cout // plan.tile_channels),
                         plan.splits)
    assert plan.grid[0] <= 2 ** 31 - 1
    assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535
    # every split has work, together they cover the contraction
    assert 1 <= plan.splits <= n_its
    assert (plan.splits - 1) * plan.its_per_split < n_its
    assert plan.splits * plan.its_per_split >= n_its
    # split only to fill the card: about one wave
    tiles_out = plan.grid[0] * plan.grid[1]
    assert plan.splits == 1 or tiles_out * plan.splits <= _plan.SM_COUNT
    assert plan.workspace_bytes == (
        plan.splits * rows * cout * 4 if plan.splits > 1 else 0)
    assert 0 < plan.smem_bytes <= _plan.SMEM_LIMIT


def _check_general_plan(plan):
    assert plan.variant == "general"
    assert (plan.tile_rows, plan.tile_channels, plan.splits) == (128, 64, 1)
    assert plan.workspace_bytes == 0
    assert plan.grid[0] <= 2 ** 31 - 1 and plan.grid[1] <= 65535
    assert plan.smem_bytes <= _plan.SMEM_LIMIT


@pytest.mark.parametrize("b", [3, 64, 256, 1024])
@pytest.mark.parametrize("layer", sorted(ALEXNET_FC))
def test_plan_fc_alexnet_takes_the_wgmma_kernel(layer, b):
    cin, cout, s, k, d = ALEXNET_FC[layer]
    plan = pq_fc_fused.plan(b, cin, cout, s, k, d)
    _check_wgmma_plan(plan, b, cout, cin // 64, FC_TILES)
    # the batch pads to the tile, not to 64 or 128 rows; a large batch
    # takes 256 rows where the kernel is built for it (D=4)
    wide = 256 if d == 4 else 128
    assert plan.tile_rows == {3: 8, 64: 64, 256: wide, 1024: wide}[b]
    # under one wave of tiles, the contraction is split
    if plan.grid[0] * plan.grid[1] * 2 <= _plan.SM_COUNT:
        assert plan.splits > 1


@pytest.mark.parametrize("images", [1, 2, 5])
@pytest.mark.parametrize("cin,cout", [(1024, 4096), (4096, 1024)])
def test_plan_fc_vit_l16_mlp_takes_the_wgmma_kernel(cin, cout, images):
    """ViT-L/16's mlp1 and mlp2 at 197 rows an image: the rows that memory
    mode routes to pq_fc_fused (up to 5 images, 985 rows)."""
    rows = chip_smoke.VIT_ROWS * images
    plan = pq_fc_fused.plan(rows, cin, cout, cin // 4, 32, 4)
    _check_wgmma_plan(plan, rows, cout, cin // 64, FC_TILES)
    assert plan.tile_rows == 256
    if images == 1:  # 1 row tile: the contraction is split to fill the card
        assert plan.splits == {4096: 4, 1024: 16}[cout]


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("geometry", sorted(RESNET_CONV))
def test_plan_conv_resnet50_takes_the_wgmma_kernel(geometry, b):
    hw, c, s, k, d = RESNET_CONV[geometry]
    plan = pq_conv_fused.plan(b, hw, hw, c, c, 3, 1, s, k, d)
    _check_wgmma_plan(plan, b * hw * hw, c, 9 * c // 64, CONV_TILES)
    blocks = plan.grid[0] * plan.grid[1] * plan.splits
    if b == 1:  # 2-8 tiles a conv: spread over tens of blocks
        assert plan.tile_rows == 64 and blocks >= 64
    else:  # 128 channels x 256 pixels a block, most of the card busy
        assert plan.tile_rows == 256
        assert 96 <= blocks <= _plan.SM_COUNT


@pytest.mark.parametrize("shape", chip_smoke.FC_ODD)
def test_plan_fc_odd_shapes_take_the_wgmma_kernel(shape):
    b, cin, cout, s, k, d = shape
    _check_wgmma_plan(pq_fc_fused.plan(b, cin, cout, s, k, d), b, cout,
                      cin // 64, FC_TILES)


@pytest.mark.parametrize("shape", chip_smoke.FC_RAGGED)
def test_plan_fc_ragged_shapes_take_the_general_kernel(shape):
    b, cin, cout, s, k, d = shape
    _check_general_plan(pq_fc_fused.plan(b, cin, cout, s, k, d))


@pytest.mark.parametrize("shape", chip_smoke.CONV_ODD)
def test_plan_conv_odd_shapes_take_the_wgmma_kernel(shape):
    b, h, w, cin, cout, kh, pad, s, k, d = shape
    rows = b * (h + 2 * pad - kh + 1) * (w + 2 * pad - kh + 1)
    _check_wgmma_plan(
        pq_conv_fused.plan(b, h, w, cin, cout, kh, pad, s, k, d), rows, cout,
        kh * kh * cin // 64, CONV_TILES)


@pytest.mark.parametrize("shape", chip_smoke.CONV_RAGGED)
def test_plan_conv_ragged_shapes_take_the_general_kernel(shape):
    b, h, w, cin, cout, kh, pad, s, k, d = shape
    _check_general_plan(
        pq_conv_fused.plan(b, h, w, cin, cout, kh, pad, s, k, d))


@pytest.mark.parametrize("case,want", [
    # fc1x1's rows are B*H*W: thousands of rows walk the grid's x dimension
    (("fc", 200000, 256, 256, 64, 32, 4), "wgmma"),
    (("fc", 4, 64, 64, 16, 32, 4), "wgmma"),
    (("fc", 4, 64, 64, 8, 32, 8), "general"),      # D = 8
    (("fc", 4, 60, 64, 16, 32, 4), "general"),     # Cin < S*D
    (("fc", 4, 192, 64, 48, 129, 4), "general"),   # K past the uint8 cap
    (("fc", 2 ** 20, 2048, 64, 512, 32, 4), "general"),  # x past 2^31 values
    # a codebook too large to keep resident beside the ring
    (("conv", 64, 8, 8, 1024, 1024, 3, 1, 256, 128, 4), "general"),
    (("conv", 64, 8, 8, 1024, 1024, 3, 1, 256, 32, 4), "wgmma"),
    # the same layer at B=2 splits the contraction: few chunks a block
    (("conv", 2, 8, 8, 1024, 128, 3, 1, 256, 128, 4), "wgmma"),
])
def test_plan_edges(case, want):
    kind, *shape = case
    plan = (pq_fc_fused.plan if kind == "fc" else pq_conv_fused.plan)(*shape)
    assert plan.variant == want
    assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535
    assert plan.smem_bytes <= _plan.SMEM_LIMIT


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(1e-6,
                                                 float(np.abs(want).max()))


def _split_sum(xr, wr, bias, plan):
    """The kernels' summation: xr (rows, n_its * 64) and wr (cout,
    n_its * 64) hold the bf16 operands in the order the blocks walk them;
    split z sums its range in float32, the partial sums are added in split
    order, then the bias."""
    step = plan.its_per_split * 64
    acc = None
    for z in range(plan.splits):
        part = xr[:, z * step:(z + 1) * step] @ wr[:, z * step:(z + 1) * step].T
        acc = part if acc is None else acc + part
    return acc + bias


@pytest.mark.parametrize("b,cin,cout,s,k,d", [
    (3, 256, 130, 64, 32, 4),     # 8-row tile, split 4
    (70, 128, 250, 32, 32, 4),    # chip_smoke's odd shapes
    (5, 64, 40, 64, 128, 1),
    (130, 192, 129, 96, 16, 2),
    (9, 1024, 520, 256, 32, 4),   # split 16
])
def test_split_contraction_fc_matches_plain_and_jax(rng, b, cin, cout, s, k,
                                                    d):
    x = rng.standard_normal((b, cin)).astype(np.float32)
    p = {"codebooks": rng.standard_normal((s, k, d)).astype(np.float32),
         "assignments": rng.integers(0, k, size=(cout, s), dtype=np.uint8),
         "bias": rng.standard_normal(cout).astype(np.float32)}
    plan = pq_fc_fused.plan(b, cin, cout, s, k, d)
    assert plan.variant == "wgmma"
    tp = {name: T(v) for name, v in p.items()}
    w = lut.decode_rows(tp["codebooks"].to(torch.bfloat16),
                        tp["assignments"], cin).float()  # (Cout, Cin)
    xb = T(x).to(torch.bfloat16).float()
    got = _split_sum(xb, w, tp["bias"], plan).numpy()
    plain = pq_fc_fused.fused_plain(T(x), tp["codebooks"], tp["assignments"],
                                    tp["bias"]).numpy()
    assert _rel_err(got, plain) <= 1e-4
    want = j_fused(x, p, interpret=True)
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("b,h,w,cin,cout,kh,pad,s,k,d", [
    (3, 9, 11, 64, 130, 3, 1, 16, 32, 4),     # chip_smoke's odd shapes
    (1, 14, 14, 128, 64, 5, 2, 64, 128, 2),
    (2, 7, 7, 64, 70, 3, 0, 64, 16, 1),
    (1, 7, 7, 256, 136, 3, 1, 64, 64, 4),     # split across chunks and taps
])
def test_split_contraction_conv_matches_plain_and_jax(rng, b, h, w, cin, cout,
                                                      kh, pad, s, k, d):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    p = {"codebooks": (rng.standard_normal((s, k, d)) * 0.3).astype(
             np.float32),
         "assignments": rng.integers(0, k, size=(cout, kh, kh, s),
                                     dtype=np.uint8),
         "bias": rng.standard_normal(cout).astype(np.float32)}
    plan = pq_conv_fused.plan(b, h, w, cin, cout, kh, pad, s, k, d)
    assert plan.variant == "wgmma" and plan.splits > 1
    tp = {name: T(v) for name, v in p.items()}
    cbb = tp["codebooks"].to(torch.bfloat16)
    xb = T(x).to(torch.bfloat16).float()
    ho, wo = h + 2 * pad - kh + 1, w + 2 * pad - kh + 1
    # X rows in the blocks' order: (chunk, tap) pairs, chunk-major
    xp = torch.nn.functional.pad(xb, (0, 0, pad, pad, pad, pad))
    taps = torch.stack([xp[:, ti:ti + ho, tj:tj + wo, :]
                        for ti in range(kh) for tj in range(kh)], dim=3)
    xr = taps.reshape(b * ho * wo, kh * kh, cin // 64, 64).permute(
        0, 2, 1, 3).reshape(b * ho * wo, -1)
    hwio = lut.decode_conv_kernel(cbb, tp["assignments"], cin).float()
    wr = hwio.permute(3, 0, 1, 2).reshape(cout, kh * kh, cin // 64, 64).permute(
        0, 2, 1, 3).reshape(cout, -1)
    got = _split_sum(xr, wr, tp["bias"], plan).reshape(b, ho, wo, cout)
    plain = pq_conv_fused.conv_fused_plain(T(x), tp["codebooks"],
                                           tp["assignments"], tp["bias"],
                                           pad=pad)
    assert _rel_err(got.numpy(), plain.numpy()) <= 1e-4
    # the JAX package's decode conv in float32 on the same bf16 values
    pj = dict(p, codebooks=jnp.asarray(cbb.float().numpy()))
    want = jconv.pq_conv(jnp.asarray(xb.numpy()), pj, stride=1, pad=pad,
                         impl="decode")
    assert _rel_err(got.numpy(), want) <= 1e-4


def test_swizzle128_is_a_bijection_that_keeps_16_byte_groups(rng):
    for rows in (8, 64, 128):
        offs = np.array([[_plan.swizzle128(r, c) for c in range(128)]
                         for r in range(rows)])
        # a bijection on the tile, and on each 8-row x 128-byte atom
        assert sorted(offs.ravel()) == list(range(rows * 128))
        for atom in range(rows // 8):
            a = offs[8 * atom:8 * atom + 8]
            assert a.min() == 1024 * atom and a.max() == 1024 * atom + 1023
        # rows stay in their 128 bytes; a 16-byte group (so every 8-byte
        # D=4 codeword and every cp.async) stays contiguous and aligned
        assert (offs // 128 == np.arange(rows)[:, None]).all()
        groups = offs.reshape(rows, 8, 16)
        assert (groups[:, :, 0] % 16 == 0).all()
        assert (np.diff(groups, axis=2) == 1).all()
        # the group index is XORed with row % 8
        want = (np.arange(8)[None, :] ^ (np.arange(rows) % 8)[:, None])
        assert ((groups[:, :, 0] % 128) // 16 == want).all()


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    """A changed .cuh (or .cu) gives a new library name, so a stale build
    is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "t.cuh"\n')
    (csrc / "t.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    first = _build.library_path()
    assert _build.library_path() == first
    (csrc / "t.cuh").write_text("// two\n")
    second = _build.library_path()
    assert second != first
    (csrc / "a.cu").write_text('#include "t.cuh"\n// edited\n')
    assert _build.library_path() not in (first, second)
    (csrc / "u.cuh").write_text("")
    assert _build.library_path() not in (first, second)


def test_build_compiles_with_the_header_directory():
    """Every .cu of the package includes its headers by name: nvcc gets
    -I csrc, and each included .cuh exists."""
    import re
    for src in _build._sources():
        with open(src) as f:
            for name in re.findall(r'#include "([^"]+)"', f.read()):
                assert os.path.exists(os.path.join(_build.CSRC, name)), (
                    src, name)
    assert any(h.endswith("pq_tile.cuh") for h in _build._headers())
