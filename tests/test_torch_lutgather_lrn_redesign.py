"""The redesigned ``pq_lut_gather`` and ``lrn_fused`` of the port, on the
CPU: their launch plans (pure functions of the shape), the staged gather's
split-S sum order and the register window's add order emulated in PyTorch.

Tolerances: the split-S emulation within 1e-5 of the largest |output| of
``lut_gather_plain`` and of the JAX ``pq_fc_lut_gather`` in interpret mode
(the same f32 LUT summed in another order); the window emulation within one
bf16 ulp of each bf16 output and 1e-6 of the largest |output| in f32 of
``lrn_plain`` and of the JAX ``lrn_fused`` in interpret mode (f32 window
sums in another order). The kernels themselves run only on the card:
chip_smoke.py holds them against the plain versions there, and bit for bit
against these two emulations.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.cuda import _plan, lrn_fused, pq_lut_gather
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

jlut = importlib.import_module("qcnn_tpu.ops.pallas.pq_lut_gather")
jlrn = importlib.import_module("qcnn_tpu.ops.pallas.lrn_fused")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- (a) the pq_lut_gather plan ---------------------------------------------

ALEXNET_FC = {"fc6": (2304, 32, 4096), "fc7": (1024, 32, 4096),
              "fc8": (4096, 16, 1000)}
STAGED_SHAPES = [(b, *ALEXNET_FC[name]) for name in ALEXNET_FC
                 for b in (1, 2, 3, 17)] + [
    (70, 1024, 32, 4096),    # nine batch tiles of 8 rows
    (1, 4096, 16, 10),       # one narrow tile: S split past 8 ways
    (2, 64, 128, 10),        # K = 128: one split
    (8, 4096, 128, 100),     # K = 128 at 8 rows: 3 units fit, 86 splits
    (3, 16, 32, 5),          # one unit
    (5, 48, 20, 70),         # K = 20: a multiple of 4, no power of two
    (1, 16, 256, 9),         # K = 256 (the entry caps at 128, this does not)
    (8 * 65535, 16, 4, 3),   # as many 8-row tiles as a launch's grid has
]
GENERAL_SHAPES = [(70, 15, 32, 250), (130, 33, 16, 129), (5, 1, 128, 40),
                  (9, 32, 3, 5), (2, 64, 30, 7), (1, 0, 32, 10),
                  (4, 16, 4096, 6)]


@pytest.mark.parametrize("b,s,k,cout", STAGED_SHAPES)
def test_lut_gather_plan_invariants(b, s, k, cout):
    pl = _plan.plan_lut_gather(b, s, k, cout)
    assert pl.variant == "staged"
    assert pl.rows in _plan.LUTG_ROWS
    assert pl.rows >= min(b, _plan.LUTG_ROWS[-1])
    assert pl.rows == 1 or pl.rows // 2 < min(b, _plan.LUTG_ROWS[-1])
    assert pl.outputs in _plan.LUTG_OUTPUTS
    assert pl.groups * pl.outputs == _plan.LUTG_THREADS
    units = s // _plan.LUTG_UNIT
    # the ranges cover S, and no split is empty
    assert pl.splits * pl.units_per_split >= units
    assert (pl.splits - 1) * pl.units_per_split < units
    out_tiles = _plan.ceil_div(cout, pl.outputs)
    b_tiles = _plan.ceil_div(b, pl.rows)
    assert pl.grid == (out_tiles, b_tiles, pl.splits)
    assert out_tiles <= _plan.MAX_GRID_X
    assert b_tiles <= _plan.MAX_GRID_YZ
    assert pl.splits <= _plan.MAX_GRID_YZ
    assert pl.smem_bytes == _plan.lut_gather_smem(
        pl.rows, pl.units_per_split, k) <= _plan.SMEM_LIMIT
    assert pl.workspace_bytes == (pl.splits * b * cout * 4
                                  if pl.splits > 1 else 0)


@pytest.mark.parametrize("b,s,k,cout", GENERAL_SHAPES)
def test_lut_gather_plan_general(b, s, k, cout):
    """S not a multiple of 16 (S = 15, 33, 1), K not a multiple of 4, an
    empty sum and a slice that fits no block: the general kernel."""
    pl = _plan.plan_lut_gather(b, s, k, cout)
    assert pl.variant == "general"
    assert (pl.smem_bytes, pl.workspace_bytes, pl.splits) == (0, 0, 1)
    assert pl.grid == (_plan.ceil_div(cout, 8), b, 1)


@pytest.mark.parametrize("name,b,rows,outputs,groups,splits,units,grid,smem", [
    ("fc6", 1, 1, 256, 1, 8, 18, (16, 1, 8), 37888),
    ("fc7", 1, 1, 256, 1, 8, 8, (16, 1, 8), 17408),
    ("fc8", 1, 1, 64, 4, 8, 32, (16, 1, 8), 33792),
    ("fc6", 2, 2, 256, 1, 8, 18, (16, 1, 8), 75776),
    ("fc7", 2, 2, 256, 1, 8, 8, (16, 1, 8), 34816),
    ("fc8", 2, 2, 64, 4, 8, 32, (16, 1, 8), 67584),
    ("fc6", 3, 4, 256, 1, 8, 18, (16, 1, 8), 151552),
    ("fc6", 17, 8, 256, 1, 12, 12, (16, 3, 12), 204800),
    ("fc8", 17, 8, 256, 1, 10, 26, (4, 3, 10), 221184),
])
def test_lut_gather_plan_of_the_alexnet_layers(name, b, rows, outputs, groups,
                                               splits, units, grid, smem):
    """At the routed batches (1 and 2) every layer is 128 blocks, about one
    an SM: the widest tile that gives so many, 8 ways along S, added up
    through the workspace."""
    pl = pq_lut_gather.plan(b, *ALEXNET_FC[name])
    assert (pl.rows, pl.outputs, pl.groups) == (rows, outputs, groups)
    assert (pl.splits, pl.units_per_split, pl.grid) == (splits, units, grid)
    assert (pl.smem_bytes, pl.workspace_bytes) == (
        smem, splits * b * ALEXNET_FC[name][2] * 4)


@pytest.mark.parametrize("b,s,k,cout,tile", [
    (8 * 65535 + 1, 16, 4, 3, 8),     # staged: 65536 tiles of 8 rows
    (600000, 16, 4, 3, 8),
    (65536, 15, 4, 3, 1),             # general: a row a tile
])
def test_lut_gather_plan_refuses_a_batch_past_the_grid(b, s, k, cout, tile):
    """Every shape decision is the plan's: a batch that no launch takes is
    refused here, by name, not by the launcher."""
    with pytest.raises(ValueError, match=f"65535 batch tiles of {tile}"):
        _plan.plan_lut_gather(b, s, k, cout)
    assert _plan.plan_lut_gather(65535, 15, 4, 3).grid == (1, 65535, 1)


def test_lut_gather_takes_no_plan_from_its_caller():
    """The wrapper plans from the tensors it is given: no argument can make
    it launch under a plan of another shape."""
    assert list(inspect.signature(pq_lut_gather.lut_gather).parameters) == [
        "lut", "assignments", "bias"]
    assert list(inspect.signature(_plan.plan_lut_gather).parameters) == [
        "b", "s", "k", "cout"]


# ---- (b) the split-S sum order ----------------------------------------------

def _fc(rng, b, cin, cout, s, k, d):
    x = rng.standard_normal((b, cin)).astype(np.float32)
    p = {
        "codebooks": rng.standard_normal((s, k, d)).astype(np.float32),
        "assignments": rng.integers(0, k, size=(cout, s), dtype=np.uint8),
        "bias": rng.standard_normal(cout).astype(np.float32),
    }
    return x, p


@pytest.mark.parametrize("b,cin,cout,s,k,d,outputs,groups,splits", [
    (2, 384, 300, 96, 32, 4, 32, 8, 1),     # 6 units, one a warp
    (3, 640, 70, 160, 16, 4, 32, 8, 2),     # 5 units a block: ragged warps
    (1, 1024, 600, 256, 32, 4, 32, 8, 4),   # 4 units a block, 8 warps
    (17, 96, 40, 48, 8, 2, 32, 8, 1),       # three batch tiles of 8 rows
    (2, 4096, 1000, 4096, 16, 1, 64, 4, 8),  # AlexNet fc8, full width
])
def test_split_sum_order_matches_plain_and_pallas(rng, b, cin, cout, s, k, d,
                                                  outputs, groups, splits):
    x, p = _fc(rng, b, cin, cout, s, k, d)
    lut = lut_ops.build_lut(T(x), T(p["codebooks"]))
    pl = pq_lut_gather.plan(b, s, k, cout)
    assert (pl.outputs, pl.groups, pl.splits) == (outputs, groups, splits)
    got = pq_lut_gather.split_sum_plain(lut, T(p["assignments"]),
                                        T(p["bias"]), pl)
    plain = pq_lut_gather.lut_gather_plain(lut, T(p["assignments"]),
                                           T(p["bias"]))
    pallas = np.asarray(jlut.pq_fc_lut_gather(jnp.asarray(x), p,
                                              interpret=True))
    scale = float(plain.abs().max())
    assert got.dtype == torch.float32 and got.shape == (b, cout)
    assert float((got - plain).abs().max()) <= 1e-5 * scale
    assert float(np.abs(got.numpy() - pallas).max()) <= 1e-5 * scale


@pytest.mark.parametrize("b,s,k,cout,outputs,groups,splits,units", [
    (2, 160, 32, 90, 32, 8, 2, 5),      # 5 units over 8 warps: 3 idle
    (2, 176, 32, 300, 32, 8, 2, 6),     # 11 units: blocks of 6 and 5
    (1, 208, 16, 40, 32, 8, 3, 5),      # 13 units: blocks of 5, 5 and 3
])
def test_split_sum_order_ragged_ranges(rng, b, s, k, cout, outputs, groups,
                                       splits, units):
    """Units that divide neither over the blocks nor over a block's warps."""
    x, p = _fc(rng, b, s * 4, cout, s, k, 4)
    lut = lut_ops.build_lut(T(x), T(p["codebooks"]))
    pl = pq_lut_gather.plan(b, s, k, cout)
    assert (pl.outputs, pl.groups, pl.splits, pl.units_per_split) == (
        outputs, groups, splits, units)
    args = (lut, T(p["assignments"]), T(p["bias"]))
    got = pq_lut_gather.split_sum_plain(*args, pl)
    plain = pq_lut_gather.lut_gather_plain(*args)
    assert float((got - plain).abs().max()) <= 1e-5 * float(plain.abs().max())


def test_split_sum_is_the_same_bits_twice(rng):
    x, p = _fc(rng, 2, 1024, 300, 256, 32, 4)
    lut = lut_ops.build_lut(T(x), T(p["codebooks"]))
    pl = pq_lut_gather.plan(2, 256, 32, 300)
    assert pl.splits > 1
    args = (lut, T(p["assignments"]), T(p["bias"]), pl)
    assert torch.equal(pq_lut_gather.split_sum_plain(*args),
                       pq_lut_gather.split_sum_plain(*args))


# ---- (c) the lrn_fused plan -------------------------------------------------

@pytest.mark.parametrize("shape,size,dtype,variant,blocks", [
    # AlexNet's two LRNs at B=256, bf16
    ((256, 55, 55, 96), 5, torch.bfloat16, "register", 9075),
    ((256, 27, 27, 256), 5, torch.bfloat16, "register", 5832),
    ((4, 7, 7, 96), 5, torch.float32, "register", 5),
    ((4, 7, 7, 96), 3, torch.float32, "register", 5),
    ((4, 7, 7, 96), 7, torch.bfloat16, "register", 3),
    ((1000, 8), 7, torch.bfloat16, "register", 1),      # one vector a row
    ((33, 100), 3, torch.float32, "register", 1),       # 25 vectors a row
    # a window wider than the kernel is built for
    ((4, 7, 7, 96), 9, torch.bfloat16, "general", 10),
    ((4, 7, 7, 96), 1, torch.float32, "general", 19),   # radius 0
    # rows that are no whole 16-byte vectors
    ((5, 130), 5, torch.float32, "general", 1),
    ((5, 130), 5, torch.bfloat16, "general", 1),
    ((33, 100), 3, torch.bfloat16, "general", 2),
    # past 32-bit indices
    ((2 ** 23, 256), 5, torch.bfloat16, "general", 2 ** 20),
])
def test_lrn_plan(shape, size, dtype, variant, blocks):
    n = int(np.prod(shape))
    esize = torch.empty((), dtype=dtype).element_size()
    pl = lrn_fused.plan(n, shape[-1], (size - 1) // 2, esize)
    assert (pl.variant, pl.blocks) == (variant, blocks)
    if variant == "register":
        assert (pl.vectors, pl.smem_bytes) == (_plan.LRN_VECTORS, 0)
        v = 16 // esize
        assert shape[-1] % v == 0 and (size - 1) // 2 <= v
        assert pl.blocks * _plan.LRN_THREADS * pl.vectors >= n // v
    else:
        assert pl.vectors == 1 and 0 < pl.smem_bytes <= 48 * 1024


# ---- (d) the register window's add order ------------------------------------

def _ulp_check(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if dtype == "bfloat16":
        _, exp = np.frexp(want)
        assert (diff <= np.ldexp(1.0, exp - 8)).all(), diff.max()
    else:
        assert diff.max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("window", lrn_fused.WINDOWS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("size", [3, 5, 7])
@pytest.mark.parametrize("shape", [(3, 5, 96), (4, 130), (2, 3, 256)])
def test_window_order_matches_plain_and_pallas(rng, window, dtype, size,
                                               shape):
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    kw = dict(size=size, alpha=1e-2, beta=0.75, k=1.0)
    xt = T(x).to(getattr(torch, dtype))
    got = lrn_fused.lrn_window_plain(xt, **kw)
    assert got.dtype == xt.dtype
    _ulp_check(got, lrn_fused.lrn_plain(xt, **kw).float().numpy(), dtype)
    want = jlrn.lrn_fused(jnp.asarray(x, getattr(jnp, dtype)), window=window,
                          tile_m=64, interpret=True, **kw)
    _ulp_check(got, want, dtype)


@pytest.mark.parametrize("beta", [0.5, 1.0, 0.6])
def test_window_order_other_betas(rng, beta):
    x = T((rng.standard_normal((6, 96)) * 3).astype(np.float32))
    kw = dict(size=5, alpha=1e-2, beta=beta, k=2.0)
    _ulp_check(lrn_fused.lrn_window_plain(x, **kw),
               lrn_fused.lrn_plain(x, **kw).numpy(), "float32")


def test_window_masks_the_channel_edges():
    """Ones everywhere: channel c sums the channels of its window that
    exist, 3 at the edge, 4 next to it, 5 inside."""
    x = torch.ones((2, 8))
    got = lrn_fused.lrn_window_plain(x, size=5, alpha=5.0, beta=1.0, k=0.0)
    want = 1.0 / torch.tensor([3., 4., 5., 5., 5., 5., 4., 3.])
    assert torch.allclose(got, want.expand(2, 8), rtol=1e-6)


# ---- (e) the JAX entry's signature ------------------------------------------

def test_entry_accepts_block_s(rng):
    x, p = _fc(rng, 2, 64, 20, 16, 16, 4)
    tp = {k: T(v) for k, v in p.items()}
    want = pq_lut_gather.pq_fc_lut_gather(T(x), tp)
    for block_s in (8, 256):
        assert torch.equal(
            pq_lut_gather.pq_fc_lut_gather(T(x), tp, block_s=block_s), want)
    assert "block_s" in inspect.signature(jlut.pq_fc_lut_gather).parameters
    assert len(pq_lut_gather.KERNEL.argtypes) == 13  # 5 pointers, 7 ints,
    assert len(pq_lut_gather.GENERAL.argtypes) == 9  # the stream
    assert lrn_fused.KERNEL.argtypes == lrn_fused.GENERAL.argtypes
    assert len(lrn_fused.KERNEL.argtypes) == 11
