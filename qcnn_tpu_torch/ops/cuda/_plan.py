"""Launch plans of the two decode-GEMM kernels, as pure functions of the
shape.

``csrc/pq_tile.cuh`` holds the kernel that ``pq_fc_fused`` and
``pq_conv_fused`` share (``wgmma``, the weight decoded into registers). It
takes Cin = S*D with Cin % 64 == 0, D in {1, 2, 4} and K <= 128; every other
shape goes to the general kernels. Which kernel runs, its tile, how the
contraction is split across blocks and how large the partial-sum workspace
is are decided here from the shape alone, never from a failure, so the CPU
tests can check the decision and the C launchers only validate it.

The constants mirror ``pq_tile.cuh``.
"""

from __future__ import annotations

from dataclasses import dataclass

SM_COUNT = 132        # H100 SXM; a card with another count is only mistuned
SMEM_LIMIT = 232448   # dynamic shared memory a block may ask for (227 KB)
KC = 64               # contraction features per stage
MT = 128              # output channels per block of the wgmma kernel
MAX_STAGES = 12       # ring depth: what fits, up to this
MIN_STAGES = 3        # a shallower ring would not hide the loads: the plan
                      # falls back to a narrower tile or the general kernel
FIXED_SMEM = 1024 + 256   # alignment slack and barriers
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535
DS = (1, 2, 4)


@dataclass(frozen=True)
class Plan:
    variant: str          # "wgmma" or "general"
    tile_rows: int        # rows of X (batch rows, output pixels) per block
    tile_channels: int    # output channels per block
    splits: int           # blocks that share one output tile's contraction
    its_per_split: int    # (chunk, tap) pairs a block walks
    grid: tuple[int, int, int]
    smem_bytes: int       # dynamic shared memory of a block
    workspace_bytes: int  # float32 partial sums, 0 when splits == 1


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def swizzle128(row: int, byte: int) -> int:
    """Byte offset, in a tile of 128-byte rows stored with the 128-byte
    swizzle, of byte ``byte`` (0..127) of row ``row``: the 16-byte group
    index is XORed with ``row % 8``. Mirror of ``pq_tile.cuh``'s
    ``swizzle128``."""
    return row * 128 + ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15))


def wgmma_takes(cin: int, s: int, k: int, d: int, x_elems: int,
                id_elems: int) -> bool:
    """Shapes of the wgmma kernel; it indexes x and ids with 32 bits."""
    return (cin > 0 and cin % KC == 0 and cin == s * d and d in DS
            and 1 <= k <= 128 and x_elems < 2 ** 31 and id_elems < 2 ** 31)


def stage_bytes(tile_rows: int, d: int, k: int, conv: bool) -> int:
    """One ring stage: the X tile, the channels' ids of the chunk and, for
    the fc, the chunk's codebook span."""
    raw = tile_rows * 128 + MT * (KC // d) + (0 if conv else 2 * KC * k)
    return ceil_div(raw, 1024) * 1024


def split_contraction(tiles: int, n_its: int) -> tuple[int, int]:
    """(splits, its_per_split): about one wave of blocks on the card, no
    empty split."""
    splits = max(1, min(n_its, SM_COUNT // max(1, tiles), MAX_GRID_YZ))
    its = ceil_div(n_its, splits)
    return ceil_div(n_its, its), its


def _wgmma_plan(rows: int, tile_rows: int, cin: int, cout: int, k: int,
                d: int, taps: int, conv: bool) -> Plan | None:
    row_tiles, ch_tiles = ceil_div(rows, tile_rows), ceil_div(cout, MT)
    n_chunks = cin // KC
    splits, its = split_contraction(row_tiles * ch_tiles, n_chunks * taps)
    resident = 0
    if conv:  # the codebook chunks a block's range can touch
        resident = min(n_chunks, (its + taps - 2) // taps + 1) * 2 * KC * k
    stage = stage_bytes(tile_rows, d, k, conv)
    stages = min(MAX_STAGES, max(its, MIN_STAGES),
                 (SMEM_LIMIT - FIXED_SMEM - resident) // stage)
    if stages < MIN_STAGES or row_tiles > MAX_GRID_X or ch_tiles > MAX_GRID_YZ:
        return None
    return Plan("wgmma", tile_rows, MT, splits, its,
                (row_tiles, ch_tiles, splits),
                FIXED_SMEM + stages * stage + resident,
                splits * rows * cout * 4 if splits > 1 else 0)


def plan_fc(b: int, cin: int, cout: int, s: int, k: int, d: int) -> Plan:
    """Plan of ``pq_fc_fused`` for x (b, cin), ids (cout, s), codebooks
    (s, k, d)."""
    if wgmma_takes(cin, s, k, d, b * cin, cout * s):
        # the batch pads to the tile; past 128 rows a D=4 layer takes
        # 256-row tiles (one decoded fragment feeds an m64n256k16)
        tiles = ((8,) if b <= 8 else (32,) if b <= 32 else (64,) if b <= 64
                 else (128,) if b <= 128 or d != 4 else (256, 128))
        for tile in tiles:
            plan = _wgmma_plan(b, tile, cin, cout, k, d, 1, conv=False)
            if plan is not None:
                return plan
    # the general kernel: 128 batch rows x 64 outputs, static shared memory
    grid = (ceil_div(cout, 64), ceil_div(b, 128), 1)
    return Plan("general", 128, 64, 1, ceil_div(cin, KC), grid, 0, 0)


def plan_conv(b: int, h: int, w: int, cin: int, cout: int, kh: int, pad: int,
              s: int, k: int, d: int) -> Plan:
    """Plan of ``pq_conv_fused`` for NHWC x (b, h, w, cin), ids
    (cout, kh, kh, s), codebooks (s, k, d), stride 1."""
    ho, wo = h + 2 * pad - kh + 1, w + 2 * pad - kh + 1
    rows = b * ho * wo
    if (wgmma_takes(cin, s, k, d, b * h * w * cin, cout * kh * kh * s)
            and h <= 65535 and w <= 65535):
        # a block's decode costs the same whatever the tile's width: the
        # widest that the pixels fill (256 is built for D=4), then the
        # narrower ones where the resident codebook leaves too few stages
        tiles = ((64,) if rows <= 256 else (256, 128, 64) if d == 4
                 else (128, 64))
        for tile in tiles:
            plan = _wgmma_plan(rows, tile, cin, cout, k, d, kh * kh,
                               conv=True)
            if plan is not None:
                return plan
    # the general kernel: 128 pixels x 64 channels, two x and weight buffers
    grid = (ceil_div(cout, 64), ceil_div(rows, 128), 1)
    return Plan("general", 128, 64, 1, kh * kh * ceil_div(cin, KC), grid,
                2 * (128 + 64) * (KC + 8) * 2, 0)
