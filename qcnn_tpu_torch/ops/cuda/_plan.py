"""Launch plans of the kernels whose launch depends on the shape (the two
decode-GEMMs, the ``pq_fc`` and ``pq_lut_gather`` gathers, ``pq_decode`` and
``lrn_fused``), as pure functions of the shape.

``csrc/pq_tile.cuh`` holds the kernel that ``pq_fc_fused`` and
``pq_conv_fused`` share (``wgmma``, the weight decoded into registers). It
takes Cin = S*D with Cin % 64 == 0, D in {1, 2, 4} and K <= 128; every other
shape goes to the general kernels. Which kernel runs, its tile, how the
contraction is split across blocks and how large the partial-sum workspace
is are decided here from the shape alone, never from a failure, so the CPU
tests can check the decision and the C launchers only validate it.

The constants mirror ``pq_tile.cuh``, ``pq_fc.cu``, ``pq_lut_gather.cu``,
``pq_decode.cu`` and ``lrn_fused.cu``.

:func:`plan_gather` plans ``pq_fc`` (rows and outputs a block, the chunk of
sub-spaces a stage, the split of S), :func:`plan_lut_gather` plans
``pq_lut_gather`` (the staged kernel's rows, outputs and split of S, or the
general kernel), :func:`plan_decode` plans
one item of a ``pq_decode`` launch (the 16-byte vector kernel or the general
one) and :func:`plan_lrn` plans ``lrn_fused`` (the register-window kernel or
the general one).
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


def decode_replays(plan: Plan) -> int:
    """How many times a launch under ``plan`` of ``pq_fc_fused`` or
    ``pq_conv_fused`` decodes each weight element: once for each tile of
    rows, as every block decodes the slice of the weight that it multiplies
    (the row tile is the grid's x in the wgmma kernel, its y in the
    general ones)."""
    return plan.grid[0] if plan.variant == "wgmma" else plan.grid[1]


# ---- pq_fc: the batch-tiled LUT gather ------------------------------------

GATHER_THREADS = 512       # threads a block; a thread owns 1 or 2 outputs
GATHER_ROWS = (1, 2, 4, 8, 16)  # batch rows a block: the instantiations
GATHER_MAX_STAGES = 4      # ring of staged chunks: what fits, 2 to 4
GATHER_LUT_ROW = 1024      # floats between two rows of a staged LUT chunk
GATHER_MAX_CHUNK = 32      # sub-spaces a stage, at most


@dataclass(frozen=True)
class GatherPlan:
    rows: int              # batch rows per block
    outputs: int           # outputs per block (GATHER_THREADS x 1 or 2)
    chunk: int             # sub-spaces a stage
    splits: int            # blocks that share one output tile's sum over S
    chunks_per_split: int
    stages: int            # chunks in flight: the ring's depth
    grid: tuple[int, int, int]   # (output tiles, batch tiles, splits)
    smem_bytes: int        # dynamic shared memory of a block
    workspace_bytes: int   # float32 partial sums, 0 when splits == 1


def gather_id_pitch(chunk: int) -> int:
    """Bytes between two outputs' staged ids: whole 16-byte units, one more
    than the chunk needs, and an odd number of them, so that the quarter
    warps' 16-byte reads fall in distinct banks."""
    units = ceil_div(chunk, 16) + 1
    return 16 * (units + 1 - units % 2)


def plan_gather(b: int, s: int, k: int, cout: int) -> GatherPlan:
    """Plan of ``pq_fc`` for a LUT (b, s, k) and ids (cout, s), k <= 256."""
    rows = next(r for r in GATHER_ROWS if r >= min(b, GATHER_ROWS[-1]))
    outputs = GATHER_THREADS * (2 if cout > GATHER_THREADS else 1)
    # a row's chunk (chunk * k floats) fits the staged row; whole 16-id
    # groups where the row allows
    chunk = max(1, min(GATHER_MAX_CHUNK, GATHER_LUT_ROW // k, s))
    if chunk >= 16:
        chunk -= chunk % 16
    out_tiles, b_tiles = ceil_div(cout, outputs), ceil_div(b, rows)
    n_chunks = ceil_div(s, chunk) if s else 0
    splits, per_split = split_contraction(out_tiles * b_tiles,
                                          max(1, n_chunks))
    stage = rows * GATHER_LUT_ROW * 4 + outputs * gather_id_pitch(chunk)
    stages = max(2, min(GATHER_MAX_STAGES, SMEM_LIMIT // stage, per_split))
    return GatherPlan(rows, outputs, chunk, splits, per_split, stages,
                      (out_tiles, b_tiles, splits), stages * stage,
                      splits * b * cout * 4 if splits > 1 else 0)


# ---- pq_lut_gather: the small-batch LUT gather -----------------------------

LUTG_THREADS = 256         # 8 warps a block
LUTG_WARPS = LUTG_THREADS // 32
LUTG_ROWS = (1, 2, 4, 8)   # batch rows a block: the instantiations
LUTG_OUTPUTS = (256, 128, 64, 32)   # outputs a block: 32 a warp
LUTG_UNIT = 16             # ids a 16-byte load: S is split in such units
LUTG_SPLITS = 8            # blocks along S where the grid is wide enough
LUTG_MIN_UNITS = 4         # units a block, at least, where S is split
LUTG_MIN_BLOCKS = SM_COUNT * 3 // 4   # a grid under this is widened


@dataclass(frozen=True)
class LutGatherPlan:
    variant: str           # "staged" or "general"
    rows: int              # batch rows per block
    outputs: int           # outputs per block
    groups: int            # warps that share an output: sub-ranges of a
                           # block's range, 8 warps / (outputs / 32)
    splits: int            # blocks that share one output tile's sum over S
    units_per_split: int   # 16-id units of S a block owns
    grid: tuple[int, int, int]   # (output tiles, batch tiles, splits)
    smem_bytes: int        # dynamic shared memory of a block
    workspace_bytes: int   # float32 partial sums that a second launch adds
                           # up in split order; 0 when splits == 1


def lut_gather_smem(rows: int, units: int, k: int) -> int:
    """A block's shared memory: one partial sum a thread and row, and the
    rows' LUT slices of `units` 16-id units."""
    return (LUTG_THREADS * rows + rows * units * LUTG_UNIT * k) * 4


def plan_lut_gather(b: int, s: int, k: int, cout: int) -> LutGatherPlan:
    """Plan of ``pq_lut_gather`` for a LUT (b, s, k) and ids (cout, s).

    The staged kernel keeps a block's LUT slice in shared memory and reads
    the ids as 16-byte words, so it takes S % 16 == 0 (every id row starts
    16-byte aligned) and K % 4 == 0 (every LUT slice does); every other
    shape runs the general kernel (a warp a (row, output), the LUT left to
    the caches).

    Every block stages its rows' slices, so a launch reads the LUT once an
    output tile: the plan takes the widest tile that still gives about a
    block an SM, 8 blocks along S, and more of them only where the slice
    would not fit or the widest grid is still short.

    Raises ValueError for a batch of more tiles than a launch's grid has
    (65535 tiles of 8 rows; 65535 rows for the general kernel)."""
    rows = next(r for r in LUTG_ROWS if r >= min(b, LUTG_ROWS[-1]))
    # 16-id units of a row's slice that fit beside the partial sums
    fit = ((SMEM_LIMIT - lut_gather_smem(rows, 0, k))
           // (rows * LUTG_UNIT * k * 4))
    staged = not (s == 0 or s % LUTG_UNIT or k % 4 or fit < 1
                  or s // LUTG_UNIT > fit * MAX_GRID_YZ
                  or b * s * k >= 2 ** 31 or cout * s >= 2 ** 31
                  or b * cout >= 2 ** 31)
    b_tiles = ceil_div(b, rows) if staged else b
    if b_tiles > MAX_GRID_YZ:
        raise ValueError(f"pq_lut_gather: a batch of {b} rows is more than "
                         f"one launch takes ({MAX_GRID_YZ} batch tiles of "
                         f"{rows if staged else 1})")
    if not staged:
        return LutGatherPlan("general", 1, LUTG_WARPS, 1, 1, 0,
                             (ceil_div(cout, LUTG_WARPS), b, 1), 0, 0)
    units = s // LUTG_UNIT
    most = max(1, units // LUTG_MIN_UNITS)
    splits = max(ceil_div(units, fit), min(LUTG_SPLITS, most))
    narrowest = ceil_div(cout, LUTG_OUTPUTS[-1]) * b_tiles
    if narrowest * splits < LUTG_MIN_BLOCKS:
        splits = max(splits, min(most, ceil_div(LUTG_MIN_BLOCKS, narrowest)))
    per_split = ceil_div(units, min(splits, MAX_GRID_YZ))
    splits = ceil_div(units, per_split)     # no empty split
    outputs = next((o for o in LUTG_OUTPUTS
                    if ceil_div(cout, o) * b_tiles * splits
                    >= LUTG_MIN_BLOCKS), LUTG_OUTPUTS[-1])
    return LutGatherPlan(
        "staged", rows, outputs, LUTG_WARPS * 32 // outputs, splits,
        per_split, (ceil_div(cout, outputs), b_tiles, splits),
        lut_gather_smem(rows, per_split, k),
        splits * b * cout * 4 if splits > 1 else 0)


# ---- pq_decode: one item of a (grouped) launch ----------------------------

DECODE_UNITS = 1024        # 16-byte vectors a block of the vector kernel
DECODE_ELEMENTS = 256      # elements a block of the general kernel
DECODE_MAX_ITEMS = 16      # items a launch


@dataclass(frozen=True)
class DecodePlan:
    variant: str           # "vector" or "general"
    units: int             # 16-byte vectors (vector) or elements (general)
    blocks: int            # blocks of the launch that this item owns
    ids_per_vector: int    # ids a thread reads for one vector; 0 for general


def plan_decode(n: int, s: int, k: int, d: int, row_len: int,
                elem_bytes: int, *, vector: bool = True) -> DecodePlan:
    """Plan of one ``pq_decode`` item: ids (n, s), codebooks (s, k, d) of
    ``elem_bytes``-byte elements, rows cut to ``row_len`` columns.

    The vector kernel writes 16 bytes a thread. It takes rows that are
    whole 16-byte vectors (so every row starts aligned and no vector cuts a
    codeword short) with a codeword of a power of two of bytes (2, 4 or 8:
    several to a vector; 16 or more: a vector is a piece of one), and sizes
    it can index with 32 bits. ``vector=False`` plans the general
    kernel (one element a thread), which takes every shape."""
    cw, row_bytes = d * elem_bytes, row_len * elem_bytes
    if (vector and row_bytes % 16 == 0 and cw >= 2 and cw & (cw - 1) == 0
            and n * s < 2 ** 31 and s * k * cw < 2 ** 31
            and n * row_bytes // 16 < 2 ** 31):
        units = n * row_bytes // 16
        return DecodePlan("vector", units, ceil_div(units, DECODE_UNITS),
                          max(1, 16 // cw))
    units = n * row_len
    return DecodePlan("general", units, ceil_div(units, DECODE_ELEMENTS), 0)


# ---- lrn_fused -------------------------------------------------------------

LRN_THREADS = 256          # threads a block, both kernels
LRN_VECTORS = 4            # 16-byte vectors a thread of the register kernel
LRN_RADII = (1, 2, 3)      # window radii the register kernel is built for


@dataclass(frozen=True)
class LrnPlan:
    variant: str           # "register" or "general"
    vectors: int           # 16-byte vectors a thread
    blocks: int
    smem_bytes: int        # dynamic shared memory of a block


def plan_lrn(n: int, c: int, radius: int, elem_bytes: int) -> LrnPlan:
    """Plan of ``lrn_fused`` for n elements of ``elem_bytes`` bytes in rows
    of c channels, window radius ``radius``.

    The register kernel keeps the window in registers and takes the
    neighbours from the adjacent lanes: it is built for radii 1 to 3, takes
    rows that are whole 16-byte vectors (a vector never crosses a channel
    edge) and indexes vectors with 32 bits. Every other shape runs the
    general kernel, whose window goes through shared memory."""
    v = 16 // elem_bytes
    if radius in LRN_RADII and c % v == 0 and n < 2 ** 31:
        return LrnPlan("register", LRN_VECTORS,
                       ceil_div(n // v, LRN_THREADS * LRN_VECTORS), 0)
    slots = LRN_THREADS * v + 2 * radius
    return LrnPlan("general", 1, ceil_div(n, LRN_THREADS * v),
                   (slots + slots // 32 + 1) * 4)
