"""Swin Transformer with product-quantized projection GEMMs.

Swin (Liu et al., ICCV 2021, arXiv:2103.14030) as the port's third model
family, beside ResNet and ViT, in the shape of ``models/vit.py`` and built
from the parts it shares with ViT (``models/transformer.py``): every
weight matrix (the patch embedding, each block's qkv, out and two MLP
matrices, each patch merging's reduction and the head) is a (Cin, Cout)
GEMM with the PQ data model of the FC layers, reached through
``ops.fc.fc_layer``. The JAX package has no Swin; the benchmark's plain
reference (``bench_cuda/reference/swin.py``) is what the tests hold it to.

Parameters are a nested dict: "patch_embed" (4x4x3 patches -> C),
"patch_norm", "s{i}b{j}" for block j of stage i (a dict of "ln1", "qkv",
"rel_table" ((2w-1)^2, heads), "out", "ln2", "mlp1", "mlp2"), "s{i}merge"
after every stage but the last ({"norm" over 4C, "reduction" 4C -> 2C,
whose bias is zero: the published layer has none}), "ln_final" and
"head". Activations are (B, tokens, C) with the tokens of the stage's
square grid in row-major order; the input image is NHWC.

A block is pre-norm: LayerNorm, window attention, the out projection and
a residual add, LayerNorm, the MLP with the exact erf GELU and a residual
add. Its tokens are split into windows of w x w; odd blocks first roll the
grid cyclically by -w/2 on both axes (``torch.roll``) and roll it back
after, and mask with -100 the pairs of tokens that came from different
regions of the grid (:func:`shift_mask`, built as the published code
builds it). Where a stage's grid is no larger than the window, its blocks
neither shift nor split and the window is the grid (Swin's rule,
:func:`window_rule`). Every attention adds a per-head relative-position
bias, gathered once in :func:`prepare_params` from the block's table by
:func:`relative_position_index` into (heads, N, N). Between stages the
patch merging concatenates each 2x2 neighbourhood in the order x[0::2,
0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2], then LayerNorm(4C)
and the reduction. The head: a final LayerNorm, the mean over the tokens,
the classifier.

Attention (:func:`_window_attention`) takes the qkv projection's output on
the block's (rolled) grid and returns its output on the grid. On a bf16
CUDA tensor with a head dimension of 32 and at most 144 tokens a window
(:func:`window_attention_route`) it is one launch of the
``window_attention_fused`` kernel (``ops/cuda/window_attention_fused.py``),
which does the window partition, the head split and merge and the window
reverse through its addressing; everywhere else (the CPU, other dtypes,
larger windows) it is :func:`window_attention_plain`, the materialized
chain between :func:`window_partition` and :func:`window_reverse`. Both
round where the chain rounds, in bf16:

- q, k and v are the bf16 output of the qkv projection;
- the logits are float32: q k^T summed in float32 and divided by
  sqrt(head dim) in float32 (``transformer.logits`` with float32 logits),
  never rounded to bf16;
- the relative-position bias, plus the -100 mask in a shifted block (the
  two summed first, a (windows, heads, N, N) float32 tensor), is added to
  the logits in float32;
- the softmax runs in float32 and its probabilities are rounded once to
  the activation dtype;
- the value product sums in float32 and emits the activation dtype.

The qkv projection runs on the rolled grid before any window partition,
and the out projection after the shift back: a product that treats every
token alike commutes with those permutations, so the residual add joins
the out projection's epilogue, as in ViT.

In memory mode each projection is routed by ``common.fc_memory_impl`` on
its rows (B x tokens); a block's projections that decode in the step are
decoded together in one ``pq_decode`` launch at its head. int8
(``prepare_params(dtype=torch.int8)``) runs the int8 fc with bf16
activations, as ViT does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qcnn_tpu_torch._device import resolve_device
from qcnn_tpu_torch.models import vit
from qcnn_tpu_torch.models.common import make_cast as _make_cast
from qcnn_tpu_torch.models.transformer import (
    block_projections,
    gemm_params,
    layernorm,
    ln_params,
    logits,
    prepare_tree,
    proj,
    relative_position_index,
)
from qcnn_tpu_torch.ops import fc as fc_ops
from qcnn_tpu_torch.ops.cuda import window_attention_fused as wa_kernel
from qcnn_tpu_torch.utils.spans import span

MASK_VALUE = -100.0  # the published shift mask's value for a masked pair
LN_EPS = 1e-5  # every LayerNorm's: torch's default, which Swin's take


@dataclasses.dataclass(frozen=True)
class SwinSpec:
    name: str
    patch: int = 4
    image_size: int = 224
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    heads: tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: int = 4
    num_classes: int = 1000

    @property
    def grid(self) -> int:
        """Tokens along each side of stage 0's grid."""
        return self.image_size // self.patch

    @property
    def final_dim(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


def swin_l384() -> SwinSpec:
    """Swin-L, patch 4, window 12, at 384x384 (the 22k-to-1k fine-tune:
    timm ``swin_large_patch4_window12_384``)."""
    return SwinSpec("Swin-L/4-w12@384", patch=4, image_size=384,
                    embed_dim=192, depths=(2, 2, 18, 2),
                    heads=(6, 12, 24, 48), window=12)


def swin_tiny_test() -> SwinSpec:
    """Miniature config for CPU tests: grids 16, 8, 4 and 2 with window 4,
    so stages 0-1 shift and mask, stage 2 is one window and stage 3 takes
    the window of its smaller grid."""
    return SwinSpec("Swin-test", patch=4, image_size=64, embed_dim=32,
                    depths=(2, 2, 2, 2), heads=(2, 4, 8, 16), window=4,
                    num_classes=10)


SWINS = {"swin_l384": swin_l384}


@dataclasses.dataclass(frozen=True)
class Block:
    """Where one block sits: its params' key, stage, width, heads, grid
    side, window side and cyclic shift."""
    key: str
    stage: int
    dim: int
    heads: int
    grid: int
    window: int
    shift: int


def window_rule(grid: int, window: int) -> tuple[int, int]:
    """(window, shift of the odd blocks) of a stage: Swin's rule, where a
    grid no larger than the window takes the grid as its window and does
    not shift."""
    if grid <= window:
        return grid, 0
    return window, window // 2


def block_layout(spec: SwinSpec) -> list:
    """Every :class:`Block` in forward order."""
    out = []
    for i, depth in enumerate(spec.depths):
        grid = spec.grid // 2 ** i
        window, shift = window_rule(grid, spec.window)
        for j in range(depth):
            out.append(Block(f"s{i}b{j}", i, spec.embed_dim * 2 ** i,
                             spec.heads[i], grid, window,
                             shift if j % 2 else 0))
    return out


# ---------------------------------------------------------------------------
# Windows, shift mask, relative-position index
# ---------------------------------------------------------------------------

def _roll(x, shift: int):
    """(B, G, G, C) rolled cyclically by ``shift`` on both grid axes."""
    return torch.roll(x, (shift, shift), (1, 2)) if shift else x


def window_partition(x, window: int, partition: str = "block"):
    """(B, G, G, C) -> (B x windows, window^2, C), windows in row-major
    order within each image and tokens row-major within each window.

    partition: "block", contiguous window x window squares (Swin), or
      "grid", MaxViT's grid partition: window (a, b) holds the tokens at
      row i (G / window) + a, column j (G / window) + b, token (i, j)."""
    b, g, _, c = x.shape
    n = g // window
    if partition == "grid":
        return x.view(b, window, n, window, n, c).permute(
            0, 2, 4, 1, 3, 5).reshape(-1, window * window, c)
    return x.view(b, n, window, n, window, c).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(o, window: int, grid: int, partition: str = "block"):
    """(B x windows, heads, window^2, head dim), the attention's output,
    -> (B, G, G, heads x head dim): the heads merged and the windows put
    back on the grid (by ``partition``, as :func:`window_partition`) in
    one copy."""
    bw, heads, _, hd = o.shape
    n = grid // window
    b = bw // (n * n)
    o = o.view(b, n, n, heads, window, window, hd)
    if partition == "grid":
        return o.permute(0, 4, 1, 5, 2, 3, 6).reshape(b, grid, grid,
                                                      heads * hd)
    return o.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, grid, grid, heads * hd)


def shift_mask(grid: int, window: int, shift: int) -> torch.Tensor:
    """(windows, N, N) float32: -100 where two tokens of a shifted window
    came from different regions of the rolled grid, else 0. The regions
    are the published ones: the grid's rows and columns cut at -window and
    -shift, numbered row-major."""
    img = torch.zeros(1, grid, grid, 1)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    region = 0
    for h in cuts:
        for w in cuts:
            img[:, h, w, :] = region
            region += 1
    ids = window_partition(img, window).view(-1, window * window)
    diff = ids[:, None, :] - ids[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def _window_bias(blk) -> torch.Tensor:
    """The block's additive attention bias: its relative-position bias
    (heads, N, N), plus the shift mask as (windows, heads, N, N) in a
    shifted block; float32."""
    mask = blk.get("shift_mask")
    if mask is None:
        return blk["rel_bias"]
    return blk["rel_bias"] + mask[:, None]


def merge_gather(x):
    """(B, G, G, C) -> (B, G^2 / 4, 4C): each 2x2 neighbourhood's tokens
    concatenated in the published order (0, 0), (1, 0), (0, 1), (1, 1) of
    (row, column) offsets."""
    b, _, _, c = x.shape
    return torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                      x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1).view(
                          b, -1, 4 * c)


# ---------------------------------------------------------------------------
# Parameters (NumPy)
# ---------------------------------------------------------------------------

def init_dense_params(spec: SwinSpec, seed: int = 0) -> dict:
    """Dense float32 params, drawn as ``vit.init_dense_params`` draws its
    GEMMs (N(0, 1/Cin) weights, zero biases) and LayerNorms; the
    relative-position tables N(0, 0.02^2), Swin's own init."""
    rng = np.random.default_rng(seed)
    c = spec.embed_dim
    params: dict = {"patch_embed": gemm_params(rng, spec.patch ** 2 * 3, c),
                    "patch_norm": ln_params(c)}
    for blk in block_layout(spec):
        d = blk.dim
        params[blk.key] = {
            "ln1": ln_params(d),
            "qkv": gemm_params(rng, d, 3 * d),
            "rel_table": (rng.standard_normal(
                ((2 * blk.window - 1) ** 2, blk.heads)) * 0.02).astype(
                    np.float32),
            "out": gemm_params(rng, d, d),
            "ln2": ln_params(d),
            "mlp1": gemm_params(rng, d, spec.mlp_ratio * d),
            "mlp2": gemm_params(rng, spec.mlp_ratio * d, d),
        }
    for i in range(len(spec.depths) - 1):
        d = spec.embed_dim * 2 ** i
        params[f"s{i}merge"] = {"norm": ln_params(4 * d),
                                "reduction": gemm_params(rng, 4 * d, 2 * d)}
    params["ln_final"] = ln_params(spec.final_dim)
    params["head"] = gemm_params(rng, spec.final_dim, spec.num_classes)
    return params


# PQ every GEMM as ViT does (plain k-means, NumPy params out); the
# LayerNorms and the relative-position tables stay dense
quantize_params = vit.quantize_params


def _gemm_cin_map(spec: SwinSpec) -> dict:
    """True Cin of every GEMM, keyed "patch_embed", "s{i}b{j}.qkv", ...,
    "s{i}merge.reduction", "head"."""
    m = {"patch_embed": spec.patch ** 2 * 3, "head": spec.final_dim}
    for blk in block_layout(spec):
        for name in ("qkv", "out", "mlp1"):
            m[f"{blk.key}.{name}"] = blk.dim
        m[f"{blk.key}.mlp2"] = spec.mlp_ratio * blk.dim
    for i in range(len(spec.depths) - 1):
        m[f"s{i}merge.reduction"] = 4 * spec.embed_dim * 2 ** i
    return m


def prepare_params(spec: SwinSpec, params: dict, dtype=torch.bfloat16, *,
                   memory: bool = False, device=None) -> dict:
    """The nested params on the device, ready for :func:`forward`: the
    GEMMs, LayerNorms and dtypes by ``vit.prepare_params``' rules, and in
    each block the relative-position table replaced by its gathered bias
    "rel_bias" (heads, N, N) float32, plus "shift_mask" (windows, N, N)
    float32 in a shifted block (one tensor a stage).

    dtype: torch.float32, torch.bfloat16 or torch.int8; device: None
    means "cuda"; pass "cpu" to prepare for the CPU."""
    device = resolve_device(device)
    out = prepare_tree(params, _gemm_cin_map(spec), dtype, memory=memory,
                           device=device, who="swin.prepare_params")
    masks = {}
    for blk in block_layout(spec):
        p = out[blk.key]
        table = p.pop("rel_table")
        n = blk.window ** 2
        if tuple(table.shape) != ((2 * blk.window - 1) ** 2, blk.heads):
            raise ValueError(
                f"{blk.key}.rel_table: shape {tuple(table.shape)}, but a "
                f"window of {blk.window} with {blk.heads} heads takes "
                f"({(2 * blk.window - 1) ** 2}, {blk.heads})")
        index = relative_position_index(blk.window).to(device)
        p["rel_bias"] = table[index.view(-1)].view(n, n, -1).permute(
            2, 0, 1).contiguous()
        if blk.shift:
            geo = (blk.grid, blk.window, blk.shift)
            if geo not in masks:
                masks[geo] = shift_mask(*geo).to(device)
            p["shift_mask"] = masks[geo]
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params: dict, x, *, spec: SwinSpec, compute_dtype=None,
            with_softmax: bool = False, device=None) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, num_classes) float32 logits (or
    probabilities).

    compute_dtype: activation dtype between layers; None keeps x's dtype.
    device: None means "cuda"; pass "cpu" to run the plain versions. The
      params must already be there (``prepare_params(device=...)``)."""
    with span("forward"):
        device = resolve_device(device)
        x = torch.as_tensor(x, device=device)
        for _, fn in forward_segments(spec, compute_dtype=compute_dtype,
                                      with_softmax=with_softmax):
            x = fn(x, params)
        return x


def forward_segments(spec: SwinSpec, *, compute_dtype=None,
                     with_softmax: bool = False):
    """[(name, fn(x, params) -> x)] whose composition is the forward on
    tensors already on the params' device: "embed", one per block
    ("s{i}b{j}"), one per patch merging ("s{i}merge"), "head"."""
    cast = _make_cast(compute_dtype)
    segs = [("embed", lambda x, p: _run_embed(x, p, spec, cast))]
    layout = block_layout(spec)
    for n, blk in enumerate(layout):
        segs.append((blk.key, lambda x, p, blk=blk: _run_block(
            x, p[blk.key], blk, spec, cast)))
        last_of_stage = n + 1 == len(layout) or layout[n + 1].stage != \
            blk.stage
        if last_of_stage and blk.stage < len(spec.depths) - 1:
            key = f"s{blk.stage}merge"
            segs.append((key, lambda x, p, blk=blk, key=key: _run_merge(
                x, p[key], blk, spec, cast)))
    segs.append(("head", lambda x, p: _run_head(x, p, spec, with_softmax)))
    return segs


def _run_embed(x, params, spec, cast):
    """The input cast, the patch embedding (patches in (row, col, channel)
    order through the GEMM) and its LayerNorm."""
    with span("embed"):
        x = cast(x)
        b, h, w, c = x.shape
        p = spec.patch
        x = x.reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), -1)
        x = proj(x, params["patch_embed"], out_dtype=cast.dtype)
        return layernorm(x, params["patch_norm"], LN_EPS)


def window_attention_route(device: torch.device, dtype: torch.dtype,
                           hd: int, n: int, partition: str = "block") -> str:
    """The form :func:`_window_attention` (and MaxViT's block and grid
    attention) takes: ``"kernel"`` (``window_attention_fused``) for bf16
    qkv on a CUDA device with a head dimension the kernel is compiled for
    and windows of at most its ``MAX_TOKENS`` tokens (n = window²), of
    either ``partition`` ("block" or "grid", both compiled in), else
    ``"plain"`` (the window partition, the materialized chain and the
    window reverse: the CPU, float32, other head dimensions, larger
    windows)."""
    if (device.type == "cuda" and dtype == torch.bfloat16
            and hd in wa_kernel.HEAD_DIMS and n <= wa_kernel.MAX_TOKENS
            and partition in wa_kernel.PARTITIONS):
        return "kernel"
    return "plain"


def window_attention_plain(qkv, bias, *, heads: int, window: int,
                           out_dtype=None, partition: str = "block"):
    """(B, G, G, 3C) qkv on a block's (rolled) grid and the block's bias
    (:func:`_window_bias`) -> (B, G, G, C) in ``out_dtype`` (float32 when
    None), as a chain: the window partition (by ``partition``, as
    :func:`window_partition`), float32 logits plus the bias, a float32
    softmax, the probabilities in qkv's dtype, the product with v, the
    window reverse with the heads merged. The kernel's function."""
    grid = qkv.shape[1]
    x = window_partition(qkv, window, partition)  # (B x windows, N, 3C)
    bw, n, c3 = x.shape
    hd = c3 // (3 * heads)
    q, k, v = x.view(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    att = logits(q, k.transpose(-1, -2), hd, torch.float32)
    windows = bias.shape[0] if bias.dim() == 4 else 1
    att.view(-1, windows, heads, n, n).add_(bias)
    probs = torch.softmax(att, dim=-1, dtype=torch.float32)
    del att
    o = fc_ops.matmul(probs.to(v.dtype), v, out_dtype)
    return window_reverse(o, window, grid, partition)


def _window_attention(qkv, bias, geo: Block, out_dtype):
    """:func:`window_attention_plain`'s function on the route's form."""
    hd = qkv.shape[-1] // (3 * geo.heads)
    kw = {"heads": geo.heads, "window": geo.window, "out_dtype": out_dtype}
    if window_attention_route(qkv.device, qkv.dtype, hd,
                              geo.window ** 2) == "kernel":
        return wa_kernel.window_attention_fused(qkv, bias, **kw)
    return window_attention_plain(qkv, bias, **kw)


def _run_block(x, blk, geo: Block, spec: SwinSpec, cast):
    """One Swin block on (B, G^2, C). The projections that decode their
    weight in the step do so in one ``pq_decode`` launch at the head of
    the block; the two residual adds and the GELU run in the epilogues of
    out, mlp2 and mlp1."""
    b = x.shape[0]
    key, od = geo.key, cast.dtype
    run = block_projections(x, blk, od, key)

    with span("layernorm", key, "ln1"):
        y = layernorm(x, blk["ln1"], LN_EPS)
    with span("window", key, "partition"):
        y = _roll(y.view(b, geo.grid, geo.grid, -1), -geo.shift)
        y = y.reshape(b, -1, y.shape[-1])  # the rolled grid's tokens
    qkv = run(y, "qkv")
    with span("attention", key):
        o = _window_attention(qkv.view(b, geo.grid, geo.grid, -1),
                              _window_bias(blk), geo, od)
    with span("window", key, "reverse"):
        o = cast(_roll(o, geo.shift).reshape(b, -1, geo.dim))
    x = run(o, "out", residual=x)
    with span("layernorm", key, "ln2"):
        y = layernorm(x, blk["ln2"], LN_EPS)
    y = run(y, "mlp1", act="gelu")
    return run(y, "mlp2", residual=x)


def _run_merge(x, mp, geo: Block, spec: SwinSpec, cast):
    """The patch merging after stage ``geo.stage``: the 2x2 gather and its
    LayerNorm, then the reduction (its own decode where it decodes in the
    step)."""
    b, _, c = x.shape
    with span("merge", f"s{geo.stage}"):
        y = merge_gather(x.view(b, geo.grid, geo.grid, c))
        y = layernorm(y, mp["norm"], LN_EPS)
    with span("fc", f"s{geo.stage}", "reduction"):
        return proj(y, mp["reduction"], out_dtype=cast.dtype)


def _run_head(x, params, spec, with_softmax: bool):
    with span("layernorm", "final"):
        x = layernorm(x, params["ln_final"], LN_EPS)
    with span("pool", "head"):
        x = x.mean(dim=1, dtype=torch.float32).to(x.dtype)
    with span("fc", "head"):
        z = proj(x, params["head"], out_dtype=torch.float32)
    if with_softmax:
        with span("softmax", "head"):
            z = torch.softmax(z, dim=-1)
    return z
