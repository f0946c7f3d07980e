"""MaxViT with product-quantized convolutions and projections.

MaxViT (Tu et al., ECCV 2022, arXiv:2204.01697) as the port's fourth model
family, beside ResNet, ViT and Swin, at the widths and in the form of
timm's ``maxvit_*_tf`` models (the TF original's: tanh GELU, TF 'same'
padding, BatchNorm eps 1e-3, the ``bias_tf`` relative-position bias). Its
block holds three mixers in a row: an MBConv, block attention over the
P x P windows of the map and grid attention over a P x P grid dilated
across the whole map. It is built from the parts it shares with ResNet
(the conv seam ``ops.conv.conv_layer``, ``resnet.fold_batchnorm``) and
with ViT and Swin (``models/transformer.py``, Swin's window attention and
its ``window_attention_fused`` kernel). The JAX package has no MaxViT; the
benchmark's plain reference (``bench_cuda/reference/maxvit.py``) is what
the tests hold it to.

Parameters are a nested dict: "stem" ({"conv1": 3x3 stride-2 conv 3 -> S,
"conv2": 3x3 conv S -> S}), "s{i}b{j}" for block j of stage i ({"mbconv",
"block", "grid"}) and "head" ({"norm", "pre", "fc"}). Activations are NHWC;
the partition blocks read them as (B, H x W, C), the same memory. Every
BatchNorm is folded at load (:func:`init_dense_params`), so the served
params hold none:

- the stem: conv1 (with bias) and BatchNorm (folded into conv1), the tanh
  GELU, conv2 (with bias). 384 -> 192;
- an MBConv ("mbconv": "proj" in a stage's first block, "conv1", "dw",
  "se1", "se2", "conv3"), in -> out = C, mid = 4C, SE width C/4:
  shortcut = x, or in the first block of a stage (stride 2) the 2x2
  average pool and the 1x1 conv "proj" (with bias); y = GELU(BN1(conv1(
  BN0(x)))) with both BatchNorms folded into conv1 (BN0 on the input side,
  exact for a 1x1 conv without padding); y = GELU(BN2(dw(y))), the 3x3
  depthwise conv with the block's stride, BN2 folded; y = y x sigmoid(se2(
  SiLU(se1(mean_hw(y))))); out = conv3(y) + shortcut, the add in conv3's
  epilogue;
- a partition block ("block", then "grid"), pre-norm: x = x + out(attn(
  LN1(x))), x = x + mlp2(GELU(mlp1(LN2(x)))), LayerNorm eps 1e-5; the
  attention's windows are the P x P squares of the map ("block") or the
  P x P grid whose window (a, b) holds the tokens at row i (H / P) + a,
  column j (W / P) + b ("grid"), 32 channels a head, plus a per-head
  relative-position bias gathered once in :func:`prepare_params` from the
  block's (heads, 2P - 1, 2P - 1) table;
- the head: the mean over the map, LayerNorm, "pre" (C -> C) and tanh,
  "fc" (C -> classes).

Every GELU is the tanh form (``gelu_tanh``), in the epilogue of the
product before it (``ops.fc.emit``). A 3x3 stride-2 conv pads as
TensorFlow's 'same' does, none before and one pixel after
(``ops.conv.same_pad``).

PQ: the 1x1 convs and the stem's conv2 are PQ convs (the conv quantizer at
ResNet's geometry, K=128, D=4); the projections, the squeeze-excite and the
head are PQ GEMMs (K=32, D=4). The stem's conv1 (3 input channels) and the
depthwise convs (one input channel a group, no sub-vector to quantize)
stay dense, and stay bf16 under int8, which has no grouped int8 conv.

In memory mode each PQ conv runs ``ops.conv.memory_fused_route``'s pick
and each PQ GEMM ``common.fc_memory_impl``'s, decided once at the head of
the MBConv (or of the partition block, or of the head) from its input; the
layers of one that decode in the step are decoded together in one
``pq_decode`` launch there. The attention of a partition block takes
``swin.window_attention_route``: on the card, bf16 qkv goes to one
``window_attention_fused`` launch, which reads the windows of either
partition in place on the map.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from qcnn_tpu_torch._device import resolve_device
from qcnn_tpu_torch.core import is_pq
from qcnn_tpu_torch.models import common, resnet, swin
from qcnn_tpu_torch.models.common import make_cast as _make_cast
from qcnn_tpu_torch.models.prepare import (
    _cast_pq,
    _decode_rows_np,
    _is_int8,
    _np,
    _tensor,
    dense_layer,
)
from qcnn_tpu_torch.models.transformer import (
    block_projections,
    gemm_params,
    layernorm,
    ln_params,
    relative_position_index,
)
from qcnn_tpu_torch.ops import conv as conv_ops
from qcnn_tpu_torch.ops import fc as fc_ops
from qcnn_tpu_torch.ops.cuda import window_attention_fused as wa_kernel
from qcnn_tpu_torch.quantizer.kmeans import split
from qcnn_tpu_torch.quantizer.opq import inverse_permutation
from qcnn_tpu_torch.quantizer.pq import quantize_conv_layer, quantize_fc_layer
from qcnn_tpu_torch.utils.spans import span

BN_EPS = 1e-3  # the TF original's BatchNorm eps, which timm's _tf_cfg takes
LN_EPS = 1e-5  # every LayerNorm's
ACT = "gelu_tanh"
PARTS = ("block", "grid")
# every MaxViT's: 32 channels a head, an MBConv 4x as wide as its block,
# a squeeze-excite a quarter as wide, a 4x MLP, the pre-logits as wide as
# the last stage
HEAD_DIM = 32
EXPAND = 4
SE_DIVISOR = 4
MLP_RATIO = 4


@dataclasses.dataclass(frozen=True)
class MaxViTSpec:
    name: str
    image_size: int = 224
    stem_width: int = 64
    dims: tuple[int, ...] = (64, 128, 256, 512)
    depths: tuple[int, ...] = (2, 2, 5, 2)
    partition: int = 7  # window side P of both partitions
    num_classes: int = 1000


def maxvit_l384() -> MaxViTSpec:
    """MaxViT-L at 384x384 (timm ``maxvit_large_tf_384``): widths 128-1024,
    depths 2, 6, 14, 2, head dimension 32, partition 12."""
    return MaxViTSpec("MaxViT-L@384", image_size=384, stem_width=128,
                      dims=(128, 256, 512, 1024), depths=(2, 6, 14, 2),
                      partition=12)


def maxvit_tiny_test() -> MaxViTSpec:
    """Miniature config for CPU tests: 128x128, partition 4, grids 32, 16,
    8 and 4 (block and grid windows differ in stages 0-2 and coincide in
    stage 3), widths multiples of 32 for 32 channels a head."""
    return MaxViTSpec("MaxViT-test", image_size=128, stem_width=32,
                      dims=(32, 64, 96, 128), depths=(2, 2, 2, 2),
                      partition=4, num_classes=10)


MAXVITS = {"maxvit_l384": maxvit_l384}


@dataclasses.dataclass(frozen=True)
class Block:
    """Where one block sits: its params' key, stage, input and output
    widths, MBConv and squeeze-excite widths, stride, heads, the map's side
    at its output, and the partition's window side."""
    key: str
    stage: int
    cin: int
    dim: int
    mid: int
    se: int
    stride: int
    heads: int
    grid: int
    window: int


def block_layout(spec: MaxViTSpec) -> list:
    """Every :class:`Block` in forward order; the first block of every
    stage has stride 2."""
    out, cin, grid = [], spec.stem_width, -(-spec.image_size // 2)
    for i, (dim, depth) in enumerate(zip(spec.dims, spec.depths)):
        if dim % HEAD_DIM:
            raise ValueError(f"width {dim} does not split into heads of "
                             f"{HEAD_DIM}")
        for j in range(depth):
            stride = 2 if j == 0 else 1
            g = -(-grid // stride)
            if g % spec.partition:
                raise ValueError(f"stage {i}: a map of {g} does not split "
                                 f"into partitions of {spec.partition}")
            out.append(Block(f"s{i}b{j}", i, cin, dim, EXPAND * dim,
                             dim // SE_DIVISOR, stride, dim // HEAD_DIM, g,
                             spec.partition))
            cin, grid = dim, g
    return out


def parameter_count(spec: MaxViTSpec) -> int:
    """Parameters of the published model by their shapes: every conv,
    BatchNorm (scale and shift), squeeze-excite, LayerNorm, projection,
    relative-position table and the head, before the folds."""
    s = spec.stem_width
    n = 27 * s + s + 2 * s + 9 * s * s + s
    for blk in block_layout(spec):
        c, m, r = blk.dim, blk.mid, blk.se
        if blk.stride == 2:
            n += blk.cin * c + c
        n += 2 * blk.cin + blk.cin * m + 2 * m + 9 * m + 2 * m
        n += m * r + r + r * m + m + m * c + c
        n += 2 * (2 * c + 3 * c * c + 3 * c + blk.heads
                  * (2 * blk.window - 1) ** 2 + c * c + c + 2 * c
                  + 2 * MLP_RATIO * c * c + MLP_RATIO * c + c)
    f = spec.dims[-1]
    return n + 2 * f + f * f + f + f * spec.num_classes + spec.num_classes


# ---------------------------------------------------------------------------
# Parameters (NumPy)
# ---------------------------------------------------------------------------

def _bn(rng, c):
    """An inference BatchNorm's (gamma, beta, mean, var), drawn near the
    identity so that each fold moves the weights."""
    return ((1 + 0.05 * rng.standard_normal(c)).astype(np.float32),
            (0.02 * rng.standard_normal(c)).astype(np.float32),
            (0.02 * rng.standard_normal(c)).astype(np.float32),
            (1 + 0.05 * np.abs(rng.standard_normal(c))).astype(np.float32))


def fold_batchnorm_in(conv: dict, gamma, beta, mean, var,
                      eps=BN_EPS) -> dict:
    """Fold an inference BatchNorm on a 1x1 conv's input into it (NumPy):
    W'[i, o] = W[i, o] s[i], b' = b + sum_i W[i, o] t[i] with s =
    gamma / sqrt(var + eps) and t = beta - mean s. Exact for a 1x1 conv
    without padding: no zero-padded pixel bypasses the norm."""
    k = np.asarray(conv["kernel"], np.float64)
    if k.shape[:2] != (1, 1):
        raise ValueError(f"an input-side fold takes a 1x1 conv, got "
                         f"{k.shape[0]}x{k.shape[1]}")
    s = np.asarray(gamma, np.float64) / np.sqrt(np.asarray(var, np.float64)
                                                + eps)
    t = np.asarray(beta, np.float64) - np.asarray(mean, np.float64) * s
    return {"kernel": (k * s[:, None]).astype(np.float32),
            "bias": (np.asarray(conv["bias"], np.float64)
                     + t @ k[0, 0]).astype(np.float32)}


def init_dense_params(spec: MaxViTSpec, seed: int = 0) -> dict:
    """Dense float32 params with every BatchNorm folded: each conv drawn
    N(0, 1/fan-in) (``resnet``'s draw), each BatchNorm near the identity
    and folded (``resnet.fold_batchnorm`` on a conv's output side,
    :func:`fold_batchnorm_in` on its input side), the GEMMs as
    ``transformer.gemm_params``, the LayerNorms at (1, 0), the
    relative-position tables N(0, 0.02^2) (timm's init)."""
    rng = np.random.default_rng(seed)
    s = spec.stem_width

    def conv(k, cin, cout):
        return resnet._conv_param(rng, k, k, cin, cout)

    def fold_out(p, c):
        return resnet.fold_batchnorm(p, *_bn(rng, c), eps=BN_EPS)

    params: dict = {"stem": {"conv1": fold_out(conv(3, 3, s), s),
                             "conv2": conv(3, s, s)}}
    for blk in block_layout(spec):
        c, m = blk.dim, blk.mid
        mb = {}
        if blk.stride == 2:
            mb["proj"] = conv(1, blk.cin, c)
        pre = _bn(rng, blk.cin)
        mb["conv1"] = fold_out(fold_batchnorm_in(conv(1, blk.cin, m), *pre),
                               m)
        mb["dw"] = fold_out(conv(3, 1, m), m)
        mb["se1"] = gemm_params(rng, m, blk.se)
        mb["se2"] = gemm_params(rng, blk.se, m)
        mb["conv3"] = conv(1, m, c)
        params[blk.key] = {"mbconv": mb}
        for part in PARTS:
            params[blk.key][part] = {
                "ln1": ln_params(c),
                "qkv": gemm_params(rng, c, 3 * c),
                "rel_table": (rng.standard_normal(
                    (blk.heads, 2 * blk.window - 1, 2 * blk.window - 1))
                    * 0.02).astype(np.float32),
                "out": gemm_params(rng, c, c),
                "ln2": ln_params(c),
                "mlp1": gemm_params(rng, c, MLP_RATIO * c),
                "mlp2": gemm_params(rng, MLP_RATIO * c, c),
            }
    f = spec.dims[-1]
    params["head"] = {"norm": ln_params(f),
                      "pre": gemm_params(rng, f, f),
                      "fc": gemm_params(rng, f, spec.num_classes)}
    return params


def quantize_params(spec: MaxViTSpec, dense: dict, *, seed: int = 0,
                    conv_subvec_len: int = 4, conv_codewords: int = 128,
                    fc_subvec_len: int = 4, fc_codewords: int = 32,
                    min_cin: int = 16, device=None) -> dict:
    """Quantize every conv with at least ``min_cin`` input channels a
    group (the 1x1 convs, the stem's conv2) at the conv geometry and every
    GEMM at the FC geometry (plain k-means, NumPy params out); the stem's
    conv1 and the depthwise convs (1 input channel a group), the
    LayerNorms and the relative-position tables stay dense. device: where
    the k-means runs; None means "cuda". One generator seeded with
    ``seed`` is split once per quantized layer, in forward order."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)

    def quant(p):
        if isinstance(p, dict) and "kernel" in p:
            cin, cout = p["kernel"].shape[2:]
            if cin < min_cin:
                return p
            oihw = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
            return quantize_conv_layer(
                split(gen), oihw, p["bias"],
                num_subspaces=-(-cin // conv_subvec_len),
                num_codewords=conv_codewords)
        if isinstance(p, dict) and "weight" in p:
            cin = p["weight"].shape[0]
            return quantize_fc_layer(
                split(gen), np.asarray(p["weight"]).T, p["bias"],
                num_subspaces=-(-cin // fc_subvec_len),
                num_codewords=fc_codewords)
        if isinstance(p, dict):
            return {k: quant(v) for k, v in p.items()}
        return p

    return {name: quant(p) for name, p in dense.items()}


def relative_position_bias(table: torch.Tensor) -> torch.Tensor:
    """(heads, 2w - 1, 2w - 1) table -> (heads, N, N) float32 bias, N =
    w²: timm's ``bias_tf``, where query (qy, qx) and key (ky, kx) read
    table[h, ky - qy + w - 1, kx - qx + w - 1]: Swin's index
    (``transformer.relative_position_index``, query minus key) read from
    the other end of the flattened table."""
    heads, side, _ = table.shape
    w = (side + 1) // 2
    index = side * side - 1 - relative_position_index(w).to(table.device)
    return table.reshape(heads, -1)[:, index].contiguous()


def prepare_params(spec: MaxViTSpec, params: dict, dtype=torch.bfloat16, *,
                   memory: bool = False, device=None) -> dict:
    """The nested params on the device, ready for :func:`forward`.

    Decode at load (memory=False): PQ convs and GEMMs are decoded to dense
    on the host in NumPy (an OPQ permutation folded in by its inverse),
    then cast to ``dtype``, as ``resnet.prepare_params`` and
    ``vit.prepare_params`` hold them. memory=True keeps them compressed
    (codebooks in ``dtype``, bf16 under int8) for the forward to decode in
    the step. The stem's conv1 and the depthwise convs stay dense in
    ``dtype``, bf16 under int8; LayerNorms stay float32; each partition's
    table becomes its gathered bias "rel_bias" (heads, N, N) float32
    (:func:`relative_position_bias`).

    dtype: torch.float32, torch.bfloat16 or torch.int8; device: None
    means "cuda"; pass "cpu" to prepare for the CPU."""
    device = resolve_device(device)
    if not (_is_int8(dtype) or dtype in (torch.float32, torch.bfloat16)):
        raise ValueError(f"maxvit.prepare_params: unsupported dtype {dtype}")
    cb_dtype = torch.bfloat16 if _is_int8(dtype) else dtype

    def prep(p):
        if isinstance(p, dict) and "codebooks" in p:
            if memory:
                return _cast_pq(p, cb_dtype, device)
            cb = _np(p["codebooks"]).astype(np.float32)
            asmt = _np(p["assignments"])
            # every width is a multiple of 4: the sub-vectors span Cin
            cin = cb.shape[0] * cb.shape[2]
            rows = _decode_rows_np(cb, asmt.reshape(-1, asmt.shape[-1]), cin)
            if "perm" in p:
                rows = rows[:, inverse_permutation(_np(p["perm"]))]
            if asmt.ndim == 4:
                return dense_layer("kernel", rows.reshape(
                    *asmt.shape[:3], cin), p["bias"], dtype, device)
            return dense_layer("weight", rows, p["bias"], dtype, device)
        if isinstance(p, dict) and ("kernel_q" in p or "weight_q" in p):
            raise ValueError("maxvit.prepare_params: these params are "
                             "prepared int8 already")
        if isinstance(p, dict) and "kernel" in p:
            k = _np(p["kernel"])
            kdtype = cb_dtype if k.shape[2] < 16 else dtype
            return dense_layer("kernel", k.transpose(3, 0, 1, 2), p["bias"],
                               kdtype, device)
        if isinstance(p, dict) and "weight" in p:
            return dense_layer("weight", _np(p["weight"]).T, p["bias"],
                               dtype, device)
        if isinstance(p, dict):
            return {k: prep(v) for k, v in p.items()}
        return _tensor(_np(p).astype(np.float32), torch.float32, device)

    out = {name: prep(p) for name, p in params.items()}
    for blk in block_layout(spec):
        for part in PARTS:
            p = out[blk.key][part]
            table = p.pop("rel_table")
            side = 2 * blk.window - 1
            if tuple(table.shape) != (blk.heads, side, side):
                raise ValueError(
                    f"{blk.key}.{part}.rel_table: shape {tuple(table.shape)},"
                    f" but a partition of {blk.window} with {blk.heads} "
                    f"heads takes ({blk.heads}, {side}, {side})")
            p["rel_bias"] = relative_position_bias(table)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params: dict, x, *, spec: MaxViTSpec, compute_dtype=None,
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


def forward_segments(spec: MaxViTSpec, *, compute_dtype=None,
                     with_softmax: bool = False):
    """[(name, fn(x, params) -> x)] whose composition is the forward on
    tensors already on the params' device: "stem", one per block
    ("s{i}b{j}": its MBConv and both partition blocks), "head"."""
    cast = _make_cast(compute_dtype)
    segs = [("stem", lambda x, p: _run_stem(x, p["stem"], cast))]
    for blk in block_layout(spec):
        segs.append((blk.key, lambda x, p, blk=blk: _run_block(
            x, p[blk.key], blk, cast)))
    segs.append(("head", lambda x, p: _run_head(x, p["head"], cast,
                                                with_softmax)))
    return segs


def _conv_route(p, shape, dtype) -> str:
    """The memory-mode impl of a stride-1 unpadded PQ conv (a 1x1, or the
    stem's conv2 at pad 1): ``ops.conv.memory_fused_route``'s pick."""
    return conv_ops.memory_fused_route(p, shape, dtype, stride=1,
                                       pad=(p["assignments"].shape[1] // 2))


def _run_stem(x, p, cast):
    """The input cast, conv1 (TF 'same' pad, its BatchNorm folded, the tanh
    GELU in its epilogue) and conv2 (its own decode where it decodes in
    the step)."""
    od = cast.dtype
    with span("conv", "stem", "conv1"):
        x = cast(x)
        x = conv_ops.conv_layer(x, p["conv1"], impl="dense", stride=2,
                                pad=conv_ops.same_pad(3, 2, x.shape[1]),
                                out_dtype=od, act=ACT)
    with span("conv", "stem", "conv2"):
        impl = (_conv_route(p["conv2"], tuple(x.shape), x.dtype)
                if is_pq(p["conv2"]) else "dense")
        return conv_ops.conv_layer(x, p["conv2"], impl=impl, stride=1,
                                   pad=1, out_dtype=od)


def _mbconv_inputs(x, mb, geo: Block, od) -> dict:
    """{layer: (input shape, input dtype)} of one MBConv's PQ-able layers
    (:func:`layer_group`), which follow from its input x (NHWC): conv1
    takes x, proj the 2x2 pool of x, conv3 the gated depthwise output
    (``od``, float32 when None) and the squeeze-excite GEMMs B rows of the
    pooled map in ``od``."""
    b, h, w, _ = x.shape
    inner = od if od is not None else torch.float32
    out = {"conv1": ((b, h, w, geo.cin), x.dtype),
           "conv3": ((b, geo.grid, geo.grid, geo.mid), inner),
           "se1": ((b, geo.mid), inner), "se2": ((b, geo.se), inner)}
    if "proj" in mb:
        out["proj"] = ((b, geo.grid, geo.grid, geo.cin), x.dtype)
    return out


def layer_group(inputs: dict, layers: dict, key: str):
    """``run(v, name, **kw)``, which applies layer ``name`` of ``layers``
    (a conv to 4-D v through ``ops.conv.conv_layer``, stride 1 and pad 0
    unless given; an FC to 2-D v through ``ops.fc.fc_layer``).

    inputs: {name: (input shape, input dtype)}. Each PQ layer's memory-mode
    impl is decided here from its input (a conv's by ``_conv_route``, an
    FC's by ``common.fc_memory_impl`` on its rows), and the layers that
    decode in the step are decoded here in one ``pq_decode`` launch: call
    it at the head of the group. ``run`` raises if v is not the input the
    route was decided for."""
    routes = {}
    for name, (shape, dtype) in inputs.items():
        p = layers[name]
        if is_pq(p):
            impl = (common.fc_memory_impl(shape[0], p, dtype)
                    if len(shape) == 2 else _conv_route(p, shape, dtype))
            routes[name] = (p, impl, shape[-1])
    decoded = conv_ops.instep_decodes(routes)

    def run(v, name, **kw):
        shape, dtype = inputs[name]
        if tuple(v.shape) != shape or v.dtype != dtype:
            raise RuntimeError(
                f"{key}.{name}: input {tuple(v.shape)} {v.dtype}, but its "
                f"route was decided for {shape} {dtype}")
        kw.update(impl=routes[name][1] if name in routes else "dense",
                  decoded=decoded.get(name))
        if v.dim() == 2:
            return fc_ops.fc_layer(v, layers[name], **kw)
        return conv_ops.conv_layer(v, layers[name], **{"stride": 1,
                                                       "pad": 0, **kw})
    return run


def avg_pool2(x):
    """(B, H, W, C) -> (B, H/2, W/2, C): the 2x2 stride-2 average (sums in
    float32 for a bf16 map, rounded once)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1).contiguous()


def _run_mbconv(x, mb, geo: Block, cast):
    """One MBConv on NHWC x. The layers that decode their weight in the
    step do so in one ``pq_decode`` launch at its head; the tanh GELUs and
    the shortcut add run in the convs' epilogues."""
    od, key = cast.dtype, geo.key
    inputs = _mbconv_inputs(x, mb, geo, od)
    run = layer_group(inputs, mb, key)

    def conv(v, name, act=None, residual=None):
        with span("conv", key, name):
            return run(v, name, out_dtype=od, act=act, residual=residual)

    def fc(v, name):
        return run(v, name, out_dtype=torch.float32)

    shortcut = x
    if "proj" in mb:
        with span("pool", key, "shortcut"):
            shortcut = avg_pool2(x)
        shortcut = conv(shortcut, "proj")
    y = conv(x, "conv1", act=ACT)
    with span("dwconv", key):
        y = conv_ops.conv_layer(
            y, mb["dw"], impl="dense", stride=geo.stride,
            pad=conv_ops.same_pad(3, geo.stride, y.shape[1]),
            groups=geo.mid, out_dtype=od, act=ACT)
    with span("se", key):
        y = squeeze_excite(y, fc, inputs["se1"][1])
    return conv(y, "conv3", residual=shortcut)


def squeeze_excite(y, fc, inner):
    """y (B, H, W, mid) scaled by its gate sigmoid(se2(SiLU(se1(mean_hw(
    y))))): the mean in float32, the GEMMs (``fc(v, name)``, float32 out)
    on its ``inner``-dtype rounding, SiLU and sigmoid in float32, the gate
    rounded to y's dtype."""
    s = y.mean(dim=(1, 2), dtype=torch.float32).to(inner)
    s = F.silu(fc(s, "se1")).to(inner)
    gate = torch.sigmoid(fc(s, "se2")).to(y.dtype)
    return y * gate[:, None, None, :]


def partition_attention(qkv, bias, geo: Block, part: str, out_dtype):
    """``swin.window_attention_plain``'s function over the partition
    ``part`` of the map, on the form ``swin.window_attention_route`` gives:
    (B, G, G, 3C) qkv -> (B, G, G, C)."""
    hd = qkv.shape[-1] // (3 * geo.heads)
    kw = {"heads": geo.heads, "window": geo.window, "out_dtype": out_dtype,
          "partition": part}
    if swin.window_attention_route(qkv.device, qkv.dtype, hd,
                                   geo.window ** 2, part) == "kernel":
        return wa_kernel.window_attention_fused(qkv, bias, **kw)
    return swin.window_attention_plain(qkv, bias, **kw)


def _run_partition(x, blk, geo: Block, part: str, cast):
    """One partition block ("block" or "grid") on (B, G^2, C); its four
    projections decoded together at its head, the two residual adds and
    the tanh GELU in the epilogues of out, mlp2 and mlp1."""
    b, g = x.shape[0], geo.grid
    key, od = f"{geo.key}.{part}", cast.dtype
    run = block_projections(x, blk, od, key)
    with span("layernorm", key, "ln1"):
        y = layernorm(x, blk["ln1"], LN_EPS)
    qkv = run(y, "qkv")
    with span("attention", key):
        o = partition_attention(qkv.view(b, g, g, -1), blk["rel_bias"], geo,
                                part, od)
    x = run(o.view(b, g * g, -1), "out", residual=x)
    with span("layernorm", key, "ln2"):
        y = layernorm(x, blk["ln2"], LN_EPS)
    y = run(y, "mlp1", act=ACT)
    return run(y, "mlp2", residual=x)


def _run_block(x, p, geo: Block, cast):
    """One MaxViT block on NHWC x: the MBConv, block attention, grid
    attention."""
    x = _run_mbconv(x, p["mbconv"], geo, cast)
    b = x.shape[0]
    y = x.view(b, geo.grid * geo.grid, geo.dim)
    for part in PARTS:
        y = _run_partition(y, p[part], geo, part, cast)
    return y.view(b, geo.grid, geo.grid, geo.dim)


def _run_head(x, p, cast, with_softmax: bool):
    """The mean over the map, LayerNorm, pre-logits and tanh, the
    classifier; its two GEMMs decoded together where they decode in the
    step."""
    od = cast.dtype
    with span("pool", "head"):
        x = x.mean(dim=(1, 2), dtype=torch.float32).to(x.dtype)
    with span("layernorm", "head"):
        x = layernorm(x, p["norm"], LN_EPS)
    inner = od if od is not None else torch.float32
    run = layer_group({"pre": (tuple(x.shape), x.dtype),
                       "fc": ((x.shape[0], p["pre"]["bias"].shape[0]),
                              inner)}, p, "head")
    with span("fc", "head", "pre"):
        x = torch.tanh(run(x, "pre", out_dtype=od))
    with span("fc", "head"):
        z = run(x, "fc", out_dtype=torch.float32)
    if with_softmax:
        with span("softmax", "head"):
            z = torch.softmax(z, dim=-1)
    return z
