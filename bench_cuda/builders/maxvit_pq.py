"""Builder of the MaxViT PQ configurations in memory mode, through the
port's family path (``models.common.build_family_forward("maxvit", ...,
memory=True)``, the wiring of ``eval.FamilyClassifier``).

The weights are made here, on the device, from the seed: a frozen copy of
the port's ``models/synth.random_maxvit_pq_params`` (every BatchNorm
folded; the 1x1 convs and the stem's conv2 PQ at D=4, K=``pq.conv_K``,
every FC PQ at D=4, K=``pq.K``, S = ceil(Cin / 4); the stem's conv1 and the
depthwise convs dense; codewords and dense weights N(0, 1/fan-in), biases
N(0, bias_scale^2); LayerNorm scales 1 + ln_scale N(0, 1) and shifts
ln_shift N(0, 1); relative-position tables N(0, rel_bias_scale^2)), drawn
with a ``torch.Generator`` on the card in two large calls, in the types
they are served in (bf16 codebooks and dense kernels, uint8 ids, float32
biases, LayerNorms and tables). The program gets them through its own
entry points; the plain reference (``reference/maxvit.py``) gets the same
tensors.
"""

from __future__ import annotations

import math

import torch

from bench_cuda.reference import maxvit as ref
from bench_cuda.reference.pq import e4m3

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def input_shape(cfg: dict) -> tuple:
    return tuple(cfg["input"])


def dtype(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["dtype"]]


def _layernorms(cfg: dict) -> list:
    """(path, width) of every LayerNorm in forward order."""
    z = ref.sizes(cfg)
    out = []
    for key, i, _ in ref.blocks(cfg):
        for part in ("block", "grid"):
            out += [((key, part, "ln1"), z["dims"][i]),
                    ((key, part, "ln2"), z["dims"][i])]
    return out + [(("head", "norm"), z["dims"][-1])]


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """The port's nested MaxViT params: {"stem": {"conv1", "conv2"},
    "s{i}b{j}": {"mbconv": {"proj" (first block), "conv1", "dw", "se1",
    "se2", "conv3"}, "block": {...}, "grid": {"ln1", "qkv", "rel_table",
    "out", "ln2", "mlp1", "mlp2"}}, "head": {"norm", "pre", "fc"}}. The
    normal draws are taken in the order of ``ref.layers`` (codewords or the
    dense kernel, then the bias), then the LayerNorms in forward order
    (scale, then shift), then each partition's relative-position table."""
    z = ref.sizes(cfg)
    pq = cfg["pq"]
    d = pq["D"]
    for k in (pq["K"], pq["conv_K"]):
        if 256 % k:
            raise ValueError(f"K={k} does not divide 256")
    layers = []
    for path, kind, kh, cin, cout, _ in ref.layers(cfg):
        s = -(-cin // d)
        if kind in ("dense", "dw"):
            layers.append((path, kind, kh, cin, cout, 0,
                           kh * kh * cin * cout))
        else:
            k = pq["conv_K"] if kind == "conv" else pq["K"]
            layers.append((path, kind, kh, cin, cout, s, s * k * d))
    norms = _layernorms(cfg)
    side = 2 * z["window"] - 1
    tables = [((key, part, "rel_table"), z["heads"][i])
              for key, i, _ in ref.blocks(cfg) for part in ("block", "grid")]
    n_float = (sum(n + cout for *_, cout, _, n in layers)
               + sum(2 * w for _, w in norms)
               + sum(h * side * side for _, h in tables))
    normal = torch.randn(n_float, generator=gen, device=device)
    # K divides 256, so ints mod K is uniform
    ints = torch.randint(0, 256, (sum(cout * kh * kh * s for _, _, kh, _,
                                      cout, s, _ in layers),),
                         generator=gen, device=device, dtype=torch.int32)
    fo = io = 0

    def take(n):
        nonlocal fo
        fo += n
        return normal[fo - n:fo]

    params: dict = {}

    def put(path, value):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for path, kind, kh, cin, cout, s, n in layers:
        fan = kh * kh * cin
        w = take(n) / math.sqrt(fan)
        bias = (take(cout) * pq["bias_scale"]).contiguous()
        if kind in ("dense", "dw"):
            put(path, {"kernel": w.view(kh, kh, cin, cout).to(dtype(cfg))
                       .contiguous(), "bias": bias})
            continue
        k = pq["conv_K"] if kind == "conv" else pq["K"]
        shape = (cout, kh, kh, s) if kind == "conv" else (cout, s)
        ids = (ints[io:io + cout * kh * kh * s] % k).to(torch.uint8)
        io += cout * kh * kh * s
        put(path, {"codebooks": w.view(s, k, d).to(dtype(cfg)).contiguous(),
                   "assignments": ids.view(shape).contiguous(),
                   "bias": bias})
    for path, width in norms:
        put(path, {"scale": (1 + pq["ln_scale"] * take(width)).contiguous(),
                   "shift": (pq["ln_shift"] * take(width)).contiguous()})
    for path, heads in tables:
        put(path, (pq["rel_bias_scale"] * take(heads * side * side)).view(
            heads, side, side))
    return params


def spec(cfg: dict):
    """The port's MaxViTSpec of the configuration; raises where the
    configuration sets a width the port's MaxViT holds fixed."""
    from qcnn_tpu_torch.models import maxvit

    z = ref.sizes(cfg)
    fixed = {"dim_head": maxvit.HEAD_DIM, "expand_ratio": maxvit.EXPAND,
             "se_ratio": 1 / maxvit.SE_DIVISOR,
             "mlp_ratio": maxvit.MLP_RATIO,
             "head_hidden_size": z["dims"][-1]}
    other = {k: cfg[k] for k, v in fixed.items() if cfg[k] != v}
    if other:
        raise ValueError(f"the port's MaxViT takes {fixed}, got {other}")
    return maxvit.MaxViTSpec(cfg["model"], image_size=z["image"],
                             stem_width=z["stem"], dims=tuple(z["dims"]),
                             depths=tuple(z["depths"]),
                             partition=z["window"],
                             num_classes=z["classes"])


def _forward(cfg: dict, weights: dict, device, compute_dtype, memory: bool):
    from qcnn_tpu_torch.models.common import build_family_forward

    prepared, fwd, _ = build_family_forward(
        "maxvit", spec(cfg), weights, memory=memory,
        compute_dtype=compute_dtype, device=device)
    return lambda x: fwd(prepared, x)


def offline_forward(cfg: dict, weights: dict, batch: int, device):
    """The forward that ``FamilyClassifier`` calls in memory mode:
    ``build_family_forward("maxvit", spec, weights, memory=True)`` in the
    configuration's dtype. Returns fn(x)."""
    return _forward(cfg, weights, device, dtype(cfg), True)


def int8_forward(cfg: dict, weights: dict, batch: int, device):
    """A control of the comparison: the program's own int8 path, as
    ``--dtype int8`` without ``--memory-mode`` runs it
    (``build_family_forward(compute_dtype=torch.int8)``: every PQ layer
    decoded at load and quantized per output channel, bf16 activations
    quantized per tensor at each product; the two dense conv kinds stay
    bf16). Returns fn(x), in ``offline_forward``'s place."""
    return _forward(cfg, weights, device, torch.int8, False)


def fp8_forward(cfg: dict, weights: dict, batch: int, device):
    """A control of the comparison: the reference with every product's
    operands in fp8 (e4m3, one scale a tensor), its softmax in bf16 as the
    program hands it over. Returns fn(x), in ``offline_forward``'s
    place."""
    return lambda x: torch.softmax(
        ref.logits(cfg, weights, x, operand=e4m3), 1).to(torch.bfloat16)


def reference_logits(cfg: dict, weights: dict, x: torch.Tensor):
    return ref.logits(cfg, weights, x)


def flops_per_image(cfg: dict) -> float:
    return ref.flops_per_image(cfg)


def kernel_work(cfg: dict, batch: int) -> dict:
    """{"window_attention_fused": [(operations, bytes)] of its launches in
    one forward at ``batch`` images}: one a partition block, block then
    grid in each of the blocks. A launch's operations are attention's two
    products (4 N C a token, N = P^2); its bytes one read of the bf16 q,
    k and v, one write of the bf16 output and one read of the float32
    (heads, N, N) bias."""
    n = ref.sizes(cfg)["window"] ** 2
    out = []
    for tokens, c, heads in ref.attention_work(cfg):
        t = batch * tokens
        out.append((4.0 * n * t * c, 2.0 * 4 * t * c + 4.0 * heads * n * n))
    return {"window_attention_fused": out}
