"""Builder of the Swin PQ configurations in memory mode, through the port's
family path (``models.common.build_family_forward("swin", ...,
memory=True)``, the wiring of ``eval.FamilyClassifier``).

The weights are made here, on the device, from the seed: a frozen copy of
the port's ``models/synth.random_swin_pq_params`` (every linear layer D=4,
K=32, S = ceil(Cin / 4), codewords N(0, 1/Cin); biases N(0, 0.01^2) but
the merges' reductions, which have none and get zeros; LayerNorm scales
1 + 0.05 N(0, 1) and shifts 0.02 N(0, 1); relative-position tables
N(0, rel_bias_scale^2)), drawn with a ``torch.Generator`` on the card in
two large calls, in the types they are served in (bf16 codebooks, uint8
ids, float32 biases, LayerNorms and tables). The program gets them
through its own entry points; the plain reference (``reference/swin.py``)
gets the same tensors.
"""

from __future__ import annotations

import math

import torch

from bench_cuda.reference import swin as ref
from bench_cuda.reference.pq import e4m3

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def input_shape(cfg: dict) -> tuple:
    return tuple(cfg["input"])


def dtype(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["dtype"]]


def _layernorms(cfg: dict) -> list:
    """(path, width) of every LayerNorm in forward order."""
    z = ref.sizes(cfg)
    out = [(("patch_norm",), z["dims"][0])]
    for key, i in ref.blocks(cfg):
        out += [((key, "ln1"), z["dims"][i]), ((key, "ln2"), z["dims"][i])]
        if key == f"s{i}b{z['depths'][i] - 1}" and i + 1 < len(z["depths"]):
            out.append(((f"s{i}merge", "norm"), 4 * z["dims"][i]))
    out.append((("ln_final",), z["dims"][-1]))
    return out


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """The port's nested Swin params: {"patch_embed", "patch_norm",
    "s{i}b{j}": {"ln1", "qkv", "rel_table", "out", "ln2", "mlp1",
    "mlp2"}, "s{i}merge": {"norm", "reduction"}, "ln_final", "head"}. The
    normal draws are taken in the order of ``ref.gemms`` (codewords, then
    the bias where the layer has one), then the LayerNorms in forward
    order (scale, then shift), then each block's relative-position
    table."""
    z = ref.sizes(cfg)
    pq = cfg["pq"]
    d, kk = pq["D"], pq["K"]
    if 256 % kk:
        raise ValueError(f"K={kk} does not divide 256")
    layers = [(path, cin, cout, -(-cin // d))
              for path, cin, cout, _ in ref.gemms(cfg)]
    norms = _layernorms(cfg)
    tables = [(key, (2 * z["windows"][i] - 1) ** 2, z["heads"][i])
              for key, i in ref.blocks(cfg)]
    n_float = (sum(s * kk * d + (0 if path[-1] == "reduction" else cout)
                   for path, _, cout, s in layers)
               + sum(2 * w for _, w in norms)
               + sum(rows * h for _, rows, h in tables))
    normal = torch.randn(n_float, generator=gen, device=device)
    # K divides 256, so ints mod K is uniform
    ints = torch.randint(0, 256, (sum(cout * s for _, _, cout, s in layers),),
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

    for path, cin, cout, s in layers:
        cb = take(s * kk * d).view(s, kk, d) / math.sqrt(cin)
        if path[-1] == "reduction":
            bias = torch.zeros(cout, device=device)
        else:
            bias = take(cout) * pq["bias_scale"]
        ids = (ints[io:io + cout * s] % kk).to(torch.uint8).view(cout, s)
        io += cout * s
        put(path, {"codebooks": cb.to(dtype(cfg)).contiguous(),
                   "assignments": ids.contiguous(),
                   "bias": bias.contiguous()})
    for path, width in norms:
        put(path, {"scale": (1 + pq["ln_scale"] * take(width)).contiguous(),
                   "shift": (pq["ln_shift"] * take(width)).contiguous()})
    for key, rows, heads in tables:
        put((key, "rel_table"),
            (pq["rel_bias_scale"] * take(rows * heads)).view(rows, heads))
    return params


def spec(cfg: dict):
    """The port's SwinSpec of the configuration."""
    from qcnn_tpu_torch.models.swin import SwinSpec

    z = ref.sizes(cfg)
    return SwinSpec(cfg["model"], patch=z["patch"], image_size=z["image"],
                    embed_dim=z["dims"][0], depths=tuple(z["depths"]),
                    heads=tuple(z["heads"]), window=cfg["window_size"],
                    mlp_ratio=z["mlp"], num_classes=z["classes"])


def offline_forward(cfg: dict, weights: dict, batch: int, device):
    """The forward that ``FamilyClassifier`` calls in memory mode:
    ``build_family_forward("swin", spec, weights, memory=True)`` in the
    configuration's dtype. Returns fn(x)."""
    from qcnn_tpu_torch.models.common import build_family_forward

    prepared, fwd, _ = build_family_forward(
        "swin", spec(cfg), weights, memory=True, compute_dtype=dtype(cfg),
        device=device)
    return lambda x: fwd(prepared, x)


def int8_forward(cfg: dict, weights: dict, batch: int, device):
    """A control of the comparison: the program's own int8 path, as
    ``--dtype int8`` without ``--memory-mode`` runs it
    (``build_family_forward(compute_dtype=torch.int8)``: every linear
    layer decoded at load and quantized per output channel, bf16
    activations quantized per tensor at each product). Returns fn(x), in
    ``offline_forward``'s place."""
    from qcnn_tpu_torch.models.common import build_family_forward

    prepared, fwd, _ = build_family_forward(
        "swin", spec(cfg), weights, memory=False, compute_dtype=torch.int8,
        device=device)
    return lambda x: fwd(prepared, x)


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
    """No port kernel of this configuration has a roofline metric: every
    linear layer at the cell's rows decodes its weight in the step
    (``pq_decode``) and multiplies on the library's GEMM, and the window
    attention is a chain of the library's kernels."""
    return {}
