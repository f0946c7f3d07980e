"""Builder of the ViT PQ configurations in memory mode, through the port's
family path (``models.common.build_family_forward("vit", ...,
memory=True)``, the wiring of ``eval.FamilyClassifier``).

The weights are made here, on the device, from the seed: a frozen copy of
the port's ``models/synth.random_vit_pq_params`` (every projection D=4,
K=32, S = ceil(Cin / 4), codewords N(0, 1/Cin); biases N(0, 0.01^2);
LayerNorm scales 1 + 0.05 N(0, 1) and shifts 0.02 N(0, 1); the class token
and the position embedding 0.02 N(0, 1)), drawn with a ``torch.Generator``
on the card in two large calls, in the types they are served in (bf16
codebooks, uint8 ids, float32 biases, LayerNorms and embeddings). The
program gets them through its own entry points; the plain reference
(``reference/vit.py``) gets the same tensors.
"""

from __future__ import annotations

import math

import torch

from bench_cuda.reference import vit as ref
from bench_cuda.reference.pq import e4m3

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def input_shape(cfg: dict) -> tuple:
    return tuple(cfg["input"])


def dtype(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["dtype"]]


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """The port's nested ViT params: {"patch_embed", "cls_token" (1, 1, D),
    "pos_embed" (1, tokens, D), "blk{i}": {"ln1", "qkv", "out", "ln2",
    "mlp1", "mlp2"}, "ln_final", "head"}. The normal draws are taken in
    the order of ``ref.gemms`` (codewords, then bias, each projection),
    then the LayerNorms (blk0's ln1, ln2, ..., the final; scale, then
    shift), the class token and the position embedding."""
    z = ref.sizes(cfg)
    pq = cfg["pq"]
    d, kk, dim = pq["D"], pq["K"], z["dim"]
    if 256 % kk:
        raise ValueError(f"K={kk} does not divide 256")
    layers = [(path, cin, cout, -(-cin // d))
              for path, cin, cout in ref.gemms(cfg)]
    n_ln = 2 * z["depth"] + 1
    n_float = (sum(s * kk * d + cout for _, _, cout, s in layers)
               + 2 * n_ln * dim + dim + z["tokens"] * dim)
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
    for path, cin, cout, s in layers:
        cb = take(s * kk * d).view(s, kk, d) / math.sqrt(cin)
        bias = take(cout) * pq["bias_scale"]
        ids = (ints[io:io + cout * s] % kk).to(torch.uint8).view(cout, s)
        io += cout * s
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = {"codebooks": cb.to(dtype(cfg)).contiguous(),
                          "assignments": ids.contiguous(),
                          "bias": bias.contiguous()}

    def ln():
        return {"scale": (1 + pq["ln_scale"] * take(dim)).contiguous(),
                "shift": (pq["ln_shift"] * take(dim)).contiguous()}

    for i in range(z["depth"]):
        params[f"blk{i}"]["ln1"] = ln()
        params[f"blk{i}"]["ln2"] = ln()
    params["ln_final"] = ln()
    params["cls_token"] = (pq["token_scale"] * take(dim)).view(1, 1, dim)
    params["pos_embed"] = (pq["token_scale"] * take(z["tokens"] * dim)).view(
        1, z["tokens"], dim)
    return params


def spec(cfg: dict):
    """The port's ViTSpec of the configuration."""
    from qcnn_tpu_torch.models.vit import ViTSpec

    z = ref.sizes(cfg)
    if z["mlp"] % z["dim"]:
        raise ValueError(f"mlp_dim {z['mlp']} is no multiple of the hidden "
                         f"size {z['dim']}")
    return ViTSpec(cfg["model"], patch=z["patch"], image_size=z["image"],
                   dim=z["dim"], depth=z["depth"], heads=z["heads"],
                   mlp_ratio=z["mlp"] // z["dim"],
                   num_classes=z["classes"])


def offline_forward(cfg: dict, weights: dict, batch: int, device):
    """The forward that ``FamilyClassifier`` calls in memory mode:
    ``build_family_forward("vit", spec, weights, memory=True)`` in the
    configuration's dtype. Returns fn(x)."""
    from qcnn_tpu_torch.models.common import build_family_forward

    prepared, fwd, _ = build_family_forward(
        "vit", spec(cfg), weights, memory=True, compute_dtype=dtype(cfg),
        device=device)
    return lambda x: fwd(prepared, x)


def int8_forward(cfg: dict, weights: dict, batch: int, device):
    """A control of the comparison: the program's own int8 path, as
    ``--dtype int8`` without ``--memory-mode`` runs it
    (``build_family_forward(compute_dtype=torch.int8)``: every projection
    decoded at load and quantized per output channel, bf16 activations
    quantized per tensor at each product). Returns fn(x), in
    ``offline_forward``'s place."""
    from qcnn_tpu_torch.models.common import build_family_forward

    prepared, fwd, _ = build_family_forward(
        "vit", spec(cfg), weights, memory=False, compute_dtype=torch.int8,
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
    projection at the cell's rows decodes its weight in the step
    (``pq_decode``) and multiplies on the library's GEMM."""
    return {}
