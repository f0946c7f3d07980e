"""Plain reference of the ViT configurations: a float32 forward pass in
plain PyTorch (TF32 off), from the configuration's sizes and the PQ
codebooks and ids that the harness made. It imports nothing of the
program.

The model is ViT (Dosovitskiy et al., ICLR 2021) with its class token:
patchify in (row, col, channel) order and embed, prepend the class token,
add the position embedding; ``num_layers`` pre-norm blocks (LayerNorm with
eps ``layernorm_epsilon``, the fused qkv projection, softmax(q k^T /
sqrt(head dim)) v over ``num_heads`` heads, the out projection, a residual
add, LayerNorm, the MLP with the exact erf GELU, a residual add); a final
LayerNorm and the head on the class token. The forward returns the head's
logits: the softmax is applied by whoever compares.

Departures from the published model, all of the benchmark's making: every
projection (patch embedding, qkv, out, both MLP matrices, head) is a PQ
layer whose dense (Cout, Cin) weight is decoded from random codebooks and
ids (``pq.decode_rows``); the LayerNorms, the class token and the
position embedding are random, and the position embedding has a row for
each of the configuration's tokens (577 at 384x384 with 16x16 patches) in
place of a trained table.

Also here: the configuration's sizes and the shapes of its PQ layers,
which the harness's generator and FLOP count read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench_cuda.reference.pq import NoTF32, decode_rows, same


def sizes(cfg: dict) -> dict:
    """{"image", "patch", "dim", "depth", "heads", "head_dim", "mlp",
    "classes", "patches", "tokens", "eps"} of a configuration."""
    h, w, c = cfg["input"]
    p, dim, heads = cfg["patch_size"], cfg["hidden_size"], cfg["num_heads"]
    if h != w or h % p or c != 3 or dim % heads:
        raise ValueError(f"input {cfg['input']}, patch {p}, hidden {dim} "
                         f"and heads {heads} do not make a ViT")
    n = (h // p) ** 2
    return {"image": h, "patch": p, "dim": dim, "depth": cfg["num_layers"],
            "heads": heads, "head_dim": dim // heads, "mlp": cfg["mlp_dim"],
            "classes": cfg["num_classes"], "patches": n, "tokens": n + 1,
            "eps": cfg["layernorm_epsilon"]}


def gemms(cfg: dict) -> list:
    """(path, Cin, Cout) of every projection in forward order: path is the
    key path into the weights ("patch_embed",), ("blk{i}", "qkv"), ...,
    ("head",)."""
    z = sizes(cfg)
    d = z["dim"]
    out = [(("patch_embed",), z["patch"] ** 2 * 3, d)]
    for i in range(z["depth"]):
        out += [((f"blk{i}", "qkv"), d, 3 * d), ((f"blk{i}", "out"), d, d),
                ((f"blk{i}", "mlp1"), d, z["mlp"]),
                ((f"blk{i}", "mlp2"), z["mlp"], d)]
    out.append((("head",), d, z["classes"]))
    return out


def flops_per_image(cfg: dict) -> float:
    """2 x the multiply-adds of the projections (the patch embedding on
    the patches, the blocks' on every token, the head on the class token)
    and of attention's two products, q k^T and the weights times v."""
    z = sizes(cfg)
    n = z["tokens"]
    total = 0
    for path, cin, cout in gemms(cfg):
        rows = {"patch_embed": z["patches"], "head": 1}.get(path[0], n)
        total += 2 * rows * cin * cout
    total += z["depth"] * 2 * 2 * z["heads"] * n * n * z["head_dim"]
    return float(total)


def layernorm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"].float() \
        + p["shift"].float()


def linear(x: torch.Tensor, p: dict, cin: int, operand=same) -> torch.Tensor:
    """x (..., Cin) times the decoded PQ weight, plus the bias."""
    w = decode_rows(p["codebooks"], p["assignments"], cin)
    return operand(x) @ operand(w).t() + p["bias"].float()


def attention(q, k, v, operand=same) -> torch.Tensor:
    """(B, heads, N, head dim) each -> (B, heads, N, head dim)."""
    z = operand(q) @ operand(k).transpose(-1, -2) / math.sqrt(q.shape[-1])
    return operand(torch.softmax(z, dim=-1)) @ operand(v)


def logits(cfg: dict, weights: dict, x_nhwc: torch.Tensor,
           operand=same) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, classes) float32 logits. ``operand``
    rounds both operands of every projection and of attention's two
    products (``pq.e4m3`` for the control); the identity by default."""
    z = sizes(cfg)
    p, d, nh, hd = z["patch"], z["dim"], z["heads"], z["head_dim"]
    with NoTF32(), torch.no_grad():
        x = x_nhwc.float()
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = linear(x.reshape(b, z["patches"], p * p * c),
                   weights["patch_embed"], p * p * c, operand)
        cls = weights["cls_token"].float().expand(b, 1, d)
        x = torch.cat([cls, x], dim=1) + weights["pos_embed"].float()
        for i in range(z["depth"]):
            blk = weights[f"blk{i}"]
            y = layernorm(x, blk["ln1"], z["eps"])
            qkv = linear(y, blk["qkv"], d, operand)
            q, k, v = (t.reshape(b, -1, nh, hd).transpose(1, 2)
                       for t in qkv.chunk(3, dim=-1))
            o = attention(q, k, v, operand).transpose(1, 2).reshape(b, -1, d)
            x = x + linear(o, blk["out"], d, operand)
            y = layernorm(x, blk["ln2"], z["eps"])
            y = F.gelu(linear(y, blk["mlp1"], d, operand))
            x = x + linear(y, blk["mlp2"], z["mlp"], operand)
        y = layernorm(x[:, 0], weights["ln_final"], z["eps"])
        return linear(y, weights["head"], d, operand)
