"""Plain reference of the Swin configurations: a float32 forward pass in
plain PyTorch (TF32 off), from the configuration's sizes and the PQ
codebooks and ids that the harness made. It imports nothing of the
program: the window partition, the relative-position index, the bias
gather and the shift mask are built here at each call, as the published
code builds them.

The model is Swin Transformer (Liu et al., ICCV 2021, arXiv:2103.14030;
``models/swin_transformer.py`` of microsoft/Swin-Transformer): the patch
embedding (4x4 patches, stride 4) and its LayerNorm; four stages of
pre-norm blocks, each LayerNorm (eps ``layernorm_epsilon``), window
attention over ``window_size``^2 tokens (q scaled by head dim^-1/2, q k^T,
plus the relative-position bias gathered from a ((2w-1)^2, heads) table,
plus in odd blocks the -100 shift mask, softmax, times v, the out
projection), with the grid rolled by -w/2 before the partition and back
after in odd blocks, a residual add, LayerNorm, the MLP with the exact erf
GELU and a residual add; a grid no larger than the window takes the grid
as its window and never shifts; between stages the patch merging (the 2x2
neighbourhood concatenated as x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
x[1::2, 1::2], LayerNorm(4C), a 4C -> 2C linear without bias); a final
LayerNorm, the mean over the tokens and the head. The forward returns the
head's logits: the softmax is applied by whoever compares.

Departures from the published model, all of the benchmark's making: the
weights are random, not trained; every linear layer (the patch
embedding, taken as a (row, column, channel) patch times a matrix, qkv,
out, both MLP matrices, the reductions, the head) is a PQ layer whose
dense (Cout, Cin) weight is decoded from random codebooks and ids
(``pq.decode_rows``); the LayerNorms are random, and the relative-position
tables are drawn at the configuration's ``pq.rel_bias_scale``, far above
Swin's init of 0.02, so that the bias is a visible part of the logits.
A reduction's bias, zero in the weights, is not read.

Also here: the configuration's sizes and the shapes of its PQ layers,
which the harness's generator and FLOP count read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_cuda.reference.pq import NoTF32, decode_rows, same


def sizes(cfg: dict) -> dict:
    """{"image", "patch", "dims", "depths", "heads", "grids", "windows",
    "shifts", "mlp", "classes", "eps"} of a configuration: per stage its
    width, depth, heads, grid side, window side and the shift of its odd
    blocks."""
    h, w, c = cfg["input"]
    p, dim = cfg["patch_size"], cfg["embed_dim"]
    depths, heads = list(cfg["depths"]), list(cfg["num_heads"])
    if h != w or h % p or c != 3 or len(depths) != len(heads):
        raise ValueError(f"input {cfg['input']}, patch {p}, depths {depths} "
                         f"and heads {heads} do not make a Swin")
    dims = [dim * 2 ** i for i in range(len(depths))]
    grids = [h // p // 2 ** i for i in range(len(depths))]
    windows, shifts = [], []
    for g in grids:
        if g <= cfg["window_size"]:
            windows.append(g)
            shifts.append(0)
        else:
            windows.append(cfg["window_size"])
            shifts.append(cfg["window_size"] // 2)
    for d, nh, g, ws in zip(dims, heads, grids, windows):
        if d % nh or g % ws:
            raise ValueError(f"width {d}, heads {nh}, grid {g} and window "
                             f"{ws} do not make a Swin stage")
    return {"image": h, "patch": p, "dims": dims, "depths": depths,
            "heads": heads, "grids": grids, "windows": windows,
            "shifts": shifts, "mlp": cfg["mlp_ratio"],
            "classes": cfg["num_classes"], "eps": cfg["layernorm_epsilon"]}


def blocks(cfg: dict) -> list:
    """(key, stage) of every block in forward order."""
    z = sizes(cfg)
    return [(f"s{i}b{j}", i) for i, depth in enumerate(z["depths"])
            for j in range(depth)]


def gemms(cfg: dict) -> list:
    """(path, Cin, Cout, tokens) of every linear layer in forward order:
    path is the key path into the weights ("patch_embed",), ("s0b0",
    "qkv"), ..., ("s0merge", "reduction"), ..., ("head",); tokens the
    rows of one image it multiplies."""
    z = sizes(cfg)
    out = [(("patch_embed",), z["patch"] ** 2 * 3, z["dims"][0],
            z["grids"][0] ** 2)]
    for i, depth in enumerate(z["depths"]):
        d, n = z["dims"][i], z["grids"][i] ** 2
        for j in range(depth):
            k = f"s{i}b{j}"
            out += [((k, "qkv"), d, 3 * d, n), ((k, "out"), d, d, n),
                    ((k, "mlp1"), d, z["mlp"] * d, n),
                    ((k, "mlp2"), z["mlp"] * d, d, n)]
        if i + 1 < len(z["depths"]):
            out.append(((f"s{i}merge", "reduction"), 4 * d, 2 * d, n // 4))
    out.append((("head",), z["dims"][-1], z["classes"], 1))
    return out


def flops_per_image(cfg: dict) -> float:
    """2 x the multiply-adds of the linear layers and of attention's two
    products, q k^T and the weights times v (per window and head N^2 x
    head dim each, so 2 N C a token); the bias, the softmax and the
    LayerNorms are not counted."""
    z = sizes(cfg)
    total = sum(2 * n * cin * cout for _, cin, cout, n in gemms(cfg))
    for i, depth in enumerate(z["depths"]):
        n = z["grids"][i] ** 2
        total += depth * 2 * 2 * n * z["windows"][i] ** 2 * z["dims"][i]
    return float(total)


def layernorm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"].float() \
        + p["shift"].float()


def linear(x: torch.Tensor, p: dict, cin: int, operand=same,
           bias: bool = True) -> torch.Tensor:
    """x (..., Cin) times the decoded PQ weight, plus the bias."""
    w = decode_rows(p["codebooks"], p["assignments"], cin)
    y = operand(x) @ operand(w).t()
    return y + p["bias"].float() if bias else y


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B x windows, ws, ws, C)."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    """(B x windows, ws, ws, C) -> (B, H, W, C)."""
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_position_index(ws: int, device) -> torch.Tensor:
    """(ws^2, ws^2): the published construction."""
    coords = torch.stack(torch.meshgrid(
        [torch.arange(ws, device=device), torch.arange(ws, device=device)],
        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def attention_mask(res: int, ws: int, shift: int, device) -> torch.Tensor:
    """(windows, ws^2, ws^2) of -100 and 0: the published construction."""
    img_mask = torch.zeros((1, res, res, 1), device=device)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def window_attention(x: torch.Tensor, blk: dict, heads: int, ws: int,
                     mask, operand=same) -> torch.Tensor:
    """(B x windows, N, C) -> (B x windows, N, C), the out projection
    included."""
    bw, n, c = x.shape
    hd = c // heads
    qkv = linear(x, blk["qkv"], c, operand).reshape(bw, n, 3, heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    q = q * hd ** -0.5
    attn = operand(q) @ operand(k).transpose(-2, -1)
    index = relative_position_index(ws, x.device)
    bias = blk["rel_table"].float()[index.view(-1)].view(n, n, -1)
    attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(bw // nw, nw, heads, n, n) \
            + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    o = (operand(attn) @ operand(v)).transpose(1, 2).reshape(bw, n, c)
    return linear(o, blk["out"], c, operand)


def block(x: torch.Tensor, blk: dict, res: int, ws: int, shift: int,
          heads: int, z: dict, operand=same) -> torch.Tensor:
    b, l, c = x.shape
    shortcut = x
    x = layernorm(x, blk["ln1"], z["eps"]).view(b, res, res, c)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    mask = attention_mask(res, ws, shift, x.device) if shift else None
    xw = window_partition(x, ws).view(-1, ws * ws, c)
    aw = window_attention(xw, blk, heads, ws, mask, operand)
    x = window_reverse(aw.view(-1, ws, ws, c), ws, res, res)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x.view(b, l, c)
    y = layernorm(x, blk["ln2"], z["eps"])
    y = F.gelu(linear(y, blk["mlp1"], c, operand))
    return x + linear(y, blk["mlp2"], z["mlp"] * c, operand)


def patch_merging(x: torch.Tensor, mp: dict, res: int, z: dict,
                  operand=same) -> torch.Tensor:
    b, _, c = x.shape
    x = x.view(b, res, res, c)
    x = torch.cat([x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :],
                   x[:, 0::2, 1::2, :], x[:, 1::2, 1::2, :]], -1)
    x = layernorm(x.view(b, -1, 4 * c), mp["norm"], z["eps"])
    return linear(x, mp["reduction"], 4 * c, operand, bias=False)


def logits(cfg: dict, weights: dict, x_nhwc: torch.Tensor,
           operand=same) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, classes) float32 logits. ``operand``
    rounds both operands of every linear layer and of attention's two
    products (``pq.e4m3`` for the control); the identity by default."""
    z = sizes(cfg)
    p = z["patch"]
    with NoTF32(), torch.no_grad():
        x = x_nhwc.float()
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = linear(x.reshape(b, -1, p * p * c), weights["patch_embed"],
                   p * p * c, operand)
        x = layernorm(x, weights["patch_norm"], z["eps"])
        for i, depth in enumerate(z["depths"]):
            res, ws = z["grids"][i], z["windows"][i]
            for j in range(depth):
                x = block(x, weights[f"s{i}b{j}"], res, ws,
                          z["shifts"][i] if j % 2 else 0, z["heads"][i], z,
                          operand)
            if i + 1 < len(z["depths"]):
                x = patch_merging(x, weights[f"s{i}merge"], res, z, operand)
        x = layernorm(x, weights["ln_final"], z["eps"]).mean(1)
        return linear(x, weights["head"], z["dims"][-1], operand)
