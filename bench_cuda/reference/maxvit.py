"""Plain reference of the MaxViT configurations: a float32 forward pass in
plain PyTorch (TF32 off), from the configuration's sizes and the PQ
codebooks and ids that the harness made. It imports nothing of the
program: the TF 'same' padding, the block and grid partitions and the
``bias_tf`` relative-position bias are built here at each call, as timm
builds them.

The model is MaxViT (Tu et al., ECCV 2022, arXiv:2204.01697) in the form
of timm's ``maxvit_*_tf`` models (``timm/models/maxxvit.py`` with
``_tf_cfg()``): the stem (a 3x3 stride-2 conv with bias, BatchNorm, the
tanh GELU, a 3x3 conv with bias); four stages of blocks, each an MBConv
(shortcut: x, or in a stage's first block the 2x2 average pool and a 1x1
conv with bias; a pre-norm BatchNorm, a 1x1 expansion to 4C, BatchNorm,
GELU, a 3x3 depthwise conv with the block's stride, BatchNorm, GELU, the
squeeze-excite (mean, C/4-wide FC, SiLU, FC, sigmoid, scale), a 1x1
projection with bias, plus the shortcut), then block attention and grid
attention, each pre-norm (LayerNorm eps ``layernorm_epsilon``, attention
over P x P windows with q scaled by head dim^-1/2, q k^T plus the
``bias_tf`` bias, softmax, times v, the out projection, a residual add,
LayerNorm, the MLP with the tanh GELU, a residual add). The block partition
takes the P x P squares of the map, the grid partition the P x P grid
whose window (a, b) holds the tokens at row i (H / P) + a, column
j (W / P) + b. Every GELU is the tanh form; a 3x3 conv pads as
TensorFlow's 'same' does (one pixel after, none before, at stride 2 on an
even map). The head: the mean over the map, LayerNorm, a pre-logits FC and
tanh, the classifier. The forward returns the head's logits: the softmax
is applied by whoever compares.

Departures from the published model, all of the benchmark's making: the
weights are random, not trained; every BatchNorm is folded into the conv
before it (the stem's into conv1, an MBConv's pre-norm and first norm into
its 1x1 expansion, its second norm into the depthwise conv), as the served
model folds them, so the weights hold no BatchNorm and each of those convs
carries a bias; the 1x1 convs and the stem's conv2 are PQ convs and every
FC is a PQ layer whose dense weight is decoded from random codebooks and
ids (``pq.decode_conv``, ``pq.decode_rows``); the stem's conv1 and the
depthwise convs are dense; the LayerNorms are random, and the
relative-position tables are drawn at the configuration's
``pq.rel_bias_scale`` (N(0, 1)), far above timm's init of 0.02, so that the
bias is a visible part of the logits, as Swin's configuration argues.

Also here: the configuration's sizes and the shapes of its layers, which
the harness's generator, FLOP count and kernel work read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_cuda.reference.pq import NoTF32, decode_conv, decode_rows, same

CHUNK = 16  # images a pass of the reference, so that its float32 maps fit


def sizes(cfg: dict) -> dict:
    """{"image", "stem", "dims", "depths", "heads", "grids", "window",
    "mid", "se", "mlp", "hidden", "classes", "eps"}: per stage its width,
    depth, heads, map side (after its first, stride-2, block); the
    partition's side; each stage's MBConv and squeeze-excite widths."""
    h, w, c = cfg["input"]
    dims, depths = list(cfg["embed_dim"]), list(cfg["depths"])
    p, hd = cfg["partition_size"], cfg["dim_head"]
    if h != w or c != 3 or len(dims) != len(depths):
        raise ValueError(f"input {cfg['input']}, widths {dims} and depths "
                         f"{depths} do not make a MaxViT")
    grids, g = [], -(-h // 2)
    for d in dims:
        g = -(-g // 2)
        if d % hd or g % p:
            raise ValueError(f"width {d}, map {g} and partition {p} do not "
                             "make a MaxViT stage")
        grids.append(g)
    return {"image": h, "stem": cfg["stem_width"], "dims": dims,
            "depths": depths, "heads": [d // hd for d in dims],
            "grids": grids, "window": p,
            "mid": [int(cfg["expand_ratio"] * d) for d in dims],
            "se": [int(cfg["se_ratio"] * d) for d in dims],
            "mlp": cfg["mlp_ratio"], "hidden": cfg["head_hidden_size"],
            "classes": cfg["num_classes"], "eps": cfg["layernorm_epsilon"]}


def blocks(cfg: dict) -> list:
    """(key, stage, block) of every block in forward order."""
    z = sizes(cfg)
    return [(f"s{i}b{j}", i, j) for i, depth in enumerate(z["depths"])
            for j in range(depth)]


def layers(cfg: dict) -> list:
    """Every weighted layer in forward order: (path, kind, kernel side,
    Cin a group, Cout, output pixels or rows of one image) with kind "conv"
    (PQ), "dense" (the stem's conv1), "dw" (a depthwise conv: Cin a group
    1) or "fc" (PQ); path is the key path into the weights."""
    z = sizes(cfg)
    s, half = z["stem"], -(-z["image"] // 2)
    out = [(("stem", "conv1"), "dense", 3, 3, s, half ** 2),
           (("stem", "conv2"), "conv", 3, s, s, half ** 2)]
    cin, g_in = s, half
    for key, i, j in blocks(cfg):
        c, m, r, g = z["dims"][i], z["mid"][i], z["se"][i], z["grids"][i]
        g_in = g_in if j else 2 * g
        if j == 0:
            out.append(((key, "mbconv", "proj"), "conv", 1, cin, c, g * g))
        out += [((key, "mbconv", "conv1"), "conv", 1, cin, m, g_in ** 2),
                ((key, "mbconv", "dw"), "dw", 3, 1, m, g * g),
                ((key, "mbconv", "se1"), "fc", 1, m, r, 1),
                ((key, "mbconv", "se2"), "fc", 1, r, m, 1),
                ((key, "mbconv", "conv3"), "conv", 1, m, c, g * g)]
        for part in ("block", "grid"):
            n = g * g
            out += [((key, part, "qkv"), "fc", 1, c, 3 * c, n),
                    ((key, part, "out"), "fc", 1, c, c, n),
                    ((key, part, "mlp1"), "fc", 1, c, z["mlp"] * c, n),
                    ((key, part, "mlp2"), "fc", 1, z["mlp"] * c, c, n)]
        cin, g_in = c, g
    f = z["dims"][-1]
    out += [(("head", "pre"), "fc", 1, f, z["hidden"], 1),
            (("head", "fc"), "fc", 1, z["hidden"], z["classes"], 1)]
    return out


def attention_work(cfg: dict) -> list:
    """(tokens, width, heads) of one image's attention of every partition
    block in forward order, block then grid in each block."""
    z = sizes(cfg)
    return [(z["grids"][i] ** 2, z["dims"][i], z["heads"][i])
            for _, i, _ in blocks(cfg) for _ in ("block", "grid")]


def flops_per_image(cfg: dict) -> float:
    """2 x the multiply-adds of the convolutions, the FCs and attention's
    two products, q k^T and the weights times v (per window and head N^2 x
    head dim each, so 2 N C a token, N = P^2); the biases, norms,
    activations, pools, the squeeze-excite's scale and the softmax are not
    counted."""
    total = sum(2 * px * k * k * ci * co for _, _, k, ci, co, px
                in layers(cfg))
    n = sizes(cfg)["window"] ** 2
    total += sum(2 * 2 * t * n * c for t, c, _ in attention_work(cfg))
    return float(total)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TensorFlow's 'same' padding of an NCHW map for a k x k conv of
    stride s: the total (ceil(n / s) - 1) s + k - n a side split with the
    odd pixel after."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad lists the last axis first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def conv(x, p: dict, cin: int, stride: int = 1, groups: int = 1,
         operand=same) -> torch.Tensor:
    """A conv of NCHW x by the layer's weight (decoded where PQ; HWIO where
    dense), 'same' padded, plus its bias."""
    if "codebooks" in p:
        w = decode_conv(p["codebooks"], p["assignments"], cin)
    else:
        w = p["kernel"].float().permute(3, 2, 0, 1)
    if w.shape[-1] > 1:
        x = pad_same(x, w.shape[-1], stride)
    return F.conv2d(operand(x), operand(w), p["bias"].float(),
                    stride=stride, groups=groups)


def linear(x: torch.Tensor, p: dict, cin: int, operand=same) -> torch.Tensor:
    w = decode_rows(p["codebooks"], p["assignments"], cin)
    return operand(x) @ operand(w).t() + p["bias"].float()


def layernorm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"].float() \
        + p["shift"].float()


def mbconv(x, p: dict, stride: int, cin: int, mid: int, r: int,
           operand=same) -> torch.Tensor:
    """timm's MbConvBlock on NCHW x, its BatchNorms folded."""
    shortcut = x
    if stride == 2:
        shortcut = conv(F.avg_pool2d(x, 2, 2), p["proj"], cin,
                        operand=operand)
    y = gelu(conv(x, p["conv1"], cin, operand=operand))
    y = gelu(conv(y, p["dw"], 1, stride, groups=mid, operand=operand))
    s = F.silu(linear(y.mean((2, 3)), p["se1"], mid, operand))
    s = torch.sigmoid(linear(s, p["se2"], r, operand))
    y = y * s[:, :, None, None]
    return conv(y, p["conv3"], mid, operand=operand) + shortcut


def lookup(length: int, device) -> torch.Tensor:
    """timm's ``generate_lookup_tensor``: (length, length, 2 length - 1)
    one-hot, [i, x, x - i + length - 1] = 1."""
    ret = torch.zeros(length, length, 2 * length - 1, device=device)
    for i in range(length):
        for x in range(length):
            ret[i, x, x - i + length - 1] = 1
    return ret


def bias_tf(table: torch.Tensor) -> torch.Tensor:
    """timm's ``RelPosBiasTf.get_bias``: (heads, 2P - 1, 2P - 1) ->
    (heads, P^2, P^2) by the one-hot einsums of
    ``reindex_2d_einsum_kronecker``."""
    p = (table.shape[1] + 1) // 2
    look = lookup(p, table.device)
    t = torch.einsum("nhw,ixh->nixw", table.float(), look)
    t = torch.einsum("nixw,jyw->nijxy", t, look)
    return t.reshape(table.shape[0], p * p, p * p)


def partition(x: torch.Tensor, p: int, kind: str) -> torch.Tensor:
    """(B, H, W, C) -> (B x windows, P, P, C): timm's ``window_partition``
    ("block") or ``grid_partition`` ("grid")."""
    b, h, w, c = x.shape
    if kind == "block":
        x = x.view(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    else:
        x = x.view(b, p, h // p, p, w // p, c).permute(0, 2, 4, 1, 3, 5)
    return x.contiguous().view(-1, p, p, c)


def reverse(windows: torch.Tensor, p: int, h: int, w: int,
            kind: str) -> torch.Tensor:
    """timm's ``window_reverse`` / ``grid_reverse``."""
    c = windows.shape[-1]
    if kind == "block":
        x = windows.view(-1, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4,
                                                              5)
    else:
        x = windows.view(-1, h // p, w // p, p, p, c).permute(0, 3, 1, 4, 2,
                                                              5)
    return x.contiguous().view(-1, h, w, c)


def attention(x: torch.Tensor, p: dict, heads: int,
              operand=same) -> torch.Tensor:
    """timm's AttentionCl (head_first=False) on (B', N, C) windows, with
    the ``bias_tf`` bias; the out projection included."""
    bw, n, c = x.shape
    hd = c // heads
    q, k, v = linear(x, p["qkv"], c, operand).reshape(
        bw, n, 3, heads, hd).transpose(1, 3).unbind(2)
    attn = (operand(q * hd ** -0.5) @ operand(k).transpose(-2, -1)
            + bias_tf(p["rel_table"]))
    attn = torch.softmax(attn, dim=-1)
    o = (operand(attn) @ operand(v)).transpose(1, 2).reshape(bw, n, c)
    return linear(o, p["out"], c, operand)


def partition_block(x: torch.Tensor, p: dict, kind: str, window: int,
                    heads: int, z: dict, operand=same) -> torch.Tensor:
    """timm's PartitionAttentionCl on (B, H, W, C)."""
    b, h, w, c = x.shape
    y = partition(layernorm(x, p["ln1"], z["eps"]), window, kind)
    y = attention(y.view(-1, window * window, c), p, heads, operand)
    x = x + reverse(y.view(-1, window, window, c), window, h, w, kind)
    y = gelu(linear(layernorm(x, p["ln2"], z["eps"]), p["mlp1"], c,
                    operand))
    return x + linear(y, p["mlp2"], z["mlp"] * c, operand)


def _logits(cfg: dict, weights: dict, x: torch.Tensor,
            operand=same) -> torch.Tensor:
    z = sizes(cfg)
    st = weights["stem"]
    x = gelu(conv(x.permute(0, 3, 1, 2), st["conv1"], 3, 2, operand=operand))
    x = conv(x, st["conv2"], z["stem"], operand=operand)
    cin = z["stem"]
    for key, i, j in blocks(cfg):
        c = z["dims"][i]
        x = mbconv(x, weights[key]["mbconv"], 1 if j else 2, cin,
                   z["mid"][i], z["se"][i], operand)
        x = x.permute(0, 2, 3, 1)
        for kind in ("block", "grid"):
            x = partition_block(x, weights[key][kind], kind, z["window"],
                                z["heads"][i], z, operand)
        x = x.permute(0, 3, 1, 2)
        cin = c
    hd = weights["head"]
    x = layernorm(x.mean((2, 3)), hd["norm"], z["eps"])
    x = torch.tanh(linear(x, hd["pre"], z["dims"][-1], operand))
    return linear(x, hd["fc"], z["hidden"], operand)


def logits(cfg: dict, weights: dict, x_nhwc: torch.Tensor,
           operand=same) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, classes) float32 logits, ``CHUNK``
    images a pass. ``operand`` rounds both operands of every conv, FC and
    attention product (``pq.e4m3`` for the control); the identity by
    default."""
    with NoTF32(), torch.no_grad():
        x = x_nhwc.float()
        return torch.cat([_logits(cfg, weights, x[i:i + CHUNK], operand)
                          for i in range(0, x.shape[0], CHUNK)])
