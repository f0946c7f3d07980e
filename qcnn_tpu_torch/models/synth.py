"""Synthetic parameter generators for any ModelSpec.

A copy of ``qcnn_tpu/models/synth.py`` (NumPy only, so the same seed gives
the same parameters in both packages).

Used by benchmarks, the multi-chip dry-run, and tests that need a full
parameter pytree without the reference weight files. The codebook geometry
policy mirrors the shipped AlexNet configuration (SURVEY.md §2a): conv layers
use 8-wide sub-spaces with 128 codewords; FC layers 4-wide with 32 codewords;
a final classifier FC gets scalar sub-spaces with 16 codewords, matching
fc8's (4096, 16, 1) codebook.

``random_resnet_pq_params``, ``random_vit_pq_params``,
``random_swin_pq_params`` and ``random_maxvit_pq_params`` are the port's
own: random codebooks and ids at the families' geometry, without the
k-means of the families' ``quantize_params``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from qcnn_tpu_torch.core import (
    ConvSpec,
    FCSpec,
    ModelSpec,
    dense_conv_params,
    dense_fc_params,
    pq_conv_params,
    pq_fc_params,
)
from qcnn_tpu_torch.models import maxvit, resnet, swin


@dataclasses.dataclass(frozen=True)
class CodebookPolicy:
    """Per-layer-kind (K, D) geometry; S is derived from the input width."""

    conv_codewords: int = 128
    conv_subvec_len: int = 8
    fc_codewords: int = 32
    fc_subvec_len: int = 4
    classifier_codewords: int = 16
    classifier_subvec_len: int = 1

    def conv_skd(self, cin_per_group: int) -> tuple[int, int, int]:
        # Fixed D with zero-padded overhang, like the reference's conv1
        # (3 channels in one 8-wide sub-space, CaffeEva.cc:1277).
        d = self.conv_subvec_len
        s = -(-cin_per_group // d)
        return s, self.conv_codewords, d

    def fc_skd(self, cin: int, is_classifier: bool) -> tuple[int, int, int]:
        if is_classifier:
            d = self.classifier_subvec_len
            k = self.classifier_codewords
        else:
            d = self.fc_subvec_len
            k = self.fc_codewords
        s = -(-cin // d)
        return s, k, d


DEFAULT_POLICY = CodebookPolicy()


def random_pq_params(
    spec: ModelSpec,
    seed: int = 0,
    policy: CodebookPolicy = DEFAULT_POLICY,
) -> list:
    """Full PQ parameter pytree with deterministic pseudo-random contents."""
    rng = np.random.default_rng(seed)
    params: list = []
    shapes = spec.feature_shapes(batch=1)
    fc_indices = [
        i for i, l in enumerate(spec.layers) if isinstance(l, FCSpec)
    ]
    last_fc = fc_indices[-1] if fc_indices else -1
    for i, layer in enumerate(spec.layers):
        _, h, w, c = shapes[i]
        if isinstance(layer, ConvSpec):
            cg = c // layer.groups
            s, k, d = policy.conv_skd(cg)
            ctrd = rng.standard_normal((s, k, d)).astype(np.float32) * 0.05
            asmt = rng.integers(
                0, k, size=(layer.out_channels, layer.kernel, layer.kernel, s),
                dtype=np.uint8,
            )
            bias = rng.standard_normal(layer.out_channels).astype(np.float32) * 0.01
            params.append(pq_conv_params(ctrd, asmt, bias))
        elif isinstance(layer, FCSpec):
            cin = h * w * c
            s, k, d = policy.fc_skd(cin, is_classifier=(i == last_fc))
            ctrd = rng.standard_normal((s, k, d)).astype(np.float32) * 0.02
            asmt = rng.integers(
                0, k, size=(layer.out_features, s), dtype=np.uint8
            )
            bias = rng.standard_normal(layer.out_features).astype(np.float32) * 0.01
            params.append(pq_fc_params(ctrd, asmt, bias))
        else:
            params.append(None)
    return params


def random_dense_params(spec: ModelSpec, seed: int = 0) -> list:
    """Dense (FP32) parameter pytree — input to the quantizer and baselines."""
    rng = np.random.default_rng(seed)
    params: list = []
    shapes = spec.feature_shapes(batch=1)
    for i, layer in enumerate(spec.layers):
        _, h, w, c = shapes[i]
        if isinstance(layer, ConvSpec):
            cg = c // layer.groups
            fan_in = layer.kernel * layer.kernel * cg
            knl = rng.standard_normal(
                (layer.kernel, layer.kernel, cg, layer.out_channels)
            ).astype(np.float32) / np.sqrt(fan_in)
            bias = np.zeros(layer.out_channels, np.float32)
            params.append(dense_conv_params(knl, bias))
        elif isinstance(layer, FCSpec):
            cin = h * w * c
            wei = rng.standard_normal((cin, layer.out_features)).astype(
                np.float32
            ) / np.sqrt(cin)
            bias = np.zeros(layer.out_features, np.float32)
            params.append(dense_fc_params(wei, bias))
        else:
            params.append(None)
    return params


def random_resnet_pq_params(spec, seed: int = 0) -> dict:
    """Synthetic PQ params for a ``models.resnet.ResNetSpec`` (NumPy), in the
    layout and geometry of ``resnet.quantize_params`` at its defaults
    (random codewords, no k-means): convs with
    cin >= 16 get D=4, K=128 and S = ceil(cin / 4); the stem stays dense;
    the fc gets D=4, K=32. Codewords are scaled like
    ``resnet.init_dense_params`` (1/sqrt(kh*kw*cin)), so decoded weights
    have its variance and the activations stay finite through 50 bf16
    layers; biases are small."""
    rng = np.random.default_rng(seed)
    d = 4  # sub-space width of convs and fc

    def pq_conv(kh, cin, cout):
        if cin < 16:
            return {"kernel": (rng.standard_normal((kh, kh, cin, cout))
                               / np.sqrt(kh * kh * cin)).astype(np.float32),
                    "bias": np.zeros(cout, np.float32)}
        s = -(-cin // d)
        return pq_conv_params(
            (rng.standard_normal((s, 128, d))
             / np.sqrt(kh * kh * cin)).astype(np.float32),
            rng.integers(0, 128, size=(cout, kh, kh, s), dtype=np.uint8),
            (rng.standard_normal(cout) * 0.01).astype(np.float32))

    params: dict = {"stem": pq_conv(7, 3, 64)}
    for key, _, convs in resnet.block_layout(spec):
        params[key] = {name: pq_conv(kh, ci, co)
                       for name, kh, ci, co in convs}
    cin = spec.stage_channels[-1]
    s = -(-cin // d)
    params["fc"] = pq_fc_params(
        (rng.standard_normal((s, 32, d)) / np.sqrt(cin)).astype(np.float32),
        rng.integers(0, 32, size=(spec.num_classes, s), dtype=np.uint8),
        (rng.standard_normal(spec.num_classes) * 0.01).astype(np.float32))
    return params


def random_vit_pq_params(spec, seed: int = 0) -> dict:
    """Synthetic PQ params for a ``models.vit.ViTSpec`` (NumPy), in the
    layout and geometry of the JAX package's ``vit.quantize_params`` at its
    defaults (``subvec_len=4``, ``num_codewords=32``): every GEMM gets D=4,
    K=32 and S = ceil(Cin / 4); the LayerNorms, ``cls_token`` and
    ``pos_embed`` stay dense, with the keys of ``vit.init_dense_params``.
    Codewords are scaled by 1/sqrt(Cin), so decoded weights have
    ``init_dense_params``' variance; biases, the LayerNorms' offsets from
    (1, 0) and the class token are small and random, so that each reaches
    the output."""
    rng = np.random.default_rng(seed)
    d, k = 4, 32

    def gemm(cin, cout):
        s = -(-cin // d)
        return pq_fc_params(
            (rng.standard_normal((s, k, d)) / np.sqrt(cin)).astype(np.float32),
            rng.integers(0, k, size=(cout, s), dtype=np.uint8),
            (rng.standard_normal(cout) * 0.01).astype(np.float32))

    def ln(dim):
        return {"scale": (1 + 0.05 * rng.standard_normal(dim)).astype(
                    np.float32),
                "shift": (0.02 * rng.standard_normal(dim)).astype(np.float32)}

    dim = spec.dim
    params: dict = {
        "patch_embed": gemm(spec.patch * spec.patch * 3, dim),
        "cls_token": (0.02 * rng.standard_normal((1, 1, dim))).astype(
            np.float32),
        "pos_embed": (0.02 * rng.standard_normal((1, spec.seq_len, dim))
                      ).astype(np.float32),
        "head": gemm(dim, spec.num_classes),
        "ln_final": ln(dim),
    }
    for i in range(spec.depth):
        params[f"blk{i}"] = {
            "ln1": ln(dim),
            "qkv": gemm(dim, 3 * dim),
            "out": gemm(dim, dim),
            "ln2": ln(dim),
            "mlp1": gemm(dim, spec.mlp_ratio * dim),
            "mlp2": gemm(spec.mlp_ratio * dim, dim),
        }
    return params


def random_swin_pq_params(spec, seed: int = 0) -> dict:
    """Synthetic PQ params for a ``models.swin.SwinSpec`` (NumPy), in the
    layout of ``swin.init_dense_params`` and the geometry of
    ``swin.quantize_params`` at its defaults: every GEMM D=4, K=32, S =
    ceil(Cin / 4), codewords N(0, 1/Cin), biases N(0, 0.01^2) but the
    merges' reductions, whose bias is zero (the published layer has none);
    LayerNorm scales 1 + 0.05 N(0, 1) and shifts 0.02 N(0, 1), as
    :func:`random_vit_pq_params` draws them. The relative-position tables
    are N(0, 1): at Swin's init of 0.02 the bias would be a negligible part
    of logits of about unit spread."""
    rng = np.random.default_rng(seed)
    d, k = 4, 32

    def gemm(cin, cout, bias=True):
        s = -(-cin // d)
        return pq_fc_params(
            (rng.standard_normal((s, k, d)) / np.sqrt(cin)).astype(np.float32),
            rng.integers(0, k, size=(cout, s), dtype=np.uint8),
            (rng.standard_normal(cout) * 0.01).astype(np.float32) if bias
            else np.zeros(cout, np.float32))

    def ln(dim):
        return {"scale": (1 + 0.05 * rng.standard_normal(dim)).astype(
                    np.float32),
                "shift": (0.02 * rng.standard_normal(dim)).astype(np.float32)}

    c = spec.embed_dim
    params: dict = {"patch_embed": gemm(spec.patch ** 2 * 3, c),
                    "patch_norm": ln(c)}
    for blk in swin.block_layout(spec):
        dim = blk.dim
        params[blk.key] = {
            "ln1": ln(dim),
            "qkv": gemm(dim, 3 * dim),
            "rel_table": rng.standard_normal(
                ((2 * blk.window - 1) ** 2, blk.heads)).astype(np.float32),
            "out": gemm(dim, dim),
            "ln2": ln(dim),
            "mlp1": gemm(dim, spec.mlp_ratio * dim),
            "mlp2": gemm(spec.mlp_ratio * dim, dim),
        }
    for i in range(len(spec.depths) - 1):
        dim = c * 2 ** i
        params[f"s{i}merge"] = {"norm": ln(4 * dim),
                                "reduction": gemm(4 * dim, 2 * dim,
                                                  bias=False)}
    params["ln_final"] = ln(spec.final_dim)
    params["head"] = gemm(spec.final_dim, spec.num_classes)
    return params


def random_maxvit_pq_params(spec, seed: int = 0) -> dict:
    """Synthetic PQ params for a ``models.maxvit.MaxViTSpec`` (NumPy), in
    the layout of ``maxvit.init_dense_params`` (every BatchNorm folded) and
    the geometry of ``maxvit.quantize_params`` at its defaults: the 1x1
    convs and the stem's conv2 D=4, K=128, every GEMM D=4, K=32, S =
    ceil(Cin / 4); the stem's conv1 and the depthwise convs dense. Weights
    and codewords N(0, 1/fan-in), biases N(0, 0.01^2); LayerNorm scales
    1 + 0.05 N(0, 1) and shifts 0.02 N(0, 1), as
    :func:`random_swin_pq_params` draws them; the relative-position tables
    N(0, 1), as Swin's."""
    rng = np.random.default_rng(seed)
    d = 4

    def bias(cout):
        return (rng.standard_normal(cout) * 0.01).astype(np.float32)

    def pq_conv(kh, cin, cout):
        s = -(-cin // d)
        return pq_conv_params(
            (rng.standard_normal((s, 128, d))
             / np.sqrt(kh * kh * cin)).astype(np.float32),
            rng.integers(0, 128, size=(cout, kh, kh, s), dtype=np.uint8),
            bias(cout))

    def dense_conv(kh, cin, cout):
        return {"kernel": (rng.standard_normal((kh, kh, cin, cout))
                           / np.sqrt(kh * kh * cin)).astype(np.float32),
                "bias": bias(cout)}

    def gemm(cin, cout):
        s = -(-cin // d)
        return pq_fc_params(
            (rng.standard_normal((s, 32, d)) / np.sqrt(cin)).astype(
                np.float32),
            rng.integers(0, 32, size=(cout, s), dtype=np.uint8), bias(cout))

    def ln(dim):
        return {"scale": (1 + 0.05 * rng.standard_normal(dim)).astype(
                    np.float32),
                "shift": (0.02 * rng.standard_normal(dim)).astype(np.float32)}

    st = spec.stem_width
    params: dict = {"stem": {"conv1": dense_conv(3, 3, st),
                             "conv2": pq_conv(3, st, st)}}
    for blk in maxvit.block_layout(spec):
        c, m = blk.dim, blk.mid
        mb = {"proj": pq_conv(1, blk.cin, c)} if blk.stride == 2 else {}
        mb.update(conv1=pq_conv(1, blk.cin, m), dw=dense_conv(3, 1, m),
                  se1=gemm(m, blk.se), se2=gemm(blk.se, m),
                  conv3=pq_conv(1, m, c))
        params[blk.key] = {"mbconv": mb}
        for part in maxvit.PARTS:
            params[blk.key][part] = {
                "ln1": ln(c),
                "qkv": gemm(c, 3 * c),
                "rel_table": rng.standard_normal(
                    (blk.heads, 2 * blk.window - 1,
                     2 * blk.window - 1)).astype(np.float32),
                "out": gemm(c, c),
                "ln2": ln(c),
                "mlp1": gemm(c, maxvit.MLP_RATIO * c),
                "mlp2": gemm(maxvit.MLP_RATIO * c, c),
            }
    f = spec.dims[-1]
    params["head"] = {"norm": ln(f), "pre": gemm(f, f),
                      "fc": gemm(f, spec.num_classes)}
    return params


def random_input(spec: ModelSpec, batch: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch, spec.in_height, spec.in_width, spec.in_channels)
    ).astype(np.float32)
