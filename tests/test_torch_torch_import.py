"""The port's torch-ecosystem importer (models/torch_import.py) against the
JAX package's, on state_dicts built here in torchvision's and timm's
naming (no torchvision or timm needed).

- The three importers give the JAX importer's arrays bit for bit (dense
  NumPy params in HWIO / (Cin, Cout) layout, BatchNorm folded).
- The port's ViT forward on imported ViT-S/16 params, in float32, matches a
  torch-functional oracle forward of the state_dict (F.conv2d patch
  embedding, F.layer_norm, exact GELU) within 1e-4 of the largest |logit|
  (measured 8.5e-7 on the CPU).
- ``load_torch_*`` read a ``.pth`` in ``tmp_path``: a bare state_dict and
  the ``{"state_dict": ...}`` and ``{"model": ...}`` wrappers.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import qcnn_tpu.core as jcore
import qcnn_tpu_torch.core as tcore
from qcnn_tpu.models import resnet as jresnet
from qcnn_tpu.models import torch_import as jimport
from qcnn_tpu.models import vit as jvit
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models import torch_import as timport
from qcnn_tpu_torch.models import vit as tvit

SMALL_RESNET = dict(name="small", stage_depths=(1, 2),
                    stage_channels=(64, 128), num_classes=10, in_size=32,
                    bottleneck=True)


def _mk_state_dict(spec, rng):
    """Random torchvision-naming ResNet state_dict for `spec`."""
    sd = {}

    def add_conv(name, cout, cin, k):
        w = rng.standard_normal((cout, cin, k, k)) / np.sqrt(cin * k * k)
        sd[f"{name}.weight"] = torch.tensor(w, dtype=torch.float32)

    def add_bn(name, c):
        sd[f"{name}.weight"] = torch.tensor(
            1.0 + 0.1 * rng.standard_normal(c), dtype=torch.float32)
        sd[f"{name}.bias"] = torch.tensor(
            0.05 * rng.standard_normal(c), dtype=torch.float32)
        sd[f"{name}.running_mean"] = torch.tensor(
            0.05 * rng.standard_normal(c), dtype=torch.float32)
        sd[f"{name}.running_var"] = torch.tensor(
            0.5 + rng.random(c), dtype=torch.float32)

    add_conv("conv1", 64, 3, 7)
    add_bn("bn1", 64)
    cin = 64
    for s, depth in enumerate(spec.stage_depths):
        mid, cout = tresnet._block_channels(spec, s)
        for b in range(depth):
            p = f"layer{s + 1}.{b}"
            stride = 2 if (s > 0 and b == 0) else 1
            if spec.bottleneck:
                add_conv(f"{p}.conv1", mid, cin, 1)
                add_bn(f"{p}.bn1", mid)
                add_conv(f"{p}.conv2", mid, mid, 3)
                add_bn(f"{p}.bn2", mid)
                add_conv(f"{p}.conv3", cout, mid, 1)
                add_bn(f"{p}.bn3", cout)
            else:
                add_conv(f"{p}.conv1", mid, cin, 3)
                add_bn(f"{p}.bn1", mid)
                add_conv(f"{p}.conv2", cout, mid, 3)
                add_bn(f"{p}.bn2", cout)
            if stride != 1 or cin != cout:
                add_conv(f"{p}.downsample.0", cout, cin, 1)
                add_bn(f"{p}.downsample.1", cout)
            cin = cout
    w = rng.standard_normal((spec.num_classes, cin)) / np.sqrt(cin)
    sd["fc.weight"] = torch.tensor(w, dtype=torch.float32)
    sd["fc.bias"] = torch.tensor(
        0.05 * rng.standard_normal(spec.num_classes), dtype=torch.float32)
    return sd


def _mk_vit_state_dict(spec, rng):
    """Random timm-naming ViT state_dict."""
    d = spec.dim
    sd = {}

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def gemm(name, cin, cout):
        sd[f"{name}.weight"] = t(rng.standard_normal((cout, cin))
                                 / np.sqrt(cin))
        sd[f"{name}.bias"] = t(0.02 * rng.standard_normal(cout))

    def ln(name, c):
        sd[f"{name}.weight"] = t(1.0 + 0.05 * rng.standard_normal(c))
        sd[f"{name}.bias"] = t(0.02 * rng.standard_normal(c))

    p = spec.patch
    sd["patch_embed.proj.weight"] = t(
        rng.standard_normal((d, 3, p, p)) / np.sqrt(3 * p * p))
    sd["patch_embed.proj.bias"] = t(0.02 * rng.standard_normal(d))
    sd["cls_token"] = t(0.02 * rng.standard_normal((1, 1, d)))
    sd["pos_embed"] = t(0.02 * rng.standard_normal((1, spec.seq_len, d)))
    for i in range(spec.depth):
        b = f"blocks.{i}"
        ln(f"{b}.norm1", d)
        gemm(f"{b}.attn.qkv", d, 3 * d)
        gemm(f"{b}.attn.proj", d, d)
        ln(f"{b}.norm2", d)
        gemm(f"{b}.mlp.fc1", d, spec.mlp_ratio * d)
        gemm(f"{b}.mlp.fc2", spec.mlp_ratio * d, d)
    ln("norm", d)
    gemm("head", d, spec.num_classes)
    return sd


def _torch_vit_forward(spec, sd, x_nchw):
    """Minimal timm-semantics ViT inference in torch (float64 here: the
    oracle, not a second float32 implementation)."""
    sd = {k: v.double() for k, v in sd.items()}
    d, nh = spec.dim, spec.heads
    hd = d // nh

    def ln(name, y):
        return F.layer_norm(y, (d,), sd[f"{name}.weight"],
                            sd[f"{name}.bias"], eps=1e-6)

    def gemm(name, y):
        return y @ sd[f"{name}.weight"].t() + sd[f"{name}.bias"]

    with torch.no_grad():
        y = F.conv2d(x_nchw.double(), sd["patch_embed.proj.weight"],
                     sd["patch_embed.proj.bias"], stride=spec.patch)
        b = y.shape[0]
        y = y.flatten(2).transpose(1, 2)  # (B, N, D)
        cls = sd["cls_token"].expand(b, -1, -1)
        y = torch.cat([cls, y], dim=1) + sd["pos_embed"]
        for i in range(spec.depth):
            blk = f"blocks.{i}"
            z = ln(f"{blk}.norm1", y)
            qkv = gemm(f"{blk}.attn.qkv", z)
            qkv = qkv.reshape(b, -1, 3, nh, hd).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]  # (B, nh, N, hd)
            att = (q @ k.transpose(-2, -1)) / np.sqrt(hd)
            att = att.softmax(dim=-1)
            z = (att @ v).transpose(1, 2).reshape(b, -1, d)
            y = y + gemm(f"{blk}.attn.proj", z)
            z = ln(f"{blk}.norm2", y)
            z = F.gelu(gemm(f"{blk}.mlp.fc1", z))
            y = y + gemm(f"{blk}.mlp.fc2", z)
        y = ln("norm", y)
        return gemm("head", y[:, 0]).numpy()


def _mini_vgg_spec(core):
    return core.ModelSpec(
        name="MiniVGG", in_height=16, in_width=16, in_channels=3,
        layers=(
            core.ConvSpec(kernel=3, out_channels=8, pad=1), core.ReLUSpec(),
            core.PoolSpec(kernel=2, stride=2),
            core.ConvSpec(kernel=3, out_channels=16, pad=1),
            core.ReLUSpec(), core.PoolSpec(kernel=2, stride=2),
            core.FCSpec(32), core.ReLUSpec(), core.DropoutSpec(0.5),
            core.FCSpec(10), core.SoftmaxSpec(),
        ),
    )


def _mk_linear_state_dict(rng):
    """torchvision vgg-style naming for the mini VGG (gaps in the indices
    where ReLU/pool/dropout modules would sit, like the real vgg16)."""
    sd = {}

    def conv(i, cin, cout):
        sd[f"features.{i}.weight"] = torch.tensor(
            rng.standard_normal((cout, cin, 3, 3)) / np.sqrt(cin * 9),
            dtype=torch.float32)
        sd[f"features.{i}.bias"] = torch.tensor(
            0.02 * rng.standard_normal(cout), dtype=torch.float32)

    def fc(i, cin, cout):
        sd[f"classifier.{i}.weight"] = torch.tensor(
            rng.standard_normal((cout, cin)) / np.sqrt(cin),
            dtype=torch.float32)
        sd[f"classifier.{i}.bias"] = torch.tensor(
            0.02 * rng.standard_normal(cout), dtype=torch.float32)

    conv(0, 3, 8)
    conv(3, 8, 16)
    fc(0, 16 * 4 * 4, 32)
    fc(3, 32, 10)
    return sd


def _same(ours, theirs, where="params"):
    if isinstance(theirs, dict):
        assert ours.keys() == theirs.keys(), where
        for key in theirs:
            _same(ours[key], theirs[key], f"{where}.{key}")
    elif isinstance(theirs, list):
        assert len(ours) == len(theirs)
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _same(a, b, f"{where}[{i}]")
    elif theirs is None:
        assert ours is None, where
    else:
        assert isinstance(ours, np.ndarray), where
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, \
            where
        np.testing.assert_array_equal(ours, theirs, err_msg=where)


@pytest.mark.parametrize("kind", ["small", "resnet18"])
def test_resnet_importer_gives_the_jax_importers_bits(kind):
    if kind == "small":
        tspec = tresnet.ResNetSpec(**SMALL_RESNET)
        jspec = jresnet.ResNetSpec(**SMALL_RESNET)
    else:
        tspec, jspec = tresnet.resnet18(), jresnet.resnet18()
    sd = _mk_state_dict(tspec, np.random.default_rng(3))
    _same(timport.resnet_from_torch_state_dict(tspec, sd),
          jimport.resnet_from_torch_state_dict(jspec, sd))


@pytest.mark.parametrize("model", ["vit_tiny_test", "vit_s16"])
def test_vit_importer_gives_the_jax_importers_bits(model):
    tspec, jspec = getattr(tvit, model)(), getattr(jvit, model)()
    sd = _mk_vit_state_dict(tspec, np.random.default_rng(7))
    ours = timport.vit_from_torch_state_dict(tspec, sd)
    _same(ours, jimport.vit_from_torch_state_dict(jspec, sd))
    p = tspec.patch
    assert ours["patch_embed"]["weight"].shape == (p * p * 3, tspec.dim)
    # the (row, col, channel) order of vit.forward's patch vectors
    w = sd["patch_embed.proj.weight"].numpy()
    np.testing.assert_array_equal(ours["patch_embed"]["weight"][
        (1 * p + 2) * 3 + 1], w[:, 1, 1, 2])


def test_linear_importer_gives_the_jax_importers_bits():
    sd = _mk_linear_state_dict(np.random.default_rng(11))
    ours = timport.linear_from_torch_state_dict(_mini_vgg_spec(tcore), sd)
    _same(ours, jimport.linear_from_torch_state_dict(_mini_vgg_spec(jcore),
                                                     sd))
    del sd["classifier.3.weight"]
    with pytest.raises(ValueError, match="learnable torch layers"):
        timport.linear_from_torch_state_dict(_mini_vgg_spec(tcore), sd)


def test_imported_vit_s16_matches_a_torch_oracle():
    """ViT-S/16 from a timm-naming state_dict, prepared in float32 and run
    by the port's forward at B=1, against the state_dict's own forward."""
    spec = tvit.vit_s16()
    rng = np.random.default_rng(7)
    sd = _mk_vit_state_dict(spec, rng)
    x = rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
    want = _torch_vit_forward(spec, sd, torch.from_numpy(
        np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))))
    params = tvit.prepare_params(
        spec, timport.vit_from_torch_state_dict(spec, sd),
        dtype=torch.float32, device="cpu")
    got = tvit.forward(params, x, spec=spec, device="cpu").numpy()
    assert np.all(np.isfinite(want)) and np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("wrapper", [None, "state_dict", "model"])
def test_load_torch_reads_pth_files(tmp_path, wrapper):
    rng = np.random.default_rng(5)
    rspec = tresnet.ResNetSpec(**SMALL_RESNET)
    vspec = tvit.vit_tiny_test()
    cases = (
        (timport.load_torch_resnet, timport.resnet_from_torch_state_dict,
         rspec, _mk_state_dict(rspec, rng)),
        (timport.load_torch_vit, timport.vit_from_torch_state_dict, vspec,
         _mk_vit_state_dict(vspec, rng)),
        (timport.load_torch_linear, timport.linear_from_torch_state_dict,
         _mini_vgg_spec(tcore), _mk_linear_state_dict(rng)),
    )
    for i, (load, from_sd, spec, sd) in enumerate(cases):
        path = str(tmp_path / f"w{i}.pth")
        torch.save(sd if wrapper is None else {wrapper: sd, "epoch": 3},
                   path)
        _same(load(spec, path), from_sd(spec, sd))
