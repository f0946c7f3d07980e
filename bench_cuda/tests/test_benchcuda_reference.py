"""The frozen generators and the plain reference against the port's CPU
forward: at a small size through the harness's builders, and at the
configurations' own widths at a batch of one."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from bench_cuda import harness
from conftest import ROOT, TINY_CONFIGS

CPU = torch.device("cpu")


def config(name: str) -> dict:
    with open(os.path.join(ROOT, "bench_cuda", "configs",
                           name + ".json")) as f:
        return json.load(f)


def builder(cfg: dict):
    return harness.load_module(
        os.path.join(ROOT, "bench_cuda", "builders",
                     cfg["builder"] + ".py"), "t_" + cfg["builder"])


def weights_and_images(cfg, seed: int, n: int):
    b = builder(cfg)
    gen = harness.generator(seed, CPU)
    w = b.make_weights(cfg, gen, CPU)
    x = harness.device_pool(gen, 1, n, b.input_shape(cfg), CPU)[0]
    return b, w, x


def tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else (tree or [])
    return [t for v in items for t in tensors(v)]


def as_float(cfg: dict) -> dict:
    """The configuration in float32, so that the port's CPU forward and
    the reference agree to float32 rounding."""
    return dict(cfg, dtype="float32")


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_generator_is_reproducible_and_moves_with_the_seed(name):
    cfg = TINY_CONFIGS[name]
    _, w1, x1 = weights_and_images(cfg, 2**31 + 3, 2)
    _, w2, x2 = weights_and_images(cfg, 2**31 + 3, 2)
    _, w3, _ = weights_and_images(cfg, 2**31 + 4, 2)
    flat = tensors(w1)
    assert all(torch.equal(a, b) for a, b in
               zip(flat, tensors(w2)))
    assert torch.equal(x1, x2)
    assert not all(torch.equal(a, b) for a, b in
                   zip(flat, tensors(w3)))
    for t in flat:
        assert torch.isfinite(t.float()).all()


@pytest.mark.parametrize("name,batch", [("tiny-alexnet", 3),
                                        ("tiny-resnet", 3),
                                        ("alexnet-pq-mem", 2),
                                        ("resnet50-pq-mem", 1)])
def test_reference_agrees_with_the_port_forward(name, batch):
    cfg = as_float(TINY_CONFIGS.get(name) or config(name))
    b, w, x = weights_and_images(cfg, 11, batch)
    probs = b.offline_forward(cfg, w, batch, CPU)(x).double()
    z = b.reference_logits(cfg, w, x).double()
    want = torch.softmax(z, dim=1)
    assert probs.shape == want.shape
    assert torch.allclose(probs, want, rtol=1e-4, atol=1e-6)
    # and the compared numbers read (almost) nothing
    logp = torch.log_softmax(z, 1).numpy()
    ids, p5 = harness.top5(probs.float().numpy())
    got = harness.compare({"ids": ids, "probs": p5,
                           "image": np.arange(batch)},
                          logp, z.std(1).numpy())
    assert got["logp_err_median"] < 1e-4
    assert got["top1_outside_ref_top5"] == 0


def test_specs_are_the_ports_published_models():
    from qcnn_tpu_torch.models import resnet, zoo

    a = config("alexnet-pq-mem")
    got, ref = builder(a).spec(a), zoo.alexnet()
    assert got.layers == ref.layers
    assert (got.in_height, got.in_width, got.in_channels) == (
        ref.in_height, ref.in_width, ref.in_channels)
    r = config("resnet50-pq-mem")
    got = builder(r).spec(r)
    ref = resnet.resnet50()
    assert (got.stage_depths, got.stage_channels, got.num_classes,
            got.in_size) == (ref.stage_depths, ref.stage_channels,
                             ref.num_classes, ref.in_size)


def test_flops_of_the_published_models():
    from bench_cuda.reference import alexnet, resnet50

    assert alexnet.flops_per_image(config("alexnet-pq-mem")) == 1448813632
    assert resnet50.flops_per_image(config("resnet50-pq-mem")) == 8178368512
