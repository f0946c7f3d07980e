"""The route of ``ops.misc.lrn(impl="auto")``: the band form with a
channel_map, else the ``lrn_fused`` kernel on a bf16 or float32 CUDA tensor
and the plain shifted-slice form elsewhere (``misc.lrn_route``).

The CPU tests hold the route's table and what each route computes on the
CPU. The tests marked ``card`` run the AlexNet family's forwards on the
card and skip without one. The file imports no JAX and nothing from
``tests`` (a ``tests`` package installed on that machine would shadow
this directory), so on a machine with a card and without JAX they run
without the suite's conftest:

    python -m pytest tests/test_torch_lrn_route.py --noconftest -m card -q
"""

import json
import os

import numpy as np
import pytest
import torch

from qcnn_tpu_torch.ops import misc
from qcnn_tpu_torch.ops.cuda import lrn_fused

KW = dict(size=5, alpha=1e-4, beta=0.75, k=1.0)
CPU, CUDA, META = (torch.device(t) for t in ("cpu", "cuda", "meta"))
MAP = (0, 1, 2, -1, 3, -1)  # a lane-padded layout: 4 channels in 6 lanes
CELL_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_cuda", "configs",
    "alexnet-pq-mem.json")


@pytest.mark.parametrize("device, dtype, size, want", [
    (CUDA, torch.bfloat16, 5, "kernel"),
    (CUDA, torch.float32, 5, "kernel"),
    (CUDA, torch.bfloat16, 3, "kernel"),
    (CUDA, torch.float32, 9, "kernel"),
    (CUDA, torch.bfloat16, 1, "kernel"),
    (CUDA, torch.bfloat16, 4, "jnp"),
    (CUDA, torch.float16, 5, "jnp"),
    (CUDA, torch.float64, 5, "jnp"),
    (CUDA, torch.int8, 5, "jnp"),
    (CPU, torch.bfloat16, 5, "jnp"),
    (CPU, torch.float32, 5, "jnp"),
    (CPU, torch.float16, 5, "jnp"),
    (META, torch.bfloat16, 5, "jnp"),
])
def test_route_table(device, dtype, size, want):
    assert misc.lrn_route(device, dtype, size) == want


def _x(rng, shape, dtype):
    return torch.from_numpy(
        (rng.standard_normal(shape) * 3).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape, size, beta", [
    ((2, 5, 5, 96), 5, 0.75), ((3, 130), 3, 0.5), ((2, 3, 3, 256), 7, 0.6)])
def test_auto_on_the_cpu_is_jnp_bit_for_bit(rng, dtype, shape, size, beta):
    x = _x(rng, shape, dtype)
    kw = dict(KW, size=size, beta=beta)
    got = misc.lrn(x, **kw)
    assert got.dtype == dtype
    assert torch.equal(got, misc.lrn(x, impl="jnp", **kw))


@pytest.mark.parametrize("impl", ["auto", "jnp", "band"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_channel_map_stays_band(rng, monkeypatch, impl, dtype):
    """A channel_map takes the band form whatever impl says, and never the
    kernel, even where the route would pick it for the tensor."""
    monkeypatch.setattr(lrn_fused, "lrn_fused", _refuse)
    monkeypatch.setattr(misc, "lrn_route", lambda *a: "kernel")
    x = _x(rng, (2, 3, 3, len(MAP)), dtype)
    got = misc.lrn(x, impl=impl, channel_map=MAP, **KW)
    assert torch.equal(got, misc.lrn(x, impl="band", channel_map=MAP, **KW))


def _refuse(*args, **kwargs):
    raise AssertionError("lrn_fused launched off its route")


def test_kernel_route_launches_lrn_fused(rng, monkeypatch):
    """Where the route says "kernel", ``auto`` hands x and the LRN's
    constants to ``lrn_fused`` and returns its result; an explicit "jnp"
    or "band" keeps its plain form."""
    calls = []

    def fake(x, **kw):
        calls.append(kw)
        return lrn_fused.lrn_plain(x, **kw)

    monkeypatch.setattr(lrn_fused, "lrn_fused", fake)
    monkeypatch.setattr(misc, "lrn_route", lambda *a: "kernel")
    x = _x(rng, (4, 96), torch.bfloat16)
    got = misc.lrn(x, **KW)
    assert calls == [KW]
    assert torch.equal(got, misc.lrn(x, impl="band", **KW))
    for impl in ("jnp", "band"):
        misc.lrn(x, impl=impl, **KW)
    assert len(calls) == 1


# --- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _forward(model: str, batch: int, dev):
    """fn(lrn_impl=None) -> logits of the model's PQ forward in memory
    mode, bf16, on ``dev`` (``network.make_forward_fn``, as ``Classifier``
    builds it); ``lrn_impl`` forces an impl on every LRN."""
    from qcnn_tpu_torch.models import network, prepare, synth, zoo

    spec = getattr(zoo, model)()
    prepared, conv_impls, fc_impls = prepare.prepare_params(
        spec, synth.random_pq_params(spec, seed=0), batch_hint=batch,
        conv_impl="memory", fc_impl="memory", dtype=torch.bfloat16,
        device=dev)
    fwd = network.make_forward_fn(
        spec, conv_impls=conv_impls, fc_impls=fc_impls, with_softmax=False,
        compute_dtype=torch.bfloat16, device=dev)
    x = torch.from_numpy(synth.random_input(spec, batch, seed=1)).to(dev)

    def run(lrn_impl=None):
        if lrn_impl is None:
            return fwd(prepared, x)
        saved = network.lrn
        network.lrn = lambda y, **kw: misc.lrn(y, impl=lrn_impl, **kw)
        try:
            return fwd(prepared, x)
        finally:
            network.lrn = saved
    return run


def _launches(run, monkeypatch) -> tuple[dict, list]:
    """The port's kernel launches of one call of ``run``, and a copy of the
    input and the constants of each ``lrn_fused`` call. Each call's input is
    contiguous and 16-byte aligned (else the entry point copies it first),
    and its output is bit-equal to ``lrn_window_plain``, the kernels' order
    of additions in PyTorch."""
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    calls, entry = [], lrn_fused.lrn_fused

    def spy(x, **kw):
        assert x.is_contiguous() and x.data_ptr() % 16 == 0, x.shape
        y = entry(x, **kw)
        assert y.dtype == torch.bfloat16 == x.dtype
        assert torch.equal(y, lrn_fused.lrn_window_plain(x, **kw))
        calls.append((x.clone(), kw))
        return y

    monkeypatch.setattr(lrn_fused, "lrn_fused", spy)
    run()
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    calls.clear()
    run()
    torch.cuda.synchronize()
    return cuda_ops.launches(), calls


@pytest.mark.card
@pytest.mark.parametrize("model, n_lrn", [
    ("alexnet", 2), ("caffenet", 2), ("vgg_cnn_s", 1)])
def test_forward_launches_lrn_fused_on_its_inputs(card, monkeypatch, model,
                                                  n_lrn):
    counts, calls = _launches(_forward(model, 16, card), monkeypatch)
    assert counts["lrn_fused"] == n_lrn
    assert counts["lrn_fused_general"] == 0
    assert len(calls) == n_lrn


@pytest.mark.card
def test_alexnet_lrn_window_engaged(card, monkeypatch):
    """AlexNet's two LRN inputs, as the forward hands them over, scaled so
    that alpha/size times the window's sum of squares is about 1 (at the
    synthetic widths it is about 5e-5, and the LRN rounds to the identity
    in bf16): the kernel stays bit-equal to ``lrn_window_plain`` and
    shrinks the activations by the window's measure, and a kernel that
    returned x, or summed a narrower window, would differ."""
    entry = lrn_fused.lrn_fused  # the kernel's own entry, not the spy
    _, calls = _launches(_forward("alexnet", 16, card), monkeypatch)
    assert len(calls) == 2
    for x, kw in calls:
        xf = x.float()
        s = (kw["alpha"] * xf.square().mean()).rsqrt()
        xs = (xf * s).to(x.dtype)
        got = entry(xs, **kw)
        assert torch.equal(got, lrn_fused.lrn_window_plain(xs, **kw))
        on = xs.float() > 1
        ratio = (got.float()[on] / xs.float()[on]).median().item()
        assert 0.2 < ratio < 0.9, ratio
        narrow = lrn_fused.lrn_window_plain(  # same alpha/size, 3 wide
            xs, **dict(kw, size=3, alpha=kw["alpha"] * 3 / kw["size"]))
        assert not torch.equal(got, narrow)
        assert not torch.equal(got, xs)


@pytest.mark.card
def test_alexnet_logp_within_the_cells_limits_of_the_plain_lrn(card,
                                                               monkeypatch):
    """AlexNet-PQ, memory mode, bf16, B=16: the kernel's LRN against the
    same forward with ``impl="jnp"`` on both LRNs, by the benchmark cell's
    measure (over the kernel forward's five best classes, the largest
    |ln p - ln p_jnp|, over the jnp forward's logit standard deviation)
    and under the cell's limits. At the synthetic widths the LRN's scale
    is about 1, so this holds the route inside the forward; the window
    itself is held by the spy and by ``test_alexnet_lrn_window_engaged``."""
    with open(CELL_CONFIG) as f:
        limits = json.load(f)["check"]
    run = _forward("alexnet", 16, card)
    counts, _ = _launches(lambda: run("jnp"), monkeypatch)
    assert counts["lrn_fused"] == 0 and counts["lrn_fused_general"] == 0
    want, got = run("jnp").double(), run().double()
    logp, ref_logp = (torch.log_softmax(v, 1) for v in (got, want))
    ids = torch.argsort(-logp, dim=1, stable=True)[:, :5]
    err = ((logp.gather(1, ids) - ref_logp.gather(1, ids)).abs().amax(1)
           / want.std(1)).cpu().numpy()
    assert np.median(err) <= limits["logp_err_median"], err
    assert np.percentile(err, 99) <= limits["logp_err_p99"], err
    ref5 = torch.argsort(-ref_logp, dim=1, stable=True)[:, :5]
    assert (ids[:, :1] == ref5).any(1).all()
