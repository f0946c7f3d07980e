"""The batch-tiled LUT gather (ops/cuda/pq_fc.py, strategy "pallas") against
the JAX package's Pallas kernel in interpret mode, on the same NumPy inputs,
and full-width AlexNet with fc_impl="pallas" against the JAX forward.

Tolerances: the kernel's plain version rtol 1e-5 of the largest |output|
(the same f32 LUT on both sides, summed in another order: the JAX kernel
contracts it with a one-hot matrix); AlexNet in bf16 as
tests/test_torch_alexnet.py states it (logits 1e-2 of their largest
magnitude, probabilities 1e-2)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.models import network as jnet
from qcnn_tpu.models import synth as jsynth
from qcnn_tpu.models import zoo as jzoo
from qcnn_tpu.models.prepare import prepare_params as jprepare
from qcnn_tpu.ops import fc as jfc
from qcnn_tpu_torch.models import network as tnet
from qcnn_tpu_torch.models import zoo as tzoo
from qcnn_tpu_torch.models.prepare import prepare_params as tprepare
from qcnn_tpu_torch.ops import fc as tfc
from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.cuda import pq_fc
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

jpq_fc = importlib.import_module("qcnn_tpu.ops.pallas.pq_fc")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fc(rng, b, cin, cout, s, k, d):
    x = rng.standard_normal((b, cin)).astype(np.float32)
    p = {
        "codebooks": rng.standard_normal((s, k, d)).astype(np.float32),
        "assignments": rng.integers(0, k, size=(cout, s), dtype=np.uint8),
        "bias": rng.standard_normal(cout).astype(np.float32),
    }
    return x, p


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(1e-6,
                                                 float(np.abs(want).max()))


@pytest.mark.parametrize("b,cin,cout,s,k,d", [
    (2, 4096, 1000, 4096, 16, 1),   # AlexNet fc8, full width
    (3, 58, 250, 15, 32, 4),        # ragged: Cin < S*D, Cout, S
    (9, 130, 300, 33, 128, 4),      # B past one batch tile, K at 128
    (2, 40, 70, 10, 256, 4),        # K = 256 (int32 ids in the JAX entry)
    (1, 7, 5, 7, 3, 1),             # K not a power of two
])
def test_plain_matches_pallas(rng, b, cin, cout, s, k, d):
    x, p = _fc(rng, b, cin, cout, s, k, d)
    want = jpq_fc.pq_fc_pallas(jnp.asarray(x), p, interpret=True)
    got = pq_fc.pq_fc_pallas(T(x), {k_: T(v) for k_, v in p.items()})
    assert got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= 1e-5


def test_gather_accumulate_is_the_lut_sum(rng):
    x, p = _fc(rng, 4, 64, 20, 16, 32, 4)
    lut = lut_ops.build_lut(T(x), T(p["codebooks"]))
    got = pq_fc.gather_accumulate(lut, T(p["assignments"]), T(p["bias"]))
    want = p["bias"] + np.stack([
        sum(lut.numpy()[b, s_, p["assignments"][:, s_]] for s_ in range(16))
        for b in range(4)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrapper_follows_the_gather_plan(rng):
    """The launch arguments are the plan's: rows, outputs, chunk, stages and
    splits from the shape alone, and a workspace only for a split sum."""
    from qcnn_tpu_torch.ops.cuda import _plan

    assert pq_fc.plan is _plan.plan_gather
    assert len(pq_fc.KERNEL.argtypes) == 15  # 5 pointers, 9 ints, the stream
    small, large = pq_fc.plan(3, 4096, 16, 1000), pq_fc.plan(4096, 64, 32, 4096)
    assert (small.rows, small.splits) == (4, 128)
    assert small.workspace_bytes == 128 * 3 * 1000 * 4
    assert (large.rows, large.splits, large.workspace_bytes) == (16, 1, 0)
    # the plan's order of additions is the plain sum, to rounding
    x, p = _fc(rng, 3, 64, 20, 16, 32, 4)
    lut = lut_ops.build_lut(T(x), T(p["codebooks"]))
    got = pq_fc.split_sum_plain(lut, T(p["assignments"]), T(p["bias"]),
                                pq_fc.plan(3, 16, 32, 20))
    want = pq_fc.gather_accumulate(lut, T(p["assignments"]), T(p["bias"]))
    assert _rel_err(got.numpy(), want.numpy()) <= 1e-5


def test_guards(rng):
    x, p = _fc(rng, 2, 32, 8, 8, 32, 4)
    tp = {k: T(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="K <= 256"):
        pq_fc.pq_fc_pallas(T(x), dict(tp, codebooks=torch.zeros(8, 300, 4)))
    lut = lut_ops.build_lut(T(x), tp["codebooks"])
    with pytest.raises(ValueError, match="subspace mismatch"):
        pq_fc.gather_accumulate(lut, tp["assignments"][:, :7], tp["bias"])
    # a tensor off the CPU takes the kernel path and raises without a card
    meta = torch.empty((2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        pq_fc.gather_accumulate(meta, tp["assignments"].to("meta"),
                                tp["bias"].to("meta"))


def test_pallas_impl_matches_jax_with_perm(rng):
    x, p = _fc(rng, 3, 64, 24, 16, 32, 4)
    p["perm"] = rng.permutation(64).astype(np.int32)
    want = jfc.pq_fc(jnp.asarray(x), p, impl="pallas")
    got = tfc.pq_fc(T(x), {k: T(v) for k, v in p.items()}, impl="pallas")
    assert _rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("batch", [1, 3])
def test_alexnet_pallas_arm_matches_jax(batch):
    """Full-width AlexNet-PQ (synthetic params, seed 0) in bf16 with convs
    decoded at load and fc6-8 through the pallas arm."""
    jspec, tspec = jzoo.alexnet(), tzoo.alexnet()
    params = jsynth.random_pq_params(jspec, seed=0)
    x = jsynth.random_input(jspec, batch, seed=1)
    pj, cj, fj = jprepare(jspec, params, batch_hint=batch, conv_impl="auto",
                          fc_impl="pallas", dtype=jnp.bfloat16)
    pt, ct, ft = tprepare(tspec, params, batch_hint=batch, conv_impl="auto",
                          fc_impl="pallas", dtype=torch.bfloat16,
                          device="cpu")
    assert (ct, ft) == (cj, fj)
    assert set(ft) - {"-"} == {"pallas"}
    want = np.asarray(jnet.forward(pj, x, spec=jspec, conv_impls=cj,
                                   fc_impls=fj, compute_dtype=jnp.bfloat16,
                                   with_softmax=False), np.float32)
    got = tnet.forward(pt, x, spec=tspec, conv_impls=ct, fc_impls=ft,
                       compute_dtype=torch.bfloat16, device="cpu",
                       with_softmax=False).float().numpy()
    assert got.shape == (batch, 1000) and np.isfinite(got).all()
    assert _rel_err(got, want) <= 1e-2
    p_want = np.asarray(jax.nn.softmax(want))
    p_got = torch.softmax(torch.from_numpy(got), -1).numpy()
    assert float(np.abs(p_got - p_want).max()) <= 1e-2
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
