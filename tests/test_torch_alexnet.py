"""Full-width AlexNet-PQ (zoo.alexnet, synth.random_pq_params(seed=0)):
the port's prepare_params + forward on the CPU against the JAX package's.

- bf16 memory mode at B=1 (fc6-8 route to lutgather) and B=3 (fgather),
  the JAX side running its Pallas kernels in interpret mode;
- f32 auto (decode at load) at B=2.

Tolerances and what was measured on the CPU with these seeds:
- probabilities: f32 <= 1e-5 (measured 4.5e-13), bf16 <= 1e-2 (measured
  1.6e-9: the random net's softmax saturates, so the logits are held too);
- logits, relative to their largest magnitude: f32 <= 1e-5 (measured
  1.4e-6), bf16 <= 1e-2 (measured 3.6e-3: 0.25 at |logit| ~ 69, half a bf16
  step there; bf16 rounds at other places, e.g. the bf16 bias add of
  conv_dense(out_dtype=bf16)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.models import network as jnet
from qcnn_tpu.models import synth as jsynth
from qcnn_tpu.models import zoo as jzoo
from qcnn_tpu.models.prepare import prepare_params as jprepare
from qcnn_tpu_torch.models import network as tnet
from qcnn_tpu_torch.models import synth as tsynth
from qcnn_tpu_torch.models import zoo as tzoo
from qcnn_tpu_torch.models.prepare import prepare_params as tprepare
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


@pytest.fixture(scope="module")
def alexnet_params():
    return jsynth.random_pq_params(jzoo.alexnet(), seed=0)


@pytest.mark.parametrize("mode,batch,dtype,fc_route,tol", [
    ("memory", 1, "bfloat16", "lutgather", 1e-2),
    ("memory", 3, "bfloat16", "fgather", 1e-2),
    ("auto", 2, "float32", "dense", 1e-5),
])
def test_alexnet_full_width_matches_jax(alexnet_params, mode, batch, dtype,
                                        fc_route, tol):
    jspec, tspec = jzoo.alexnet(), tzoo.alexnet()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = jsynth.random_input(jspec, batch, seed=1)
    pj, cj, fj = jprepare(jspec, alexnet_params, batch_hint=batch,
                          conv_impl=mode, fc_impl=mode, dtype=jdt)
    pt, ct, ft = tprepare(tspec, alexnet_params, batch_hint=batch,
                          conv_impl=mode, fc_impl=mode, dtype=tdt,
                          device="cpu")
    assert (ct, ft) == (cj, fj)
    assert set(ft) - {"-"} == {fc_route}
    want = np.asarray(jnet.forward(pj, x, spec=jspec, conv_impls=cj,
                                   fc_impls=fj, compute_dtype=jdt,
                                   with_softmax=False), np.float32)
    got = tnet.forward(pt, x, spec=tspec, conv_impls=ct, fc_impls=ft,
                       compute_dtype=tdt, device="cpu", with_softmax=False)
    got = got.float().numpy()
    assert got.shape == (batch, 1000) and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale
    p_want = np.asarray(jax.nn.softmax(want))
    p_got = torch.softmax(torch.from_numpy(got), -1).numpy()
    assert float(np.abs(p_got - p_want).max()) <= tol
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_synth_copy_gives_the_same_params(alexnet_params):
    ours = tsynth.random_pq_params(tzoo.alexnet(), seed=0)
    for a, b in zip(ours, alexnet_params):
        assert (a is None) == (b is None)
        if a is not None:
            for key in b:
                np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(
        tsynth.random_input(tzoo.alexnet(), 2, seed=3),
        jsynth.random_input(jzoo.alexnet(), 2, seed=3))
