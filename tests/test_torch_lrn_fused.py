"""The one-pass LRN (ops/cuda/lrn_fused.py) against the JAX package's Pallas
kernel in interpret mode, every window name, on the same NumPy inputs.

All three JAX windows square in x's dtype and sum in float32 in different
orders, so the tolerance is one bf16 ulp of each output for bf16 (one
rounding of the f32 result apart) and rtol 1e-6 of the largest |output|
for float32."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu_torch.ops.cuda import lrn_fused
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

jlrn = importlib.import_module("qcnn_tpu.ops.pallas.lrn_fused")


def _check(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if dtype == "bfloat16":
        _, exp = np.frexp(want)
        assert (diff <= np.ldexp(1.0, exp - 8)).all(), diff.max()
    else:
        assert diff.max() <= 1e-6 * np.abs(want).max()


def _run(rng, shape, dtype, window, beta, k=1.0):
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    kw = dict(size=5, alpha=1e-4, beta=beta, k=k)
    want = jlrn.lrn_fused(jnp.asarray(x, getattr(jnp, dtype)), window=window,
                          tile_m=64, interpret=True, **kw)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = lrn_fused.lrn_fused(xt, window=window, **kw)
    assert got.dtype == xt.dtype
    _check(got, want, dtype)


@pytest.mark.parametrize("window", lrn_fused.WINDOWS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(4, 7, 7, 96), (3, 130), (2, 5, 5, 256)])
def test_plain_matches_pallas(rng, window, dtype, shape):
    _run(rng, shape, dtype, window, beta=0.75)


@pytest.mark.parametrize("window", lrn_fused.WINDOWS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("beta", [0.5, 1.0, 0.6])
def test_other_betas_match_pallas(rng, window, dtype, beta):
    _run(rng, (2, 3, 3, 96), dtype, window, beta=beta, k=2.0)


def test_squares_in_the_input_dtype(rng):
    """bf16 input: the window sums the bf16-rounded squares, as every JAX
    window does, not the f32 squares of misc.lrn(impl="jnp")."""
    from qcnn_tpu_torch.ops import misc

    x = torch.from_numpy((rng.standard_normal((64, 96)) * 3).astype(
        np.float32)).to(torch.bfloat16)
    kw = dict(size=5, alpha=1.0, beta=0.75, k=1.0)  # alpha large: sums count
    got = lrn_fused.lrn_fused(x, window="shift", **kw)
    assert torch.equal(got, misc.lrn(x, impl="band", **kw))
    assert not torch.equal(got, misc.lrn(x, impl="jnp", **kw))


def test_guards():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="unknown lrn window"):
        lrn_fused.lrn_fused(x, size=5, alpha=1e-4, beta=0.75, k=1.0,
                            window="band")
    with pytest.raises(ValueError, match="odd window size"):
        lrn_fused.lrn_fused(x, size=4, alpha=1e-4, beta=0.75, k=1.0)
    meta = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        lrn_fused.lrn_fused(meta, size=5, alpha=1e-4, beta=0.75, k=1.0)
