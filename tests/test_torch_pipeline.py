"""The port's GPipe ViT forward (``qcnn_tpu_torch/parallel/pipeline.py``)
against the JAX package's, on the CPU.

One module fixture spawns 4 gloo ranks once (``tests/torch_parallel_worker
.py``); each stage rank runs every case and writes its outputs, while this
process computes the JAX pipeline on the virtual CPU mesh of
``tests/conftest.py`` from the same seeded params. Tolerance: the JAX
test's own (``tests/test_pipeline.py``), rtol 2e-5 / atol 2e-6 on the
probabilities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.models import vit as jvit
from qcnn_tpu.parallel.pipeline import (
    make_pipeline_mesh,
    pipeline_vit_forward,
    place_pipeline_params,
    stack_vit_blocks,
)
from qcnn_tpu_torch.models import synth as tsynth
from qcnn_tpu_torch.models import vit as tvit
from qcnn_tpu_torch.parallel import pipeline as tpipeline
from tests import torch_parallel_worker as W
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

SPEC = W.vit_tiny(jvit)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    spawned = W.Ranks("pipeline", str(tmp_path_factory.mktemp("pipeline")))
    yield spawned
    spawned.close()


def port(ranks, key: str, stages: int) -> np.ndarray:
    """Stage 0's output; every stage must hold the same, and ranks beyond
    the stages nothing."""
    outs = ranks.results()
    for r in range(W.WORLD):
        if r < stages:
            np.testing.assert_array_equal(outs[r][key], outs[0][key],
                                          err_msg=f"rank {r} differs")
        else:
            assert outs[r][key].size == 0
    return outs[0][key]


def jax_pipeline(params, stages, microbatches, x):
    mesh = make_pipeline_mesh(jax.devices()[:stages])
    stacked, rest = stack_vit_blocks(SPEC, params)
    stacked, rest = place_pipeline_params(mesh, stacked, rest)
    fn = pipeline_vit_forward(mesh, SPEC, microbatches=microbatches,
                              with_softmax=True)
    return np.asarray(fn(stacked, rest, jnp.asarray(x)))


@pytest.mark.parametrize("stages,microbatches", W.PP_CASES)
def test_pipeline_matches_jax(ranks, stages, microbatches):
    want = jax_pipeline(jvit.init_dense_params(SPEC, seed=0), stages,
                        microbatches, W.vit_input(16, seed=1))
    got = port(ranks, f"pp_{stages}x{microbatches}", stages)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("b", W.PP_RAGGED)
def test_pipeline_pads_ragged_batches(ranks, b):
    """Batches that are not a microbatch multiple (the engine's bucket-1
    dispatch) pad and are cut back."""
    x = W.vit_input(b, seed=2)
    want = np.asarray(jvit.forward(jvit.init_dense_params(SPEC, seed=0), x,
                                   spec=SPEC, with_softmax=True))
    got = port(ranks, f"pp_ragged_{b}", 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_pipeline_memory_mode_matches_jax(ranks):
    """PQ blocks kept compressed (memory mode): each stage decodes its
    blocks in the step."""
    pq = tsynth.random_vit_pq_params(W.vit_tiny(tvit), seed=4)
    prepared = jvit.prepare_params(SPEC, pq, dtype=np.float32, memory=True)
    want = jax_pipeline(prepared, 2, 2, W.vit_input(4, seed=3))
    np.testing.assert_allclose(port(ranks, "pp_memory", 2), want, rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("which", ("stages_beyond_the_world",
                                   "forward_depth", "placement_depth"))
def test_pipeline_validates(ranks, which):
    errors = dict(zip(("stages_beyond_the_world", "forward_depth",
                       "placement_depth"),
                      port(ranks, "errors", W.WORLD)))
    want = {"stages_beyond_the_world": f"{W.WORLD + 1} pipeline stages > "
                                       f"{W.WORLD} devices",
            "forward_depth": "depth 8 not divisible by 3 stages",
            "placement_depth": "depth 8 not divisible by 3 stages"}
    assert str(errors[which]) == want[which]
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_vit_forward(make_pipeline_mesh(jax.devices()[:3]), SPEC,
                             microbatches=4)


def test_stack_round_trip():
    dense = jvit.init_dense_params(SPEC, seed=0)
    prepared = tvit.prepare_params(W.vit_tiny(tvit), dense,
                                   dtype=torch.float32, device="cpu")
    stacked, rest = tpipeline.stack_vit_blocks(SPEC, prepared)
    jstacked, _ = stack_vit_blocks(SPEC, dense)
    assert stacked["qkv"]["weight"].shape[0] == SPEC.depth
    np.testing.assert_array_equal(stacked["mlp1"]["bias"][3].numpy(),
                                  np.asarray(dense["blk3"]["mlp1"]["bias"]))
    np.testing.assert_array_equal(stacked["qkv"]["weight"].numpy(),
                                  np.asarray(jstacked["qkv"]["weight"]))
    # a prepared weight stays the (Cin, Cout) view of (Cout, Cin) memory
    assert stacked["qkv"]["weight"][0].stride() == \
        prepared["blk0"]["qkv"]["weight"].stride()
    assert "patch_embed" in rest and "head" in rest
    assert not any(k.startswith("blk") for k in rest)
