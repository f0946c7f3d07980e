"""The port's parallel layer (``qcnn_tpu_torch/parallel/``) against the JAX
package's, on the CPU.

One module fixture spawns 4 gloo ranks once (``tests/torch_parallel_worker
.py``, one torch thread each); they run every case and write their outputs.
Meanwhile this process computes the JAX side on the 8-device virtual CPU
mesh of ``tests/conftest.py``, from the same seeded NumPy params and
inputs. Tolerances are the JAX tests' own (``tests/test_parallel.py``):
sharded forwards rtol 1e-4 / atol 1e-5, the explicit-collective FCs rtol
1e-5 / atol 1e-4 (the fused impl, bf16 on the card, 1e-4 of the largest
|output|: its plain version rounds operands to bf16 as the kernel does),
the ResNet DP forward 1e-4 / 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qcnn_tpu.core as jcore
from qcnn_tpu.models import network as jnet
from qcnn_tpu.models import resnet as jresnet
from qcnn_tpu.ops.fc import pq_fc as jpq_fc
from qcnn_tpu.parallel import make_mesh as jmake_mesh
from qcnn_tpu.parallel import make_sharded_forward as jmake_sharded
from qcnn_tpu.parallel import shard_params as jshard_params
from qcnn_tpu.parallel.sharding import make_dp_forward as jmake_dp
from qcnn_tpu.parallel.shardmap_ops import (
    column_parallel_pq_fc as jcolumn,
    row_parallel_pq_fc as jrow,
    row_parallel_pq_fc_overlapped as jring,
)
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models import synth as tsynth
from qcnn_tpu_torch.parallel import shardmap_ops
from tests import torch_parallel_worker as W
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    spawned = W.Ranks("parallel", str(tmp_path_factory.mktemp("parallel")))
    yield spawned
    spawned.close()


def port(ranks, key: str) -> np.ndarray:
    """Rank 0's output of a case; every rank must hold the same."""
    outs = ranks.results()
    for r in range(1, W.WORLD):
        if outs[r][key].size:
            np.testing.assert_array_equal(outs[r][key], outs[0][key],
                                          err_msg=f"rank {r} differs")
    return outs[0][key]


def jax_mesh(dp, tp):
    return jmake_mesh(jax.devices()[:dp * tp], dp=dp, tp=tp)


def jax_sharded(spec, params, x, mesh, fc_mode):
    sharded = jshard_params(spec, params, mesh, fc_mode=fc_mode)
    fwd = jmake_sharded(spec, mesh, fc_mode=fc_mode)
    return np.asarray(fwd(sharded, jnp.asarray(x)))


@pytest.mark.parametrize("mesh", W.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("fc_mode", W.FC_MODES)
def test_sharded_forward_matches_jax(ranks, fc_mode, mesh):
    spec = W.tiny_spec(jcore)
    x = W.model_input(spec, W.B, seed=5)
    want = jax_sharded(spec, W.tiny_params(), x, jax_mesh(*mesh), fc_mode)
    got = port(ranks, f"forward_{fc_mode}_{mesh[0]}x{mesh[1]}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("batch", (1, 7))
def test_batch_that_does_not_split_over_data(ranks, batch):
    """B % dp != 0 (engine bucket 1 on dp=4): zero rows pad the batch and
    are cut from the output."""
    spec = W.tiny_spec(jcore)
    x = W.model_input(spec, W.B, seed=5)[:batch]
    want = np.asarray(jnet.forward(W.tiny_params(), x, spec=spec))
    got = port(ranks, f"ragged_{batch}")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("perm", (False, True), ids=("plain", "opq"))
@pytest.mark.parametrize("fc_mode", ("column", "row"))
def test_lrn_padded_pool_and_opq_perm_match_jax(ranks, fc_mode, perm):
    """A grouped conv, LRN and a padded ceil-pool inside the sharded
    forward; with an OPQ perm, which the row layout applies to the full
    input before cutting its sub-spaces."""
    spec = W.trap_spec(jcore)
    x = W.model_input(spec, W.B, seed=6)
    want = jax_sharded(spec, W.trap_params(perm=perm), x, jax_mesh(2, 2),
                       fc_mode)
    got = port(ranks, f"traps_{fc_mode}_perm{int(perm)}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_even_lrn_raises_in_the_sharded_forward(ranks):
    spec = W.trap_spec(jcore, lrn_size=4)
    with pytest.raises(ValueError, match="odd"):
        jnet.forward(W.trap_params(), W.model_input(spec, 2, seed=6),
                     spec=spec)
    assert "odd" in str(port(ranks, "even_lrn_raised"))


def test_column_sharding_places_shards(ranks):
    assert port(ranks, "col_placements_ok") == 1
    # each model-axis shard holds half the output channels
    assert tuple(port(ranks, "column_assignments_shape")) == (32, 8)
    assert tuple(port(ranks, "column_bias_shape")) == (32,)
    assert tuple(port(ranks, "column_codebooks_shape")) == (8, 16, 72)


def test_row_sharding_places_shards(ranks):
    assert port(ranks, "row_placements_ok") == 1
    # S=8 split over tp=2, D=576/8
    assert tuple(port(ranks, "row_codebooks_shape")) == (4, 16, 72)
    assert tuple(port(ranks, "row_assignments_shape")) == (64, 4)
    assert tuple(port(ranks, "row_bias_shape")) == (64,)


@pytest.mark.parametrize("fc_mode", ("column", "row"))
def test_shard_params_replicates_opq_perm_and_int8_scales(ranks, fc_mode):
    """Keys beyond the PQ triple replicate whole (the JAX package once
    raised KeyError on them)."""
    params = [dict(p) if p is not None else None for p in W.tiny_params()]
    params[3]["perm"] = np.random.default_rng(0).permutation(576).astype(
        np.int32)
    sharded = jshard_params(W.tiny_spec(jcore), params, jax_mesh(2, 2),
                            fc_mode=fc_mode)
    np.testing.assert_array_equal(port(ranks, f"{fc_mode}_perm"),
                                  np.asarray(sharded[3]["perm"]))
    np.testing.assert_array_equal(port(ranks, f"{fc_mode}_scale"),
                                  np.linspace(0.5, 1.5, 64, dtype=np.float32))
    assert port(ranks, f"{fc_mode}_act_scale") == np.float32(0.25)


def test_subspaces_that_do_not_split_replicate(ranks):
    """param_shardings: S=6 over tp=4 keeps the layer whole."""
    assert port(ranks, "odd_s_replicated") == 1


@pytest.mark.parametrize("form", ("plain", "ring"))
def test_shardmap_pads_subspaces_with_zero_codebooks(ranks, form):
    """S=15 over tp=4 raises; one all-zero codebook appended makes S=16,
    whose sub-space adds exact zeros."""
    assert port(ranks, "odd_s_raised") == 1
    xo, po = W.fc_data(seed=8, cin=60, s=15)
    want = np.asarray(jpq_fc(xo, po, impl="gather"))
    key = "odd_s_padded" if form == "plain" else "odd_s_padded_ring"
    np.testing.assert_allclose(port(ranks, key), want, rtol=1e-5, atol=1e-4)


def test_memory_route_resolves_for_the_global_batch(ranks):
    """An fc6-class FC at B=4 on dp=4: each shard holds one row, where
    ``fc_memory_impl`` would pick 'lutgather'; the sharded forward runs the
    unsharded step's 'fgather', and so does the JAX package."""
    assert str(port(ranks, "route_memory_impl_b4")) == "fgather"
    assert str(port(ranks, "route_memory_impl_b1")) == "lutgather"
    assert list(port(ranks, "route_prepared_impls")) == [
        "fgather", "-", "indecode", "-"]
    assert list(port(ranks, "route_seen")) == ["fgather", "indecode"]
    spec = W.route_spec(jcore)
    _, fc_impls = jnet.resolve_strategy(spec, W.route_params(), 4,
                                        fc_impl="memory",
                                        dtype=jnp.bfloat16)
    assert fc_impls[0] == "fgather"
    np.testing.assert_array_equal(port(ranks, "route_sharded"),
                                  port(ranks, "route_unsharded"))


# the JAX package's shard_map FCs do not trace with a Pallas impl (its
# shard_map checks the varying axes, and a pallas_call's output states
# none): those impls are held to the unsharded JAX call of the same impl
JAX_SHARD_MAP_IMPLS = ("gather", "indecode")


def jax_fc(make_fc, impl, x, p, dp=2, tp=2):
    if impl not in JAX_SHARD_MAP_IMPLS:
        return np.asarray(jpq_fc(x, p, impl=impl))
    fn = jax.jit(make_fc(jax_mesh(dp, tp), impl=impl))
    return np.asarray(fn(x, p["codebooks"], p["assignments"], p["bias"]))


def _fc_close(got, want, impl):
    if impl == "fgather":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("impl", W.FC_IMPLS)
def test_row_parallel_matches_jax(ranks, impl):
    x, p = W.fc_data()
    _fc_close(port(ranks, f"row_{impl}"), jax_fc(jrow, impl, x, p), impl)


@pytest.mark.parametrize("impl", W.FC_IMPLS)
def test_column_parallel_matches_jax(ranks, impl):
    x, p = W.fc_data()
    _fc_close(port(ranks, f"col_{impl}"), jax_fc(jcolumn, impl, x, p), impl)


@pytest.mark.parametrize("mesh", W.RING_MESHES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_row_parallel_overlapped_matches_jax(ranks, mesh):
    """The ring reduce-scatter, posted before each chunk's partial, against
    the JAX ring."""
    x, p = W.fc_data()
    fn = jax.jit(jring(jax_mesh(*mesh)))
    want = np.asarray(fn(x, p["codebooks"], p["assignments"], p["bias"]))
    np.testing.assert_allclose(port(ranks, f"ring_{mesh[0]}x{mesh[1]}"),
                               want, rtol=1e-5, atol=1e-4)


def _resnet_memory():
    spec = jresnet.ResNetSpec("rn-dp", (1,), (32,), num_classes=6,
                              in_size=16, bottleneck=False)
    pq = tsynth.random_resnet_pq_params(W.resnet_tiny(tresnet), seed=3)
    return spec, jresnet.prepare_params(spec, pq, dtype=np.float32,
                                        memory=True)


def test_dp_forward_resnet_family_memory(ranks):
    """make_dp_forward over a tiny ResNet in memory mode, B=6 over dp=4."""
    spec, prepared = _resnet_memory()
    x = np.ascontiguousarray(W.vit_input(6, seed=9)[:, :16, :16])
    want = np.asarray(jresnet.forward(prepared, x, spec=spec))
    np.testing.assert_allclose(port(ranks, "dp_resnet"), want, rtol=1e-4,
                               atol=1e-4)


def test_dp_forward_matches_the_jax_dp_forward():
    """The JAX DP wrapper at B=8 over dp=4 is the single-device forward:
    what the port's B=6 case above is held to."""
    spec, prepared = _resnet_memory()
    x = np.ascontiguousarray(W.vit_input(8, seed=9)[:, :16, :16])
    fwd = functools.partial(jresnet.forward, spec=spec)
    got = np.asarray(jmake_dp(fwd, jax_mesh(4, 1))(prepared, x))
    np.testing.assert_allclose(got, np.asarray(fwd(prepared, x)), rtol=1e-4,
                               atol=1e-4)


def test_global_mesh_from_init_distributed(ranks):
    """Every rank joined through init_distributed (a file:// store);
    make_mesh() is pure DP over the world and dp*tp must match it."""
    assert tuple(port(ranks, "default_mesh_sizes")) == (W.WORLD, 1)
    assert port(ranks, "bad_mesh_raised") == 1
    assert shardmap_ops.init_method("127.0.0.1:1234") == \
        "tcp://127.0.0.1:1234"
    assert shardmap_ops.init_method("file:///tmp/s") == "file:///tmp/s"


def test_backend_follows_the_cards(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert shardmap_ops.choose_backend(1) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert shardmap_ops.choose_backend(1) == "nccl"
    assert shardmap_ops.choose_backend(2) == "gloo"  # two ranks, one card
    # 2 hosts of 1 card: torchrun's local world is the rank's host
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert shardmap_ops.choose_backend(2) == "nccl"


def test_mesh_engine_serves_and_stops(ranks):
    """BatchingEngine(mesh=) over (2, 2): rank 0 serves 4 requests, the
    other ranks follow until its stop()."""
    spec = W.tiny_spec(jcore)
    images = W.model_input(spec, W.ENGINE_REQUESTS, seed=10)
    want = np.asarray(jnet.forward(W.tiny_params(), images, spec=spec))
    np.testing.assert_allclose(port(ranks, "engine"), want, rtol=1e-4,
                               atol=1e-5)


def test_mesh_engine_from_forward_serves_and_stops(ranks):
    """BatchingEngine.from_forward(mesh=): the ResNet forward DP over 4."""
    spec, prepared = _resnet_memory()
    images = np.ascontiguousarray(
        W.vit_input(W.ENGINE_REQUESTS, 11)[:, :16, :16])
    want = np.asarray(jresnet.forward(prepared, images, spec=spec,
                                      with_softmax=True))
    np.testing.assert_allclose(port(ranks, "engine_dp"), want, rtol=1e-4,
                               atol=1e-4)


def test_dcp_checkpoint_saved_by_every_rank_loads_alike(ranks):
    """Every rank called save_checkpoint(store="dcp") and
    save_family_checkpoint(store="dcp") with the same arrays: one copy is
    written (the default planner keeps each replicated tensor once), and
    every rank's own load gives the saved arrays and dtypes."""
    files = list(port(ranks, "dcp_files"))
    assert files[0] == ".metadata" and "__0_0.distcp" in files
    sizes = dict(zip(files, port(ranks, "dcp_bytes")))
    one_copy = sum(np.asarray(v).nbytes for p in W.trap_params(perm=True)
                   for v in (p or {}).values())
    assert sum(n for f, n in sizes.items() if f != ".metadata") < 2 * one_copy
    for key, v in W.store_expected().items():
        got = port(ranks, key)
        assert got.dtype == v.dtype, key
        np.testing.assert_array_equal(got, v)
