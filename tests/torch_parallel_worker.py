"""One rank of the port's parallel layer, for the CPU tests.

``tests/test_torch_parallel.py`` and ``tests/test_torch_pipeline.py`` spawn
WORLD of these once per file: each joins a gloo group through
``parallel.shardmap_ops.init_distributed`` on a ``file://`` store (no port
to collide across test workers), runs every case of its suite in one
order, and writes its results to OUT/rank{RANK}.npz. The tests hold them
against the JAX package. This module imports torch, numpy and the port
only; its NumPy makers of the seeded params and inputs are shared with
the tests.

Usage: python tests/torch_parallel_worker.py SUITE RANK WORLD STORE OUT
(SUITE: parallel, pipeline or store; WORLD 4, or 2 for the store suite
that ``tests/test_torch_array_store.py`` spawns)
"""

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

WORLD = 4
TIMEOUT_S = 120  # a hang in a collective fails the tests, not the run

B = 8  # the global batch of the sharded cases
MESHES = ((2, 2), (1, 4), (4, 1))
FC_MODES = ("column", "row", "replicated")
FC_IMPLS = ("gather", "indecode", "lutgather", "fgather", "pallas")
RING_MESHES = ((2, 2), (1, 4))
PP_CASES = ((4, 4), (2, 8), (4, 2))  # (stages, microbatches)
PP_RAGGED = (1, 3)
ENGINE_REQUESTS = 4


class Ranks:
    """WORLD ranks of one suite, started together at construction (so they
    run while the test computes the JAX side); :meth:`results` waits for
    them, at most TIMEOUT_S in all, and loads each rank's outputs."""

    def __init__(self, suite: str, out_dir: str, world: int = WORLD):
        self._dir = out_dir
        self._results = None
        self.world = world
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        store = os.path.join(out_dir, "store")
        self._logs = [open(os.path.join(out_dir, f"log{r}"), "w")
                      for r in range(world)]
        self._procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              suite, str(r), str(world), store, out_dir],
                             env=env, stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(self._logs)]
        self._deadline = time.monotonic() + TIMEOUT_S

    def _log(self, r: int) -> str:
        with open(os.path.join(self._dir, f"log{r}")) as f:
            return f.read()[-3000:]

    def results(self) -> list:
        if self._results is None:
            for r, p in enumerate(self._procs):
                try:
                    p.wait(timeout=max(1.0, self._deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    self.close()
                    raise AssertionError(f"rank {r} still ran after "
                                         f"{TIMEOUT_S} s:\n{self._log(r)}")
                if p.returncode != 0:
                    self.close()
                    raise AssertionError(f"rank {r} failed (rc="
                                         f"{p.returncode}):\n{self._log(r)}")
            self._results = [
                dict(np.load(os.path.join(self._dir, f"rank{r}.npz")))
                for r in range(self.world)]
        return self._results

    def close(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self._logs:
            log.close()


# -- seeded params and inputs (NumPy; either package's spec types) ---------

def tiny_spec(core):
    """tests/test_parallel.py's conv + pool + two-FC PQ model."""
    return core.ModelSpec(
        name="tiny", in_height=12, in_width=12, in_channels=8,
        layers=(core.ConvSpec(kernel=3, out_channels=16, pad=1, stride=1),
                core.ReLUSpec(), core.PoolSpec(kernel=2, stride=2),
                core.FCSpec(64), core.ReLUSpec(), core.FCSpec(16),
                core.SoftmaxSpec()))


def trap_spec(core, lrn_size=5):
    """A grouped conv, an LRN (an even size raises, where the JAX package
    once diverged) and a padded ceil-pool (its clamp, another such place)
    before two PQ FCs."""
    return core.ModelSpec(
        name="traps", in_height=13, in_width=13, in_channels=8,
        layers=(core.ConvSpec(kernel=3, out_channels=16, pad=1, groups=2),
                core.ReLUSpec(), core.LRNSpec(lrn_size, 1e-4, 0.75, 1.0),
                core.PoolSpec(kernel=3, stride=2, pad=1), core.FCSpec(64),
                core.ReLUSpec(), core.FCSpec(16), core.SoftmaxSpec()))


def route_spec(core):
    """An fc6-class first FC (S*D = 4096): its memory route depends on the
    batch (``models.common.fc_memory_impl``)."""
    return core.ModelSpec(
        name="route", in_height=4, in_width=4, in_channels=256,
        layers=(core.FCSpec(64), core.ReLUSpec(), core.FCSpec(16),
                core.SoftmaxSpec()))


def _pq_conv(rng, cg, cout, k_sz, s, k):
    d = cg // s
    return {"codebooks": rng.standard_normal((s, k, d), dtype=np.float32)
            * 0.2,
            "assignments": rng.integers(0, k, (cout, k_sz, k_sz, s),
                                        dtype=np.uint8),
            "bias": rng.standard_normal(cout, dtype=np.float32) * 0.1}


def _pq_fc(rng, cin, cout, s, k):
    d = cin // s
    return {"codebooks": rng.standard_normal((s, k, d), dtype=np.float32)
            * 0.2,
            "assignments": rng.integers(0, k, (cout, s), dtype=np.uint8),
            "bias": rng.standard_normal(cout, dtype=np.float32) * 0.1}


def tiny_params(seed=0):
    rng = np.random.default_rng(seed)
    return [_pq_conv(rng, 8, 16, 3, 2, 8), None, None,
            _pq_fc(rng, 16 * 6 * 6, 64, 8, 16), None,
            _pq_fc(rng, 64, 16, 8, 16), None]


def trap_params(seed=1, perm=False):
    rng = np.random.default_rng(seed)
    params = [_pq_conv(rng, 4, 16, 3, 1, 8), None, None, None,
              _pq_fc(rng, 7 * 7 * 16, 64, 196, 16), None,
              _pq_fc(rng, 64, 16, 16, 16), None]
    if perm:
        params[4]["perm"] = rng.permutation(784).astype(np.int32)
    return params


def route_params(seed=2):
    rng = np.random.default_rng(seed)
    return [_pq_fc(rng, 4096, 64, 1024, 16), None,
            _pq_fc(rng, 64, 16, 16, 16), None]


def model_input(spec, batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, spec.in_height, spec.in_width, spec.in_channels)
    ).astype(np.float32)


def fc_data(seed=3, b=B, cin=64, cout=32, s=16, k=8, d=4):
    """tests/test_parallel.py's shardmap FC inputs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cin)).astype(np.float32)
    return x, {"codebooks": rng.standard_normal((s, k, d)).astype(np.float32),
               "assignments": rng.integers(0, k, (cout, s), dtype=np.uint8),
               "bias": rng.standard_normal(cout).astype(np.float32)}


def resnet_tiny(resnet_mod):
    return resnet_mod.ResNetSpec("rn-dp", (1,), (32,), num_classes=6,
                                 in_size=16, bottleneck=False)


def vit_tiny(vit_mod):
    """tests/test_pipeline.py's ViT."""
    return vit_mod.ViTSpec("ViT-pp-test", patch=8, image_size=32, dim=64,
                           depth=8, heads=4, num_classes=10)


def vit_input(b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, 32, 32, 3)).astype(np.float32)


# -- the ranks ---------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def parallel_cases(rank: int, world: int, out_dir: str) -> dict:
    from torch.distributed.tensor import Replicate, Shard

    from qcnn_tpu_torch import core
    from qcnn_tpu_torch.models import common, network, resnet, synth
    from qcnn_tpu_torch.models.prepare import prepare_params
    from qcnn_tpu_torch.parallel import sharding
    from qcnn_tpu_torch.parallel.mesh import make_mesh
    from qcnn_tpu_torch.parallel.shardmap_ops import (
        column_parallel_pq_fc,
        row_parallel_pq_fc,
        row_parallel_pq_fc_overlapped,
    )
    from qcnn_tpu_torch.parallel.sharding import (
        make_dp_forward,
        make_sharded_forward,
        param_shardings,
        shard_params,
    )
    from qcnn_tpu_torch.serve.engine import BatchingEngine, EngineConfig

    out = {}
    meshes = {m: make_mesh(dp=m[0], tp=m[1]) for m in MESHES}
    default = make_mesh()
    out["default_mesh_sizes"] = np.array(default.mesh.shape)
    try:
        make_mesh(dp=3)
        out["bad_mesh_raised"] = np.array(0)
    except ValueError:
        out["bad_mesh_raised"] = np.array(1)

    spec = tiny_spec(core)
    params = tiny_params()
    x = model_input(spec, B, seed=5)
    for (dp, tp), mesh in meshes.items():
        for mode in FC_MODES:
            sharded = shard_params(spec, params, mesh, fc_mode=mode,
                                   device="cpu")
            fwd = make_sharded_forward(spec, mesh, fc_mode=mode,
                                       device="cpu")
            out[f"forward_{mode}_{dp}x{tp}"] = _np(fwd(sharded, x))
    # a batch that does not split over the data axis (engine bucket 1)
    for b in (1, 7):
        mesh = meshes[(4, 1)]
        fwd = make_sharded_forward(spec, mesh, device="cpu")
        out[f"ragged_{b}"] = _np(fwd(shard_params(spec, params, mesh,
                                                  device="cpu"), x[:b]))

    # LRN, padded ceil-pool, grouped conv; OPQ perm in both layouts
    espec = trap_spec(core, lrn_size=4)
    fwd = make_sharded_forward(espec, meshes[(2, 2)], device="cpu")
    try:
        fwd(shard_params(espec, trap_params(), meshes[(2, 2)], device="cpu"),
            model_input(espec, B, seed=6))
        out["even_lrn_raised"] = np.array("")
    except ValueError as e:
        out["even_lrn_raised"] = np.array(str(e))
    tspec = trap_spec(core)
    xt = model_input(tspec, B, seed=6)
    for mode in ("column", "row"):
        for perm in (False, True):
            tparams = trap_params(perm=perm)
            mesh = meshes[(2, 2)]
            fwd = make_sharded_forward(tspec, mesh, fc_mode=mode,
                                       device="cpu")
            out[f"traps_{mode}_perm{int(perm)}"] = _np(fwd(
                shard_params(tspec, tparams, mesh, fc_mode=mode,
                             device="cpu"), xt))

    # placements, local shapes, replicated extra keys (perm, int8 scale)
    mesh = meshes[(2, 2)]
    col = param_shardings(spec, params, mesh, fc_mode="column")[3]
    row = param_shardings(spec, params, mesh, fc_mode="row")[3]
    out["col_placements_ok"] = np.array(int(
        col["assignments"] == (Replicate(), Shard(0))
        and col["bias"] == (Replicate(), Shard(0))
        and col["codebooks"] == (Replicate(), Replicate())))
    out["row_placements_ok"] = np.array(int(
        row["codebooks"] == (Replicate(), Shard(0))
        and row["assignments"] == (Replicate(), Shard(1))
        and row["bias"] == (Replicate(), Replicate())))
    extra = [dict(p) if p is not None else None for p in params]
    extra[3]["perm"] = np.random.default_rng(0).permutation(576).astype(
        np.int32)
    extra[3]["scale"] = np.linspace(0.5, 1.5, 64).astype(np.float32)
    extra[3]["act_scale"] = np.float32(0.25)
    for mode in ("column", "row"):
        sh = shard_params(spec, extra, mesh, fc_mode=mode, device="cpu")
        out[f"{mode}_assignments_shape"] = np.array(sh[3]["assignments"].shape)
        out[f"{mode}_codebooks_shape"] = np.array(sh[3]["codebooks"].shape)
        out[f"{mode}_bias_shape"] = np.array(sh[3]["bias"].shape)
        for key in ("perm", "scale", "act_scale"):
            out[f"{mode}_{key}"] = sh[3][key].numpy()
    # S % tp != 0 replicates (S=8 over tp=4 splits; S=6 does not)
    odd = [None, None, None, _pq_fc(np.random.default_rng(4), 576, 64, 6, 16),
           None, None, None]
    pl = param_shardings(spec, odd, meshes[(1, 4)], fc_mode="row")[3]
    out["odd_s_replicated"] = np.array(int(all(
        v == (Replicate(), Replicate()) for v in pl.values())))

    # the memory-FC route resolves for the global batch, not a shard's
    rspec = route_spec(core)
    rparams = route_params()
    xr = model_input(rspec, 4, seed=7)
    prepared, conv_impls, fc_impls = prepare_params(
        rspec, rparams, fc_impl="memory", batch_hint=4,
        dtype=torch.bfloat16, device="cpu")
    out["route_prepared_impls"] = np.array(fc_impls)
    seen = []
    real = sharding.fc_layer

    def recording(x, p, *, impl, **kw):
        seen.append(impl)
        return real(x, p, impl=impl, **kw)

    sharding.fc_layer = recording
    try:
        fwd = make_sharded_forward(rspec, meshes[(4, 1)], fc_impl="memory",
                                   compute_dtype=torch.bfloat16,
                                   device="cpu")
        got = fwd(shard_params(rspec, rparams, meshes[(4, 1)],
                               device="cpu"), torch.as_tensor(xr))
    finally:
        sharding.fc_layer = real
    out["route_seen"] = np.array(seen)
    out["route_sharded"] = _np(got)
    out["route_unsharded"] = _np(network.forward(
        rparams, xr, spec=rspec, fc_impl="memory",
        compute_dtype=torch.bfloat16, device="cpu"))
    out["route_memory_impl_b4"] = np.array(
        common.fc_memory_impl(4, rparams[0], torch.bfloat16))
    out["route_memory_impl_b1"] = np.array(
        common.fc_memory_impl(1, rparams[0], torch.bfloat16))

    # explicit-collective FCs, every impl, and the ring
    xf, pf = fc_data()
    tf = {k: torch.as_tensor(v) for k, v in pf.items()}
    xft = torch.as_tensor(xf)
    for impl in FC_IMPLS:
        for name, make_fc in (("row", row_parallel_pq_fc),
                              ("col", column_parallel_pq_fc)):
            fn = make_fc(meshes[(2, 2)], impl=impl)
            out[f"{name}_{impl}"] = _np(fn(xft, tf["codebooks"],
                                           tf["assignments"], tf["bias"]))
    for dp, tp in RING_MESHES:
        fn = row_parallel_pq_fc_overlapped(meshes[(dp, tp)])
        out[f"ring_{dp}x{tp}"] = _np(fn(xft, tf["codebooks"],
                                        tf["assignments"], tf["bias"]))
    # S=15 does not split over tp=4: the caller pads with a zero codebook
    xo, po = fc_data(seed=8, cin=60, s=15)
    fn = row_parallel_pq_fc(meshes[(1, 4)], impl="gather")
    try:
        fn(torch.as_tensor(xo), *(torch.as_tensor(po[k]) for k in
                                  ("codebooks", "assignments", "bias")))
        out["odd_s_raised"] = np.array(0)
    except ValueError:
        out["odd_s_raised"] = np.array(1)
    cb = np.concatenate([po["codebooks"], np.zeros((1, 8, 4), np.float32)])
    a = np.concatenate([po["assignments"],
                        np.zeros((32, 1), np.uint8)], axis=1)
    out["odd_s_padded"] = _np(fn(torch.as_tensor(xo), torch.as_tensor(cb),
                                 torch.as_tensor(a),
                                 torch.as_tensor(po["bias"])))
    out["odd_s_padded_ring"] = _np(row_parallel_pq_fc_overlapped(
        meshes[(1, 4)])(torch.as_tensor(xo), torch.as_tensor(cb),
                        torch.as_tensor(a), torch.as_tensor(po["bias"])))

    # make_dp_forward over a tiny ResNet in memory mode (B=6 on dp=4)
    rspec_rn = resnet_tiny(resnet)
    rn = resnet.prepare_params(
        rspec_rn, synth.random_resnet_pq_params(rspec_rn, seed=3),
        dtype=torch.float32, memory=True, device="cpu")
    xr = vit_input(6, seed=9)[:, :16, :16]

    def rn_forward(p, v):
        return resnet.forward(p, v, spec=rspec_rn, device="cpu")

    out["dp_resnet"] = _np(make_dp_forward(rn_forward, meshes[(4, 1)])(
        rn, torch.as_tensor(np.ascontiguousarray(xr))))

    # engines over meshes: rank 0 serves, the others follow
    cfg = EngineConfig(max_batch=4, max_wait_ms=5.0)
    images = model_input(spec, ENGINE_REQUESTS, seed=10)
    eng = BatchingEngine(spec, params, mesh=meshes[(2, 2)], config=cfg,
                         compute_dtype=torch.float32, device="cpu")
    out["engine"] = _serve(eng, images, rank)
    rn_images = np.ascontiguousarray(vit_input(ENGINE_REQUESTS, 11)[:, :16,
                                                                    :16])

    def rn_softmax(p, v):
        return resnet.forward(p, v, spec=rspec_rn, with_softmax=True,
                              device="cpu")

    eng = BatchingEngine.from_forward(
        rn_softmax, rn, (16, 16, 3), config=cfg, mesh=meshes[(4, 1)],
        device="cpu")
    out["engine_dp"] = _serve(eng, rn_images, rank)
    out.update(store_cases(rank, world, out_dir))
    return out


def store_expected() -> dict:
    """What every rank of store_cases must load: {output key: array}."""
    from qcnn_tpu_torch.formats import checkpoint
    from qcnn_tpu_torch.models import resnet, synth

    want = {f"dcp_linear_{i}_{key}": v
            for i, p in enumerate(trap_params(perm=True))
            for key, v in (p or {}).items()}
    flat = checkpoint._flatten(synth.random_resnet_pq_params(
        resnet_tiny(resnet), seed=3))
    want.update({f"dcp_family_{key.replace('/', '.')}": v
                 for key, v in flat.items()})
    return want


def store_cases(rank: int, world: int, out_dir: str) -> dict:
    """The dcp array store: every rank saves one linear and one family
    checkpoint with the same arrays, then each rank loads them on its
    own."""
    from qcnn_tpu_torch import core
    from qcnn_tpu_torch.formats import checkpoint
    from qcnn_tpu_torch.models import resnet, synth

    out = {}
    ck = os.path.join(out_dir, "dcp_linear")
    checkpoint.save_checkpoint(ck, trap_spec(core), trap_params(perm=True),
                               store="dcp")
    files = sorted(os.listdir(os.path.join(ck, "params_dcp")))
    out["dcp_files"] = np.array(files)
    out["dcp_bytes"] = np.array([os.path.getsize(os.path.join(
        ck, "params_dcp", f)) for f in files])
    _, back = checkpoint.load_checkpoint(ck)
    for i, p in enumerate(back):
        for key, v in (p or {}).items():
            out[f"dcp_linear_{i}_{key}"] = v
    ck = os.path.join(out_dir, "dcp_family")
    rspec = resnet_tiny(resnet)
    checkpoint.save_family_checkpoint(
        ck, "resnet", rspec, synth.random_resnet_pq_params(rspec, seed=3),
        store="dcp")
    flat = checkpoint._flatten(checkpoint.load_family_checkpoint(ck)[2])
    for key, v in flat.items():
        out[f"dcp_family_{key.replace('/', '.')}"] = v
    return out


def _serve(engine, images, rank: int) -> np.ndarray:
    """Rank 0 warms up, serves every image as a request and stops; the
    other ranks follow until the stop."""
    if rank != 0:
        engine.follow()
        return np.zeros(0, np.float32)
    engine.warmup()
    engine.start()
    try:
        futures = [engine.submit(img) for img in images]
        return np.stack([f.result(timeout=60) for f in futures])
    finally:
        engine.stop()


def pipeline_cases(rank: int, world: int, out_dir: str) -> dict:
    from qcnn_tpu_torch.models import synth, vit
    from qcnn_tpu_torch.parallel.pipeline import (
        make_pipeline_mesh,
        pipeline_vit_forward,
        place_pipeline_params,
        stack_vit_blocks,
    )

    out = {}
    spec = vit_tiny(vit)
    dense = vit.prepare_params(spec, vit.init_dense_params(spec, seed=0),
                               dtype=torch.float32, device="cpu")
    stacked_all, rest_all = stack_vit_blocks(spec, dense)
    meshes = {s: make_pipeline_mesh(stages=s) for s in (2, 4)}

    def run(stages, m, b, seed, stacked=stacked_all, rest=rest_all):
        mesh = meshes[stages]
        local, rest = place_pipeline_params(mesh, stacked, rest,
                                            device="cpu")
        if local is None:
            return np.zeros(0, np.float32)
        fn = pipeline_vit_forward(mesh, spec, microbatches=m,
                                  with_softmax=True)
        return _np(fn(local, rest, vit_input(b, seed)))

    for stages, m in PP_CASES:
        out[f"pp_{stages}x{m}"] = run(stages, m, 16, seed=1)
    for b in PP_RAGGED:
        out[f"pp_ragged_{b}"] = run(2, 2, b, seed=2)
    # memory mode: every block keeps its one grouped decode
    mem = vit.prepare_params(spec, synth.random_vit_pq_params(spec, seed=4),
                             dtype=torch.float32, memory=True, device="cpu")
    stacked_mem, rest_mem = stack_vit_blocks(spec, mem)
    out["pp_memory"] = run(2, 2, 4, 3, stacked_mem, rest_mem)

    errors = []
    try:
        make_pipeline_mesh(stages=world + 1)
    except ValueError as e:
        errors.append(str(e))
    mesh3 = make_pipeline_mesh(stages=3)
    for call in (lambda: pipeline_vit_forward(mesh3, spec, microbatches=4),
                 lambda: place_pipeline_params(mesh3, stacked_all, rest_all,
                                               device="cpu")):
        try:
            call()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = np.array(errors)
    return out


SUITES = {"parallel": parallel_cases, "pipeline": pipeline_cases,
          "store": store_cases}


def main() -> int:
    suite, rank, world, store, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from qcnn_tpu_torch.parallel.shardmap_ops import init_distributed

    init_distributed(f"file://{store}", world, rank)
    assert dist.get_backend() == "gloo"
    try:
        out = SUITES[suite](rank, world, out_dir)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    print(f"RANK_OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
