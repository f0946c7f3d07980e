"""The parallel layer's multi-rank dry run, and a launcher for it.

``dryrun_multichip(world, device=)`` is the port of the JAX package's
multi-chip dry run (``__graft_entry__.dryrun_multichip``): every rank of an
initialized process group runs it, case by case in one order, and each case
holds the sharded result against the unsharded one computed on the same
rank:

- the tiny AlexNet-shaped spec (grouped conv, LRN, pool, two PQ FCs)
  sharded in the three FC modes;
- the dcp array store: one linear and one family checkpoint saved by every
  rank with the same arrays (``store="dcp"``), loaded by each;
- the row and column explicit-collective FCs at fc6's geometry
  (9216 -> 4096, S=2304, K=32, D=4, B=8) with ``lutgather``, ``fgather``
  and ``pallas``, and the overlapped ring;
- ``lutgather`` (1 row per rank) and ``fgather`` (4 rows per rank) on data
  shards;
- full-width AlexNet-PQ in memory mode sharded over (dp, tp) = (world, 1)
  and (1, world), column and row;
- ResNet-50 in memory mode through ``make_dp_forward``;
- ViT-B/16 in memory mode pipelined over 2 stages;
- the mesh engine serving requests.

Each rank prints one ``dryrun {json}`` line per case: its time (one call
after a warm-up, host clock; a correctness run, not a scaling number), the
error against its limit and the kernel launches of the sharded call alone.
A case past its limit raises.

Launcher: ``python -m qcnn_tpu_torch.parallel.dryrun --world 2 [--device
cuda|cpu]`` starts ``world`` ranks of this module on a ``file://`` store
and waits for them (at most LAUNCH_TIMEOUT_S). Ranks on one card share it
over gloo (NCCL refuses two ranks on one GPU); with a card each they take
NCCL. On the CPU the model cases run at small batches (a rehearsal: the
plain versions at full width are slow).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

# the batches of the model cases by device type: (AlexNet, ResNet-50,
# ViT-B/16, engine requests)
BATCHES = {"cuda": (64, 16, 8, 16), "cpu": (4, 2, 4, 4)}
LAUNCH_TIMEOUT_S = 390
FC6 = dict(s=2304, k=32, d=4, cin=9216, cout=4096, b=8)
# limits: max |difference| / max |reference| for the FCs (the LUT sums in
# float32, the fused kernel in bf16); max |d prob| and the top-1 agreement
# for the models (AlexNet memory 1e-2 / 0.99, ResNet-50 and ViT 5e-3 /
# 0.99, as the card's smoke holds them)
FC_LIMITS = {"lutgather": 2e-3, "pallas": 2e-3, "fgather": 3e-2,
             "ring": 2e-3}
TINY_LIMIT = 1e-4


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Report:
    """Runs and prints the cases of one rank."""

    def __init__(self, rank: int, device: torch.device):
        self.rank, self.device = rank, device
        self.cases: list[dict] = []

    def run(self, name: str, fn, check, warm: bool = True, **info):
        """fn() twice (a warm-up, then the timed call, whose launches are
        counted; once without ``warm``), then check(result) -> (error,
        limit, ok)."""
        from qcnn_tpu_torch.ops import cuda as cuda_ops

        if warm:
            fn()
            _sync(self.device)
        cuda_ops.reset_launches()
        t0 = time.perf_counter()
        got = fn()
        _sync(self.device)
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in cuda_ops.launches().items() if v}
        err, limit, ok = check(got)
        case = {"rank": self.rank, "case": name, "ms": round(ms, 4),
                "err": err, "limit": limit, "launches": counts, **info}
        self.cases.append(case)
        print("dryrun " + json.dumps(case), flush=True)
        if not ok:
            raise AssertionError(f"rank {self.rank} {name}: error {err} "
                                 f"past {limit}")
        return got


def _rel_err(limit: float, want: torch.Tensor):
    def check(got):
        err = ((got.float() - want.float()).abs().max()
               / want.float().abs().max().clamp_min(1e-12)).item()
        return err, limit, err <= limit
    return check


def _prob_err(max_dprob: float, want: torch.Tensor, min_top1: float = 0.99):
    def check(got):
        got, ref = got.float(), want.float()
        err = (got - ref).abs().max().item()
        top1 = (got.argmax(1) == ref.argmax(1)).float().mean().item()
        return ([err, top1], [max_dprob, min_top1],
                err <= max_dprob and top1 >= min_top1)
    return check


def _dcp_round_trip(save, load):
    """save(dir) on every rank into one directory (rank 0's, broadcast),
    then load(dir) on every rank; the directory goes afterwards."""
    import shutil

    path = [tempfile.mkdtemp(prefix="dryrun_dcp_")
            if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(path, src=0)
    try:
        save(path[0])
        return load(path[0])
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(path[0])


def _same_arrays(want):
    """Check: the loaded arrays are the saved ones, dtypes and bits (the
    error is the count of keys that differ); a params list or a family's
    nested dict."""
    from qcnn_tpu_torch.formats.checkpoint import _flatten

    def flat(tree):
        if isinstance(tree, list):
            tree = {str(i): p for i, p in enumerate(tree) if p is not None}
        return _flatten(tree)

    def check(got):
        a, b = flat(want), flat(got)
        bad = sorted(set(a) ^ set(b)) + [
            k for k in set(a) & set(b)
            if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
            or not np.array_equal(a[k], b[k])]
        return len(bad), 0, not bad
    return check


def tiny_spec():
    """The JAX dry run's miniature AlexNet: a PQ grouped conv, LRN, pool
    and two PQ FCs."""
    from qcnn_tpu_torch.core import (
        ConvSpec,
        FCSpec,
        LRNSpec,
        ModelSpec,
        PoolSpec,
        ReLUSpec,
        SoftmaxSpec,
    )

    return ModelSpec(
        name="TinyPQ", in_height=19, in_width=19, in_channels=8,
        layers=(ConvSpec(kernel=3, out_channels=32, pad=1, groups=2,
                         stride=2),
                ReLUSpec(), LRNSpec(5, 1e-4, 0.75, 1.0),
                PoolSpec(kernel=3, stride=2), FCSpec(64), ReLUSpec(),
                FCSpec(16), SoftmaxSpec()))


def _fc6_params(seed: int, device) -> dict:
    g = FC6
    rng = np.random.default_rng(seed)
    p = {"codebooks": (rng.standard_normal((g["s"], g["k"], g["d"])) * 0.1
                       ).astype(np.float32),
         "assignments": rng.integers(0, g["k"], (g["cout"], g["s"]),
                                     dtype=np.uint8),
         "bias": rng.standard_normal(g["cout"]).astype(np.float32)}
    return {k: torch.as_tensor(v, device=device) for k, v in p.items()}


def dryrun_multichip(world: int, device=None) -> list[dict]:
    """Run every case on this rank of an initialized group of ``world``
    ranks (every rank calls it). Returns this rank's case records.

    device: None means "cuda"; pass "cpu" for gloo ranks on the CPU."""
    from qcnn_tpu_torch._device import default_dtype, resolve_device
    from qcnn_tpu_torch.formats.checkpoint import (
        load_checkpoint,
        load_family_checkpoint,
        save_checkpoint,
        save_family_checkpoint,
    )
    from qcnn_tpu_torch.models import network, resnet, synth, vit, zoo
    from qcnn_tpu_torch.models.prepare import prepare_params
    from qcnn_tpu_torch.models.synth import CodebookPolicy
    from qcnn_tpu_torch.ops.fc import pq_fc
    from qcnn_tpu_torch.parallel.mesh import make_mesh
    from qcnn_tpu_torch.parallel.pipeline import (
        make_pipeline_mesh,
        pipeline_vit_forward,
        place_pipeline_params,
        stack_vit_blocks,
    )
    from qcnn_tpu_torch.parallel.sharding import (
        make_dp_forward,
        make_sharded_forward,
        shard_params,
    )
    from qcnn_tpu_torch.parallel.shardmap_ops import (
        column_parallel_pq_fc,
        row_parallel_pq_fc,
        row_parallel_pq_fc_overlapped,
    )
    from qcnn_tpu_torch.serve.engine import BatchingEngine, EngineConfig

    if dist.get_world_size() != world:
        raise ValueError(f"the group has {dist.get_world_size()} ranks, "
                         f"not {world}")
    device = resolve_device(device)
    rank = dist.get_rank()
    report = _Report(rank, device)
    dtype = default_dtype(device)
    b_alex, b_resnet, b_vit, n_requests = BATCHES[device.type]
    tp = 2 if world % 2 == 0 else 1
    mesh = make_mesh(tp=tp)
    data_mesh = make_mesh(dp=world, tp=1)

    # the tiny spec, sharded in the three FC modes (float32)
    spec = tiny_spec()
    policy = CodebookPolicy(conv_codewords=16, conv_subvec_len=4,
                            fc_codewords=8, fc_subvec_len=4,
                            classifier_codewords=8, classifier_subvec_len=1)
    params = synth.random_pq_params(spec, seed=0, policy=policy)
    x = torch.as_tensor(synth.random_input(spec, batch=2 * world, seed=1),
                        device=device)
    want = network.forward(params, x, spec=spec, device=device)
    for mode in ("column", "row", "replicated"):
        sharded = shard_params(spec, params, mesh, fc_mode=mode,
                               device=device)
        fwd = make_sharded_forward(spec, mesh, fc_mode=mode, device=device)
        report.run(f"tiny {mode} dp={world // tp} tp={tp}",
                   lambda: fwd(sharded, x), _rel_err(TINY_LIMIT, want))

    # the dcp array store: every rank saves one linear and one family
    # checkpoint with the same arrays, then loads them on its own
    fspec = resnet.ResNetSpec("dryrun", (1, 1), (64, 128), num_classes=10,
                              in_size=32, bottleneck=False)
    fparams = synth.random_resnet_pq_params(fspec, seed=2)
    report.run("dcp store linear", lambda: _dcp_round_trip(
        lambda ck: save_checkpoint(ck, spec, params, store="dcp"),
        lambda ck: load_checkpoint(ck)[1]), _same_arrays(params), warm=False)
    report.run("dcp store family", lambda: _dcp_round_trip(
        lambda ck: save_family_checkpoint(ck, "resnet", fspec, fparams,
                                          store="dcp"),
        lambda ck: load_family_checkpoint(ck)[2]), _same_arrays(fparams),
        warm=False)

    # explicit-collective FCs at fc6's geometry
    p6 = _fc6_params(11, device)
    g = torch.Generator().manual_seed(11)
    xf6 = torch.randn((FC6["b"], FC6["cin"]), generator=g).to(device)
    want6 = pq_fc(xf6, p6, impl="decode")
    args6 = (xf6, p6["codebooks"], p6["assignments"], p6["bias"])
    for impl in ("lutgather", "fgather", "pallas"):
        for form, make_fc in (("row", row_parallel_pq_fc),
                              ("column", column_parallel_pq_fc)):
            fn = make_fc(mesh, impl=impl)
            report.run(f"fc6 {form} {impl} B={FC6['b']} tp={tp}",
                       lambda: fn(*args6), _rel_err(FC_LIMITS[impl], want6))
    ring = row_parallel_pq_fc_overlapped(mesh)
    report.run(f"fc6 ring B={FC6['b']} tp={tp}", lambda: ring(*args6),
               _rel_err(FC_LIMITS["ring"], want6))

    # data shards running the gather kernels: 1 and 4 rows per rank
    for impl, per_rank in (("lutgather", 1), ("fgather", 4)):
        xb = torch.randn((per_rank * world, FC6["cin"]), generator=g).to(
            device)
        fn = make_dp_forward(lambda p, v, impl=impl: pq_fc(v, p, impl=impl),
                             data_mesh)
        report.run(f"fc6 dp {impl} rows/rank={per_rank}",
                   lambda: fn(p6, xb),
                   _rel_err(FC_LIMITS[impl],
                            pq_fc(xb, p6, impl="decode")))
    del p6

    # full-width AlexNet-PQ in memory mode over data x model
    aspec = zoo.alexnet()
    aparams = synth.random_pq_params(aspec, seed=0)
    xa = torch.as_tensor(synth.random_input(aspec, b_alex, seed=5),
                         device=device)
    prepared, conv_impls, fc_impls = prepare_params(
        aspec, aparams, batch_hint=b_alex, conv_impl="memory",
        fc_impl="memory", dtype=dtype, device=device)
    want_a = network.forward(prepared, xa, spec=aspec, conv_impls=conv_impls,
                             fc_impls=fc_impls, compute_dtype=dtype,
                             device=device)
    for dp, tp_a in ((world, 1), (1, world)):
        amesh = make_mesh(dp=dp, tp=tp_a)
        for mode in ("column", "row"):
            sharded = shard_params(aspec, prepared, amesh, fc_mode=mode,
                                   device=device)
            fwd = make_sharded_forward(
                aspec, amesh, fc_mode=mode, conv_impls=conv_impls,
                fc_impls=fc_impls, compute_dtype=dtype, device=device)
            report.run(f"alexnet memory {mode} B={b_alex} dp={dp} "
                       f"tp={tp_a}", lambda: fwd(sharded, xa),
                       _prob_err(1e-2, want_a),
                       fc_impls=sorted(set(fc_impls) - {"-"}))
            del sharded

    # the mesh engine, serving requests (rank 0 leads, the others follow)
    eng = BatchingEngine(aspec, aparams, mesh=mesh, conv_impl="memory",
                         fc_impl="memory", compute_dtype=dtype,
                         config=EngineConfig(max_batch=n_requests,
                                             max_wait_ms=20.0),
                         device=device)
    images = synth.random_input(aspec, n_requests, seed=6)
    eng_prep, eng_conv, eng_fc = prepare_params(
        aspec, aparams, batch_hint=n_requests, conv_impl="memory",
        fc_impl="memory", dtype=dtype, device=device)
    want_e = network.forward(eng_prep, images, spec=aspec,
                             conv_impls=eng_conv, fc_impls=eng_fc,
                             compute_dtype=dtype, device=device)
    del eng_prep, prepared

    def serve():
        """Rank 0 warms up, serves and stops; the others follow it through
        all three, and hold no answers."""
        if rank != 0:
            eng.follow()
            return want_e
        eng.warmup()
        eng.start()
        try:
            futures = [eng.submit(img) for img in images]
            return torch.as_tensor(np.stack([f.result(timeout=120)
                                             for f in futures]),
                                   device=device)
        finally:
            eng.stop()

    report.run(f"engine alexnet memory requests={n_requests} tp={tp} "
               f"(warm-up included)", serve, _prob_err(1e-2, want_e),
               warm=False)
    del eng

    # ResNet-50 in memory mode, data-parallel
    rspec = resnet.resnet50()
    rprep = resnet.prepare_params(
        rspec, synth.random_resnet_pq_params(rspec, seed=0), dtype=dtype,
        memory=True, device=device)
    xr = torch.randn((b_resnet, rspec.in_size, rspec.in_size, 3),
                     generator=g).to(device)

    def rforward(p, v):
        return resnet.forward(p, v, spec=rspec, compute_dtype=dtype,
                              with_softmax=True, device=device)

    want_r = rforward(rprep, xr)
    rfwd = make_dp_forward(rforward, data_mesh)
    report.run(f"resnet50 memory dp={world} B={b_resnet}",
               lambda: rfwd(rprep, xr), _prob_err(5e-3, want_r))
    del rprep

    # ViT-B/16 in memory mode over 2 pipeline stages, 4 microbatches
    vspec = vit.vit_b16()
    vprep = vit.prepare_params(vspec, synth.random_vit_pq_params(vspec,
                                                                 seed=0),
                               dtype=dtype, memory=True, device=device)
    xv = torch.randn((b_vit, 224, 224, 3), generator=g).to(device)
    want_v = vit.forward(vprep, xv, spec=vspec, compute_dtype=dtype,
                         with_softmax=True, device=device)
    pmesh = make_pipeline_mesh(stages=2)
    stacked, rest = stack_vit_blocks(vspec, vprep)
    del vprep
    local, rest = place_pipeline_params(pmesh, stacked, rest, device=device)
    del stacked
    if local is not None:
        pipe = pipeline_vit_forward(pmesh, vspec, microbatches=4,
                                    compute_dtype=dtype, with_softmax=True)
        report.run(f"vit_b16 memory pipeline stages=2 microbatches=4 "
                   f"B={b_vit}", lambda: pipe(local, rest, xv),
                   _prob_err(5e-3, want_v))
    dist.barrier()
    return report.cases


def _rank_main(args) -> int:
    from qcnn_tpu_torch.parallel.shardmap_ops import init_distributed

    torch.set_num_threads(2)
    init_distributed(args.init, args.world, args.rank)
    print(f"dryrun rank={args.rank} backend={dist.get_backend()} "
          f"device={args.device}", flush=True)
    try:
        dryrun_multichip(args.world, args.device)
    finally:
        dist.destroy_process_group()
    print(f"DRYRUN_OK {args.rank}", flush=True)
    return 0


def launch(world: int, device: str) -> int:
    """Start ``world`` ranks of this module and wait for them; their output
    goes to this process's standard output, rank by rank."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "qcnn_tpu_torch.parallel.dryrun",
               "--world", str(world), "--device", device,
               "--init", f"file://{os.path.join(tmp, 'store')}"]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=log,
                                  stderr=subprocess.STDOUT)
                 for r, log in enumerate(logs)]
        deadline = time.monotonic() + LAUNCH_TIMEOUT_S
        rc = 0
        try:
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    rc = 124
                    break
                rc = rc or p.returncode
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for r, log in enumerate(logs):
                log.seek(0)
                for line in log:
                    print(f"[rank {r}] {line}", end="", flush=True)
                log.close()
        return rc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="The parallel layer's dry run over WORLD ranks.")
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank", type=int, default=None,
                        help="(for the launcher) run as this rank")
    parser.add_argument("--init", default=None,
                        help="(for the launcher) the group's init URL")
    args = parser.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    return launch(args.world, args.device)


if __name__ == "__main__":
    sys.exit(main())
