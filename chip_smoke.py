#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (qcnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (any exception exits non-zero):

1. device: needs CUDA; prints the card's name and power limit; TF32 off.
2. build: compiles the kernels in qcnn_tpu_torch/csrc with nvcc for sm_90a.
3. kernels vs plain versions at every AlexNet geometry of the main path:
   pq_decode bit-exact (conv1-5, fc6-8), pq_lut_gather at B=1 (fc6-8),
   pq_fc_fused at B=256 and B=3 (fc6-8, both decode names).
4. timing (CUDA events, L2 flushed before each launch) of each kernel, its
   plain version and one PyTorch library call computing the same function,
   beside the least time the card could take (its bound).
5. end to end: full-width AlexNet-PQ, synthetic params (seed 0), bf16,
   strategy 'auto' (decode at load) and 'memory' (in-step kernels) at
   B=256 and B=1; the launch counts show that memory mode ran the kernels,
   and memory mode agrees with auto. A few steps of each run go through
   torch.profiler: device-busy time a step and the kernels that take it.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. With no CUDA device it exits 1 and prints
neither.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Published dense peaks (NVIDIA data sheets, SXM parts): bytes/s of device
# memory and operations/s by type.
PEAKS = {
    "H100": {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12},
    "H200": {"bytes": 4.8e12, "bf16": 989e12, "f32": 67e12},
}
ALEXNET_CONVS = ("conv1", "conv2", "conv3", "conv4", "conv5")
ALEXNET_FCS = ("fc6", "fc7", "fc8")
FLUSH_BYTES = 256 << 20  # > the 50 MB L2


def log(*args) -> None:
    print(*args, flush=True)


def peaks_for(name: str) -> dict:
    return PEAKS["H200"] if "H200" in name else PEAKS["H100"]


def bound(bytes_moved: float, ops: float, ops_rate: float,
          peaks: dict) -> tuple[float, str]:
    """Least time in ms, and what sets it."""
    t_bytes = bytes_moved / peaks["bytes"] * 1e3
    t_ops = ops / ops_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def time_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Median device time of one call, with the L2 flushed before each."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def profile_steps(fwd, steps: int, label: str) -> None:
    """Device time of `steps` forwards by kernel (torch.profiler), the
    device-busy time a step, and its share of the profiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    if busy_ms <= 0:
        raise AssertionError(f"profile {label}: no device time recorded")
    log(f"profile {label}: device_busy_ms/step={busy_ms:.4f} "
        f"profiled_wall_ms/step={wall_ms:.4f} "
        f"idle_share={max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / steps / 1e3:9.4f} ms/step "
            f"x{e.count // steps:<3} {e.key[:90]}")


def alexnet_geometry(spec, params):
    """{layer name: (spec index, layer spec, PQ params)} for AlexNet."""
    from qcnn_tpu_torch.core import ConvSpec, FCSpec

    convs = [i for i, layer in enumerate(spec.layers)
             if isinstance(layer, ConvSpec)]
    fcs = [i for i, layer in enumerate(spec.layers)
           if isinstance(layer, FCSpec)]
    names = dict(zip(ALEXNET_CONVS, convs)) | dict(zip(ALEXNET_FCS, fcs))
    return {name: (i, spec.layers[i], params[i]) for name, i in names.items()}


def phase_kernels(geo, spec, dev, flush, peaks):
    """Phases 3 and 4: each kernel against its plain version, then timed."""
    from qcnn_tpu_torch.ops import lut as lut_ops
    from qcnn_tpu_torch.ops.cuda import pq_decode, pq_fc_fused, pq_lut_gather

    gen = np.random.default_rng(7)
    shapes = spec.feature_shapes(batch=1)
    rows = {}

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    # --- pq_decode: in-step conv decodes (the path) and fc rows, bit-exact
    dec = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes": 0.0, "max_abs_err": 0.0}
    for name in ALEXNET_CONVS + ALEXNET_FCS:
        i, layer, p = geo[name]
        _, h, w, c = shapes[i]
        a = p["assignments"]
        if name in ALEXNET_CONVS:
            cout, kh, kw, s = a.shape
            a2 = a.reshape(cout * kh * kw, s)
            row_len = c // layer.groups
        else:
            a2 = a
            row_len = h * w * c
        for dtype in (torch.bfloat16, torch.float32):
            cb = t(p["codebooks"], dtype)
            ids = t(a2)
            got = pq_decode.decode_rows(cb, ids, row_len)
            want = lut_ops.decode_rows(cb, ids, row_len)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"pq_decode {name} {dtype}: not "
                                     "bit-exact against the plain gather")
        log(f"check pq_decode {name} N={a2.shape[0]} S={a2.shape[1]} "
            f"C={row_len} bf16+f32 bit-exact max_abs_err=0.0")
        if name not in ALEXNET_CONVS:
            continue
        cb = t(p["codebooks"], torch.bfloat16)
        ids = t(a2)
        s, k, d = cb.shape
        srange = torch.arange(s, device=dev)[None, :]
        ids_long = ids.long()  # an index tensor, made outside the timing
        ms = time_ms(lambda: pq_decode.decode_rows(cb, ids, row_len), flush)
        plain = time_ms(lambda: lut_ops.decode_rows(cb, ids, row_len), flush)
        lib = time_ms(lambda: cb[srange, ids_long], flush)
        n = ids.shape[0]
        nbytes = n * s + cb.numel() * 2 + n * row_len * 2
        b_ms, _ = bound(nbytes, 0, peaks["bf16"], peaks)
        log(f"time pq_decode {name} kernel_ms={ms:.5f} plain_ms={plain:.5f} "
            f"library_ms={lib:.5f} bound_ms={b_ms:.5f} (bytes {nbytes})")
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", b_ms), ("bytes", nbytes)):
            dec[key] += v
    dec["bound_by"] = "bytes"
    rows["pq_decode"] = dec

    # --- pq_lut_gather at B=1 (memory mode's fc route at B <= 2)
    lg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
          "max_abs_err": 0.0, "t_bytes": 0.0, "t_ops": 0.0}
    for name in ALEXNET_FCS:
        i, _, p = geo[name]
        _, h, w, c = shapes[i]
        cin = h * w * c
        cb = t(p["codebooks"], torch.bfloat16)
        ids = t(p["assignments"])
        bias = t(p["bias"], torch.float32)
        b = 1
        x = t(gen.standard_normal((b, cin)), torch.bfloat16)
        lut = lut_ops.build_lut(x, cb).contiguous()
        got = pq_lut_gather.lut_gather(lut, ids, bias)
        want = pq_lut_gather.lut_gather_plain(lut, ids, bias)
        err = (got - want).abs().max().item()
        scale = max(1e-6, want.abs().max().item())
        if not err / scale <= 1e-5:
            raise AssertionError(f"pq_lut_gather {name}: max_abs_err {err} "
                                 f"> 1e-5 x {scale}")
        lg["max_abs_err"] = max(lg["max_abs_err"], err)
        log(f"check pq_lut_gather {name} B={b} max_abs_err={err:.3e} "
            f"(rtol 1e-5 of {scale:.3e})")
        s, k, _ = cb.shape
        cout = ids.shape[0]
        idx = ids.long().t().expand(b, s, cout).contiguous()
        ms = time_ms(lambda: pq_lut_gather.lut_gather(lut, ids, bias), flush)
        plain = time_ms(
            lambda: pq_lut_gather.lut_gather_plain(lut, ids, bias), flush)
        lib = time_ms(lambda: torch.gather(lut, 2, idx).sum(1) + bias, flush)
        nbytes = b * s * k * 4 + cout * s + cout * 4 + b * cout * 4
        ops = b * cout * s
        b_ms, _ = bound(nbytes, ops, peaks["f32"], peaks)
        log(f"time pq_lut_gather {name} B={b} kernel_ms={ms:.5f} "
            f"plain_ms={plain:.5f} library_ms={lib:.5f} bound_ms={b_ms:.5f} "
            f"(bytes {nbytes}, adds {ops})")
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", b_ms),
                       ("t_bytes", nbytes / peaks["bytes"]),
                       ("t_ops", ops / peaks["f32"])):
            lg[key] += v
    lg["bound_by"] = "bytes" if lg.pop("t_bytes") >= lg.pop("t_ops") \
        else "operations"
    rows["pq_lut_gather"] = lg

    # --- pq_fc_fused at B=256 (timed: the main path's batch) and B=3
    fu = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
          "max_abs_err": 0.0, "t_bytes": 0.0, "t_ops": 0.0}
    for b in (256, 3):
        for name in ALEXNET_FCS:
            i, _, p = geo[name]
            _, h, w, c = shapes[i]
            cin = h * w * c
            params = {"codebooks": t(p["codebooks"], torch.bfloat16),
                      "assignments": t(p["assignments"]),
                      "bias": t(p["bias"], torch.float32)}
            x = t(gen.standard_normal((b, cin)), torch.bfloat16)
            want = pq_fc_fused.fused_plain(x, params["codebooks"],
                                           params["assignments"],
                                           params["bias"])
            scale = max(1e-6, want.abs().max().item())
            for decode in pq_fc_fused.DECODES:
                got = pq_fc_fused.pq_fc_fused(x, params, decode=decode)
                err = (got - want).abs().max().item()
                if not err / scale <= 1e-4:
                    raise AssertionError(
                        f"pq_fc_fused {name} B={b} {decode}: max_abs_err "
                        f"{err} > 1e-4 x {scale}")
                fu["max_abs_err"] = max(fu["max_abs_err"], err)
                log(f"check pq_fc_fused {name} B={b} decode={decode} "
                    f"max_abs_err={err:.3e} (rtol 1e-4 of {scale:.3e})")
            s, k, d = params["codebooks"].shape
            cout = params["assignments"].shape[0]
            w_io = lut_ops.decode_fc_weight(params["codebooks"],
                                            params["assignments"], cin)
            w_io = w_io.contiguous()
            ms = time_ms(lambda: pq_fc_fused.pq_fc_fused(x, params), flush)
            plain = time_ms(lambda: pq_fc_fused.fused_plain(
                x, params["codebooks"], params["assignments"],
                params["bias"]), flush)
            lib = time_ms(lambda: torch.matmul(x, w_io), flush)
            nbytes = (b * cin * 2 + cout * s + s * k * d * 2 + cout * 4
                      + b * cout * 4)
            ops = 2 * b * cin * cout
            b_ms, by = bound(nbytes, ops, peaks["bf16"], peaks)
            log(f"time pq_fc_fused {name} B={b} kernel_ms={ms:.5f} "
                f"plain_ms={plain:.5f} library_ms={lib:.5f} "
                f"bound_ms={b_ms:.5f} bound_by={by} (bytes {nbytes}, "
                f"flop {ops})")
            if b == 256:
                for key, v in (("ms", ms), ("plain_ms", plain),
                               ("library_ms", lib), ("bound_ms", b_ms),
                               ("t_bytes", nbytes / peaks["bytes"]),
                               ("t_ops", ops / peaks["bf16"])):
                    fu[key] += v
    fu["bound_by"] = "bytes" if fu.pop("t_bytes") >= fu.pop("t_ops") \
        else "operations"
    rows["pq_fc_fused"] = fu
    rows["pq_decode"].pop("bytes")

    # the kernels' other paths, off AlexNet's shapes: Cin not a multiple of
    # 8 (no 16-byte x loads), a codebook span too large to stage (K=128,
    # D=8), ragged B, Cout and S
    for b, cin, cout, s, k, d in ((70, 58, 250, 15, 32, 4),
                                  (5, 3, 40, 1, 128, 8),
                                  (130, 130, 129, 33, 16, 4)):
        params = {"codebooks": t(gen.standard_normal((s, k, d)),
                                 torch.bfloat16),
                  "assignments": t(gen.integers(0, k, (cout, s),
                                                dtype=np.uint8)),
                  "bias": t(gen.standard_normal(cout), torch.float32)}
        x = t(gen.standard_normal((b, cin)), torch.bfloat16)
        want = pq_fc_fused.fused_plain(x, params["codebooks"],
                                       params["assignments"], params["bias"])
        err = (pq_fc_fused.pq_fc_fused(x, params) - want).abs().max().item()
        lut = lut_ops.build_lut(x, params["codebooks"]).contiguous()
        want_l = pq_lut_gather.lut_gather_plain(lut, params["assignments"],
                                                params["bias"])
        err_l = (pq_lut_gather.lut_gather(lut, params["assignments"],
                                          params["bias"])
                 - want_l).abs().max().item()
        dec = pq_decode.decode_rows(params["codebooks"],
                                    params["assignments"], cin)
        if (err > 1e-4 * want.abs().max().item()
                or err_l > 1e-5 * want_l.abs().max().item()
                or not torch.equal(dec, lut_ops.decode_rows(
                    params["codebooks"], params["assignments"], cin))):
            raise AssertionError(f"ragged B={b} Cin={cin} Cout={cout} S={s} "
                                 f"K={k} D={d}: fused {err}, lut {err_l}")
        log(f"check ragged B={b} Cin={cin} Cout={cout} S={s} K={k} D={d}: "
            f"fused max_abs_err={err:.3e} lut max_abs_err={err_l:.3e} "
            "decode bit-exact")
    return rows


def phase_end_to_end(spec, params, dev, gpu_name):
    """Phase 5: auto and memory at B=256 and B=1; returns the launch counts
    of the whole phase."""
    from qcnn_tpu_torch.models import network, prepare, synth
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    x_all = torch.from_numpy(synth.random_input(spec, 256, seed=1)).to(dev)
    expect = {  # launches per forward of each kernel, by strategy and batch
        ("auto", 256): {"pq_decode": 0, "pq_lut_gather": 0, "pq_fc_fused": 0},
        ("auto", 1): {"pq_decode": 0, "pq_lut_gather": 0, "pq_fc_fused": 0},
        ("memory", 256): {"pq_decode": 5, "pq_lut_gather": 0,
                          "pq_fc_fused": 3},
        ("memory", 1): {"pq_decode": 5, "pq_lut_gather": 3, "pq_fc_fused": 0},
    }
    probs = {}
    cuda_ops.reset_launches()
    totals = {name: 0 for name in cuda_ops.KERNELS}
    for (mode, b), per_fwd in expect.items():
        t0 = time.perf_counter()
        prepared, conv_impls, fc_impls = prepare.prepare_params(
            spec, params, batch_hint=b, conv_impl=mode, fc_impl=mode,
            dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        resident = sum(v.numel() * v.element_size() for p in prepared
                       if p is not None for v in p.values())
        x = x_all[:b]

        def fwd():
            return network.forward(prepared, x, spec=spec,
                                   conv_impls=conv_impls, fc_impls=fc_impls,
                                   compute_dtype=torch.bfloat16, device=dev)

        before = cuda_ops.launches()
        out = fwd()
        fwd()
        steps = 10 if b > 1 else 50
        prof_steps = 3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            fwd()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        profile_steps(fwd, prof_steps, f"{mode} B={b}")
        after = cuda_ops.launches()
        n_fwd = steps + 2 + prof_steps
        for name, n in per_fwd.items():
            got = after[name] - before[name]
            if got != n * n_fwd:
                raise AssertionError(
                    f"{mode} B={b}: {name} launched {got} times, expected "
                    f"{n} per forward x {n_fwd}")
            totals[name] += got
        out = out.float()
        if out.shape != (b, spec.num_classes):
            raise AssertionError(f"{mode} B={b}: output shape {out.shape}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{mode} B={b}: non-finite probabilities")
        row_sum_err = (out.sum(1) - 1).abs().max().item()
        if row_sum_err > 1e-3:
            raise AssertionError(f"{mode} B={b}: rows sum to 1 +- "
                                 f"{row_sum_err}")
        probs[(mode, b)] = out
        log(f"e2e {mode} B={b} fc_impls={sorted(set(fc_impls) - {'-'})} "
            f"img/s={b * steps / dt:.1f} ms/step={dt / steps * 1e3:.4f} "
            f"prepare_s={prep_s:.2f} resident_param_bytes={resident} "
            f"peak_alloc_bytes={peak} "
            f"launches={ {k: after[k] - before[k] for k in per_fwd} } "
            f"card={gpu_name}")
    final = cuda_ops.launches()
    if final != totals:
        raise AssertionError(f"launch counts {final} != per-run sum {totals}")
    for b in (256, 1):
        a, m = probs[("auto", b)], probs[("memory", b)]
        err = (a - m).abs().max().item()
        top1 = (a.argmax(1) == m.argmax(1)).float().mean().item()
        log(f"e2e memory vs auto B={b}: max_abs_err(probs)={err:.3e} "
            f"top1_agreement={top1:.4f}")
        if err > 1e-2 or top1 < 0.99:
            raise AssertionError(f"memory vs auto B={b}: max|dprob| {err} "
                                 f"(limit 1e-2), top-1 agreement {top1} "
                                 "(limit 0.99)")
    return final


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from qcnn_tpu_torch.models import synth, zoo
    from qcnn_tpu_torch.ops.cuda import _build

    # phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    dev = torch.device("cuda", 0)
    gpu_name = torch.cuda.get_device_name(0)
    peaks = peaks_for(gpu_name)
    log(f"device {gpu_name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"peaks={peaks}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 2: build
    path, build_s, build_log = _build.build()
    log(f"build {os.path.basename(path)} seconds={build_s:.2f}")
    for line in build_log.splitlines():
        if "Used" in line or "spill" in line or "error" in line:
            log("  ptxas: " + line.strip())

    spec = zoo.alexnet()
    params = synth.random_pq_params(spec, seed=0)
    geo = alexnet_geometry(spec, params)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    # phases 3-4: kernels vs plain versions, then timed
    rows = phase_kernels(geo, spec, dev, flush, peaks)
    del flush

    # phase 5: the main path, end to end
    launches = phase_end_to_end(spec, params, dev, gpu_name)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main path")

    sources = {
        "pq_decode": ("qcnn_tpu_torch/csrc/pq_decode.cu",
                      "qcnn_tpu/ops/pallas/pq_decode.py:80"),
        "pq_lut_gather": ("qcnn_tpu_torch/csrc/pq_lut_gather.cu",
                          "qcnn_tpu/ops/pallas/pq_lut_gather.py:67"),
        "pq_fc_fused": ("qcnn_tpu_torch/csrc/pq_fc_fused.cu",
                        "qcnn_tpu/ops/pallas/pq_fc_fused.py:125"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
