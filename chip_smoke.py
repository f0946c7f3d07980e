#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (qcnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py               # everything, as below
    python3 chip_smoke.py --only-fused  # phases 1-2 and the two decode-GEMMs

Phases, each fatal on failure (any exception exits non-zero):

1. device: needs CUDA; prints the card's name and power limit; TF32 off.
2. build: compiles the kernels in qcnn_tpu_torch/csrc with nvcc for sm_90a
   and prints what ptxas reports for each kernel (registers, shared memory,
   spills, warnings) under the kernel's name.
3. kernels vs plain versions at every geometry of the main paths:
   pq_fc_fused at AlexNet fc6-8 (B=256, 3, 64 and 1024, both decode names)
   and pq_conv_fused at ResNet-50's two fused geometries (B=64 and B=1),
   all of which must plan the wgmma kernels; each split contraction is
   launched twice and must give the same bits; odd shapes the wgmma
   kernels take and ragged ones that go to the general kernels.
   pq_decode bit-exact (conv1-5, fc6-8), pq_lut_gather at B=1 (fc6-8),
   pq_fc at AlexNet fc6-8 (B=256 and B=3), lrn_fused at AlexNet's two
   LRN shapes (B=256, bf16, all three window names) and small f32 ones.
4. timing (CUDA events, L2 flushed before each launch, every repetition
   enqueued behind a device spin so the host's pace is not in the number)
   of each kernel, its plain version and one PyTorch library call computing
   the same function, beside the least time the card could take (its
   bound); for the two decode-GEMMs also the general kernel on the same
   inputs. Then lrn_fused's own entry point, counted (no forward runs it,
   as in the JAX package), and the general kernels through the public
   entry points on ragged shapes, counted.
5. end to end: full-width AlexNet-PQ, synthetic params (seed 0), bf16,
   strategy 'auto' (decode at load) and 'memory' (in-step kernels) at
   B=256 and B=1; the launch counts show that memory mode ran the kernels,
   and memory mode agrees with auto. A few steps of each run go through
   torch.profiler: device-busy time a step and the kernels that take it.
6. AlexNet's explicit FC arm fc_impl='pallas' (convs 'auto') at B=256 and
   B=1: pq_fc three times a forward, agreeing with auto.
7. full-width ResNet-50 (224x224, 1000 classes), bf16, synthetic PQ params
   (seed 0), through models.common.build_family_forward: decode at load and
   memory mode at B=64 (the family's max_batch) and B=1, each profiled.
   Memory mode launches pq_conv_fused 7 times a forward (conv2 of stage 2
   blocks 1-5 and stage 3 blocks 1-2) and pq_decode 46 times (the other 45
   PQ convs and the fc head); decode at load launches no kernel. No path
   launches a general kernel.

Limits (the script fails past them):
- kernels against their plain versions: pq_fc_fused and pq_conv_fused
  (wgmma and general kernels) 1e-4 and pq_fc 1e-5 of the largest |output|
  (the same bf16 operands or f32 LUT, f32 sums in another order: per split
  of the contraction, then the splits in order); lrn_fused within one bf16
  ulp of each bf16 output and 1e-6 of the largest |output| in f32 (f32
  window sums in another order).
- AlexNet memory and pallas against auto: max |dprob| <= 1e-2, top-1 equal
  on >= 99 % of rows (the random net's softmax saturates).
- ResNet-50 memory against decode at load: max |dprob| <= 5e-3, top-1 equal
  on >= 99 % of rows. The fused conv sums bf16 products in f32 and emits
  f32 before the cast, where cuDNN's bf16 conv rounds its output and adds
  the bias in bf16; through 53 convs this moved probabilities by 1.5e-4 on
  the CPU (B=16, seed 0). The random net gives every row the same top class
  with a margin of about half its probability, so top-1 is the weak check
  and |dprob| the strong one.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. With no CUDA device it exits 1 and prints
neither; with --only-fused it stops after the decode-GEMMs and prints
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
SPIN_CYCLES = 18_000_000  # about 10 ms of device clock


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
    """Median device time of one call, with the L2 flushed before each.
    The device first spins for about 10 ms while the host enqueues every
    repetition behind it, so that a slow host (Python around a launch, two
    launches a call) does not show up as device time."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for i in range(reps):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def profile_steps(fwd, steps: int, label: str) -> None:
    """Device time of `steps` forwards by kernel (torch.profiler), the
    device-busy time a step, its share of the profiled wall time, and the
    host's CPU time a step in operators and launches."""
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
    # the host side: CPU time of the operators and launches a step
    host = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU]
    host_ms = sum(e.self_cpu_time_total for e in host) / steps / 1e3
    top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:4]
    log(f"  host: self_cpu_ms/step={host_ms:.4f}; top: " + ", ".join(
        f"{e.key} {e.self_cpu_time_total / steps / 1e3:.4f} ms "
        f"x{e.count // steps}" for e in top))


def log_ptxas(build_log: str) -> None:
    """The registers, shared memory and spills that ptxas reports, each
    under the (mangled) name of the kernel it compiled."""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            log("  ptxas: kernel " + line.split("'")[1])
        elif ("Used" in line or "spill" in line or "error" in line
              or "warning" in line.lower() or "Potential" in line):
            log("  ptxas:   " + line.replace("ptxas info    :", "").strip())


def new_row() -> dict:
    """A kernel's entry of the {"kernels": [...]} record, being summed."""
    return {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "max_abs_err": 0.0, "t_bytes": 0.0, "t_ops": 0.0}


def add_timing(row: dict, n: int, ms: float, plain: float, lib: float,
               b_ms: float, nbytes: float, ops: float, ops_rate: float,
               peaks: dict) -> None:
    """Add n launches' worth of one shape's times to a kernel's row."""
    for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                   ("bound_ms", b_ms), ("t_bytes", nbytes / peaks["bytes"]),
                   ("t_ops", ops / ops_rate)):
        row[key] += n * v


def close_row(row: dict) -> dict:
    """Name what bounds the summed shapes, bytes or operations."""
    row["bound_by"] = "bytes" if row.pop("t_bytes") >= row.pop("t_ops") \
        else "operations"
    return row


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
    dec = new_row()
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
        add_timing(dec, 1, ms, plain, lib, b_ms, nbytes, 0, peaks["bf16"],
                   peaks)
    rows["pq_decode"] = close_row(dec)

    # --- pq_lut_gather at B=1 (memory mode's fc route at B <= 2)
    lg = new_row()
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
        add_timing(lg, 1, ms, plain, lib, b_ms, nbytes, ops, peaks["f32"],
                   peaks)
    rows["pq_lut_gather"] = close_row(lg)

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


# ResNet-50's convs that memory mode runs through pq_conv_fused: conv2 of
# these blocks' stage, (block key, spatial size, such convs a forward)
RESNET50_FUSED = (("s2b1", 14, 5), ("s3b1", 7, 2))


def phase_other_kernels(spec, geo, dev, flush, peaks):
    """Phases 3 and 4 for pq_fc (AlexNet fc6-8, times at B=256) and
    lrn_fused (AlexNet's two LRNs at B=256); then lrn_fused's own entry
    point on those shapes, counted. Returns (rows, counts of the entry-point
    run)."""
    import torch.nn.functional as F

    from qcnn_tpu_torch.core import LRNSpec
    from qcnn_tpu_torch.ops import cuda as cuda_ops
    from qcnn_tpu_torch.ops import lut as lut_ops
    from qcnn_tpu_torch.ops.cuda import lrn_fused, pq_fc

    gen = np.random.default_rng(11)
    tgen = torch.Generator(device=dev).manual_seed(11)
    rows = {}

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    # --- pq_fc at AlexNet fc6-8 (times at B=256) and B=3
    shapes = spec.feature_shapes(batch=1)
    fc = new_row()
    for b in (256, 3):
        for name in ALEXNET_FCS:
            i, _, p = geo[name]
            _, h, w, c = shapes[i]
            cin = h * w * c
            cb = t(p["codebooks"], torch.bfloat16)
            ids = t(p["assignments"])
            bias = t(p["bias"], torch.float32)
            x = t(gen.standard_normal((b, cin)), torch.bfloat16)
            lut = lut_ops.build_lut(x, cb).contiguous()
            got = pq_fc.gather_accumulate(lut, ids, bias)
            want = pq_fc.lut_gather_plain(lut, ids, bias)
            err = (got - want).abs().max().item()
            scale = max(1e-6, want.abs().max().item())
            if not err <= 1e-5 * scale:
                raise AssertionError(f"pq_fc {name} B={b}: max_abs_err "
                                     f"{err} > 1e-5 x {scale}")
            fc["max_abs_err"] = max(fc["max_abs_err"], err)
            log(f"check pq_fc {name} B={b} max_abs_err={err:.3e} "
                f"(rtol 1e-5 of {scale:.3e})")
            s, k, _ = cb.shape
            cout = ids.shape[0]
            # a stride-0 view: gather reads it without a (B, S, Cout) copy
            idx = ids.long().t().expand(b, s, cout)
            ms = time_ms(lambda: pq_fc.gather_accumulate(lut, ids, bias),
                         flush)
            plain = time_ms(lambda: pq_fc.lut_gather_plain(lut, ids, bias),
                            flush, reps=5)
            lib = time_ms(lambda: torch.gather(lut, 2, idx).sum(1) + bias,
                          flush, reps=5)
            nbytes = b * s * k * 4 + cout * s + cout * 4 + b * cout * 4
            ops = b * cout * s
            b_ms, by = bound(nbytes, ops, peaks["f32"], peaks)
            log(f"time pq_fc {name} B={b} kernel_ms={ms:.5f} "
                f"plain_ms={plain:.5f} library_ms={lib:.5f} "
                f"bound_ms={b_ms:.5f} bound_by={by} (bytes {nbytes}, "
                f"adds {ops})")
            if b == 256:
                add_timing(fc, 1, ms, plain, lib, b_ms, nbytes, ops,
                           peaks["f32"], peaks)
    rows["pq_fc"] = close_row(fc)

    # --- lrn_fused at AlexNet's two LRN shapes, B=256, bf16
    lrns = [(spec.layers[i], spec.feature_shapes(batch=256)[i])
            for i, layer in enumerate(spec.layers)
            if isinstance(layer, LRNSpec)]
    lr = new_row()
    inputs = []
    for layer, shape in lrns:
        kw = dict(size=layer.size, alpha=layer.alpha, beta=layer.beta,
                  k=layer.k)
        x = torch.randn(shape, generator=tgen, device=dev).mul_(3).to(
            torch.bfloat16)
        inputs.append((x, kw))
        want = lrn_fused.lrn_plain(x, **kw).float()
        ulp = torch.ldexp(torch.ones_like(want),
                          torch.frexp(want).exponent - 8)
        for window in lrn_fused.WINDOWS:
            diff = (lrn_fused.lrn_fused(x, window=window, **kw).float()
                    - want).abs()
            if not bool((diff <= ulp).all()):
                raise AssertionError(f"lrn_fused {tuple(shape)} {window}: "
                                     "more than one bf16 ulp off")
            lr["max_abs_err"] = max(lr["max_abs_err"], diff.max().item())
        log(f"check lrn_fused {tuple(shape)} bf16 windows={lrn_fused.WINDOWS}"
            f" max_abs_err={lr['max_abs_err']:.3e} (<= 1 bf16 ulp each)")
        del want, ulp, diff
        xn = x.permute(0, 3, 1, 2)
        ms = time_ms(lambda: lrn_fused.lrn_fused(x, **kw), flush)
        plain = time_ms(lambda: lrn_fused.lrn_plain(x, **kw), flush)
        lib = time_ms(lambda: F.local_response_norm(xn, **kw), flush)
        nbytes = 2 * x.numel() * x.element_size()
        b_ms, by = bound(nbytes, 0, peaks["f32"], peaks)
        log(f"time lrn_fused {tuple(shape)} kernel_ms={ms:.5f} "
            f"plain_ms={plain:.5f} library_ms={lib:.5f} bound_ms={b_ms:.5f} "
            f"bound_by={by} (bytes {nbytes})")
        add_timing(lr, 1, ms, plain, lib, b_ms, nbytes, 0, peaks["f32"],
                   peaks)
    rows["lrn_fused"] = close_row(lr)
    # float32, other ranks, channel counts and betas
    for shape in ((4, 7, 7, 96), (5, 130), (2, 3, 3, 256)):
        for beta in (0.75, 0.5, 1.0, 0.6):
            kw = dict(size=5, alpha=1e-4, beta=beta, k=2.0)
            x = t(gen.standard_normal(shape) * 3, torch.float32)
            want = lrn_fused.lrn_plain(x, **kw)
            err = (lrn_fused.lrn_fused(x, **kw) - want).abs().max().item()
            if not err <= 1e-6 * want.abs().max().item():
                raise AssertionError(f"lrn_fused f32 {shape} beta={beta}: "
                                     f"max_abs_err {err}")
        log(f"check lrn_fused f32 {shape} betas 0.75/0.5/1.0/0.6 "
            "(rtol 1e-6)")

    # lrn_fused's own entry point, as its users call it (no forward does)
    cuda_ops.reset_launches()
    for x, kw in inputs:
        lrn_fused.lrn_fused(x, **kw)
    torch.cuda.synchronize()
    counts = cuda_ops.launches()
    if counts != {name: (len(inputs) if name == "lrn_fused" else 0)
                  for name in counts}:
        raise AssertionError(f"lrn_fused entry point: launches {counts}")
    return rows, counts


# shapes off the models' paths. The first group of each kind is taken by
# the wgmma kernels (Cin = S*D a multiple of 64; ragged B and Cout, D in
# {1, 2, 4}, K not a power of two); the second goes to the general kernels
# (Cin not a multiple of 8, a codebook span too large to stage, Cin < S*D).
# fc: (B, Cin, Cout, S, K, D); conv: (B, H, W, Cin, Cout, kh, pad, S, K, D)
FC_ODD = ((70, 128, 250, 32, 32, 4), (5, 64, 40, 64, 128, 1),
          (130, 192, 129, 96, 16, 2), (33, 256, 300, 64, 20, 4),
          (9, 1024, 520, 256, 32, 4))
FC_RAGGED = ((70, 58, 250, 15, 32, 4), (5, 3, 40, 1, 128, 8),
             (130, 130, 129, 33, 16, 4))
CONV_ODD = ((3, 9, 11, 64, 130, 3, 1, 16, 32, 4),
            (1, 14, 14, 128, 64, 5, 2, 64, 128, 2),
            (2, 7, 7, 64, 70, 3, 0, 64, 16, 1),
            (40, 6, 5, 192, 260, 3, 1, 48, 100, 4),
            (4, 10, 10, 128, 96, 3, 1, 64, 32, 2))
CONV_RAGGED = ((3, 9, 11, 32, 128, 3, 1, 8, 32, 4),
               (1, 14, 14, 48, 64, 5, 2, 24, 128, 2),
               (2, 7, 7, 50, 70, 3, 1, 13, 16, 4),
               (3, 6, 5, 40, 33, 3, 0, 40, 64, 1),
               (5, 8, 8, 300, 200, 3, 1, 75, 128, 4))


def phase_fused_kernels(spec, geo, rparams, dev, flush, peaks):
    """Phases 3 and 4 for the two decode-GEMMs: pq_fc_fused at AlexNet fc6-8
    (B=256, the main path's batch, summed into the kernel's row; B=3, 64 and
    1024, the ends of its route) and pq_conv_fused at ResNet-50's two fused
    geometries (B=64, summed times a forward: 5 at 14x14 and 2 at 7x7; B=1).
    Each shape is held against the plain version, launched twice where the
    contraction is split (the two outputs must be the same bits), and timed
    beside the general kernel on the same inputs. Then the odd and ragged
    shapes, and the general kernels through the public entry points,
    counted. Returns (rows, counts of that entry-point run)."""
    import torch.nn.functional as F

    from qcnn_tpu_torch.ops import cuda as cuda_ops
    from qcnn_tpu_torch.ops import lut as lut_ops
    from qcnn_tpu_torch.ops.cuda import pq_conv_fused, pq_fc_fused

    gen = np.random.default_rng(13)
    shapes = spec.feature_shapes(batch=1)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def dev_params(p):
        return {"codebooks": t(p["codebooks"], torch.bfloat16),
                "assignments": t(p["assignments"]),
                "bias": t(p["bias"], torch.float32)}

    def random_params(a_shape, s, k, d):
        return {"codebooks": t(gen.standard_normal((s, k, d)) * 0.3,
                               torch.bfloat16),
                "assignments": t(gen.integers(0, k, a_shape, dtype=np.uint8)),
                "bias": t(gen.standard_normal(a_shape[0]), torch.float32)}

    def hold(name, label, got, want, row, variant):
        err = (got - want).abs().max().item()
        scale = max(1e-6, want.abs().max().item())
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{name} {label}: max_abs_err {err} "
                                 f"> 1e-4 x {scale}")
        if row is not None:
            row["max_abs_err"] = max(row["max_abs_err"], err)
        log(f"check {name} {label} kernel={variant} max_abs_err={err:.3e} "
            f"(rtol 1e-4 of {scale:.3e})")

    def same_bits(name, label, fn, plan):
        """Two launches of a split contraction give the same bits."""
        if plan.splits == 1:
            return
        first, second = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"{name} {label}: two launches of the "
                                 f"{plan.splits}-way split differ")
        log(f"check {name} {label} splits={plan.splits} two launches "
            "bit-identical")

    def fc_general(x, params):
        """The general kernel on a shape the wrapper gives the other one."""
        cb, ids, bias = (params["codebooks"], params["assignments"],
                         params["bias"])
        (b, cin), (s, k, d) = x.shape, cb.shape
        out = torch.empty((b, ids.shape[0]), dtype=torch.float32, device=dev)
        pq_fc_fused.GENERAL.launch(
            x.data_ptr(), cb.data_ptr(), ids.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, cin, s, k, d, ids.shape[0])
        return out

    def conv_general(x, params, pad):
        cb, ids, bias = (params["codebooks"], params["assignments"],
                         params["bias"])
        (b, h, w, cin), (s, k, d) = x.shape, cb.shape
        cout, kh = ids.shape[0], ids.shape[1]
        out = torch.empty((b, h + 2 * pad - kh + 1, w + 2 * pad - kh + 1,
                           cout), dtype=torch.float32, device=dev)
        pq_conv_fused.GENERAL.launch(
            x.data_ptr(), cb.data_ptr(), ids.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, w, cin, s, k, d, cout, kh, pad)
        return out

    def fc_case(b, cin, params, label, row, timed_into=None):
        """Check one FC shape; time it when `timed_into` is a row (summed
        there) or True (logged only)."""
        x = t(gen.standard_normal((b, cin)), torch.bfloat16)
        cb, ids, bias = (params["codebooks"], params["assignments"],
                         params["bias"])
        s, k, d = cb.shape
        cout = ids.shape[0]
        plan = pq_fc_fused.plan(b, cin, cout, s, k, d)
        want = pq_fc_fused.fused_plain(x, cb, ids, bias)
        for decode in pq_fc_fused.DECODES:
            hold("pq_fc_fused", f"{label} decode={decode}",
                 pq_fc_fused.pq_fc_fused(x, params, decode=decode), want,
                 row, plan.variant)
        same_bits("pq_fc_fused", label,
                  lambda: pq_fc_fused.pq_fc_fused(x, params), plan)
        if timed_into is None:
            return plan
        w_io = lut_ops.decode_fc_weight(cb, ids, cin).contiguous()
        ms = time_ms(lambda: pq_fc_fused.pq_fc_fused(x, params), flush)
        plain = time_ms(lambda: pq_fc_fused.fused_plain(x, cb, ids, bias),
                        flush, reps=10)
        lib = time_ms(lambda: torch.matmul(x, w_io), flush)
        nbytes = (b * cin * 2 + cout * s + s * k * d * 2 + cout * 4
                  + b * cout * 4)
        ops = 2 * b * cin * cout
        b_ms, by = bound(nbytes, ops, peaks["bf16"], peaks)
        other = ""
        if plan.variant == "wgmma":
            hold("pq_fc_fused_general", label, fc_general(x, params), want,
                 None, "general")
            other = (f" general_kernel_ms="
                     f"{time_ms(lambda: fc_general(x, params), flush):.5f}")
        log(f"time pq_fc_fused {label} kernel={plan.variant} "
            f"tile_rows={plan.tile_rows} splits={plan.splits} "
            f"grid={plan.grid} smem={plan.smem_bytes} kernel_ms={ms:.5f}"
            f"{other} plain_ms={plain:.5f} library_ms={lib:.5f} "
            f"bound_ms={b_ms:.5f} bound_by={by} (bytes {nbytes}, flop {ops})")
        if isinstance(timed_into, dict):
            add_timing(timed_into, 1, ms, plain, lib, b_ms, nbytes, ops,
                       peaks["bf16"], peaks)
        return plan

    def conv_case(b, h, w, cin, params, pad, label, row, timed_into=None,
                  per_fwd=1):
        x = t(gen.standard_normal((b, h, w, cin)), torch.bfloat16)
        cb, ids, bias = (params["codebooks"], params["assignments"],
                         params["bias"])
        s, k, d = cb.shape
        cout, kh = ids.shape[0], ids.shape[1]
        plan = pq_conv_fused.plan(b, h, w, cin, cout, kh, pad, s, k, d)
        want = pq_conv_fused.conv_fused_plain(x, cb, ids, bias, pad=pad)

        def run():
            return pq_conv_fused.pq_conv_fused(x, params, stride=1, pad=pad)

        hold("pq_conv_fused", label, run(), want, row, plan.variant)
        same_bits("pq_conv_fused", label, run, plan)
        if timed_into is None:
            return plan
        # library: cuDNN on the decoded bf16 weight (OHWI memory, a
        # channels_last OIHW view), as decode at load runs it
        wd = lut_ops.decode_conv_kernel(cb, ids, cin)
        xn, wn = x.permute(0, 3, 1, 2), wd.permute(3, 2, 0, 1)
        ms = time_ms(run, flush)
        plain = time_ms(lambda: pq_conv_fused.conv_fused_plain(
            x, cb, ids, bias, pad=pad), flush, reps=10)
        lib = time_ms(lambda: F.conv2d(xn, wn, padding=pad), flush)
        ho, wo = want.shape[1], want.shape[2]
        nbytes = (x.numel() * 2 + ids.numel() + cb.numel() * 2 + cout * 4
                  + b * ho * wo * cout * 4)
        ops = 2 * b * ho * wo * kh * kh * cin * cout
        b_ms, by = bound(nbytes, ops, peaks["bf16"], peaks)
        other = ""
        if plan.variant == "wgmma":
            hold("pq_conv_fused_general", label, conv_general(x, params, pad),
                 want, None, "general")
            other = (" general_kernel_ms=" + format(time_ms(
                lambda: conv_general(x, params, pad), flush), ".5f"))
        log(f"time pq_conv_fused {label} kernel={plan.variant} "
            f"tile_rows={plan.tile_rows} splits={plan.splits} "
            f"grid={plan.grid} smem={plan.smem_bytes} kernel_ms={ms:.5f}"
            f"{other} plain_ms={plain:.5f} library_ms={lib:.5f} "
            f"bound_ms={b_ms:.5f} bound_by={by} (bytes {nbytes}, flop {ops}) "
            f"x{per_fwd} a forward")
        if isinstance(timed_into, dict):
            add_timing(timed_into, per_fwd, ms, plain, lib, b_ms, nbytes, ops,
                       peaks["bf16"], peaks)
        return plan

    fu, fu_gen, cf, cf_gen = new_row(), new_row(), new_row(), new_row()

    # --- pq_fc_fused at AlexNet fc6-8
    for b in (256, 3, 64, 1024):
        for name in ALEXNET_FCS:
            i, _, p = geo[name]
            _, h, w, c = shapes[i]
            plan = fc_case(b, h * w * c, dev_params(p), f"{name} B={b}", fu,
                           timed_into=fu if b == 256 else True)
            if plan.variant != "wgmma":
                raise AssertionError(f"pq_fc_fused {name} B={b}: the main "
                                     f"path's shape planned {plan.variant}")
    for b, cin, cout, s, k, d in FC_ODD:
        plan = fc_case(b, cin, random_params((cout, s), s, k, d),
                       f"odd B={b} Cin={cin} Cout={cout} S={s} K={k} D={d}",
                       None)
        if plan.variant != "wgmma":
            raise AssertionError(f"odd fc shape planned {plan.variant}")
    for b, cin, cout, s, k, d in FC_RAGGED:
        plan = fc_case(b, cin, random_params((cout, s), s, k, d),
                       f"ragged B={b} Cin={cin} Cout={cout} S={s} K={k} "
                       f"D={d}", fu_gen, timed_into=fu_gen)
        if plan.variant != "general":
            raise AssertionError(f"ragged fc shape planned {plan.variant}")

    # --- pq_conv_fused at ResNet-50's fused geometries
    for b in (64, 1):
        for key, hw, per_fwd in RESNET50_FUSED:
            params = dev_params(rparams[key]["conv2"])
            cout = params["assignments"].shape[0]
            plan = conv_case(
                b, hw, hw, cout, params, 1,
                f"resnet50 {key}.conv2 B={b} {hw}x{hw} {cout}->{cout}", cf,
                timed_into=cf if b == 64 else True, per_fwd=per_fwd)
            if plan.variant != "wgmma":
                raise AssertionError(f"pq_conv_fused {key} B={b}: the main "
                                     f"path's shape planned {plan.variant}")
    for b, h, w, cin, cout, kh, pad, s, k, d in CONV_ODD:
        plan = conv_case(b, h, w, cin,
                         random_params((cout, kh, kh, s), s, k, d), pad,
                         f"odd B={b} {h}x{w} {cin}->{cout} k={kh} pad={pad} "
                         f"S={s} K={k} D={d}", None)
        if plan.variant != "wgmma":
            raise AssertionError(f"odd conv shape planned {plan.variant}")
    for b, h, w, cin, cout, kh, pad, s, k, d in CONV_RAGGED:
        plan = conv_case(b, h, w, cin,
                         random_params((cout, kh, kh, s), s, k, d), pad,
                         f"ragged B={b} {h}x{w} {cin}->{cout} k={kh} "
                         f"pad={pad} S={s} K={k} D={d}", cf_gen,
                         timed_into=cf_gen)
        if plan.variant != "general":
            raise AssertionError(f"ragged conv shape planned {plan.variant}")
    rows = {"pq_fc_fused": close_row(fu),
            "pq_fc_fused_general": close_row(fu_gen),
            "pq_conv_fused": close_row(cf),
            "pq_conv_fused_general": close_row(cf_gen)}

    # the general kernels through the public entry points, as a caller with
    # such a shape reaches them (no model of the smoke has one)
    cuda_ops.reset_launches()
    b, cin, cout, s, k, d = FC_RAGGED[0]
    pq_fc_fused.pq_fc_fused(t(gen.standard_normal((b, cin)), torch.bfloat16),
                            random_params((cout, s), s, k, d))
    b, h, w, cin, cout, kh, pad, s, k, d = CONV_RAGGED[0]
    pq_conv_fused.pq_conv_fused(
        t(gen.standard_normal((b, h, w, cin)), torch.bfloat16),
        random_params((cout, kh, kh, s), s, k, d), stride=1, pad=pad)
    torch.cuda.synchronize()
    counts = cuda_ops.launches()
    if counts != {name: (1 if name.endswith("_general") else 0)
                  for name in counts}:
        raise AssertionError(f"general entry points: launches {counts}")
    return rows, counts



def tensor_bytes(params) -> int:
    """Bytes of every tensor in a nested list/dict of params."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(tensor_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tensor_bytes(v) for v in params if v is not None)
    return 0


def drive(label: str, fwd, b: int, classes: int, steps: int, per_fwd: dict,
          gpu_name: str, resident: int, prep_s: float,
          prof_steps: int = 3) -> tuple[torch.Tensor, dict]:
    """One run of a path: counts set to 0 just before, 2 warm-up forwards,
    3 timed loops of `steps` forwards (the median loop's ms/step is
    reported, with the range: the host is shared and B=1 is host-bound),
    `prof_steps` profiled ones (none when 0), counts read just after and
    held to `per_fwd` (launches a forward; 0 for a kernel it does not name).
    Returns the probabilities and the counts."""
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    cuda_ops.reset_launches()
    out = fwd()
    fwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            fwd()
        torch.cuda.synchronize()
        loop_ms.append((time.perf_counter() - t0) / steps * 1e3)
    peak = torch.cuda.max_memory_allocated()
    if prof_steps:
        profile_steps(fwd, prof_steps, label)
    torch.cuda.synchronize()
    counts = cuda_ops.launches()
    n_fwd = 2 + len(loop_ms) * steps + prof_steps
    for name, got in counts.items():
        n = per_fwd.get(name, 0)
        if got != n * n_fwd:
            raise AssertionError(f"{label}: {name} launched {got} times, "
                                 f"expected {n} per forward x {n_fwd}")
    out = out.float()
    if out.shape != (b, classes):
        raise AssertionError(f"{label}: output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: non-finite probabilities")
    row_sum_err = (out.sum(1) - 1).abs().max().item()
    if row_sum_err > 1e-3:
        raise AssertionError(f"{label}: rows sum to 1 +- {row_sum_err}")
    ms = float(np.median(loop_ms))
    log(f"e2e {label} img/s={b / ms * 1e3:.1f} ms/step={ms:.4f} "
        f"(range {min(loop_ms):.4f}-{max(loop_ms):.4f} over {len(loop_ms)} "
        f"loops of {steps}) prepare_s={prep_s:.2f} "
        f"resident_param_bytes={resident} peak_alloc_bytes={peak} "
        f"launches={ {k: v // n_fwd for k, v in counts.items() if v} } "
        f"per forward card={gpu_name}")
    return out, counts


def agree(label: str, ref: torch.Tensor, got: torch.Tensor, max_dprob: float,
          min_top1: float) -> None:
    err = (ref - got).abs().max().item()
    top1 = (ref.argmax(1) == got.argmax(1)).float().mean().item()
    log(f"e2e {label}: max_abs_err(probs)={err:.3e} "
        f"top1_agreement={top1:.4f}")
    if not (err <= max_dprob and top1 >= min_top1):
        raise AssertionError(f"{label}: max|dprob| {err} (limit {max_dprob}), "
                             f"top-1 agreement {top1} (limit {min_top1})")


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def phase_end_to_end(spec, params, dev, gpu_name):
    """Phases 5 and 6: AlexNet auto and memory at B=256 and B=1, then the
    fc_impl='pallas' arm. Returns the launch counts of each path and the
    probabilities of each run."""
    from qcnn_tpu_torch.models import network, prepare, synth

    x_all = torch.from_numpy(synth.random_input(spec, 256, seed=1)).to(dev)
    expect = {  # launches per forward of each kernel, by strategy and batch
        ("auto", "auto", 256): {},
        ("auto", "auto", 1): {},
        ("memory", "memory", 256): {"pq_decode": 5, "pq_fc_fused": 3},
        ("memory", "memory", 1): {"pq_decode": 5, "pq_lut_gather": 3},
        ("auto", "pallas", 256): {"pq_fc": 3},
        ("auto", "pallas", 1): {"pq_fc": 3},
    }
    probs, counts = {}, {}
    for (conv_mode, fc_mode, b), per_fwd in expect.items():
        t0 = time.perf_counter()
        prepared, conv_impls, fc_impls = prepare.prepare_params(
            spec, params, batch_hint=b, conv_impl=conv_mode, fc_impl=fc_mode,
            dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        x = x_all[:b]

        def fwd():
            return network.forward(prepared, x, spec=spec,
                                   conv_impls=conv_impls, fc_impls=fc_impls,
                                   compute_dtype=torch.bfloat16, device=dev)

        pallas = fc_mode == "pallas"
        label = (f"alexnet {fc_mode} B={b} "
                 f"fc_impls={sorted(set(fc_impls) - {'-'})}")
        probs[(fc_mode, b)], run_counts = drive(
            label, fwd, b, spec.num_classes,
            steps=(5 if b > 1 else 20) if pallas else (10 if b > 1 else 50),
            per_fwd=per_fwd, gpu_name=gpu_name,
            resident=tensor_bytes(prepared), prep_s=prep_s,
            prof_steps=0 if pallas else 3)
        add_counts(counts.setdefault(f"alexnet {fc_mode}", {}), run_counts)
    for mode in ("memory", "pallas"):
        for b in (256, 1):
            agree(f"alexnet {mode} vs auto B={b}", probs[("auto", b)],
                  probs[(mode, b)], 1e-2, 0.99)
    return counts


def phase_resnet(dev, gpu_name):
    """Phase 7: full-width ResNet-50 through build_family_forward, decode at
    load and memory mode, at B=64 and B=1. Returns the launch counts of the
    memory-mode path."""
    from qcnn_tpu_torch.models import common, resnet, synth

    spec = resnet.resnet50()
    t0 = time.perf_counter()
    params = synth.random_resnet_pq_params(spec, seed=0)
    log(f"resnet50 synthetic params seconds={time.perf_counter() - t0:.2f}")
    gen = torch.Generator(device=dev).manual_seed(1)
    x_all = torch.randn((64, spec.in_size, spec.in_size, 3), generator=gen,
                        device=dev)
    per_fwd = {"memory": {"pq_conv_fused": 7, "pq_decode": 46},
               "decode": {}}
    probs, counts = {}, {}
    for mode in ("decode", "memory"):
        t0 = time.perf_counter()
        prepared, fwd_fn, _ = common.build_family_forward(
            "resnet", spec, params, memory=mode == "memory",
            compute_dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        for b in (64, 1):
            x = x_all[:b]
            probs[(mode, b)], run_counts = drive(
                f"resnet50 {mode} B={b}", lambda: fwd_fn(prepared, x), b,
                spec.num_classes, steps=10 if b > 1 else 30,
                per_fwd=per_fwd[mode], gpu_name=gpu_name,
                resident=tensor_bytes(prepared), prep_s=prep_s)
            if mode == "memory":
                add_counts(counts, run_counts)
        del prepared
    for b in (64, 1):
        agree(f"resnet50 memory vs decode B={b}", probs[("decode", b)],
              probs[("memory", b)], 5e-3, 0.99)
    return counts


def main() -> int:
    only_fused = sys.argv[1:] == ["--only-fused"]
    if sys.argv[1:] and not only_fused:
        print("usage: chip_smoke.py [--only-fused]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from qcnn_tpu_torch.models import resnet, synth, zoo
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
    log_ptxas(build_log)

    spec = zoo.alexnet()
    params = synth.random_pq_params(spec, seed=0)
    geo = alexnet_geometry(spec, params)
    rparams = synth.random_resnet_pq_params(resnet.resnet50(), seed=0)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    # phases 3-4: kernels vs plain versions, then timed; lrn_fused's and
    # the general kernels' own entry points
    rows, general_counts = phase_fused_kernels(spec, geo, rparams, dev,
                                               flush, peaks)
    if only_fused:
        log(json.dumps({"partial": "fused kernels only", "rows": rows}))
        return 0
    rows |= phase_kernels(geo, spec, dev, flush, peaks)
    new_rows, lrn_counts = phase_other_kernels(spec, geo, dev, flush, peaks)
    rows |= new_rows
    del flush

    # phases 5-7: the paths, end to end
    counts = phase_end_to_end(spec, params, dev, gpu_name)
    counts["resnet50 memory"] = phase_resnet(dev, gpu_name)
    counts["lrn_fused entry point"] = lrn_counts
    counts["general entry points"] = general_counts
    owners = {  # the paths that own each kernel
        "pq_decode": ("alexnet memory", "resnet50 memory"),
        "pq_lut_gather": ("alexnet memory",),
        "pq_fc_fused": ("alexnet memory",),
        "lrn_fused": ("lrn_fused entry point",),
        "pq_conv_fused": ("resnet50 memory",),
        "pq_fc": ("alexnet pallas",),
        "pq_fc_fused_general": ("general entry points",),
        "pq_conv_fused_general": ("general entry points",),
    }
    launches = {}
    for name, paths in owners.items():
        for path_name in paths:
            if counts[path_name].get(name, 0) == 0:
                raise AssertionError(f"{name} was never launched on the "
                                     f"path {path_name!r}")
        launches[name] = sum(c.get(name, 0) for c in counts.values())

    sources = {
        "pq_decode": ("qcnn_tpu_torch/csrc/pq_decode.cu",
                      "qcnn_tpu/ops/pallas/pq_decode.py:80"),
        "pq_lut_gather": ("qcnn_tpu_torch/csrc/pq_lut_gather.cu",
                          "qcnn_tpu/ops/pallas/pq_lut_gather.py:67"),
        "pq_fc_fused": ("qcnn_tpu_torch/csrc/pq_fc_fused.cu",
                        "qcnn_tpu/ops/pallas/pq_fc_fused.py:125"),
        "lrn_fused": ("qcnn_tpu_torch/csrc/lrn_fused.cu",
                      "qcnn_tpu/ops/pallas/lrn_fused.py:102"),
        "pq_conv_fused": ("qcnn_tpu_torch/csrc/pq_conv_fused.cu",
                          "qcnn_tpu/ops/pallas/pq_conv_fused.py:93"),
        "pq_fc": ("qcnn_tpu_torch/csrc/pq_fc.cu",
                  "qcnn_tpu/ops/pallas/pq_fc.py:61"),
        "pq_fc_fused_general": (
            "qcnn_tpu_torch/csrc/pq_fc_fused_general.cu",
            "qcnn_tpu/ops/pallas/pq_fc_fused.py:125"),
        "pq_conv_fused_general": (
            "qcnn_tpu_torch/csrc/pq_conv_fused_general.cu",
            "qcnn_tpu/ops/pallas/pq_conv_fused.py:93"),
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
