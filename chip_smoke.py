#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (qcnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                # everything, as below
    python3 chip_smoke.py --only-fused   # phases 1-2 and the two decode-GEMMs
    python3 chip_smoke.py --only-gather  # phases 1-2 and the two gathers
    python3 chip_smoke.py --only-lut-lrn # phases 1-2, pq_lut_gather, lrn_fused
    python3 chip_smoke.py --only-int8    # phases 1-2, the f32 conv check, 8
    python3 chip_smoke.py --only-io      # phases 1-2, the f32 conv check, 9
    python3 chip_smoke.py --only-vit     # phases 1-2 and 10 (ViT)
    python3 chip_smoke.py --only-serve   # phases 1-2 and 11 (serving)
    python3 chip_smoke.py --only-quantize  # phases 1-2 and 12 (quantizer)
    python3 chip_smoke.py --only-profile   # phases 1-2 and 13 (profile)
    python3 chip_smoke.py --gather-times [--root CHECKOUT]
        # phases 1-2, then only the times of pq_fc, pq_decode, pq_lut_gather
        # and lrn_fused, of this checkout's package or another's (say the
        # parent commit's, unpacked beside it): how two versions are
        # compared inside one call. The clock is the checkout's
        # (qcnn_tpu_torch.utils.timing.time_ms): CHECKOUT must have it.
    python3 chip_smoke.py --quantize-repro [--root CHECKOUT]
        # phase 1, then AlexNet (plain and error-corrected) and ResNet-50
        # quantized twice each with one seed: which PQ layers differ bit
        # for bit, and the first k-means seeding or Lloyd iteration at
        # which the runs part (any checkout's quantizer)

Phases, each fatal on failure (any exception exits non-zero):

1. device: needs CUDA; prints the card's name and power limit. torch's
   TF32 switches stay at their defaults: the package sets what it needs.
2. build: compiles the kernels in qcnn_tpu_torch/csrc with nvcc for sm_90a
   and prints what ptxas reports for each kernel (registers, shared memory,
   spills, warnings) under the kernel's name. Then one float32 conv_dense
   (AlexNet conv2's geometry, B=8) under those defaults against float64:
   the package's f32 convs must not run in TF32. Then one ViT-B/16 block
   in float32 (B=2, 197 tokens) with TF32 allowed for float32 matmuls
   (torch.set_float32_matmul_precision("high")) against the block written
   out in float64: the package's f32 matmuls must not run in TF32 either.
3. kernels vs plain versions at every geometry of the main paths:
   pq_fc_fused at AlexNet fc6-8 (B=256, 3, 64 and 1024, both decode names)
   and at ViT-L/16's mlp1 (1024 -> 4096) and mlp2 (4096 -> 1024) with one
   image's 197 rows, and pq_conv_fused at ResNet-50's two fused geometries
   (B=64 and B=1), all of which must plan the wgmma kernels; each split
   contraction is launched twice and must give the same bits; odd shapes
   the wgmma kernels take and ragged ones that go to the general kernels.
   pq_fc at AlexNet fc6-8 (B=256, 64, 3 and 1) and on ragged shapes (S not
   a multiple of 16, K=256, K not a multiple of 4), each launched twice
   with equal bits. pq_decode bit-exact in bf16 and f32 under its plan and
   under the general plan (AlexNet conv1-5 and fc6-8, every PQ weight of
   ResNet-50, fc6's geometry at K = 256), and the grouped launch
   bit-equal to per-item launches (AlexNet's five convs, block 0 of each
   ResNet-50 stage, the four projections of a ViT-B/16 block, 20 items).
   pq_lut_gather at fc6-8 for B = 1, 2 (the route's), 3 and 17 (batch
   tiles of 4 and 8 rows), all of which must plan the staged kernel, each
   launched twice with equal bits and held bit for bit to split_sum_plain
   (the kernel's order of additions in PyTorch, which the CPU tests hold
   against the JAX kernel); odd shapes the staged kernel takes (one split,
   idle warps, K = 20, 64 splits), the same; ragged shapes must plan its
   general kernel. lrn_fused at AlexNet's two LRN shapes (B=256, bf16, all
   three window names, the register kernel), small f32 ones, window sizes
   3, 5, 7 (register) and 9 (general), rows that are no whole 16-byte
   vectors (general) and a base pointer off the 16-byte grid; AlexNet's
   shapes and every case at beta 0.75, bf16 and f32, must be the bits of
   lrn_window_plain (the window's order of additions in PyTorch).
4. timing (CUDA events, L2 flushed before each launch, every repetition
   enqueued behind a device spin so the host's pace is not in the number)
   of each kernel, its plain version and one PyTorch library call computing
   the same function, beside the least time the card could take (its
   bound); for the two decode-GEMMs also the general kernel on the same
   inputs, for pq_fc also the shared-memory floor (4 bytes an add), for
   the grouped pq_decode also the per-item launches, for pq_lut_gather
   (B = 1 and 2) also pq_fc on the same inputs and the launch floor (an
   empty kernel under the same timer); there the kernel must be under the
   library call's time. Every time line of a planned kernel prints the
   plan. The general kernels of pq_lut_gather and lrn_fused are timed on
   ragged shapes into rows of their own. Then lrn_fused's own entry point,
   counted (no forward runs it, as in the JAX package), and the four
   general kernels through the public entry points on ragged shapes, each
   counted under its own name.
5. end to end: full-width AlexNet-PQ, synthetic params (seed 0), bf16,
   strategy 'auto' (decode at load) and 'memory' (in-step kernels) at
   B=256 and B=1; the launch counts show that memory mode ran the kernels
   (pq_decode once a forward: conv1-5 in one launch), and memory mode
   agrees with auto. A few steps of each run go through
   torch.profiler: device-busy time a step and the kernels that take it.
6. AlexNet's explicit FC arm fc_impl='pallas' (convs 'auto') at B=256 and
   B=1: pq_fc three times a forward, agreeing with auto.
7. full-width ResNet-50 (224x224, 1000 classes), bf16, synthetic PQ params
   (seed 0), through models.common.build_family_forward: decode at load and
   memory mode at B=64 (the family's max_batch) and B=1, each profiled.
   Memory mode launches pq_conv_fused 7 times a forward (conv2 of stage 2
   blocks 1-5 and stage 3 blocks 1-2) and pq_decode 17 times (one launch
   at the head of each of the 16 blocks for its other PQ convs, and the fc
   head); decode at load launches no kernel. No path launches a general
   kernel.
8. int8. What torch._int_mm (cuBLASLt's int8 GEMM) takes is logged, and
   that it takes a weight's column-major view without a copy is held.
   AlexNet is calibrated as bench.py does (one bf16 pass over 32 images,
   margin 1.0). Every AlexNet conv and fc geometry with its int8 weights,
   at B=256 and B=1: the im2col + int8 GEMM int32 sums must be the bits of
   the float64 plain version; then the sums' time (im2col and GEMM apart),
   the int8 layer's as the forward runs it, cuDNN / cuBLAS in bf16 on the
   same shape, the plain version and the bound (int8 at 1,979 TOP/s).
   Then AlexNet int8 'auto' (no kernel) and int8 convs with
   fc_impl='memory' (pq_fc_fused 3 a forward at B=256, pq_lut_gather 3 at
   B=1) at B=256 and B=1, and ResNet-50 int8 decode at load (dynamic
   scales, no kernel) at B=64 and B=1, each through the same loops,
   profile and launch checks as phase 5, and each held to its bf16
   counterpart's logits.
9. from files to top-5, as a user runs it (eval/, formats/, preproc/,
   models/loader.py). Both host libraries (the .cbn page codec and the image
   pipeline) are built with g++, strictly: a failed build fails the phase,
   and the native codec must give NumPy's bits on fc6's full-width
   assignments. In a temporary directory the port's own writers put
   AlexNet-PQ (synthetic, seed 0) in the reference layout, a (3, 256, 256)
   mean image, 1000 class names, image labels, 64 BMPs of mixed sizes and a
   .bin of 256 preprocessed images. Classifier.from_reference('alexnet',
   memory, batch_hint=64) runs classify_batch on the 64 BMPs (pq_decode 1
   and pq_fc_fused 3 a call), its native preprocessing is held to the
   NumPy path and its probabilities to network.forward 'auto' on the same
   batch; a batch_hint=1 classifier runs classify on one image
   (pq_decode 1, pq_lut_gather 3). evaluate_dataset streams the .bin with
   read_bin_batches at batch 64 and must give the accuracy_at_k of one
   in-memory forward of all 256. Then ResNet-50 goes through
   save_family_checkpoint + save_preprocessor(TorchPreprocessor.imagenet())
   and FamilyClassifier.from_checkpoint(memory=True) classifies 16 BMPs
   (pq_conv_fused 7, pq_decode 17 a call), held to memory=False. Each path
   runs once to warm up, then with the counts set to 0: any other count
   fails. The 'io ...' lines give bytes written, load and build seconds,
   preprocessing and classify ms an image, evaluate_dataset images/s, the
   TimerSet reports and the card's name and power limit.

10. the ViT family, full width (224x224, 1000 classes), synthetic PQ params
   (seed 0), through build_family_forward; each run through the loops,
   profile and launch checks of phase 5, with resident and peak bytes:
   A: ViT-B/16 decode at load, bf16, B=32 (serving_defaults' max_batch)
      and B=1: no kernel;
   B: ViT-B/16 memory mode, B=32 and B=1: pq_decode 14 a forward (the
      patch embedding, one grouped launch a block for its four
      projections, the head) and no other kernel;
   C: ViT-L/16 memory mode, B=1: pq_decode 26 and pq_fc_fused 48 (mlp1
      and mlp2 of every block: 197 rows, under fc_memory_impl's 1024);
   D: ViT-L/16 decode at load, B=1: no kernel;
   E: ViT-B/16 int8 (dynamic amax, bf16 activations), B=32: no kernel;
   F: save_family_checkpoint of ViT-B/16 + TorchPreprocessor.imagenet(),
      FamilyClassifier.from_checkpoint(memory=True) on 16 BMPs: pq_decode
      14 a call, held to memory=False.

11. serving (serve/, cli.py), at full width from synthetic params (seed 0)
   and files the port's own writers put in a temporary directory (phase
   9's, plus an AlexNet-PQ checkpoint and a ResNet-50 family checkpoint):
   pq_fc_fused at AlexNet fc6-8 with M = 1 and 8 rows (the buckets 1 and 8
   of a max_batch=64 engine), held to its plain version and timed as in
   phases 3-4. Then an AlexNet-PQ memory-mode bf16 engine on the JAX
   package's ladder (1, 8, 32, 64) behind the HTTP server, driven
   closed-loop by a client process (spawned; it imports no torch) at
   concurrency 1, 8 and 64 with 64, 256 and 512 preprocessed float32
   tensors, a profiled c=64 window, 64 BMP uploads and an in-process
   drain of 512 submits: one 'serve' line each (req/s, client p50/p95/p99
   ms, batches, mean batch, padded_waste, stage_ms, the compute-stage
   latency_percentiles) and pq_decode 1 + pq_fc_fused 3 launches per
   engine batch, exactly. Every answer is held to a Classifier (memory,
   batch_hint=64) and to a decode-at-load engine on the same images. A
   router over two AlexNet servers sends to both and, with one shut down,
   every request still returns 200. A burst of 256 requests into an engine
   with max_queue=8 (started once the burst is back) gives as many 503s as
   stats['rejected']; X-Deadline-Ms 0.001 gives as many 504s as
   stats['expired']. A ResNet-50 family checkpoint through
   cli.family_engine_from_checkpoint (memory), 128 requests at c=32:
   pq_conv_fused 7 + pq_decode 17 a batch, held to a FamilyClassifier.
   `python -m qcnn_tpu_torch serve --checkpoint ... --memory-mode` runs as
   a process and answers /healthz within 120 s and one BMP; `python -m
   qcnn_tpu_torch classify` runs on two BMPs with rc 0. The warm forward
   of both engines at B = 1, 8, 16, 32, 64, 128 ('ladder' lines: ms a
   batch, median of 3). Last, stop() with 256 requests in flight leaves no
   future unresolved after 5 s. Every run is logged before a broken limit
   fails the phase.

12. the quantizer and the conv strategies that ROADMAP A4 added, on the
   card, in the order (c), (b), (d), (a), while a thread writes (a)'s dense
   checkpoint (npz, compressed: tens of seconds of the host's zlib):
   (c) pq_conv 'gemm' (ungrouped convs) and the per-op 'memory' mix at
   every AlexNet conv, B=64, bf16 (synthetic PQ params, seed 0): float32
   outputs against 'decode' within 1e-4 of the largest, one pq_decode
   launch a call, and the bf16-output times of the impl, 'decode' and
   'indecode_ohwi'; then network.forward with conv 'auto' (decode at
   load) and 'memory' at B=64 (pq_decode 1 a forward) and 'lut' at B=32
   (no kernel; the largest LUT's bytes logged), each against 'auto'.
   (b) `python -m qcnn_tpu_torch make-family resnet50` as a process
   (plain k-means, conv K=128, fc K=32: bench.py's family weights), then
   FamilyClassifier.from_checkpoint in memory mode (pq_conv_fused 7 +
   pq_decode 17 a forward) and decoded at load, B=64.
   (a) `python -m qcnn_tpu_torch quantize DENSE OUT --calib-random 32` on
   AlexNet's random dense params (seed 0) as a process: sequential
   error-corrected PQ, default geometry, one logged line a layer with its
   seconds; plain quantize_network in-process; per layer the weight MSE
   and the response MSE (each quantized prefix's float32 activations, all
   positions) of both; the logits' relative L2 against the dense net on
   the 32 calibration inputs (error correction must be closer than plain:
   the paper's claim) and on 64 held-out inputs (logged); the written
   checkpoint through Classifier.from_checkpoint, memory mode, bf16, at
   B=64 (pq_decode 1 + pq_fc_fused 3) and B=1 (pq_decode 1 +
   pq_lut_gather 3), against decode at load of the same checkpoint.
   (d) `python -m qcnn_tpu_torch serve --model resnet50 --memory-mode` as
   a process, started while (a)'s checkpoint is written: it quantizes the
   seed-0 dense init on the card, and must answer /healthz within 300 s
   and one tensor with 5 probabilities in descending order.
   One seed, two runs, the same bits ('quantize repro' lines): (b)'s
   make-family checkpoint against resnet.quantize_params in this process,
   (a)'s plain pass run twice, and (a)'s error-corrected process against
   the same pass in this process; every PQ layer's codebooks and ids must
   be equal bit for bit. Then the k-means update's sums at fc6's geometry
   ('quantize sums' lines): the quantizer's sorted segment sum (the same
   bits twice), the one-hot product and the scatter-add, timed.
   'quantize step' lines give each part's seconds.

13. the profile command (eval/profiler.py, cli.py), through cli.main as
   `python -m qcnn_tpu_torch profile` runs it, with the card's clock
   (utils.timing.time_ms, which the phases above use too): AlexNet auto at
   B=256 and B=1, memory at B=256 (pq_decode and pq_fc_fused must launch,
   no other kernel) and B=1 (pq_decode and pq_lut_gather), int8 at B=256
   (no kernel), fc 'pallas' at B=256 (pq_fc), and ResNet-50 memory mode at
   B=64 (pq_conv_fused and pq_decode; its PQ weights from phase 12's
   quantize_params, the same bits as the command's). Each table is printed
   ('profile-table' lines); every conv and FC row (every family segment)
   must have a positive time; the sum of the rows is held against the
   device-busy ms of the same step built here (profile_steps): the ratio
   is logged and must lie in 0.5-2.0. Then the profiler's fused-decode
   estimate beside pq_conv_fused less cuDNN at ResNet-50's two fused
   geometries ('profile fused-est-decode' lines, no limit).

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
- f32 conv_dense against float64: 1e-5 of the largest |output| (measured
  1.5e-6 on an H100; cuDNN in TF32 on the same inputs 2.9e-4).
- int8 against bf16 (AlexNet int8 against bf16 auto, ResNet-50 int8 against
  bf16 decode at load, same inputs): max |dlogit| <= 5e-2 of the largest
  |logit| and top-1 equal on >= 95 % of rows. Per-tensor int8 activations
  and per-channel int8 weights round every layer's operands to 1/254 of
  their range. Measured on an H100 80GB HBM3 at 700 W: AlexNet auto
  3.40e-2 (B=256) and 3.42e-2 (B=1), with fc memory 2.72e-2 and 1.83e-2;
  ResNet-50 2.39e-2 (B=64) and 2.06e-2 (B=1); top-1 agreement 1.0 in every
  run.
- phase 9: native preprocessing against NumPy at rtol 1e-4, atol 1e-3
  (Caffe pipeline) and 1e-5, 1e-5 (torch pipeline), the limits of
  tests/test_native_preproc.py; the classifier against network.forward
  'auto' and the family memory mode against decode at load at the limits
  of phases 5 and 7; evaluate_dataset's accuracy equal to accuracy_at_k's.
  Its labels are each even row's top class and each odd row's 500th (by
  the in-memory forward, whose softmax is checked not to saturate), so no
  hit hangs on rounding.
- phase 10 (every run is logged before a broken limit fails it): ViT
  memory mode against decode at load (B vs A, C vs D, F's classifier):
  ResNet-50's, max |dprob| <= 5e-3 and top-1 equal on >= 99 % of rows.
  ViT-B/16 int8 against bf16 decode at load (E vs A): relative L2 of the
  logits <= 0.2, the JAX package's own bound for its family int8
  (tests/test_model_families.py); the top-1 agreement is logged.
- the f32 ViT block against float64: 1e-5 of the largest |output|.
- phase 12: gemm and per-op memory within 1e-4 of decode's largest
  |output| (the same bf16 operands, float32 sums in another order);
  AlexNet memory (the quantized checkpoint; conv lut and memory) against
  decode at load at phase 5's limits, ResNet-50 at phase 7's; EC's
  relative L2 below plain's on the calibration inputs.
- phase 11: pq_fc_fused at M = 1 and 8 at phase 3's 1e-4; each answer's
  top-5 probabilities against the reference's at the same ids, and its
  top-1: AlexNet max |dprob| <= 1e-2 and top-1 equal on >= 99 % (against
  the Classifier and against the decode-at-load engine), ResNet-50 5e-3
  and 99 %; launch counts exact; the status counts as above.

- phase 13: each profile table's sum of rows within 0.5-2.0 of its step's
  device-busy ms (the rows are timed one by one with the L2 flushed; the
  step runs warm); launch counts as listed there; phase 12's repro checks
  bit for bit.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. With no CUDA device it exits 1 and prints
neither; with --only-fused, --only-gather, --only-lut-lrn, --only-int8,
--only-io, --only-vit, --only-serve, --only-quantize, --only-profile,
--gather-times or --quantize-repro it stops early and prints neither.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# torch is imported under the __main__ check at the end: phase 11's client
# processes import this file as a module, and load the server without it

# Published dense peaks (NVIDIA data sheets, SXM parts): bytes/s of device
# memory and operations/s by type.
PEAKS = {
    "H100": {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12,
             "int8": 1979e12},
    "H200": {"bytes": 4.8e12, "bf16": 989e12, "f32": 67e12,
             "int8": 1979e12},
}
ALEXNET_CONVS = ("conv1", "conv2", "conv3", "conv4", "conv5")
ALEXNET_FCS = ("fc6", "fc7", "fc8")
# peak_alloc_bytes of the memory-mode runs when every conv decoded for
# itself (this script's run of the version before the grouped decode, on an
# H100 80GB HBM3): a group's weights now live until its block or step ends
PEAK_PER_CONV_DECODE = {
    "alexnet memory B=256": 2753165824, "alexnet memory B=1": 223171072,
    "resnet50 memory B=64": 521740288, "resnet50 memory B=1": 97525760,
}
# the package's clock, qcnn_tpu_torch.utils.timing.time_ms (CUDA events,
# the L2 flushed before each call, the launches queued behind a device
# spin) and its flush buffer: bound by main() once the checkout is on the
# path, so that the smoke and the profiler share one clock
time_ms = flush_buffer = None


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


def profile_steps(fwd, steps: int, label: str) -> float:
    """Device time of `steps` forwards by kernel (torch.profiler), the
    device-busy time a step, its share of the profiled wall time, and the
    host's CPU time a step in operators and launches. Returns the
    device-busy ms a step."""
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
    return busy_ms


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
    from qcnn_tpu_torch.ops.cuda import (
        _build,
        pq_decode,
        pq_fc,
        pq_fc_fused,
        pq_lut_gather,
    )

    gen = np.random.default_rng(7)
    rows = {}

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    # --- pq_lut_gather at B = 1 and 2 (memory mode's fc route at B <= 2),
    # and at B = 3 and 17 (the batch tiles of 4 and 8 rows)
    floor = time_ms(lambda: _build.EMPTY.launch(1, 1, 1, 32, 0), flush)
    log(f"time launch floor (an empty kernel of one warp, flushed like every "
        f"kernel) kernel_ms={floor:.5f}")
    lg = new_row()
    for b in (1, 2, 3, 17):
        for name in ALEXNET_FCS:
            lut, ids, bias = gather_fc_inputs(geo, spec, name, b, gen, dev)
            _, s, k = lut.shape
            cout = ids.shape[0]
            pl = pq_lut_gather.plan(b, s, k, cout)
            if pl.variant != "staged" or pl.smem_bytes > 232448:
                raise AssertionError(f"pq_lut_gather {name} B={b}: {pl}")
            if b <= 2 and pl.splits == 1:
                raise AssertionError(f"pq_lut_gather {name} B={b}: no split "
                                     f"sum to check in {pl}")
            want = pq_lut_gather.lut_gather_plain(lut, ids, bias)
            scale = max(1e-6, want.abs().max().item())
            got = pq_lut_gather.lut_gather(lut, ids, bias)
            again = pq_lut_gather.lut_gather(lut, ids, bias)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not err <= 1e-5 * scale:
                raise AssertionError(
                    f"pq_lut_gather {name} B={b}: max_abs_err {err} > 1e-5 "
                    f"x {scale}")
            if not torch.equal(got, again):
                raise AssertionError(
                    f"pq_lut_gather {name} B={b}: two launches of the "
                    f"{pl.splits}-way split differ")
            # the order of additions that the CPU tests hold against the
            # JAX kernel is the order the kernel adds in
            if not torch.equal(got, pq_lut_gather.split_sum_plain(
                    lut, ids, bias, pl)):
                raise AssertionError(
                    f"pq_lut_gather {name} B={b}: not the bits of "
                    f"split_sum_plain under {pl}")
            lg["max_abs_err"] = max(lg["max_abs_err"], err)
            log(f"check pq_lut_gather {name} B={b} splits={pl.splits} "
                f"max_abs_err={err:.3e} (rtol 1e-5 of {scale:.3e}) two "
                "launches bit-identical, bit-equal to split_sum_plain")
            if b > 2:
                continue
            idx = ids.long().t().expand(b, s, cout)
            ms = time_ms(lambda: pq_lut_gather.lut_gather(lut, ids, bias),
                         flush)
            fc_ms = time_ms(lambda: pq_fc.gather_accumulate(lut, ids, bias),
                            flush)
            # an empty kernel of the plan's grid, block and shared memory
            plan_floor = time_ms(lambda: _build.EMPTY.launch(
                *pl.grid, 256, pl.smem_bytes), flush)
            plain = time_ms(
                lambda: pq_lut_gather.lut_gather_plain(lut, ids, bias), flush)
            lib = time_ms(lambda: torch.gather(lut, 2, idx).sum(1) + bias,
                          flush)
            nbytes = b * s * k * 4 + cout * s + cout * 4 + b * cout * 4
            ops = b * cout * s
            b_ms, by = bound(nbytes, ops, peaks["f32"], peaks)
            log(f"time pq_lut_gather {name} B={b} rows={pl.rows} "
                f"outputs={pl.outputs} groups={pl.groups} "
                f"splits={pl.splits} grid={pl.grid} "
                f"smem={pl.smem_bytes} kernel_ms={ms:.5f} "
                f"pq_fc_ms={fc_ms:.5f} plain_ms={plain:.5f} "
                f"library_ms={lib:.5f} bound_ms={b_ms:.5f} bound_by={by} "
                f"launch_floor_ms={floor:.5f} "
                f"empty_kernel_of_this_grid_ms={plan_floor:.5f} "
                f"(bytes {nbytes}, adds {ops})")
            if not ms < lib:
                raise AssertionError(
                    f"pq_lut_gather {name} B={b}: kernel {ms} ms is not "
                    f"under the library call's {lib} ms")
            if b == 1:  # the path's batch
                add_timing(lg, 1, ms, plain, lib, b_ms, nbytes, ops,
                           peaks["f32"], peaks)
    rows["pq_lut_gather"] = close_row(lg)
    # the staged kernel off AlexNet's shapes: one split (the sums written
    # with the bias, no reduce), warps of a block with no unit of their own,
    # three batch tiles, K no power of two, one narrow tile split 64 ways
    for b, s, k, cout in LUT_GATHER_ODD:
        lut = t(gen.standard_normal((b, s, k)), torch.float32)
        ids = t(gen.integers(0, k, (cout, s), dtype=np.uint8))
        bias = t(gen.standard_normal(cout), torch.float32)
        want = pq_lut_gather.lut_gather_plain(lut, ids, bias)
        pl = pq_lut_gather.plan(b, s, k, cout)
        if pl.variant != "staged":
            raise AssertionError(f"pq_lut_gather odd B={b} S={s} K={k} "
                                 f"Cout={cout}: planned {pl}")
        got = pq_lut_gather.lut_gather(lut, ids, bias)
        again = pq_lut_gather.lut_gather(lut, ids, bias)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not (err <= 1e-5 * want.abs().max().item()
                and torch.equal(got, again)
                and torch.equal(got, pq_lut_gather.split_sum_plain(
                    lut, ids, bias, pl))):
            raise AssertionError(f"pq_lut_gather odd B={b} S={s} K={k} "
                                 f"Cout={cout} {pl}: max_abs_err {err}")
        log(f"check pq_lut_gather odd B={b} S={s} K={k} Cout={cout} "
            f"outputs={pl.outputs} groups={pl.groups} "
            f"splits={pl.splits} grid={pl.grid} "
            f"max_abs_err={err:.3e} two launches bit-identical, bit-equal "
            "to split_sum_plain")

    # the kernels' other paths, off AlexNet's shapes: Cin not a multiple of
    # 8 (no 16-byte x loads), a codebook span too large to stage (K=128,
    # D=8), ragged B, Cout and S
    lgg = new_row()
    for b, cin, cout, s, k, d in FC_RAGGED:
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
        if pq_lut_gather.plan(b, s, k, cout).variant != "general":
            raise AssertionError(f"pq_lut_gather ragged S={s} K={k}: planned "
                                 f"{pq_lut_gather.plan(b, s, k, cout)}")
        want_l = pq_lut_gather.lut_gather_plain(lut, params["assignments"],
                                                params["bias"])
        err_l = (pq_lut_gather.lut_gather(lut, params["assignments"],
                                          params["bias"])
                 - want_l).abs().max().item()
        lgg["max_abs_err"] = max(lgg["max_abs_err"], err_l)
        dec = pq_decode.decode_rows(params["codebooks"],
                                    params["assignments"], cin)
        if (err > 1e-4 * want.abs().max().item()
                or err_l > 1e-5 * want_l.abs().max().item()
                or not torch.equal(dec, lut_ops.decode_rows(
                    params["codebooks"], params["assignments"], cin))):
            raise AssertionError(f"ragged B={b} Cin={cin} Cout={cout} S={s} "
                                 f"K={k} D={d}: fused {err}, lut {err_l}")
        log(f"check ragged B={b} Cin={cin} Cout={cout} S={s} K={k} D={d}: "
            f"fused max_abs_err={err:.3e} lut (general kernel) "
            f"max_abs_err={err_l:.3e} decode bit-exact")
        ids, bias = params["assignments"], params["bias"]
        idx = ids.long().t().expand(b, s, cout)
        ms = time_ms(lambda: pq_lut_gather.lut_gather(lut, ids, bias), flush)
        plain = time_ms(
            lambda: pq_lut_gather.lut_gather_plain(lut, ids, bias), flush)
        lib = time_ms(lambda: torch.gather(lut, 2, idx).sum(1) + bias, flush)
        nbytes = b * s * k * 4 + cout * s + cout * 4 + b * cout * 4
        b_ms, by = bound(nbytes, b * cout * s, peaks["f32"], peaks)
        log(f"time pq_lut_gather_general ragged B={b} S={s} K={k} "
            f"Cout={cout} kernel_ms={ms:.5f} plain_ms={plain:.5f} "
            f"library_ms={lib:.5f} bound_ms={b_ms:.5f} bound_by={by} "
            f"launch_floor_ms={floor:.5f} (bytes {nbytes}, adds "
            f"{b * cout * s})")
        add_timing(lgg, 1, ms, plain, lib, b_ms, nbytes, b * cout * s,
                   peaks["f32"], peaks)
    rows["pq_lut_gather_general"] = close_row(lgg)
    return rows


# pq_lut_gather's staged kernel off AlexNet's shapes: (B, S, K, Cout)
LUT_GATHER_ODD = ((2, 96, 32, 300), (3, 160, 16, 70), (17, 48, 8, 40),
                  (5, 48, 20, 70), (1, 4096, 16, 10), (9, 2304, 32, 130))
# pq_fc off AlexNet's shapes: (B, S, K, Cout). S not a multiple of 16 (ids
# staged with plain loads), K = 256 (a 4-sub-space chunk), K not a multiple
# of 4 (the LUT staged 4 bytes at a time), more rows than a batch tile
GATHER_RAGGED = ((5, 33, 256, 70), (3, 15, 32, 250), (9, 7, 3, 5),
                 (70, 40, 20, 300))
# shared memory of the card: 132 SMs x 128 bytes a clock at about 1.75 GHz
SMEM_BYTES_PER_S = 132 * 128 * 1.75e9


def resnet50_decode_items(rparams):
    """{name: (codebooks, assignments (N, S), row_len)} (NumPy) of every PQ
    conv of ResNet-50 and its fc head, in forward order."""
    from qcnn_tpu_torch.models import resnet

    items = {}
    for key, _, convs in resnet.block_layout(resnet.resnet50()):
        for name, _, cin, _ in convs:
            p = rparams[key][name]
            a = p["assignments"]
            items[f"{key}.{name}"] = (p["codebooks"],
                                      a.reshape(-1, a.shape[3]), cin)
    fc = rparams["fc"]
    items["fc"] = (fc["codebooks"], fc["assignments"],
                   resnet.resnet50().stage_channels[-1])
    return items


def gather_fc_inputs(geo, spec, name, b, gen, dev):
    """AlexNet fc `name` at batch b: (LUT (b, S, K) f32, ids, bias) on the
    card, the LUT built from random bf16 activations."""
    from qcnn_tpu_torch.ops import lut as lut_ops

    i, _, p = geo[name]
    _, h, w, c = spec.feature_shapes(batch=1)[i]
    cb = torch.from_numpy(p["codebooks"]).to(dev, torch.bfloat16)
    x = torch.from_numpy(gen.standard_normal((b, h * w * c))).to(
        dev, torch.bfloat16)
    return (lut_ops.build_lut(x, cb).contiguous(),
            torch.from_numpy(p["assignments"]).to(dev),
            torch.from_numpy(p["bias"]).to(dev, torch.float32))


def alexnet_decode_items(geo, spec, dev, dtype):
    """AlexNet conv1-5 as pq_decode items on the card."""
    shapes = spec.feature_shapes(batch=1)
    items = []
    for name in ALEXNET_CONVS:
        i, layer, p = geo[name]
        a = p["assignments"]
        items.append((torch.from_numpy(p["codebooks"]).to(dev, dtype),
                      torch.from_numpy(a.reshape(-1, a.shape[3])).to(dev),
                      shapes[i][3] // layer.groups))
    return items


def phase_gather_times(geo, spec, dev, flush):
    """The times of pq_fc (fc6-8 at B = 256, 64, 3, 1), of pq_decode
    (conv1-5, one call each), of pq_lut_gather (fc6-8 at B = 1, 2) and of
    lrn_fused (AlexNet's two LRNs at B=256, bf16), through the entry points
    that every version of the port has (`gather_accumulate`, `decode_rows`,
    `lut_gather`, `lrn_fused`): the table that compares two checkouts of
    the package inside one call."""
    from qcnn_tpu_torch.core import LRNSpec
    from qcnn_tpu_torch.ops.cuda import (
        lrn_fused,
        pq_decode,
        pq_fc,
        pq_lut_gather,
    )

    gen = np.random.default_rng(11)
    for b in (256, 64, 3, 1):
        for name in ALEXNET_FCS:
            lut, ids, bias = gather_fc_inputs(geo, spec, name, b, gen, dev)
            ms = time_ms(lambda: pq_fc.gather_accumulate(lut, ids, bias),
                         flush)
            log(f"gather-times pq_fc {name} B={b} kernel_ms={ms:.5f}")
    total = 0.0
    for name, (cb, ids, row_len) in zip(
            ALEXNET_CONVS, alexnet_decode_items(geo, spec, dev,
                                                torch.bfloat16)):
        ms = time_ms(lambda: pq_decode.decode_rows(cb, ids, row_len), flush)
        total += ms
        log(f"gather-times pq_decode {name} kernel_ms={ms:.5f}")
    log(f"gather-times pq_decode conv1-5 one call each kernel_ms={total:.5f}")
    for b in (1, 2):
        total = 0.0
        for name in ALEXNET_FCS:
            lut, ids, bias = gather_fc_inputs(geo, spec, name, b, gen, dev)
            ms = time_ms(lambda: pq_lut_gather.lut_gather(lut, ids, bias),
                         flush)
            total += ms
            log(f"gather-times pq_lut_gather {name} B={b} kernel_ms={ms:.5f}")
        log(f"gather-times pq_lut_gather fc6-8 B={b} kernel_ms={total:.5f}")
    total = 0.0
    tgen = torch.Generator(device=dev).manual_seed(11)
    for i, layer in enumerate(spec.layers):
        if not isinstance(layer, LRNSpec):
            continue
        shape = spec.feature_shapes(batch=256)[i]
        x = torch.randn(shape, generator=tgen, device=dev).mul_(3).to(
            torch.bfloat16)
        ms = time_ms(lambda: lrn_fused.lrn_fused(
            x, size=layer.size, alpha=layer.alpha, beta=layer.beta,
            k=layer.k), flush)
        total += ms
        log(f"gather-times lrn_fused {tuple(shape)} bf16 kernel_ms={ms:.5f}")
    log(f"gather-times lrn_fused both kernel_ms={total:.5f}")


def phase_gather_kernels(spec, geo, rparams, vparams, dev, flush, peaks):
    """Phases 3 and 4 for the two gathers.

    pq_fc at AlexNet fc6-8, B = 256 (summed into the kernel's row), 64, 3
    and 1, and on ragged shapes, against `lut_gather_plain` at 1e-5 of the
    largest |output|; every split plan launched twice with equal bits; each
    timed beside its plain version, `torch.gather(LUT, 2, idx).sum`, the
    data-sheet bound and the shared-memory floor (4 bytes an add).

    pq_decode bit-exact in bf16 and f32, under its plan and under the
    general plan, at AlexNet's conv1-5 and fc6-8 and every PQ weight of
    ResNet-50; the grouped launch on AlexNet's five convs (the kernel's
    row: one launch a forward) and on block 0 of each ResNet-50 stage,
    bit-equal to per-item `decode_rows` and timed against those launches
    and against `C[arange(S), A]`."""
    from qcnn_tpu_torch.ops import lut as lut_ops
    from qcnn_tpu_torch.ops.cuda import pq_decode, pq_fc

    gen = np.random.default_rng(11)
    shapes = spec.feature_shapes(batch=1)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    # --- pq_fc
    fc = new_row()

    def fc_case(label, lut, ids, bias, timed, reps=20):
        b, s, k = lut.shape
        cout = ids.shape[0]
        pl = pq_fc.plan(b, s, k, cout)
        if pl.smem_bytes > 232448:
            raise AssertionError(f"pq_fc {label}: plan {pl}")
        got = pq_fc.gather_accumulate(lut, ids, bias)
        want = pq_fc.lut_gather_plain(lut, ids, bias)
        err = (got - want).abs().max().item()
        scale = max(1e-6, want.abs().max().item())
        if not err <= 1e-5 * scale:
            raise AssertionError(f"pq_fc {label}: max_abs_err {err} > 1e-5 "
                                 f"x {scale}")
        fc["max_abs_err"] = max(fc["max_abs_err"], err)
        again = pq_fc.gather_accumulate(lut, ids, bias)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"pq_fc {label}: two launches of the "
                                 f"{pl.splits}-way split differ")
        log(f"check pq_fc {label} max_abs_err={err:.3e} (rtol 1e-5 of "
            f"{scale:.3e}) splits={pl.splits} two launches bit-identical")
        if not timed:
            return None
        # a stride-0 view: gather reads it without a (B, S, Cout) copy
        idx = ids.long().t().expand(b, s, cout)
        ms = time_ms(lambda: pq_fc.gather_accumulate(lut, ids, bias), flush,
                     reps=reps)
        plain = time_ms(lambda: pq_fc.lut_gather_plain(lut, ids, bias),
                        flush, reps=5)
        lib = time_ms(lambda: torch.gather(lut, 2, idx).sum(1) + bias, flush,
                      reps=5)
        nbytes = b * s * k * 4 + cout * s + cout * 4 + b * cout * 4
        ops = b * cout * s
        b_ms, by = bound(nbytes, ops, peaks["f32"], peaks)
        floor = ops * 4 / SMEM_BYTES_PER_S * 1e3
        log(f"time pq_fc {label} rows={pl.rows} outputs={pl.outputs} "
            f"chunk={pl.chunk} stages={pl.stages} splits={pl.splits} "
            f"grid={pl.grid} smem={pl.smem_bytes} kernel_ms={ms:.5f} "
            f"plain_ms={plain:.5f} library_ms={lib:.5f} bound_ms={b_ms:.5f} "
            f"bound_by={by} smem_floor_ms={floor:.5f} (bytes {nbytes}, "
            f"adds {ops})")
        if not ms < lib:
            log(f"note pq_fc {label}: the kernel is not under the library "
                "call's time")
        return ms, plain, lib, b_ms, nbytes, ops

    for b in (256, 64, 3, 1):
        for name in ALEXNET_FCS:
            times = fc_case(f"{name} B={b}",
                            *gather_fc_inputs(geo, spec, name, b, gen, dev),
                            timed=True)
            if b == 256:
                add_timing(fc, 1, *times, peaks["f32"], peaks)
        if b == 256:  # the clock the card holds right after that load
            log("nvidia-smi after pq_fc B=256: clocks.sm,power.draw = "
                + subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, check=True).stdout.strip())
    for b, s, k, cout in GATHER_RAGGED:
        fc_case(f"ragged B={b} S={s} K={k} Cout={cout}",
                t(gen.standard_normal((b, s, k)), torch.float32),
                t(gen.integers(0, k, (cout, s), dtype=np.uint8)),
                t(gen.standard_normal(cout), torch.float32), timed=False)

    # --- pq_decode
    def exact(label, item_np):
        """Bit-exact under the item's plan and under the general plan, in
        both dtypes."""
        cb_np, ids_np, row_len = item_np
        ids = t(ids_np)
        variant = None
        for dtype in (torch.bfloat16, torch.float32):
            cb = t(cb_np, dtype)
            want = lut_ops.decode_rows(cb, ids, row_len)
            pl = pq_decode.plan(ids.shape[0], *cb.shape, row_len,
                                cb.element_size())
            general = pq_decode.plan(ids.shape[0], *cb.shape, row_len,
                                     cb.element_size(), vector=False)
            variant = variant or pl.variant
            for which in (pl, general):
                (got,) = pq_decode.launch_items([(cb, ids, row_len)],
                                                [which])
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"pq_decode {label} {dtype} {which.variant}: not "
                        "bit-exact against the plain gather")
        log(f"check pq_decode {label} N={ids.shape[0]} S={ids.shape[1]} "
            f"D={cb_np.shape[2]} C={row_len} plan(bf16)={variant} "
            "bf16+f32, planned and general kernels bit-exact "
            "max_abs_err=0.0")

    for name in ALEXNET_CONVS + ALEXNET_FCS:
        i, layer, p = geo[name]
        _, h, w, c = shapes[i]
        a = p["assignments"]
        if name in ALEXNET_CONVS:
            exact(name, (p["codebooks"], a.reshape(-1, a.shape[3]),
                         c // layer.groups))
        else:
            exact(name, (p["codebooks"], a, h * w * c))
    r50 = resnet50_decode_items(rparams)
    for name, item in r50.items():
        exact(f"resnet50 {name}", item)
    # K = 256 (uint8 ids: memory mode past K = 128), at fc6's geometry
    exact("fc6 K=256", (gen.standard_normal((2304, 256, 4)),
                        gen.integers(0, 256, (4096, 2304), dtype=np.uint8),
                        9216))

    def group_case(label, items):
        """The grouped launch against per-item launches: equal bits, then
        (grouped, per item, plain, library) ms and the bytes moved."""
        many = pq_decode.decode_rows_many(items)
        single = [pq_decode.decode_rows(*item) for item in items]
        torch.cuda.synchronize()
        for got, want, item in zip(many, single, items):
            if not (torch.equal(got, want) and torch.equal(
                    got, lut_ops.decode_rows(*item))):
                raise AssertionError(f"pq_decode grouped {label}: an item "
                                     "differs from its own decode_rows")
        index = [(torch.arange(cb.shape[0], device=dev)[None, :], ids.long())
                 for cb, ids, _ in items]  # made outside the timing
        ms = time_ms(lambda: pq_decode.decode_rows_many(items), flush)
        each = time_ms(lambda: [pq_decode.decode_rows(*item)
                                for item in items], flush)
        plain = time_ms(lambda: [lut_ops.decode_rows(*item)
                                 for item in items], flush)
        lib = time_ms(lambda: [cb[srange, ids_long] for (cb, _, _),
                               (srange, ids_long) in zip(items, index)],
                      flush)
        nbytes = sum(ids.numel() + cb.numel() * cb.element_size()
                     + ids.shape[0] * row_len * cb.element_size()
                     for cb, ids, row_len in items)
        b_ms, _ = bound(nbytes, 0, peaks["bf16"], peaks)
        plans = [pq_decode.plan(ids.shape[0], *cb.shape, row_len,
                                cb.element_size())
                 for cb, ids, row_len in items]
        log(f"time pq_decode grouped {label} items={len(items)} "
            f"plans={[(pl.variant, pl.blocks) for pl in plans]} "
            f"kernel_ms={ms:.5f} per_item_launches_ms={each:.5f} "
            f"plain_ms={plain:.5f} library_ms={lib:.5f} bound_ms={b_ms:.5f} "
            f"(bytes {nbytes})")
        return ms, plain, lib, b_ms, nbytes, 0

    dec = new_row()
    for dtype in (torch.float32, torch.bfloat16):
        times = group_case(f"alexnet conv1-5 {dtype}",
                           alexnet_decode_items(geo, spec, dev, dtype))
    add_timing(dec, 1, *times, peaks["bf16"], peaks)  # bf16: the path's
    for stage in range(4):
        items = [(t(cb, torch.bfloat16), t(ids), row_len)
                 for name, (cb, ids, row_len) in r50.items()
                 if name.startswith(f"s{stage}b0.")]
        group_case(f"resnet50 s{stage}b0 bf16", items)
    # one ViT-B/16 block's four projections, as memory mode decodes them
    blk = vparams["vit_b16"]["blk0"]
    group_case("vit_b16 blk0 bf16 (qkv, out, mlp1, mlp2)",
               [(t(blk[name]["codebooks"], torch.bfloat16),
                 t(blk[name]["assignments"]),
                 blk[name]["codebooks"].shape[0]
                 * blk[name]["codebooks"].shape[2])
                for name in VIT_BLOCK_GEMMS])
    # one call each, flushed: what a launch costs whatever its size
    for name, (cb, ids, row_len) in zip(
            ALEXNET_CONVS, alexnet_decode_items(geo, spec, dev,
                                                torch.bfloat16)):
        ms = time_ms(lambda: pq_decode.decode_rows(cb, ids, row_len), flush)
        log(f"time pq_decode {name} alone kernel_ms={ms:.5f}")
    # more items than one launch takes
    items = alexnet_decode_items(geo, spec, dev, torch.bfloat16) * 4
    for got, item in zip(pq_decode.decode_rows_many(items), items):
        if not torch.equal(got, lut_ops.decode_rows(*item)):
            raise AssertionError("pq_decode grouped: 20 items differ")
    log("check pq_decode grouped 20 items (two launches) bit-exact")
    return {"pq_fc": close_row(fc), "pq_decode": close_row(dec)}


# ResNet-50's convs that memory mode runs through pq_conv_fused: conv2 of
# these blocks' stage, (block key, spatial size, such convs a forward)
RESNET50_FUSED = (("s2b1", 14, 5), ("s3b1", 7, 2))
# ViT/16 at 224x224: 196 patches and the class token, the rows a projection
# sees per image; a block's four PQ GEMMs
VIT_ROWS = 197
VIT_BLOCK_GEMMS = ("qkv", "out", "mlp1", "mlp2")


def phase_other_kernels(spec, geo, dev, flush, peaks):
    """Phases 3 and 4 for lrn_fused (AlexNet's two LRNs at B=256) and its
    general kernel (a window of 9, rows of 130 channels); then lrn_fused's
    own entry point on AlexNet's shapes, counted, and the general kernels
    of lrn_fused and pq_lut_gather through their public entry points,
    counted. Returns (rows, counts of the entry-point run, counts of the
    general kernels' run)."""
    import torch.nn.functional as F

    from qcnn_tpu_torch.core import LRNSpec
    from qcnn_tpu_torch.ops import cuda as cuda_ops
    from qcnn_tpu_torch.ops.cuda import lrn_fused, pq_lut_gather

    gen = np.random.default_rng(11)
    tgen = torch.Generator(device=dev).manual_seed(11)
    rows = {}

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

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
            got = lrn_fused.lrn_fused(x, window=window, **kw)
            diff = (got.float() - want).abs()
            if not bool((diff <= ulp).all()):
                raise AssertionError(f"lrn_fused {tuple(shape)} {window}: "
                                     "more than one bf16 ulp off")
            lr["max_abs_err"] = max(lr["max_abs_err"], diff.max().item())
        del want, ulp, diff
        # the order of additions that the CPU tests hold against the JAX
        # kernels is the order the kernel adds in
        if not torch.equal(got, lrn_fused.lrn_window_plain(x, **kw)):
            raise AssertionError(f"lrn_fused {tuple(shape)}: not the bits "
                                 "of lrn_window_plain")
        log(f"check lrn_fused {tuple(shape)} bf16 windows={lrn_fused.WINDOWS}"
            f" max_abs_err={lr['max_abs_err']:.3e} (<= 1 bf16 ulp each), "
            "bit-equal to lrn_window_plain")
        del got
        pl = lrn_fused.plan(x.numel(), shape[-1], (layer.size - 1) // 2, 2)
        if pl.variant != "register":
            raise AssertionError(f"lrn_fused {tuple(shape)}: the main "
                                 f"shape planned {pl}")
        xn = x.permute(0, 3, 1, 2)
        ms = time_ms(lambda: lrn_fused.lrn_fused(x, **kw), flush)
        plain = time_ms(lambda: lrn_fused.lrn_plain(x, **kw), flush)
        lib = time_ms(lambda: F.local_response_norm(xn, **kw), flush)
        nbytes = 2 * x.numel() * x.element_size()
        b_ms, by = bound(nbytes, 0, peaks["f32"], peaks)
        log(f"time lrn_fused {tuple(shape)} kernel={pl.variant} "
            f"vectors={pl.vectors} blocks={pl.blocks} smem={pl.smem_bytes} "
            f"kernel_ms={ms:.5f} plain_ms={plain:.5f} library_ms={lib:.5f} "
            f"bound_ms={b_ms:.5f} bound_by={by} (bytes {nbytes})")
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

    def hold(x, size, variant, label, beta=0.75):
        """One more case of either dtype under the same limits."""
        kw = dict(size=size, alpha=1e-2, beta=beta, k=1.0)
        pl = lrn_fused.plan(x.numel(), x.shape[-1], (size - 1) // 2,
                            x.element_size())
        if pl.variant != variant:
            raise AssertionError(f"lrn_fused {label}: planned {pl}")
        want = lrn_fused.lrn_plain(x, **kw).float()
        got = lrn_fused.lrn_fused(x, **kw)
        diff = (got.float() - want).abs()
        same = torch.equal(got, lrn_fused.lrn_window_plain(x, **kw))
        if x.dtype == torch.bfloat16:
            ulp = torch.ldexp(torch.ones_like(want),
                              torch.frexp(want).exponent - 8)
            ok = bool((diff <= ulp).all())
        else:
            ok = diff.max().item() <= 1e-6 * want.abs().max().item()
        if not (ok and same):
            raise AssertionError(f"lrn_fused {label}: max_abs_err "
                                 f"{diff.max().item()}, bit-equal to "
                                 f"lrn_window_plain: {same}")
        log(f"check lrn_fused {label} {tuple(x.shape)} size={size} "
            f"kernel={pl.variant} max_abs_err={diff.max().item():.3e} "
            f"bit_equal_to_lrn_window_plain={same}")
        return diff.max().item()

    # window sizes 3 and 7 (the register kernel's other radii) and 9 (the
    # general kernel), rows that are no whole 16-byte vectors, a base
    # pointer off the 16-byte grid (the wrapper copies), a tensor that ends
    # inside a warp's span
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((3, 13, 13, 96), (2, 27, 27, 256), (1000, 8)):
            x = t(gen.standard_normal(shape) * 3, dtype)
            for size in (3, 5, 7):
                hold(x, size, "register", f"{dtype}")
            hold(x, 9, "general", f"{dtype}")
        hold(t(gen.standard_normal((7, 5, 130)) * 3, dtype), 5, "general",
             f"{dtype} rows of 130")
        hold(t(gen.standard_normal((33, 100)) * 3, dtype), 3,
             "register" if dtype == torch.float32 else "general",
             f"{dtype} rows of 100")
        base = t(gen.standard_normal(6 * 96 + 1) * 3, dtype)
        hold(base[1:].view(6, 96), 5, "register", f"{dtype} unaligned base")

    # the general kernel, timed: a window wider than the register kernel is
    # built for, and rows that are no whole 16-byte vectors
    lrg = new_row()
    for shape, dtype, size in (((64, 27, 27, 256), torch.bfloat16, 9),
                               ((16384, 130), torch.float32, 5)):
        x = torch.randn(shape, generator=tgen, device=dev).mul_(3).to(dtype)
        kw = dict(size=size, alpha=1e-2, beta=0.75, k=1.0)
        lrg["max_abs_err"] = max(lrg["max_abs_err"],
                                 hold(x, size, "general", f"{dtype} timed"))
        xn = x.movedim(-1, 1) if x.dim() > 2 else x.unsqueeze(-1)
        ms = time_ms(lambda: lrn_fused.lrn_fused(x, **kw), flush)
        plain = time_ms(lambda: lrn_fused.lrn_plain(x, **kw), flush)
        lib = time_ms(lambda: F.local_response_norm(xn, **kw), flush)
        nbytes = 2 * x.numel() * x.element_size()
        b_ms, by = bound(nbytes, 0, peaks["f32"], peaks)
        pl = lrn_fused.plan(x.numel(), shape[-1], (size - 1) // 2,
                            x.element_size())
        log(f"time lrn_fused_general {tuple(shape)} {dtype} size={size} "
            f"kernel={pl.variant} blocks={pl.blocks} smem={pl.smem_bytes} "
            f"kernel_ms={ms:.5f} plain_ms={plain:.5f} library_ms={lib:.5f} "
            f"bound_ms={b_ms:.5f} bound_by={by} (bytes {nbytes})")
        add_timing(lrg, 1, ms, plain, lib, b_ms, nbytes, 0, peaks["f32"],
                   peaks)
    rows["lrn_fused_general"] = close_row(lrg)

    # lrn_fused's own entry point, as its users call it (no forward does)
    cuda_ops.reset_launches()
    for x, kw in inputs:
        lrn_fused.lrn_fused(x, **kw)
    torch.cuda.synchronize()
    counts = cuda_ops.launches()
    if counts != {name: (len(inputs) if name == "lrn_fused" else 0)
                  for name in counts}:
        raise AssertionError(f"lrn_fused entry point: launches {counts}")

    # the general kernels of the two through their public entry points, as
    # a caller with such a shape reaches them (no model of the smoke has one)
    cuda_ops.reset_launches()
    b, cin, cout, s, k, d = FC_RAGGED[0]
    pq_lut_gather.pq_fc_lut_gather(
        t(gen.standard_normal((b, cin)), torch.bfloat16),
        {"codebooks": t(gen.standard_normal((s, k, d)), torch.bfloat16),
         "assignments": t(gen.integers(0, k, (cout, s), dtype=np.uint8)),
         "bias": t(gen.standard_normal(cout), torch.float32)})
    lrn_fused.lrn_fused(t(gen.standard_normal((7, 5, 130)), torch.float32),
                        size=5, alpha=1e-4, beta=0.75, k=2.0)
    torch.cuda.synchronize()
    general_counts = cuda_ops.launches()
    if general_counts != {
            name: int(name in ("pq_lut_gather_general", "lrn_fused_general"))
            for name in general_counts}:
        raise AssertionError(f"general entry points of pq_lut_gather and "
                             f"lrn_fused: launches {general_counts}")
    return rows, counts, general_counts


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


def phase_fused_kernels(spec, geo, rparams, vparams, dev, flush, peaks):
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
    # --- pq_fc_fused at ViT-L/16's MLP GEMMs: one image's 197 rows, as
    # memory mode runs them at B=1 (48 launches a forward)
    vit_l = vparams["vit_l16"]["blk0"]
    for name in ("mlp1", "mlp2"):
        params = dev_params(vit_l[name])
        s, _, d = params["codebooks"].shape
        plan = fc_case(VIT_ROWS, s * d, params,
                       f"vit_l16 {name} B=1 rows={VIT_ROWS}", fu,
                       timed_into=True)
        if plan.variant != "wgmma":
            raise AssertionError(f"pq_fc_fused vit_l16 {name}: the main "
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
    if counts != {name: int(name in ("pq_fc_fused_general",
                                     "pq_conv_fused_general"))
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
    before = next((f" (per-conv decode: {v})"
                   for k, v in PEAK_PER_CONV_DECODE.items()
                   if label.startswith(k)), "")
    log(f"e2e {label} img/s={b / ms * 1e3:.1f} ms/step={ms:.4f} "
        f"(range {min(loop_ms):.4f}-{max(loop_ms):.4f} over {len(loop_ms)} "
        f"loops of {steps}) prepare_s={prep_s:.2f} "
        f"resident_param_bytes={resident} peak_alloc_bytes={peak}{before} "
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
        ("memory", "memory", 256): {"pq_decode": 1, "pq_fc_fused": 3},
        ("memory", "memory", 1): {"pq_decode": 1, "pq_lut_gather": 3},
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
    per_fwd = {"memory": {"pq_conv_fused": 7, "pq_decode": 17},
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


def check_f32_conv(dev) -> None:
    """A float32 conv_dense with cuDNN's TF32 switch left at torch's default
    against the same conv in float64: the package turns TF32 off for its f32
    convs itself. A direct F.conv2d under the same globals is logged beside
    it, to show what the check would catch."""
    import torch.nn.functional as F

    from qcnn_tpu_torch.ops.conv import conv_dense

    gen = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn((8, 27, 27, 96), generator=gen, device=dev)
    k = torch.randn((5, 5, 48, 256), generator=gen, device=dev)
    bias = torch.zeros(256, device=dev)
    kw = dict(stride=1, padding=2, groups=2)
    want = F.conv2d(x.double().permute(0, 3, 1, 2),
                    k.double().permute(3, 2, 0, 1), **kw).permute(0, 2, 3, 1)
    got = conv_dense(x, k, bias, stride=1, pad=2, groups=2)
    direct = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                      **kw).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got.double() - want).abs().max().item() / scale
    err_direct = (direct.double() - want).abs().max().item() / scale
    log(f"check conv_dense f32 (8,27,27,96) 5x5 groups=2 against f64: "
        f"rel_err={err:.3e} (limit 1e-5); F.conv2d with the same globals "
        f"rel_err={err_direct:.3e}; cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} (torch's default)")
    if not err <= 1e-5:
        raise AssertionError(f"conv_dense f32: rel err {err} against f64")


def vit_block_f64(x, blk, heads: int):
    """One ViT block in float64, written out here: the oracle of
    check_f32_vit_block, not the package's code."""
    import math

    import torch.nn.functional as F

    def ln(v, p):
        mu = v.mean(-1, keepdim=True)
        var = ((v - mu) ** 2).mean(-1, keepdim=True)
        return ((v - mu) / torch.sqrt(var + 1e-6) * p["scale"].double()
                + p["shift"].double())

    def gemm(v, p):
        return v @ p["weight"].double() + p["bias"].double()

    b, n, d = x.shape
    hd = d // heads
    qkv = gemm(ln(x, blk["ln1"]), blk["qkv"])
    q, k, v = (t.reshape(b, n, heads, hd).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    x = x + gemm((att @ v).transpose(1, 2).reshape(b, n, d), blk["out"])
    y = F.gelu(gemm(ln(x, blk["ln2"]), blk["mlp1"]))
    return x + gemm(y, blk["mlp2"])


def check_f32_vit_block(dev, vparams) -> None:
    """One ViT-B/16 block in float32 (decode at load, B=2, 197 tokens) with
    TF32 allowed for float32 matmuls (torch.set_float32_matmul_precision
    ("high")) against the block in float64: the package runs its float32
    matmuls in IEEE float32 itself. A plain float32 matmul of the block's
    qkv GEMM under the same setting is logged beside it."""
    from qcnn_tpu_torch.models import common, vit

    spec = vit.vit_b16()
    blk = vit.prepare_params(spec, {"blk0": vparams["vit_b16"]["blk0"]},
                             dtype=torch.float32, device=dev)["blk0"]
    gen = torch.Generator(device=dev).manual_seed(37)
    x = torch.randn((2, VIT_ROWS, spec.dim), generator=gen, device=dev)
    w = blk["qkv"]["weight"]
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = vit._run_block(x, blk, spec, common.make_cast(torch.float32),
                             torch.float32)
        direct = x @ w
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(prev)
    want = vit_block_f64(x.double(), blk, spec.heads)
    err = ((got.double() - want).abs().max() / want.abs().max()).item()
    exact = x.double() @ w.double()
    err_direct = ((direct.double() - exact).abs().max()
                  / exact.abs().max()).item()
    log(f"check vit_b16 block f32 (2,197,768) against f64: rel_err="
        f"{err:.3e} (limit 1e-5); x @ W_qkv in f32 with TF32 allowed "
        f"rel_err={err_direct:.3e}; float32_matmul_precision during the "
        f"check 'high', default {prev!r}")
    if not err <= 1e-5:
        raise AssertionError(f"vit block f32: rel err {err} against f64")


def int8_gemm_probe(dev) -> None:
    """What torch._int_mm (cuBLASLt's int8 GEMM) takes on this card and
    torch, logged; and that a column-major second operand (the (Cin, Cout)
    view of an int8 weight's (Cout, Cin) memory) is taken without a copy:
    the call's allocations past the output are held under 1 MB."""
    for label, (m, k, n) in {"M=16": (16, 32, 32), "M=17": (17, 32, 32),
                             "K=12": (32, 12, 32), "N=12": (32, 32, 12),
                             "M=1": (1, 32, 32)}.items():
        a = torch.ones((m, k), dtype=torch.int8, device=dev)
        b = torch.ones((n, k), dtype=torch.int8, device=dev).t()
        try:
            torch._int_mm(a, b)
            torch.cuda.synchronize()
            verdict = "taken"
        except RuntimeError as e:
            verdict = f"refused: {str(e).splitlines()[0][:120]}"
        log(f"probe torch._int_mm {label} (M, K, N)={(m, k, n)}: {verdict}")
    a = torch.ones((256, 9216), dtype=torch.int8, device=dev)
    w = torch.ones((4096, 9216), dtype=torch.int8, device=dev)
    for label, b in (("column-major", w.t()), ("row-major", w.t().contiguous())):
        torch._int_mm(a, b)  # the GEMM's workspace is made on first use
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = torch._int_mm(a, b)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before - out.numel() * 4
        log(f"probe torch._int_mm fc6 B=256 {label} second operand: "
            f"allocated past the output {extra} bytes")
        if label == "column-major" and extra > 1 << 20:
            raise AssertionError("torch._int_mm copied the column-major "
                                 f"weight ({extra} bytes)")
        del out


def phase_int8_layers(spec, params, scales, dev, peaks) -> None:
    """Phase 8a: every AlexNet conv and fc geometry with its int8 weights,
    at B=256 and B=1. The im2col + int8 GEMM int32 sums must be the bits of
    the float64 plain version (F.conv2d or matmul on widened codes); then
    the times: the sums (im2col and GEMM apart), the whole int8 layer as the
    forward runs it (quantize or codes in, sums, epilogue), cuDNN / cuBLAS
    in bf16 on the same shape, the plain version and the bound."""
    import torch.nn.functional as F

    from qcnn_tpu_torch.core import ConvSpec
    from qcnn_tpu_torch.models import prepare
    from qcnn_tpu_torch.ops import conv as conv_ops
    from qcnn_tpu_torch.ops import fc as fc_ops

    gen = torch.Generator(device=dev).manual_seed(21)
    geo = alexnet_geometry(spec, params)
    flush = flush_buffer(dev)
    for b in (256, 1):
        prepared, _, _ = prepare.prepare_params(
            spec, params, batch_hint=b, dtype=torch.int8, act_scales=scales,
            device=dev)
        shapes = spec.feature_shapes(batch=b)
        totals = dict(sums=0.0, layer=0.0, bf16=0.0, bound=0.0)
        codes_in = False  # the previous conv/fc emitted int8 codes
        for name in ALEXNET_CONVS + ALEXNET_FCS:
            i, layer, _ = geo[name]
            p = prepared[i]
            shape = shapes[i] if isinstance(layer, ConvSpec) else (
                b, int(np.prod(shapes[i][1:])))
            xq = torch.randint(-127, 128, shape, dtype=torch.int8,
                               device=dev, generator=gen)
            xb = torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
            x_in = xq if codes_in else xb
            codes_in = "out_scale" in p
            epilogue = dict(act_scale=p.get("act_scale"),
                            out_scale=p.get("out_scale"))
            if isinstance(layer, ConvSpec):
                kq = p["kernel_q"]
                kh, kw, cg, cout = kq.shape
                geom = dict(stride=layer.stride, pad=layer.pad,
                            groups=layer.groups)
                k = kh * kw * cg
                k_pad = fc_ops.padded_k(k)
                got = conv_ops.conv_int8_sums(xq, kq, **geom)
                want = conv_ops.conv_int8_sums_plain(xq, kq, **geom)
                cols, (_, ho, wo) = conv_ops.im2col_int8(
                    xq, kh, kw, k_pad=k_pad, **geom)
                step = cout // layer.groups
                wmat = conv_ops.int8_kernel_matrix(kq)
                mats = [fc_ops.pad_k_columns(wmat[:, g * step:(g + 1) * step],
                                             k_pad)
                        for g in range(layer.groups)]
                m = b * ho * wo
                sums = time_ms(lambda: conv_ops.conv_int8_sums(xq, kq, **geom),
                               flush)
                im2col = time_ms(lambda: conv_ops.im2col_int8(
                    xq, kh, kw, k_pad=k_pad, **geom), flush)
                gemm = time_ms(lambda: [fc_ops.int8_matmul(cols[g], mats[g])
                                        for g in range(layer.groups)], flush)
                layer_ms = time_ms(lambda: conv_ops.conv_dense_int8(
                    x_in, kq, p["scale"], p["bias"], **geom, **epilogue),
                    flush)
                wb = kq.permute(3, 0, 1, 2).to(torch.bfloat16).contiguous()
                xn, wn = xb.permute(0, 3, 1, 2), wb.permute(0, 3, 1, 2)
                bf16 = time_ms(lambda: F.conv2d(
                    xn, wn, stride=layer.stride, padding=layer.pad,
                    groups=layer.groups), flush)
                plain = time_ms(lambda: conv_ops.conv_int8_sums_plain(
                    xq, kq, **geom), flush, reps=3)
                split = (f" im2col_ms={im2col:.5f} gemm_ms={gemm:.5f} "
                         f"im2col_bytes={cols.numel()}")
                del cols, mats
            else:
                wq = p["weight_q"]
                k, cout = wq.shape
                m = b
                got = fc_ops.int8_matmul(xq, wq)
                want = fc_ops.int8_matmul_plain(xq, wq)
                sums = time_ms(lambda: fc_ops.int8_matmul(xq, wq), flush)
                layer_ms = time_ms(lambda: fc_ops.fc_dense_int8(
                    x_in, wq, p["scale"], p["bias"], **epilogue), flush)
                wb = wq.t().to(torch.bfloat16).contiguous().t()
                bf16 = time_ms(lambda: torch.matmul(xb, wb), flush)
                plain = time_ms(lambda: fc_ops.int8_matmul_plain(xq, wq),
                                flush, reps=3)
                split = ""
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"int8 {name} B={b}: the int32 sums "
                                     "differ from the float64 plain version")
            nbytes = xq.numel() + k * cout + m * cout * 4
            ops = 2 * m * k * cout
            b_ms, by = bound(nbytes, ops, peaks["int8"], peaks)
            for key, v in (("sums", sums), ("layer", layer_ms),
                           ("bf16", bf16), ("bound", b_ms)):
                totals[key] += v
            log(f"time int8 {name} B={b} M={m} K={k} N={cout} "
                f"groups={getattr(layer, 'groups', 1)} input="
                f"{'codes' if x_in is xq else 'bf16'} "
                f"out={'codes' if codes_in else 'float'} sums bit-equal to "
                f"plain; sums_ms={sums:.5f}{split} layer_ms={layer_ms:.5f} "
                f"bf16_library_ms={bf16:.5f} plain_ms={plain:.5f} "
                f"bound_ms={b_ms:.5f} bound_by={by} (bytes {nbytes}, "
                f"ops {ops})")
        log(f"time int8 alexnet conv1-5+fc6-8 B={b}: sums_ms="
            f"{totals['sums']:.5f} layer_ms={totals['layer']:.5f} "
            f"bf16_library_ms={totals['bf16']:.5f} "
            f"bound_ms={totals['bound']:.5f}")
        del prepared


def agree_logits(label: str, ref: torch.Tensor, got: torch.Tensor,
                 max_rel: float, min_top1: float) -> str:
    """Logs how far got's logits lie from ref's; returns what breaks the
    limits ('' when none does)."""
    ref, got = ref.float(), got.float()
    rel = ((ref - got).abs().max() / ref.abs().max()).item()
    top1 = (ref.argmax(1) == got.argmax(1)).float().mean().item()
    log(f"e2e {label}: max|dlogit|/max|logit|={rel:.3e} "
        f"top1_agreement={top1:.4f} (limits {max_rel}, {min_top1})")
    if rel <= max_rel and top1 >= min_top1:
        return ""
    return (f"{label}: max|dlogit| {rel} of the largest (limit {max_rel}), "
            f"top-1 agreement {top1} (limit {min_top1})")


# int8 against bf16 (phase 8): max |dlogit| over the largest |logit|, and
# the share of rows whose top-1 agrees
INT8_ALEXNET_LIMITS = (5e-2, 0.95)
INT8_RESNET_LIMITS = (5e-2, 0.95)


def phase_int8(spec, params, rparams, dev, peaks, gpu_name):
    """Phase 8: int8 on the card. Calibration as bench.py does it, the
    layer check (phase_int8_layers), AlexNet int8 'auto' and int8 convs with
    fc_impl='memory' at B=256 and B=1, ResNet-50 int8 decode at load at B=64
    and B=1; each run through drive() and held to its bf16 counterpart.
    Returns the launch counts of the AlexNet int8 memory path."""
    from qcnn_tpu_torch.models import (
        calibrate,
        common,
        network,
        prepare,
        resnet,
        synth,
    )

    int8_gemm_probe(dev)
    t0 = time.perf_counter()
    pb, cb, fb = prepare.prepare_params(spec, params, batch_hint=256,
                                        dtype=torch.bfloat16, device=dev)
    scales = calibrate.calibrate_act_scales(
        spec, pb, synth.random_input(spec, 32, seed=3), conv_impls=cb,
        fc_impls=fb, device=dev)
    log(f"int8 calibration (bf16, 32 images, margin 1.0) seconds="
        f"{time.perf_counter() - t0:.2f} act_scales="
        f"{ {i: round(v, 6) for i, v in scales.items()} }")
    phase_int8_layers(spec, params, scales, dev, peaks)

    x_all = torch.from_numpy(synth.random_input(spec, 256, seed=1)).to(dev)
    ref = {b: network.forward(pb, x_all[:b], spec=spec, conv_impls=cb,
                              fc_impls=fb, compute_dtype=torch.bfloat16,
                              with_softmax=False, device=dev)
           for b in (256, 1)}
    del pb
    expect = {("auto", 256): {}, ("auto", 1): {},
              ("memory", 256): {"pq_fc_fused": 3},
              ("memory", 1): {"pq_lut_gather": 3}}
    counts: dict = {}
    failed = []  # every run is logged before a broken limit fails the phase
    for (fc_mode, b), per_fwd in expect.items():
        t0 = time.perf_counter()
        prepared, conv_impls, fc_impls = prepare.prepare_params(
            spec, params, batch_hint=b, fc_impl=fc_mode, dtype=torch.int8,
            act_scales=scales, device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        x = x_all[:b]

        def fwd(with_softmax=True):
            return network.forward(prepared, x, spec=spec,
                                   conv_impls=conv_impls, fc_impls=fc_impls,
                                   compute_dtype=torch.bfloat16,
                                   with_softmax=with_softmax, device=dev)

        label = (f"alexnet int8 {fc_mode} B={b} "
                 f"fc_impls={sorted(set(fc_impls) - {'-'})}")
        _, run_counts = drive(label, fwd, b, spec.num_classes,
                              steps=10 if b > 1 else 50, per_fwd=per_fwd,
                              gpu_name=gpu_name,
                              resident=tensor_bytes(prepared), prep_s=prep_s)
        if fc_mode == "memory":
            add_counts(counts, run_counts)
        failed.append(agree_logits(f"{label} vs bf16 auto", ref[b],
                                   fwd(False), *INT8_ALEXNET_LIMITS))
        del prepared

    rspec = resnet.resnet50()
    gen = torch.Generator(device=dev).manual_seed(1)
    x_all = torch.randn((64, rspec.in_size, rspec.in_size, 3), generator=gen,
                        device=dev)
    logits = {}
    for dtype in (torch.bfloat16, torch.int8):
        t0 = time.perf_counter()
        prepared, fwd_fn, act = common.build_family_forward(
            "resnet", rspec, rparams, compute_dtype=dtype, device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        for b in (64, 1):
            x = x_all[:b]
            if dtype == torch.int8:
                drive(f"resnet50 int8 decode B={b}",
                      lambda: fwd_fn(prepared, x), b, rspec.num_classes,
                      steps=10 if b > 1 else 30, per_fwd={},
                      gpu_name=gpu_name, resident=tensor_bytes(prepared),
                      prep_s=prep_s)
            logits[(dtype, b)] = resnet.forward(
                prepared, x, spec=rspec, compute_dtype=act, device=dev)
        del prepared
    for b in (64, 1):
        failed.append(agree_logits(
            f"resnet50 int8 decode B={b} vs bf16 decode",
            logits[(torch.bfloat16, b)], logits[(torch.int8, b)],
            *INT8_RESNET_LIMITS))
    if any(failed):
        raise AssertionError("; ".join(f for f in failed if f))
    return counts


# phase 9: BMPs of mixed sizes (height, width), cycled: below the 256-px
# resize, non-square, and widths that are not multiples of 4 (padded rows)
IO_BMP_SIZES = ((256, 256), (181, 257), (333, 250), (200, 301), (375, 500),
                (227, 227), (240, 321), (300, 200))
# the evaluate_dataset images: standard normal times this scale, where the
# random AlexNet's softmax does not saturate (on the CPU, f32: largest
# |logit| 6.8, smallest probability 3.7e-7), so that no rank that decides a
# hit is a tie of probabilities at 0
IO_DATASET_SCALE = 0.1
IO_BMPS, IO_FAMILY_BMPS, IO_DATASET_ROWS, IO_BATCH = 64, 16, 256, 64


def io_drive(label: str, clf, run, calls: int, per_call: dict,
             images: int) -> dict:
    """One warm-up call, then the classifier's timers and the counts set to
    0, `calls` timed calls, counts read and held to `per_call` (launches a
    call; 0 for a kernel it does not name). Logs the median ms an image
    and the TimerSet report of the timed calls; returns the counts."""
    from qcnn_tpu_torch.ops import cuda as cuda_ops
    from qcnn_tpu_torch.utils.timing import TimerSet

    run()
    torch.cuda.synchronize()
    clf.timers = TimerSet()
    cuda_ops.reset_launches()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / images)
    counts = cuda_ops.launches()
    for name, got in counts.items():
        if got != per_call.get(name, 0) * calls:
            raise AssertionError(f"io {label}: {name} launched {got} times, "
                                 f"expected {per_call.get(name, 0)} per call "
                                 f"x {calls}")
    ms = float(np.median(times))
    log(f"io {label}: ms/image={ms:.4f} (range {min(times):.4f}-"
        f"{max(times):.4f} over {calls} calls) launches per call="
        f"{ {k: v // calls for k, v in counts.items() if v} }")
    log(f"io {label}: TimerSet " + ", ".join(
        f"{k} mean_ms={v['mean_ms']:.4f} x{v['count']}"
        for k, v in clf.timers.report().items()))
    return counts


def write_io_files(d: str, spec, params) -> dict:
    """Phase 9, step 2: the files a user brings, written by the port's own
    writers: AlexNet-PQ in the reference layout, its mean image, class
    names, image labels, BMPs and a .bin of preprocessed images."""
    from qcnn_tpu_torch.formats import write_bin
    from qcnn_tpu_torch.models import loader, synth
    from qcnn_tpu_torch.preproc import encode_bmp24

    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    loader.save_reference_model(spec, params,
                                os.path.join(d, "AlexNet", "Bin.Files"),
                                "bvlc_alexnet_aCaF")
    write_bin(os.path.join(d, "AlexNet", "imagenet_mean.single.bin"),
              rng.uniform(100, 130, (3, 256, 256)).astype(np.float32))
    with open(os.path.join(d, "class_names.txt"), "w") as f:
        f.writelines(f"class {i}\n" for i in range(1000))
    paths, labels = [], {}
    for i in range(IO_BMPS):
        h, w = IO_BMP_SIZES[i % len(IO_BMP_SIZES)]
        stem = f"ILSVRC2012_val_{i + 1:08d}"
        path = os.path.join(d, "bmp", stem + ".BMP")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(encode_bmp24(rng.integers(0, 256, (h, w, 3),
                                              dtype=np.uint8)))
        paths.append(path)
        labels[stem] = int(rng.integers(0, 1000))
    with open(os.path.join(d, "image_labels.txt"), "w") as f:
        f.writelines(f"{stem}.JPEG {c}\n" for stem, c in labels.items())
    dataset = synth.random_input(spec, IO_DATASET_ROWS,
                                 seed=5) * IO_DATASET_SCALE
    write_bin(os.path.join(d, "val.bin"), dataset)
    seconds = time.perf_counter() - t0
    sizes = {}
    for root, _, files in os.walk(d):
        for name in files:
            sizes[os.path.join(root, name)] = os.path.getsize(
                os.path.join(root, name))
    ref = sum(v for k, v in sizes.items() if "Bin.Files" in k)
    log(f"io wrote {len(sizes)} files, {sum(sizes.values())} bytes in "
        f"{seconds:.2f} s: reference layout "
        f"{len(os.listdir(os.path.join(d, 'AlexNet', 'Bin.Files')))} files "
        f"{ref} bytes, {IO_BMPS} BMPs "
        f"{sum(v for k, v in sizes.items() if k.endswith('.BMP'))} bytes, "
        f"val.bin {sizes[os.path.join(d, 'val.bin')]} bytes")
    return {"paths": paths, "labels": labels, "dataset": dataset}


def phase_io(spec, params, rparams, dev, smi: str) -> dict:
    """Phase 9: the I/O and classify path, from files to top-5 on the card.
    Returns the launch counts of each path it drives."""
    import tempfile

    from qcnn_tpu_torch.core import FCSpec
    from qcnn_tpu_torch.eval import (
        Classifier,
        FamilyClassifier,
        accuracy_at_k,
        evaluate_dataset,
    )
    from qcnn_tpu_torch.eval.harness import upload
    from qcnn_tpu_torch.formats import native as cbn_native
    from qcnn_tpu_torch.formats import read_bin_batches, reference_codec
    from qcnn_tpu_torch.formats.checkpoint import (
        save_family_checkpoint,
        save_preprocessor,
    )
    from qcnn_tpu_torch.models import loader, network, prepare, resnet
    from qcnn_tpu_torch.ops import cuda as cuda_ops
    from qcnn_tpu_torch.preproc import TorchPreprocessor
    from qcnn_tpu_torch.preproc import native as img_native

    # step 1: the native libraries, built strictly (no NumPy fallback here)
    for name, lib in (("cbncodec", cbn_native.LIBRARY),
                      ("imgproc", img_native.LIBRARY)):
        path, seconds = lib.build()
        log(f"io build {name} {os.path.basename(path)} "
            f"seconds={seconds:.2f}")
    codec = cbn_native.get_lib()
    if codec is None or not img_native.available():
        raise AssertionError("io: a native library built but did not load")
    fc6 = next(p for layer, p in zip(spec.layers, params)
               if isinstance(layer, FCSpec))
    asmt = np.asarray(fc6["assignments"]).reshape(-1).astype(np.uint32)
    bits = max(1, int(asmt.max()).bit_length())
    t0 = time.perf_counter()
    pages = codec.pack_pages(asmt, bits)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = reference_codec._pack_pages_numpy(asmt, bits)
    t_numpy = time.perf_counter() - t0
    if not (np.array_equal(pages, want) and np.array_equal(
            codec.unpack_pages(pages, asmt.size, bits),
            reference_codec._unpack_pages_numpy(want, asmt.size, bits))):
        raise AssertionError("io: native .cbn codec differs from NumPy")
    log(f"io cbn codec fc6 assignments {tuple(fc6['assignments'].shape)} "
        f"bits={bits}: native == NumPy bit for bit; pack ms native="
        f"{t_native * 1e3:.2f} numpy={t_numpy * 1e3:.2f}")

    counts = {}
    with tempfile.TemporaryDirectory() as d:
        # step 2: the files
        files = write_io_files(d, spec, params)
        paths = files["paths"]

        # step 3: the AlexNet classifier, memory mode, batch_hint=64
        t0 = time.perf_counter()
        res = loader.load_reference_model(
            spec, os.path.join(d, "AlexNet", "Bin.Files"),
            "bvlc_alexnet_aCaF")
        load_s = time.perf_counter() - t0
        if res.synthesized_layers:
            raise AssertionError(f"io: synthesized {res.synthesized_layers}")
        t0 = time.perf_counter()
        clf = Classifier.from_reference(
            "alexnet", d, conv_impl="memory", fc_impl="memory",
            class_names_path=os.path.join(d, "class_names.txt"),
            image_labels_path=os.path.join(d, "image_labels.txt"))
        torch.cuda.synchronize()
        log(f"io load_reference_model seconds={load_s:.3f}; "
            f"Classifier.from_reference (load + prepare, memory, "
            f"batch_hint=64) seconds={time.perf_counter() - t0:.3f} "
            f"fc_impls={sorted(set(clf.fc_impls) - {'-'})} "
            f"dtype={clf.params[0]['codebooks'].dtype}")
        t0 = time.perf_counter()
        x_native = clf.pre.load_batch(paths, native="require")
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        x_numpy = clf.pre.load_batch(paths, native="never")
        t_numpy = time.perf_counter() - t0
        err = float(np.abs(x_native - x_numpy).max())
        log(f"io preproc {IO_BMPS} BMPs -> {x_native.shape}: ms/image "
            f"native={t_native * 1e3 / IO_BMPS:.3f} "
            f"numpy={t_numpy * 1e3 / IO_BMPS:.3f} "
            f"max|native-numpy|={err:.3e}")
        np.testing.assert_allclose(x_native, x_numpy, rtol=1e-4, atol=1e-3)

        results = []
        counts["io alexnet classify"] = io_drive(
            f"alexnet classify_batch memory batch_hint=64 B={IO_BMPS}", clf,
            lambda: results.append(clf.classify_batch(paths)), 3,
            {"pq_decode": 1, "pq_fc_fused": 3}, IO_BMPS)
        got = torch.from_numpy(clf._probs(x_native))
        auto, conv_a, fc_a = prepare.prepare_params(
            spec, clf.raw_params, batch_hint=64, dtype=torch.bfloat16,
            device=dev)
        ref = network.forward(auto, upload(x_native, dev), spec=spec,
                              conv_impls=conv_a, fc_impls=fc_a,
                              compute_dtype=torch.bfloat16,
                              device=dev).float().cpu()
        del auto
        agree(f"io alexnet classifier (memory) vs network.forward auto "
              f"B={IO_BMPS}",
              ref, got, 1e-2, 0.99)
        last = results[-1]
        if [r.class_ids[0] for r in last] != got.argmax(1).tolist():
            raise AssertionError("io: classify_batch top-1 differs from "
                                 "its forward")
        if [r.ground_truth_id for r in last] != list(
                files["labels"].values()):
            raise AssertionError("io: ground-truth ids differ from the "
                                 "label file")
        log(f"io top-5 of image 1: ids={last[0].class_ids} "
            f"names={last[0].class_names} probs[0]={last[0].probs[0]:.6f} "
            f"ground_truth={last[0].ground_truth}")

        clf1 = Classifier.from_reference("alexnet", d, conv_impl="memory",
                                         fc_impl="memory", batch_hint=1)
        one = []
        counts["io alexnet classify batch_hint=1"] = io_drive(
            "alexnet classify memory batch_hint=1 B=1", clf1,
            lambda: one.append(clf1.classify(paths[0])), 10,
            {"pq_decode": 1, "pq_lut_gather": 3}, 1)
        if one[-1].class_ids[0] != last[0].class_ids[0]:
            raise AssertionError("io: batch_hint=1 top-1 differs")
        del clf1

        # step 4: evaluate_dataset over the streamed .bin
        dataset = files["dataset"]
        probs = clf._probs(dataset)  # one in-memory forward of every row
        if not probs.min() > 0:
            raise AssertionError("io: the evaluation softmax saturated")
        order = np.argsort(-probs, axis=1, kind="stable")
        labels = np.where(np.arange(IO_DATASET_ROWS) % 2 == 0, order[:, 0],
                          order[:, 500])
        want = accuracy_at_k(probs, labels)
        cuda_ops.reset_launches()
        rep = evaluate_dataset(
            clf._fwd, clf.params,
            read_bin_batches(os.path.join(d, "val.bin"), np.float32,
                             IO_BATCH),
            labels, batch_size=IO_BATCH)
        counts["io alexnet evaluate_dataset"] = cuda_ops.launches()
        log(f"io evaluate_dataset val.bin {IO_DATASET_ROWS} images batch "
            f"{IO_BATCH}: "
            f"images/s={rep['images_per_s']:.1f} forward_s="
            f"{rep['forward_s']:.4f} accuracy={rep['accuracy']} "
            f"in-memory accuracy_at_k={want} launches="
            f"{ {k: v for k, v in counts['io alexnet evaluate_dataset'].items() if v} }")
        if rep["images"] != IO_DATASET_ROWS or rep["accuracy"] != want:
            raise AssertionError("io: evaluate_dataset differs from the "
                                 "in-memory accuracy")
        batches = -(-IO_DATASET_ROWS // IO_BATCH)
        if counts["io alexnet evaluate_dataset"] != {
                k: {"pq_decode": 1, "pq_fc_fused": 3}.get(k, 0) * batches
                for k in counts["io alexnet evaluate_dataset"]}:
            raise AssertionError("io: evaluate_dataset launched other "
                                 "kernels than pq_decode 1 + pq_fc_fused 3 "
                                 "a batch")
        del clf

        # step 5: the ResNet-50 family checkpoint, memory mode
        ck = os.path.join(d, "resnet50")
        t0 = time.perf_counter()
        save_family_checkpoint(ck, "resnet", resnet.resnet50(), rparams)
        save_preprocessor(ck, TorchPreprocessor.imagenet())
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fam = FamilyClassifier.from_checkpoint(ck, memory=True)
        torch.cuda.synchronize()
        log(f"io resnet50 family checkpoint "
            f"{sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))}"
            f" bytes: save seconds={save_s:.3f}, FamilyClassifier."
            f"from_checkpoint (memory) seconds={time.perf_counter() - t0:.3f}")
        paths16 = paths[:IO_FAMILY_BMPS]
        x_native = fam.pre.load_batch(paths16, native="require")
        np.testing.assert_allclose(
            x_native, fam.pre.load_batch(paths16, native="never"),
            rtol=1e-5, atol=1e-5)
        counts["io resnet50 family"] = io_drive(
            f"resnet50 family classify_batch memory B={IO_FAMILY_BMPS}", fam,
            lambda: fam.classify_batch(paths16), 3,
            {"pq_conv_fused": 7, "pq_decode": 17}, IO_FAMILY_BMPS)
        got = torch.from_numpy(fam._probs(x_native))
        del fam
        dec = FamilyClassifier.from_checkpoint(ck, memory=False)
        agree(f"io resnet50 family memory vs decode at load "
              f"B={IO_FAMILY_BMPS}",
              torch.from_numpy(dec._probs(x_native)), got, 5e-3, 0.99)
        del dec
    log(f"io card: {smi}")
    return counts


# phase 10: (run, model, mode, batches, launches a forward); decode at load
# and int8 run no kernel of the package
VIT_RUNS = (
    ("A", "vit_b16", "decode", (32, 1), {}),
    ("B", "vit_b16", "memory", (32, 1), {"pq_decode": 14}),
    ("E", "vit_b16", "int8", (32,), {}),
    ("C", "vit_l16", "memory", (1,), {"pq_decode": 26, "pq_fc_fused": 48}),
    ("D", "vit_l16", "decode", (1,), {}),
)


def phase_vit(dev, gpu_name, vparams) -> dict:
    """Phase 10: full-width ViT-B/16 and ViT-L/16 (224x224, 1000 classes),
    synthetic PQ params (seed 0), through build_family_forward: runs A-E
    (VIT_RUNS) and F, a FamilyClassifier on a ViT-B/16 family checkpoint
    written by the port. Every run is logged before a broken limit fails
    the phase. Returns the launch counts of the paths that launch
    kernels."""
    import tempfile

    from qcnn_tpu_torch.eval import FamilyClassifier
    from qcnn_tpu_torch.formats.checkpoint import (
        save_family_checkpoint,
        save_preprocessor,
    )
    from qcnn_tpu_torch.models import common, vit
    from qcnn_tpu_torch.preproc import TorchPreprocessor, encode_bmp24

    gen = torch.Generator(device=dev).manual_seed(1)
    x_all = torch.randn((32, 224, 224, 3), generator=gen, device=dev)
    probs, logits, counts = {}, {}, {}
    for run, model, mode, batches, per_fwd in VIT_RUNS:
        spec = vit.VITS[model]()
        t0 = time.perf_counter()
        prepared, fwd_fn, act = common.build_family_forward(
            "vit", spec, vparams[model], memory=mode == "memory",
            compute_dtype=torch.int8 if mode == "int8" else torch.bfloat16,
            device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        for b in batches:
            x = x_all[:b]
            probs[(run, b)], run_counts = drive(
                f"{model} {mode} B={b} (run {run})",
                lambda: fwd_fn(prepared, x), b, spec.num_classes,
                steps=10 if b > 1 else 30, per_fwd=per_fwd,
                gpu_name=gpu_name, resident=tensor_bytes(prepared),
                prep_s=prep_s)
            if run in ("A", "E") and b == 32:
                logits[run] = vit.forward(prepared, x, spec=spec,
                                          compute_dtype=act,
                                          device=dev).float()
            if per_fwd:
                add_counts(counts.setdefault(f"{model} {mode}", {}),
                           run_counts)
        del prepared, fwd_fn
        torch.cuda.empty_cache()

    failed = []
    for ref, got, b, label in (("A", "B", 32, "vit_b16"),
                               ("A", "B", 1, "vit_b16"),
                               ("D", "C", 1, "vit_l16")):
        try:
            agree(f"{label} memory vs decode at load B={b} (runs {got} vs "
                  f"{ref})", probs[(ref, b)], probs[(got, b)], 5e-3, 0.99)
        except AssertionError as e:
            failed.append(str(e))
    ref, got = logits["A"], logits["E"]
    rel = ((got - ref).norm() / ref.norm()).item()
    top1 = (ref.argmax(1) == got.argmax(1)).float().mean().item()
    log(f"e2e vit_b16 int8 vs bf16 decode at load B=32 (runs E vs A): "
        f"rel_l2(logits)={rel:.4e} (limit 0.2) top1_agreement={top1:.4f} "
        f"max|dlogit|/max|logit|="
        f"{((got - ref).abs().max() / ref.abs().max()).item():.4e}")
    if not rel <= 0.2:
        failed.append(f"vit_b16 int8 vs bf16: rel L2 {rel} > 0.2")

    # run F: a ViT-B/16 family checkpoint written by the port, 16 BMPs
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(9)
        paths = []
        for i in range(IO_FAMILY_BMPS):
            h, w = IO_BMP_SIZES[i % len(IO_BMP_SIZES)]
            paths.append(os.path.join(d, f"image{i}.BMP"))
            with open(paths[-1], "wb") as f:
                f.write(encode_bmp24(rng.integers(0, 256, (h, w, 3),
                                                  dtype=np.uint8)))
        ck = os.path.join(d, "vit_b16")
        t0 = time.perf_counter()
        save_family_checkpoint(ck, "vit", vit.VITS["vit_b16"](),
                               vparams["vit_b16"])
        save_preprocessor(ck, TorchPreprocessor.imagenet())
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fam = FamilyClassifier.from_checkpoint(ck, memory=True)
        torch.cuda.synchronize()
        nbytes = sum(os.path.getsize(os.path.join(ck, f))
                     for f in os.listdir(ck))
        log(f"io vit_b16 family checkpoint {nbytes} bytes: save seconds="
            f"{save_s:.3f}, FamilyClassifier.from_checkpoint (memory) "
            f"seconds={time.perf_counter() - t0:.3f}")
        label = f"vit_b16 family classify_batch memory B={IO_FAMILY_BMPS}"
        counts["io vit_b16 family"] = io_drive(
            f"{label} (run F)", fam, lambda: fam.classify_batch(paths), 3,
            {"pq_decode": 14}, IO_FAMILY_BMPS)
        x_in = fam.pre.load_batch(paths)
        profile_steps(lambda: fam._probs(x_in), 3, f"{label} forward (run F)")
        got = torch.from_numpy(fam._probs(x_in))
        del fam
        dec = FamilyClassifier.from_checkpoint(ck, memory=False)
        try:
            agree(f"io vit_b16 family memory vs decode at load "
                  f"B={IO_FAMILY_BMPS} (run F)",
                  torch.from_numpy(dec._probs(x_in)), got, 5e-3, 0.99)
        except AssertionError as e:
            failed.append(str(e))
        del dec
    if failed:
        raise AssertionError("phase 10: " + "; ".join(failed))
    return counts


# phase 11: serving. The AlexNet engine takes serving_defaults' ladder (the
# JAX package's); (concurrency, requests) of its closed-loop runs; the
# buckets whose warm forward is timed; the ResNet-50 run
SERVE_LADDER = (1, 8, 32, 64)
SERVE_RUNS = ((1, 64), (8, 256), (64, 512))
SERVE_PROFILED = (64, 256)
SERVE_TIMED_BUCKETS = (1, 8, 16, 32, 64, 128)
SERVE_RESNET = (32, 128)
SERVE_BURST, SERVE_QUEUE = 256, 8


def serve_client(url: str, payloads, concurrency: int, requests: int,
                 headers=None) -> dict:
    """Closed-loop HTTP load from a child process (spawned: it imports this
    file as a module, where torch is not imported, so the clients' Python
    does not share the server's GIL). `payloads`: a .npy of preprocessed
    images sent as X-Shape tensors, or a list of BMP paths sent as bodies;
    request i sends payload i % len. `concurrency` threads each keep one
    request outstanding until `requests` have been sent. Returns the wall
    seconds and, per request, (payload index, status, client ms, body)."""
    import threading
    import urllib.error
    import urllib.request

    if isinstance(payloads, str):
        images = np.load(payloads)
        bodies = [(img.tobytes(), {"X-Shape": ",".join(map(str, img.shape))})
                  for img in images]
    else:
        bodies = []
        for path in payloads:
            with open(path, "rb") as f:
                bodies.append((f.read(), {}))
    results = [None] * requests
    next_i = iter(range(requests))
    lock = threading.Lock()

    def worker() -> None:
        while True:
            with lock:
                i = next(next_i, None)
            if i is None:
                return
            body, hdr = bodies[i % len(bodies)]
            req = urllib.request.Request(
                url, data=body, method="POST",
                headers={**hdr, **(headers or {})})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    status, data = r.status, r.read()
            except urllib.error.HTTPError as e:
                status, data = e.code, e.read()
            results[i] = (i % len(bodies), status,
                          (time.perf_counter() - t0) * 1e3, json.loads(data))

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"wall_s": time.perf_counter() - t0, "results": results,
            "torch_in_client": "torch" in sys.modules}


def serve_fc_check(geo, spec, dev, peaks) -> float:
    """pq_fc_fused at AlexNet fc6-8 with M = 1 and 8 rows, the batches that
    buckets 1 and 8 of a max_batch=64 engine give it (fgather resolves for
    every bucket): against the plain version at 1e-4 of the largest
    |output| (both decode names), a split contraction twice to the same
    bits, then timed. Returns the largest error."""
    from qcnn_tpu_torch.ops import lut as lut_ops
    from qcnn_tpu_torch.ops.cuda import pq_fc_fused

    gen = np.random.default_rng(17)
    shapes = spec.feature_shapes(batch=1)
    flush = flush_buffer(dev)
    worst = 0.0
    for b in (1, 8):
        for name in ALEXNET_FCS:
            i, _, p = geo[name]
            _, h, w, c = shapes[i]
            cin = h * w * c
            params = {
                "codebooks": torch.from_numpy(p["codebooks"]).to(
                    dev, torch.bfloat16),
                "assignments": torch.from_numpy(p["assignments"]).to(dev),
                "bias": torch.from_numpy(p["bias"]).to(dev, torch.float32)}
            cb, ids, bias = (params["codebooks"], params["assignments"],
                             params["bias"])
            s, k, d = cb.shape
            cout = ids.shape[0]
            x = torch.from_numpy(gen.standard_normal((b, cin))).to(
                dev, torch.bfloat16)
            plan = pq_fc_fused.plan(b, cin, cout, s, k, d)
            want = pq_fc_fused.fused_plain(x, cb, ids, bias)
            scale = max(1e-6, want.abs().max().item())
            label = f"{name} B={b} (serving bucket {b})"
            for decode in pq_fc_fused.DECODES:
                got = pq_fc_fused.pq_fc_fused(x, params, decode=decode)
                err = (got - want).abs().max().item()
                log(f"check pq_fc_fused {label} decode={decode} "
                    f"kernel={plan.variant} max_abs_err={err:.3e} "
                    f"(rtol 1e-4 of {scale:.3e})")
                if not err <= 1e-4 * scale:
                    raise AssertionError(f"pq_fc_fused {label}: max_abs_err "
                                         f"{err} > 1e-4 x {scale}")
                worst = max(worst, err)
            if plan.splits > 1:
                first = pq_fc_fused.pq_fc_fused(x, params)
                second = pq_fc_fused.pq_fc_fused(x, params)
                torch.cuda.synchronize()
                if not torch.equal(first, second):
                    raise AssertionError(f"pq_fc_fused {label}: two launches "
                                         f"of the {plan.splits}-way split "
                                         "differ")
                log(f"check pq_fc_fused {label} splits={plan.splits} two "
                    "launches bit-identical")
            w_io = lut_ops.decode_fc_weight(cb, ids, cin).contiguous()
            ms = time_ms(lambda: pq_fc_fused.pq_fc_fused(x, params), flush)
            plain = time_ms(lambda: pq_fc_fused.fused_plain(x, cb, ids, bias),
                            flush, reps=10)
            lib = time_ms(lambda: torch.matmul(x, w_io), flush)
            nbytes = (b * cin * 2 + cout * s + s * k * d * 2 + cout * 4
                      + b * cout * 4)
            b_ms, by = bound(nbytes, 2 * b * cin * cout, peaks["bf16"], peaks)
            log(f"time pq_fc_fused {label} kernel={plan.variant} "
                f"tile_rows={plan.tile_rows} splits={plan.splits} "
                f"grid={plan.grid} smem={plan.smem_bytes} kernel_ms={ms:.5f} "
                f"plain_ms={plain:.5f} library_ms={lib:.5f} "
                f"bound_ms={b_ms:.5f} bound_by={by} (bytes {nbytes})")
    return worst


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stats_snapshot(engine) -> dict:
    return {**engine.stats, "stage_ms": dict(engine.stats["stage_ms"])}


def serve_run(label: str, clients, url: str, engine, payloads,
              concurrency: int, requests: int, per_batch: dict,
              headers=None) -> dict:
    """One closed-loop run against `engine`'s server: counts set to 0 just
    before, read just after and held to `per_batch` launches for each batch
    the engine ran (0 for a kernel it does not name). Logs the serve line;
    returns the client's results and the run's engine statistics."""
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    before = stats_snapshot(engine)
    cuda_ops.reset_launches()
    out = clients.apply(serve_client, (url, payloads, concurrency, requests,
                                       headers))
    torch.cuda.synchronize()
    counts = cuda_ops.launches()
    after = stats_snapshot(engine)
    if out["torch_in_client"]:
        raise AssertionError(f"serve {label}: the client process imported "
                             "torch")
    delta = {k: after[k] - before[k] for k in ("requests", "batches",
                                               "padded_waste", "rejected",
                                               "expired")}
    stage = {k: round(after["stage_ms"][k] - before["stage_ms"][k], 3)
             for k in after["stage_ms"]}
    lat = np.asarray([r[2] for r in out["results"]])
    codes = {}
    for r in out["results"]:
        codes[r[1]] = codes.get(r[1], 0) + 1
    batches = delta["batches"]
    log(f"serve {label}: c={concurrency} requests={requests} "
        f"req/s={requests / out['wall_s']:.1f} client_ms "
        f"p50={np.percentile(lat, 50):.3f} p95={np.percentile(lat, 95):.3f} "
        f"p99={np.percentile(lat, 99):.3f} statuses={codes} "
        f"engine batches={batches} mean_batch="
        f"{delta['requests'] / max(batches, 1):.2f} padded_waste="
        f"{delta['padded_waste']} rejected={delta['rejected']} expired="
        f"{delta['expired']} stage_ms={stage} compute latency_percentiles="
        f"{engine.latency_percentiles()} launches="
        f"{ {k: v for k, v in counts.items() if v} }")
    for name, got in counts.items():
        want = per_batch.get(name, 0) * batches
        if got != want:
            raise AssertionError(f"serve {label}: {name} launched {got} "
                                 f"times, expected {per_batch.get(name, 0)} "
                                 f"per batch x {batches}")
    return {"results": out["results"], "delta": delta, "counts": counts}


def drain_run(label: str, engine, images: np.ndarray, requests: int,
              per_batch: dict, ref: np.ndarray) -> dict:
    """The engine without HTTP: one thread submits every request, then
    waits for all: the engine's own ceiling beside the served runs. Held
    to `ref` at the AlexNet limits. Returns the launch counts."""
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    before = stats_snapshot(engine)
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    futs = [engine.submit(images[i % len(images)]) for i in range(requests)]
    probs = np.stack([f.result(timeout=120) for f in futs])
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = cuda_ops.launches()
    after = stats_snapshot(engine)
    batches = after["batches"] - before["batches"]
    stage = {k: round(after["stage_ms"][k] - before["stage_ms"][k], 3)
             for k in after["stage_ms"]}
    want = ref[np.arange(requests) % len(images)]
    err = float(np.abs(probs - want).max())
    top1 = float((probs.argmax(1) == want.argmax(1)).mean())
    log(f"serve {label}: in-process drain requests={requests} "
        f"req/s={requests / wall:.1f} engine batches={batches} mean_batch="
        f"{requests / max(batches, 1):.2f} padded_waste="
        f"{after['padded_waste'] - before['padded_waste']} stage_ms={stage} "
        f"max_abs_err(probs)={err:.3e} top1_agreement={top1:.4f} launches="
        f"{ {k: v for k, v in counts.items() if v} }")
    for name, got in counts.items():
        if got != per_batch.get(name, 0) * batches:
            raise AssertionError(f"serve {label}: {name} launched {got} "
                                 f"times, expected {per_batch.get(name, 0)} "
                                 f"per batch x {batches}")
    if not (err <= 1e-2 and top1 >= 0.99):
        raise AssertionError(f"serve {label}: max|dprob| {err}, top-1 "
                             f"agreement {top1}")
    return counts


def hold_responses(label: str, results, ref: np.ndarray, max_dprob: float,
                   min_top1: float) -> None:
    """Each 200 response's top-5 probabilities against the reference's at
    the same class ids, and its top-1 against the reference's argmax."""
    errs, top1 = [], []
    for idx, status, _, body in results:
        if status != 200:
            continue
        row = ref[idx]
        errs.append(max(abs(p - row[c]) for c, p in zip(body["class_ids"],
                                                        body["probs"])))
        top1.append(body["class_ids"][0] == int(row.argmax()))
    if not errs:
        raise AssertionError(f"serve {label}: no response to hold")
    err, agree_share = max(errs), float(np.mean(top1))
    log(f"serve {label}: {len(errs)} responses max_abs_err(probs)="
        f"{err:.3e} top1_agreement={agree_share:.4f} (limits {max_dprob}, "
        f"{min_top1})")
    if not (err <= max_dprob and agree_share >= min_top1):
        raise AssertionError(f"serve {label}: max|dprob| {err} (limit "
                             f"{max_dprob}), top-1 agreement {agree_share} "
                             f"(limit {min_top1})")


def profile_window(label: str, fn) -> None:
    """Device-busy ms and idle share over one call of `fn` (a served run:
    the kernels come from the engine's threads), by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:  # the kernels launch from the engine's compute thread
        from torch._C._profiler import _ExperimentalConfig

        extra = {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}
    except TypeError:  # a torch without the option: CUPTI sees every thread
        extra = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **extra) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile {label}: device_busy_ms={busy_ms:.4f} "
        f"profiled_wall_ms={wall_ms:.4f} "
        f"idle_share={max(0.0, 1 - busy_ms / wall_ms):.3f} "
        f"all_threads={bool(extra)}")
    if busy_ms <= 0:
        raise AssertionError(f"profile {label}: no device time recorded")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:9.4f} ms x{e.count:<5} "
            f"{e.key[:90]}")


def time_ladder(label: str, engine, buckets) -> None:
    """The engine's warm forward at each bucket: ms a batch (host clock to
    a synchronize, median of 3 after one warm forward) and images/s."""
    h, w, c = (engine.spec.in_height, engine.spec.in_width,
               engine.spec.in_channels)
    rows = []
    with engine._compute_context():
        for b in buckets:
            x = torch.randn((b, h, w, c), device=engine.device).to(
                engine._upload_dtype)
            engine._fwd(engine.params, x)
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                engine._fwd(engine.params, x).float().cpu()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = float(np.median(times))
            rows.append(f"B={b} ms/batch={ms:.4f} img/s={b / ms * 1e3:.1f}")
    log(f"ladder {label}: " + "; ".join(rows))


def wait_healthy(port: int, proc, timeout_s: float) -> float:
    """Seconds until GET /healthz answers 200; raises if the process exits
    or the time runs out."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if proc.poll() is not None:
            raise AssertionError(f"serve process exited with {proc.returncode}"
                                 f": {proc.stdout.read()[-2000:]}")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                if r.status == 200:
                    return time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError):
            pass
        time.sleep(0.25)
    raise AssertionError(f"serve process: no /healthz within {timeout_s} s")


def post_bmp(port: int, path: str) -> tuple[int, dict]:
    import urllib.request

    with open(path, "rb") as f:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/classify",
                                     data=f.read(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def phase_serve(spec, params, rparams, geo, dev, peaks,
                smi: str) -> tuple[dict, float]:
    """Phase 11: the serving daemon on the card. Returns the launch counts
    of the served runs and pq_fc_fused's largest error at M = 1 and 8."""
    import multiprocessing
    import shutil
    import tempfile

    from qcnn_tpu_torch import cli
    from qcnn_tpu_torch.eval import Classifier, FamilyClassifier
    from qcnn_tpu_torch.formats.checkpoint import (
        save_checkpoint,
        save_family_checkpoint,
        save_preprocessor,
    )
    from qcnn_tpu_torch.models import common, resnet
    from qcnn_tpu_torch.preproc import Preprocessor, TorchPreprocessor
    from qcnn_tpu_torch.serve import EngineConfig
    from qcnn_tpu_torch.serve.http import serve as http_serve
    from qcnn_tpu_torch.serve.router import serve_router

    t_phase = time.perf_counter()
    fc_err = serve_fc_check(geo, spec, dev, peaks)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    counts, failed, procs, servers, engines = {}, [], [], [], []

    def check(fn, *args):
        """Log a broken limit and go on; the phase raises at its end."""
        try:
            fn(*args)
        except AssertionError as e:
            failed.append(str(e))
            log(f"serve FAILED: {e}")

    def start_server(engine, preprocessor=None, names=None):
        server = http_serve(engine, port=0, block=False,
                            preprocessor=preprocessor, class_names=names)
        servers.append(server)
        return server, f"http://127.0.0.1:{server.server_address[1]}"

    d = tempfile.mkdtemp()
    try:
        # step 1: the files, written by the port's own writers
        files = write_io_files(d, spec, params)
        paths = files["paths"]
        mean_path = os.path.join(d, "AlexNet", "imagenet_mean.single.bin")
        ck = os.path.join(d, "alexnet_ck")
        save_checkpoint(ck, spec, params)
        save_preprocessor(ck, Preprocessor.alexnet(mean_path))
        shutil.copy(os.path.join(d, "class_names.txt"),
                    os.path.join(ck, "class_names.txt"))
        rck = os.path.join(d, "resnet50_ck")
        save_family_checkpoint(rck, "resnet", resnet.resnet50(), rparams)
        save_preprocessor(rck, TorchPreprocessor.imagenet())

        # step 2: the entry points as processes, started now so that their
        # start-up overlaps the in-process work; read in step 8
        port = free_port()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "qcnn_tpu_torch", "serve", "--checkpoint",
             ck, "--port", str(port), "--memory-mode", "--device", dev.type],
            cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        t_spawn = time.perf_counter()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "qcnn_tpu_torch", "classify",
             "--checkpoint", ck, "--device", dev.type, *paths[:2]],
            cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

        # step 3: the payloads (preprocessed as the server preprocesses a
        # BMP upload) and the references
        x = Preprocessor.alexnet(mean_path).load_batch(paths, native="require")
        xr = TorchPreprocessor.imagenet().load_batch(paths, native="require")
        np.save(os.path.join(d, "alexnet.npy"), x)
        np.save(os.path.join(d, "resnet50.npy"), xr)
        clf = Classifier.from_checkpoint(ck, conv_impl="memory",
                                         fc_impl="memory", batch_hint=64,
                                         device=dev)
        ref_mem = clf._probs(x)
        del clf
        fam = FamilyClassifier.from_checkpoint(rck, memory=True, device=dev)
        ref_resnet = fam._probs(xr)
        del fam

        # step 4: AlexNet-PQ memory mode, bf16, the serving ladder
        config = EngineConfig(**common.serving_defaults("alexnet"))
        if config.bucket_ladder() != SERVE_LADDER:
            raise AssertionError(f"alexnet ladder {config.bucket_ladder()}")
        t0 = time.perf_counter()
        mem, pre, names = cli.linear_engine_from_checkpoint(
            ck, config, conv_impl="memory", fc_impl="memory", device=dev)
        engines.append(mem.start())
        warm = mem.warmup()
        log(f"serve alexnet memory engine: load+prepare+warmup seconds="
            f"{time.perf_counter() - t0:.2f} warmup_ms="
            f"{ {b: round(ms, 2) for b, ms in warm.items()} } "
            f"upload={mem._upload_dtype} buckets={mem._buckets}")
        mem_srv, mem_url = start_server(mem, pre, names)
        per_batch = {"pq_decode": 1, "pq_fc_fused": 3}
        npy = os.path.join(d, "alexnet.npy")
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(1) as clients:
            served = []
            for c, n in SERVE_RUNS:
                run = serve_run("alexnet memory tensors", clients,
                                mem_url + "/classify", mem, npy, c, n,
                                per_batch)
                served += run["results"]
                add_counts(counts.setdefault("serve alexnet memory", {}),
                           run["counts"])
            c, n = SERVE_PROFILED
            runs = []
            profile_window(
                f"serve alexnet memory c={c} requests={n}",
                lambda: runs.append(serve_run(
                    "alexnet memory tensors (profiled)", clients,
                    mem_url + "/classify", mem, npy, c, n, per_batch)))
            runs.append(serve_run("alexnet memory BMP uploads", clients,
                                  mem_url + "/classify", mem, paths, 8,
                                  len(paths), per_batch))
            for run in runs:
                served += run["results"]
                add_counts(counts["serve alexnet memory"], run["counts"])
            add_counts(counts["serve alexnet memory"], drain_run(
                "alexnet memory", mem, x, SERVE_RUNS[-1][1], per_batch,
                ref_mem))
            check(hold_responses, "alexnet memory vs Classifier memory "
                  "batch_hint=64", served, ref_mem, 1e-2, 0.99)

            # step 5: the decode-at-load engine: its answers, then the
            # router over both servers
            auto, _, _ = cli.linear_engine_from_checkpoint(ck, config,
                                                           device=dev)
            engines.append(auto.start())
            auto.warmup()
            futs = [auto.submit(img) for img in x]
            ref_auto = np.stack([f.result(timeout=120) for f in futs])
            check(hold_responses, "alexnet memory vs decode-at-load engine",
                  served, ref_auto, 1e-2, 0.99)
            auto_srv, auto_url = start_server(auto, pre, names)
            router = serve_router([mem_url, auto_url], port=0, block=False,
                                  cooldown_s=60)
            servers.append(router)
            r_url = f"http://127.0.0.1:{router.server_address[1]}/classify"
            n_before = (mem.stats["requests"], auto.stats["requests"])
            out = clients.apply(serve_client, (r_url, npy, 4, 32))
            to_both = (mem.stats["requests"] - n_before[0],
                       auto.stats["requests"] - n_before[1])
            auto_srv.shutdown()
            auto_srv.server_close()
            servers.remove(auto_srv)
            after = clients.apply(serve_client, (r_url, npy, 4, 32))
            health = router.router.health()["backends"]
            statuses = [r[1] for r in out["results"] + after["results"]]
            log(f"serve router over 2 AlexNet servers: 32 requests -> "
                f"memory {to_both[0]}, auto {to_both[1]}; auto server shut "
                f"down, 32 more -> statuses "
                f"{ {s: statuses.count(s) for s in set(statuses)} }; "
                f"backends {health}")
            if not (min(to_both) > 0 and statuses == [200] * 64
                    and health[1]["errors"] > 0):
                failed.append("router: no failover to the live server")

            # step 6: backpressure and deadlines on the card
            burst, _, _ = cli.linear_engine_from_checkpoint(
                ck, EngineConfig(max_batch=64, buckets=SERVE_LADDER,
                                 max_queue=SERVE_QUEUE),
                conv_impl="memory", fc_impl="memory", device=dev)
            engines.append(burst)
            burst.warmup()
            _, burst_url = start_server(burst)
            # not started: the first SERVE_QUEUE requests wait in the queue,
            # every other one is shed; started once all of those are back
            pending = clients.apply_async(serve_client, (
                burst_url + "/classify", npy, SERVE_BURST, SERVE_BURST))
            t0 = time.perf_counter()
            while (burst.stats["rejected"] < SERVE_BURST - SERVE_QUEUE
                   and time.perf_counter() - t0 < 60):
                time.sleep(0.05)
            burst.start()
            res = pending.get(timeout=120)
            codes = [r[1] for r in res["results"]]
            log(f"serve burst of {SERVE_BURST} into max_queue={SERVE_QUEUE}:"
                f" 200={codes.count(200)} 503={codes.count(503)} "
                f"stats rejected={burst.stats['rejected']} in "
                f"{res['wall_s']:.3f} s")
            if not (codes.count(503) == burst.stats["rejected"]
                    == SERVE_BURST - SERVE_QUEUE
                    and codes.count(200) == SERVE_QUEUE):
                failed.append("backpressure: 503s differ from rejected")
            expired = mem.stats["expired"]
            late = serve_run("alexnet memory X-Deadline-Ms 0.001", clients,
                             mem_url + "/classify", mem, npy, 8, 32, per_batch,
                             {"X-Deadline-Ms": "0.001"})
            codes = [r[1] for r in late["results"]]
            if not (codes.count(504) == mem.stats["expired"] - expired
                    and codes.count(504) + codes.count(200) == 32
                    and codes.count(504) > 0):
                failed.append(f"deadline: 504s {codes.count(504)} against "
                              f"expired {mem.stats['expired'] - expired}")

            # step 7: ResNet-50, a family checkpoint in memory mode
            t0 = time.perf_counter()
            rcfg = EngineConfig(**common.serving_defaults("resnet50"))
            reng, rpre, _ = cli.family_engine_from_checkpoint(
                rck, rcfg, memory_mode=True, device=dev)
            engines.append(reng.start())
            warm = reng.warmup()
            log(f"serve resnet50 memory engine: load+prepare+warmup seconds="
                f"{time.perf_counter() - t0:.2f} warmup_ms="
                f"{ {b: round(ms, 2) for b, ms in warm.items()} } "
                f"upload={reng._upload_dtype}")
            _, r_url = start_server(reng, rpre)
            c, n = SERVE_RESNET
            run = serve_run("resnet50 memory tensors", clients,
                            r_url + "/classify", reng,
                            os.path.join(d, "resnet50.npy"), c, n,
                            {"pq_conv_fused": 7, "pq_decode": 17})
            counts["serve resnet50 memory"] = run["counts"]
            check(hold_responses, "resnet50 memory vs FamilyClassifier "
                  "memory", run["results"], ref_resnet, 5e-3, 0.99)

        # step 8: the entry points
        classify_out, _ = procs[1].communicate(timeout=300)
        log(f"serve classify process rc={procs[1].returncode}: "
            + " | ".join(classify_out.strip().splitlines()[:8]))
        if procs[1].returncode != 0:
            failed.append(f"classify process rc {procs[1].returncode}: "
                          f"{classify_out[-2000:]}")
        up_s = wait_healthy(port, procs[0], 120 - (time.perf_counter()
                                                   - t_spawn))
        status, body = post_bmp(port, paths[0])
        log(f"serve process: /healthz 200 after "
            f"{time.perf_counter() - t_spawn:.2f} s from spawn "
            f"(polled {up_s:.2f} s), /classify of a BMP -> {status} "
            f"top-1 {body['class_ids'][0]} {body['class_names'][0]} "
            f"(in-process reference top-1 {int(ref_mem[0].argmax())})")
        if status != 200:
            failed.append(f"serve process: /classify {status}")

        # step 9: the ladder, measured (the engines' own forwards)
        time_ladder("alexnet memory", mem, SERVE_TIMED_BUCKETS)
        time_ladder("resnet50 memory", reng, SERVE_TIMED_BUCKETS)

        # step 10: stop() with requests in flight
        futs = [mem.submit(img) for img in x for _ in range(4)]
        mem.stop()
        done = stopped = hung = 0
        for f in futs:
            try:
                f.result(timeout=5)
                done += 1
            except RuntimeError:
                stopped += 1
            except TimeoutError:
                hung += 1
        log(f"serve stop() with {len(futs)} requests in flight: completed "
            f"{done}, failed 'engine stopped' {stopped}, unresolved {hung}")
        if hung:
            failed.append(f"stop: {hung} futures unresolved after 5 s")
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
        for engine in engines:
            engine.stop()
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        shutil.rmtree(d, ignore_errors=True)
    log(f"serve phase seconds={time.perf_counter() - t_phase:.1f} card: {smi}")
    if failed:
        raise AssertionError("phase 11: " + "; ".join(failed))
    return counts, fc_err


QUANT_CALIB = 32      # calibration inputs of the error-corrected AlexNet
QUANT_HELD_OUT = 64   # inputs of the held-out comparison (logged only)
QUANT_BATCH = 64      # batch of the classifier and A4 runs
QUANT_LUT_BATCH = 32  # batch of the network-level 'lut' run
QUANT_FAMILY = "resnet50"


def run_cli(label: str, argv: list, root: str) -> float:
    """Run `python -m qcnn_tpu_torch <argv>` as a process and log each line
    of its stderr with the seconds since the previous one (the quantizer
    logs one line a layer). Returns the process's seconds."""
    env = dict(os.environ, PYTHONPATH=root)
    t0 = last = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "qcnn_tpu_torch", *argv],
                            cwd=root, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stderr:
            now = time.perf_counter()
            log(f"quantize {label} +{now - last:.3f}s: {line.rstrip()}")
            last = now
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"quantize {label}: exit code {rc}")
    return time.perf_counter() - t0


def layer_errors(spec, dense, quant, x, dev) -> dict:
    """{layer index: (weight MSE, response MSE)} of a quantized linear-spec
    net against its dense one: the mean squared difference of the decoded
    weight, and of the layer's output (no bias) on the float32 activations
    that the quantized prefix feeds it, over every position."""
    from qcnn_tpu_torch.core import ConvSpec, FCSpec
    from qcnn_tpu_torch.models import network
    from qcnn_tpu_torch.models.prepare import _decode_rows_np
    from qcnn_tpu_torch.ops.conv import conv_dense
    from qcnn_tpu_torch.ops.fc import matmul

    out = {}
    for i, layer in enumerate(spec.layers):
        if not isinstance(layer, (ConvSpec, FCSpec)):
            continue
        cb = np.asarray(quant[i]["codebooks"])
        asmt = np.asarray(quant[i]["assignments"])
        a = network.forward(quant, x, spec=spec, upto=i, with_softmax=False,
                            device=dev).float()
        if isinstance(layer, ConvSpec):
            w = np.asarray(dense[i]["kernel"])                    # HWIO
            kh, kw, cg, cout = w.shape
            w_hat = _decode_rows_np(cb, asmt.reshape(-1, cb.shape[0]), cg)
            w_hat = w_hat.reshape(cout, kh, kw, cg).transpose(1, 2, 3, 0)
            zero = torch.zeros(cout, device=dev)
            conv = dict(stride=layer.stride, pad=layer.pad,
                        groups=layer.groups)
            y = conv_dense(a, torch.from_numpy(w).to(dev), zero, **conv)
            y_hat = conv_dense(a, torch.from_numpy(
                np.ascontiguousarray(w_hat)).to(dev), zero, **conv)
        else:
            if a.ndim == 4:  # the first FC: NCHW flatten
                a = a.permute(0, 3, 1, 2).reshape(a.shape[0], -1)
            w = np.asarray(dense[i]["weight"])                    # (Cin, Cout)
            w_hat = _decode_rows_np(cb, asmt, w.shape[0]).T
            y = matmul(a, torch.from_numpy(w).to(dev), None)
            y_hat = matmul(a, torch.from_numpy(
                np.ascontiguousarray(w_hat)).to(dev), None)
        out[i] = (float(np.mean((w_hat - w) ** 2)),
                  float(((y - y_hat) ** 2).mean()))
    return out


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm()).item()


def pq_leaves(params, path: str = "") -> dict:
    """{path: layer dict} of every PQ layer (one with codebooks) in a list
    or a nested dict of params, in order."""
    if isinstance(params, dict) and "codebooks" in params:
        return {path: params}
    items = (params.items() if isinstance(params, dict)
             else enumerate(params or ()))
    out = {}
    for key, value in items:
        if isinstance(value, (dict, list, tuple)):
            out |= pq_leaves(value, f"{path}/{key}" if path else str(key))
    return out


def differing_layers(first, second) -> list:
    """The PQ layers whose codebooks (float32 bits) or ids differ between
    two quantizations of one model."""
    a, b = pq_leaves(first), pq_leaves(second)
    if list(a) != list(b):
        raise AssertionError(f"the runs quantized other layers: {list(a)} "
                             f"against {list(b)}")

    def bits(leaf):
        cb = np.asarray(torch.as_tensor(leaf["codebooks"]).float().cpu())
        ids = np.asarray(torch.as_tensor(leaf["assignments"]).cpu())
        return cb.view(np.uint32), ids.astype(np.int64)

    out = []
    for path in a:
        (cb_a, ids_a), (cb_b, ids_b) = bits(a[path]), bits(b[path])
        if not (np.array_equal(cb_a, cb_b) and np.array_equal(ids_a, ids_b)):
            out.append(path)
    return out


def repro_check(label: str, first, second) -> None:
    """Log which PQ layers of two runs with one seed differ; none may."""
    diff = differing_layers(first, second)
    log(f"quantize repro {label}: {len(pq_leaves(first))} PQ layers, "
        f"{len(diff)} differ bit for bit" + (f" (first {diff[0]})"
                                            if diff else ""))
    if diff:
        raise AssertionError(f"{label}: one seed gave other codebooks or "
                             f"ids at {diff}")


def time_cluster_sums(dev, gpu_name: str) -> None:
    """The k-means update's sums at AlexNet fc6's geometry (S=2304,
    N=4096 units, K=32, D=4) on the card: the quantizer's sorted segment
    sum, the one-hot product the JAX package contracts and the
    scatter-add the port used before, each run twice (same bits or not),
    and timed."""
    from qcnn_tpu_torch.quantizer import kmeans

    s, n, k, d = 2304, 4096, 32, 4
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((s, n, d), generator=gen, device=dev)
    ids = torch.randint(0, k, (s, n), generator=gen, device=dev)

    def one_hot():
        step = kmeans.chunk_size(n * k, x.device)
        codes = torch.arange(k, device=dev)
        out = []
        for i in range(0, s, step):
            oh = (ids[i:i + step, :, None] == codes).float()
            out.append(torch.bmm(oh.transpose(1, 2), x[i:i + step]))
        return torch.cat(out)

    def scatter_add():
        out = torch.zeros((s, k, d), device=dev)
        return out.scatter_add_(1, ids[..., None].expand(s, n, d), x)

    flush = flush_buffer(dev)
    want = kmeans.cluster_sums(x, ids, k)[0]
    for name, fn in (("cluster_sums (sorted segment sum)",
                      lambda: kmeans.cluster_sums(x, ids, k)[0]),
                     ("one-hot bmm", one_hot), ("scatter_add_", scatter_add)):
        first, second = fn(), fn()
        err = ((first - want).abs().max() / want.abs().max()).item()
        log(f"quantize sums fc6 {name}: ms={time_ms(fn, flush, reps=10):.4f}"
            f" same_bits_twice={torch.equal(first, second)} "
            f"rel_err_vs_cluster_sums={err:.2e} card={gpu_name}")
        if name.startswith("cluster_sums") and not torch.equal(first,
                                                              second):
            raise AssertionError("cluster_sums gave other bits twice")


def phase_quantize(spec, params, dev, gpu_name: str,
                   family: str = QUANT_FAMILY) -> dict:
    """Phase 12: the quantizer and the conv strategies A4 added, on the
    card. (a) AlexNet from FP32: the `quantize` CLI (sequential
    error-corrected PQ over random calibration inputs) as a process, plain
    quantize_network in-process, the per-layer errors, the written
    checkpoint classified in memory mode against decode at load, and the
    paper's claim (EC closer to the dense logits than plain on the
    calibration inputs). (b) `make-family resnet50` (plain) as a process,
    classified in memory mode against decode at load. (c) pq_conv 'gemm'
    and per-op 'memory' at AlexNet's convs against 'decode', timed, and
    network.forward with conv 'lut' and 'memory' against 'decode'. (d)
    `serve --model resnet50 --memory-mode` as a process answers one
    tensor. They run in the order (c), (b), (d), (a), while a thread
    writes (a)'s dense checkpoint. Each quantization runs twice with one
    seed (AlexNet plain twice in-process, the EC process against the same
    pass in-process, make-family against quantize_params in-process): the
    codebooks and ids must be the same bits. Returns the launch counts of
    each path and the in-process ResNet-50 PQ params."""
    import shutil
    import tempfile
    import threading
    import urllib.request

    from qcnn_tpu_torch.core import ConvSpec
    from qcnn_tpu_torch.eval import Classifier, FamilyClassifier
    from qcnn_tpu_torch.formats.checkpoint import (
        load_checkpoint,
        load_family_checkpoint,
        save_checkpoint,
        save_preprocessor,
    )
    from qcnn_tpu_torch.models import network, prepare, resnet, synth
    from qcnn_tpu_torch.ops import conv as conv_ops
    from qcnn_tpu_torch.ops import cuda as cuda_ops
    from qcnn_tpu_torch.preproc import TorchPreprocessor
    from qcnn_tpu_torch.quantizer.sequential import quantize_network

    t_phase = t_step = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    counts, failed = {}, []

    def step(name):
        nonlocal t_step
        now = time.perf_counter()
        log(f"quantize step {name}: seconds={now - t_step:.2f}")
        t_step = now

    def check(fn, *args):
        """Log a broken limit and go on; the phase raises at its end."""
        try:
            fn(*args)
        except AssertionError as e:
            failed.append(str(e))
            log(f"quantize FAILED: {e}")

    names = {i: f"{type(layer).__name__[:-4].lower()}{i}"
             for i, layer in enumerate(spec.layers)}
    resnet_spec = resnet.RESNETS[family]()
    d = tempfile.mkdtemp()
    try:
        # the dense AlexNet checkpoint (seed 0) that (a) quantizes: the npz
        # store compresses 244 MB of float32, which takes the host tens of
        # seconds, so a thread writes it while (c) and (b) run (zlib
        # releases the GIL)
        dense = synth.random_dense_params(spec, seed=0)
        src, out = os.path.join(d, "dense"), os.path.join(d, "pq_ec")
        write_error = []

        def write_dense():
            try:
                save_checkpoint(src, spec, dense)
            except Exception as e:  # noqa: BLE001 - re-raised after join
                write_error.append(e)

        writer = threading.Thread(target=write_dense)
        writer.start()
        # (c) A4 at AlexNet's geometry, bf16 (synthetic PQ params, seed 0)
        flush = flush_buffer(dev)
        gen = torch.Generator(device=dev).manual_seed(5)
        shapes = spec.feature_shapes(batch=QUANT_BATCH)
        for i, layer in enumerate(spec.layers):
            if not isinstance(layer, ConvSpec):
                continue
            p = {k: torch.as_tensor(np.asarray(v), device=dev)
                 for k, v in params[i].items()}
            p["codebooks"] = p["codebooks"].bfloat16()
            x = torch.randn(shapes[i], generator=gen, device=dev).bfloat16()
            conv = dict(stride=layer.stride, pad=layer.pad,
                        groups=layer.groups)
            want = conv_ops.pq_conv(x, p, impl="decode", **conv)
            scale = want.abs().max().item()
            impls = ["memory"] + (["gemm"] if layer.groups == 1 else [])
            for impl in impls:
                cuda_ops.reset_launches()
                got = conv_ops.pq_conv(x, p, impl=impl, **conv)
                torch.cuda.synchronize()
                c = cuda_ops.launches()
                add_counts(counts.setdefault(f"a4 {impl}", {}), c)
                err = (got - want).abs().max().item() / scale
                cout, kh, kw, _ = p["assignments"].shape
                route = ("gemm" if impl == "gemm" or conv_ops._gemm_wins(
                    x.shape, cout, kh, kw, layer.groups, layer.stride,
                    layer.pad) else "indecode_ohwi")
                times = {name: time_ms(lambda name=name: conv_ops.pq_conv(
                    x, p, impl=name, out_dtype=torch.bfloat16, **conv),
                    flush, reps=10)
                    for name in (impl, "decode", "indecode_ohwi")}
                log(f"a4 {names[i]} B={QUANT_BATCH} {tuple(x.shape)} "
                    f"impl={impl} route={route} rel_err(f32 out vs decode)="
                    f"{err:.3e} (limit 1e-4) launches="
                    f"{ {k: v for k, v in c.items() if v} } ms(bf16 out): "
                    + " ".join(f"{k}={v:.4f}" for k, v in times.items())
                    + f" card={gpu_name}")

                def within(err=err, label=f"a4 {names[i]} {impl}", c=c):
                    if not err <= 1e-4:
                        raise AssertionError(f"{label}: rel err {err}")
                    if c["pq_decode"] != 1 or sum(c.values()) != 1:
                        raise AssertionError(f"{label}: launches {c}")

                check(within)
        del flush
        x_all = torch.from_numpy(synth.random_input(spec, QUANT_BATCH,
                                                    seed=6)).to(dev)
        fwd_probs = {}
        for impl, b, per_fwd in (("auto", QUANT_BATCH, {}),
                                 ("memory", QUANT_BATCH, {"pq_decode": 1}),
                                 ("lut", QUANT_LUT_BATCH, {})):
            x = x_all[:b]
            t0 = time.perf_counter()
            prepared, conv_impls, fc_impls = prepare.prepare_params(
                spec, params, batch_hint=b, conv_impl=impl, fc_impl="auto",
                dtype=torch.bfloat16, device=dev)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            fwd_probs[impl], c = drive(
                f"a4 alexnet conv_impl={impl} B={b} conv_impls="
                f"{sorted(set(conv_impls) - {'-'})}",
                lambda: network.forward(prepared, x, spec=spec,
                                        conv_impls=conv_impls,
                                        fc_impls=fc_impls,
                                        compute_dtype=torch.bfloat16,
                                        device=dev),
                b, spec.num_classes, steps=2, per_fwd=per_fwd,
                gpu_name=gpu_name, resident=tensor_bytes(prepared),
                prep_s=prep_s, prof_steps=0)
            if impl == "memory":
                counts["a4 network memory"] = c
            if impl == "lut":
                lut_bytes = 0
                in_shapes = spec.feature_shapes(batch=b)
                for i, layer in enumerate(spec.layers):
                    if isinstance(layer, ConvSpec):
                        _, h, w, _ = in_shapes[i]
                        s_cnt, k_cnt, _ = params[i]["codebooks"].shape
                        lut_bytes = max(lut_bytes, b * h * w * 4 * s_cnt
                                        * k_cnt * layer.groups)
                log(f"a4 alexnet lut B={b}: largest LUT {lut_bytes} bytes "
                    f"(float32), peak_alloc_bytes="
                    f"{torch.cuda.max_memory_allocated()}")
            del prepared
        for impl in ("memory", "lut"):
            b = fwd_probs[impl].shape[0]
            check(agree, f"a4 alexnet conv_impl={impl} vs decode B={b}",
                  fwd_probs["auto"][:b], fwd_probs[impl], 1e-2, 0.99)
        step("(c) A4")

        # (b) ResNet-50 from `make-family` (plain k-means, K = 128 / 32)
        rck = os.path.join(d, family)
        rs = run_cli(family, ["make-family", family, rck, "--device",
                              dev.type], root)
        log(f"quantize {family} make-family seconds={rs:.2f} "
            f"card={gpu_name}")
        rprobs = {}
        for memory in (True, False):
            t0 = time.perf_counter()
            fam = FamilyClassifier.from_checkpoint(rck, memory=memory,
                                                   device=dev)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            size = fam.spec.in_size
            gen = torch.Generator(device=dev).manual_seed(4)
            x = torch.randn((QUANT_BATCH, size, size, 3), generator=gen,
                            device=dev)
            mode = "memory" if memory else "decode"
            rprobs[mode], c = drive(
                f"quantize {family} {mode} B={QUANT_BATCH}",
                lambda: fam._fwd(fam.params, x), QUANT_BATCH,
                fam.spec.num_classes, steps=5,
                per_fwd=({"pq_conv_fused": 7, "pq_decode": 17} if memory
                         else {}),
                gpu_name=gpu_name, resident=tensor_bytes(fam.params),
                prep_s=prep_s, prof_steps=0)
            if memory:
                counts[f"quantize {family} memory"] = c
            del fam
        check(agree, f"quantize {family} memory vs decode B={QUANT_BATCH}",
              rprobs["decode"], rprobs["memory"], 5e-3, 0.99)
        # the same seed in this process: the same bits as make-family's
        family_pq = resnet.quantize_params(
            resnet_spec, resnet.init_dense_params(resnet_spec, seed=0),
            device=dev)
        check(repro_check, f"{family} plain (make-family process, then "
              "in-process)", load_family_checkpoint(rck)[2], family_pq)
        step("(b) make-family, the family classifier and the repro check")
        # (d) `serve --model resnet50` as a process: it quantizes the
        # seed-0 dense init on the card at start-up; started while the
        # card waits for the dense checkpoint's write
        port = free_port()
        server = subprocess.Popen(
            [sys.executable, "-m", "qcnn_tpu_torch", "serve", "--model",
             family, "--memory-mode", "--port", str(port), "--device",
             dev.type], cwd=root, env=dict(os.environ, PYTHONPATH=root),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            t0 = time.perf_counter()
            writer.join()
            if write_error:
                raise write_error[0]
            step("(a) waiting for the dense AlexNet checkpoint's write")
            ready = (time.perf_counter() - t0
                     + wait_healthy(port, server, 300.0))
            size = resnet_spec.in_size
            x = np.random.default_rng(7).standard_normal(
                (size, size, 3)).astype(np.float32)
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/classify", data=x.tobytes(),
                headers={"X-Shape": f"{size},{size},3"}, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                status, body = r.status, json.loads(r.read())
            log(f"quantize serve --model {family} --memory-mode: /healthz "
                f"after {ready:.2f} s (process start, quantize_params on "
                f"the card, engine warm-up), one tensor: status {status} "
                f"class_ids={body.get('class_ids')} "
                f"probs={body.get('probs')}")

            def answered():
                probs = np.asarray(body.get("probs", []), np.float64)
                if not (status == 200 and len(body.get("class_ids", []))
                        == 5 and probs.shape == (5,)
                        and np.isfinite(probs).all()
                        and (probs >= 0).all() and probs.sum() <= 1 + 1e-3
                        and (np.diff(probs) <= 0).all()):
                    raise AssertionError(f"serve --model {family}: status "
                                         f"{status}, body {body}")

            check(answered)
        finally:
            server.terminate()
            try:
                server.wait(timeout=30)
            except subprocess.TimeoutExpired:
                server.kill()
                server.wait()
        step(f"(d) serve --model {family} (beside the write)")

        # (a) AlexNet: FP32 -> PQ, error-corrected by the CLI, plain here
        ec_s = run_cli("alexnet ec", ["quantize", src, out, "--calib-random",
                                      str(QUANT_CALIB), "--device",
                                      dev.type], root)
        t0 = last = time.perf_counter()

        def plain_log(msg):
            nonlocal last
            torch.cuda.synchronize()
            now = time.perf_counter()
            log(f"quantize alexnet plain +{now - last:.3f}s: {msg}")
            last = now

        gen = torch.Generator(device=dev).manual_seed(0)
        plain = quantize_network(gen, spec, dense, log=plain_log)
        plain_s = time.perf_counter() - t0
        _, ec = load_checkpoint(out)
        # one seed, two runs: the plain pass again, and the CLI's
        # error-corrected pass (--calib-random, --seed 0) in this process
        cal_np = np.random.default_rng(1).standard_normal(
            (QUANT_CALIB, spec.in_height, spec.in_width, spec.in_channels)
        ).astype(np.float32)
        check(repro_check, "alexnet plain (twice in-process)", plain,
              quantize_network(torch.Generator(device=dev).manual_seed(0),
                               spec, dense))
        check(repro_check, "alexnet ec (quantize process, then "
              "in-process)", ec, quantize_network(
                  torch.Generator(device=dev).manual_seed(0), spec, dense,
                  x_calib=cal_np, seed=0))
        step("(a) the repro checks")
        check(time_cluster_sums, dev, gpu_name)
        log(f"quantize alexnet seconds: ec_process={ec_s:.2f} (process "
            f"start and checkpoint write included) plain_in_process="
            f"{plain_s:.2f} card={gpu_name}")
        x_cal = torch.from_numpy(cal_np).to(dev)
        x_held = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (QUANT_HELD_OUT, spec.in_height, spec.in_width,
             spec.in_channels)).astype(np.float32)).to(dev)
        err_plain = layer_errors(spec, dense, plain, x_cal, dev)
        err_ec = layer_errors(spec, dense, ec, x_cal, dev)
        for i in err_plain:
            log(f"quantize alexnet {names[i]}: plain weight_mse="
                f"{err_plain[i][0]:.6e} response_mse={err_plain[i][1]:.6e}"
                f"; ec weight_mse={err_ec[i][0]:.6e} response_mse="
                f"{err_ec[i][1]:.6e} (on the {QUANT_CALIB} calibration "
                "inputs through each quantized prefix)")

        def logits(p, x):
            return network.forward(p, x, spec=spec, with_softmax=False,
                                   device=dev).float()

        errs = {}
        for tag, x in (("calibration", x_cal), ("held-out", x_held)):
            want = logits(dense, x)
            errs[tag] = (rel_l2(logits(plain, x), want),
                         rel_l2(logits(ec, x), want))
            log(f"quantize alexnet logits vs dense, {tag} ({x.shape[0]} "
                f"inputs, f32): rel_l2 plain={errs[tag][0]:.6f} "
                f"ec={errs[tag][1]:.6f}")

        def ec_closer():
            p, e = errs["calibration"]
            if not e < p:
                raise AssertionError(f"alexnet EC rel L2 {e} not below "
                                     f"plain {p} on the calibration inputs")

        check(ec_closer)
        step("(a) quantize, the per-layer errors and the logits")

        # the written checkpoint, classified: memory mode vs decode at load
        save_preprocessor(out, TorchPreprocessor.imagenet(
            crop=spec.in_height))
        x64 = synth.random_input(spec, QUANT_BATCH, seed=3)
        probs = {}
        for mode, b, per_fwd in (("memory", QUANT_BATCH,
                                  {"pq_decode": 1, "pq_fc_fused": 3}),
                                 ("memory", 1,
                                  {"pq_decode": 1, "pq_lut_gather": 3}),
                                 ("auto", QUANT_BATCH, {}),
                                 ("auto", 1, {})):
            t0 = time.perf_counter()
            clf = Classifier.from_checkpoint(
                out, conv_impl=mode, fc_impl=mode, batch_hint=b,
                compute_dtype=torch.bfloat16, device=dev)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            x = torch.from_numpy(x64[:b]).to(dev)
            label = (f"quantize alexnet {mode} B={b} "
                     f"fc_impls={sorted(set(clf.fc_impls) - {'-'})}")
            probs[(mode, b)], c = drive(
                label, lambda: clf._fwd(clf.params, x), b, spec.num_classes,
                steps=5 if b > 1 else 20, per_fwd=per_fwd, gpu_name=gpu_name,
                resident=tensor_bytes(clf.params), prep_s=prep_s,
                prof_steps=0)
            if mode == "memory":
                add_counts(counts.setdefault(
                    f"quantize alexnet memory B={b}", {}), c)
            del clf
        for b in (QUANT_BATCH, 1):
            check(agree, f"quantize alexnet memory vs auto B={b}",
                  probs[("auto", b)], probs[("memory", b)], 1e-2, 0.99)
        step("(a) the written checkpoint classified")
    finally:
        writer.join()
        shutil.rmtree(d, ignore_errors=True)
    log(f"quantize phase seconds={time.perf_counter() - t_phase:.2f}")
    if failed:
        raise AssertionError(f"phase 12: {len(failed)} checks failed: "
                             + "; ".join(failed))
    return counts, family_pq


PROFILE_RUNS = (  # (label, profile flags, the kernels that must launch)
    ("alexnet auto B=256", ["--model", "alexnet", "--batch", "256"], ()),
    ("alexnet auto B=1", ["--model", "alexnet", "--batch", "1"], ()),
    ("alexnet memory B=256", ["--model", "alexnet", "--batch", "256",
                              "--conv-impl", "memory", "--fc-impl",
                              "memory"], ("pq_decode", "pq_fc_fused")),
    ("alexnet memory B=1", ["--model", "alexnet", "--batch", "1",
                            "--conv-impl", "memory", "--fc-impl", "memory"],
     ("pq_decode", "pq_lut_gather")),
    ("alexnet int8 B=256", ["--model", "alexnet", "--batch", "256",
                            "--dtype", "int8"], ()),
    ("alexnet pallas B=256", ["--model", "alexnet", "--batch", "256",
                              "--fc-impl", "pallas"], ("pq_fc",)),
    ("resnet50 memory B=64", ["--model", "resnet50", "--batch", "64",
                              "--conv-impl", "memory", "--fc-impl",
                              "memory"], ("pq_conv_fused", "pq_decode")),
)
PROFILE_RATIO = (0.5, 2.0)  # sum of the rows / the step's device-busy ms
PROFILE_ROW = re.compile(r"^\[\s*\d+\] (\S+)\s+(\S+)\s+\(.*?\)\s+([\d.]+) us")
PROFILE_SEGMENT = re.compile(r"^(\S+)\s+([\d.]+)\s+[\d.]+$")


def profile_step(argv: list, dev, family_pq):
    """The forward step that `profile argv` times layer by layer, built as
    the command builds it (the same seeds and flags; family_pq: ResNet-50's
    PQ params, the bits the command quantizes): fn() -> output."""
    from qcnn_tpu_torch import cli
    from qcnn_tpu_torch.models import network, prepare, resnet, synth, zoo

    args = cli.build_parser().parse_args(["profile", *argv])
    dtype = cli._dtype_arg(args.dtype)
    act = prepare.act_dtype_for(dtype)
    if args.model.startswith("resnet"):
        spec = resnet.RESNETS[args.model]()
        prepared = resnet.prepare_params(spec, family_pq, dtype=dtype, memory=(
            "memory" in (args.conv_impl, args.fc_impl)), device=dev)
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (args.batch, spec.in_size, spec.in_size, 3)).astype(
            np.float32)).to(dev)
        return lambda: resnet.forward(prepared, x, spec=spec,
                                      compute_dtype=act, device=dev)
    spec = zoo.get_model(args.model)
    prepared, ci, fi = prepare.prepare_params(
        spec, synth.random_pq_params(spec, seed=0), batch_hint=args.batch,
        conv_impl=args.conv_impl, fc_impl=args.fc_impl, dtype=dtype,
        device=dev)
    x = torch.from_numpy(synth.random_input(spec, args.batch, seed=1)).to(dev)
    return lambda: network.forward(prepared, x, spec=spec, conv_impls=ci,
                                   fc_impls=fi, compute_dtype=act, device=dev)


def fused_estimate_check(family_pq, dev, smi: str) -> None:
    """The profiler's decode estimate for a fused conv (the launch plan's
    row tiles times one pq_decode of the same codebooks and ids) beside
    pq_conv_fused's time less cuDNN's on the decoded weight, at ResNet-50's
    two fused geometries (B=64, its quantized conv2 weights). Logged; the
    estimate is a model and has no limit."""
    import torch.nn.functional as F

    from qcnn_tpu_torch.core import ConvSpec
    from qcnn_tpu_torch.eval import profiler
    from qcnn_tpu_torch.ops import lut as lut_ops
    from qcnn_tpu_torch.ops.cuda import pq_conv_fused

    flush = flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    for key, hw, _ in RESNET50_FUSED:
        leaf = family_pq[key]["conv2"]
        p = {name: torch.as_tensor(np.ascontiguousarray(leaf[name]),
                                   device=dev)
             for name in ("codebooks", "assignments", "bias")}
        p["codebooks"] = p["codebooks"].bfloat16()
        p["bias"] = p["bias"].float()
        cin = p["assignments"].shape[0]  # conv2 keeps its width
        x = torch.randn((64, hw, hw, cin), generator=gen,
                        device=dev).bfloat16()
        replays, decode = profiler._fused_decode(
            ConvSpec(kernel=3, out_channels=cin, pad=1), p, x, "fusedconv")
        decode_ms = time_ms(decode, flush)
        fused_ms = time_ms(lambda: pq_conv_fused.pq_conv_fused(
            x, p, stride=1, pad=1), flush)
        w = lut_ops.decode_conv_kernel(p["codebooks"], p["assignments"], cin)
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        lib_ms = time_ms(lambda: F.conv2d(xn, wn, padding=1), flush)
        log(f"profile fused-est-decode resnet50 {key}.conv2 B=64 "
            f"{hw}x{hw} {cin}->{cin}: estimate={replays} x pq_decode "
            f"{decode_ms:.5f} = {replays * decode_ms:.5f} ms; pq_conv_fused "
            f"{fused_ms:.5f} - cuDNN on the decoded weight {lib_ms:.5f} = "
            f"{fused_ms - lib_ms:.5f} ms card={smi}")


def phase_profile(dev, smi: str, family_pq=None) -> dict:
    """Phase 13: `python -m qcnn_tpu_torch profile` through cli.main, as a
    user runs it, for each of PROFILE_RUNS: the table (printed here), a
    positive time on every conv and FC row (every segment of a family),
    the launch counts of the run (its owning kernels, and no other), and
    the sum of the rows against the device-busy ms of the same step
    (profile_steps), within PROFILE_RATIO. family_pq: ResNet-50's PQ
    params from phase 12 (the same bits as the command's), else made
    here, and used for fused_estimate_check too. Every run is logged
    before a broken limit fails the phase. Returns the launch counts of
    each run."""
    import contextlib
    import io

    from qcnn_tpu_torch import cli
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    from qcnn_tpu_torch.models import resnet

    t_phase = time.perf_counter()
    if family_pq is None:
        spec = resnet.resnet50()
        family_pq = resnet.quantize_params(
            spec, resnet.init_dense_params(spec, seed=0), device=dev)
    counts, failed = {}, []
    for label, argv, owners in PROFILE_RUNS:
        t0 = time.perf_counter()
        buf = io.StringIO()
        cuda_ops.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["profile", *argv, "--device", dev.type])
        torch.cuda.synchronize()
        c = cuda_ops.launches()
        run_s = time.perf_counter() - t0
        counts[f"profile {label}"] = c
        table = buf.getvalue().splitlines()
        for line in table:
            log(f"profile-table {label}: {line}")
        family = argv[1].startswith("resnet")
        if family:
            rows = [(m[1], "segment", float(m[2]) * 1e3) for m in
                    map(PROFILE_SEGMENT.match, table) if m and m[1] != "total"]
        else:
            rows = [(m[1], m[2], float(m[3])) for m in
                    map(PROFILE_ROW.match, table) if m]
        rows_ms = sum(us for _, _, us in rows) / 1e3
        fwd = profile_step(argv, dev, family_pq)
        fwd()
        busy = profile_steps(fwd, 3, f"step of profile {label}")
        ratio = rows_ms / busy
        launched = sorted(k for k, v in c.items() if v)
        log(f"profile {label}: rc={rc} rows={len(rows)} sum_of_rows_ms="
            f"{rows_ms:.4f} step_device_busy_ms={busy:.4f} ratio={ratio:.3f}"
            f" (limits {PROFILE_RATIO}) launches="
            f"{ {k: c[k] for k in launched} } seconds={run_s:.2f} card={smi}")
        timed = [r for r in rows if family or r[0] in ("Conv", "FC")]
        problems = []
        if rc != 0:
            problems.append(f"exit code {rc}")
        if not timed or not all(us > 0 for _, _, us in timed):
            problems.append(f"rows {timed}")
        if launched != sorted(owners):
            problems.append(f"launched {launched}, expected {sorted(owners)}")
        if not PROFILE_RATIO[0] <= ratio <= PROFILE_RATIO[1]:
            problems.append(f"sum of rows / device-busy = {ratio:.3f}")
        if problems:
            failed.append(f"{label}: " + "; ".join(problems))
            log(f"profile FAILED {label}: " + "; ".join(problems))
    fused_estimate_check(family_pq, dev, smi)
    log(f"profile phase seconds={time.perf_counter() - t_phase:.2f}")
    if failed:
        raise AssertionError(f"phase 13: {len(failed)} runs failed: "
                             + " | ".join(failed))
    return counts


def quantize_repro(dev, smi: str) -> None:
    """--quantize-repro: quantize AlexNet (plain, and error-corrected over
    32 random calibration inputs) and ResNet-50 (plain) twice each with
    one seed, and name the first PQ layer, and the first k-means step, at
    which the two runs part: every k-means seeding and Lloyd iteration of
    both runs is hashed (its centroids' bits) and the hashes are compared
    in order. Then AlexNet plain and error-corrected with the quantizer's
    seeds 0, 1 and 2 (the same calibration inputs): the logits' relative
    L2 against the dense net on the calibration and on 64 held-out inputs,
    as phase 12 measures them for seed 0. Uses only what every version of
    the quantizer has, so that --root can point it at an older
    checkout."""
    import hashlib

    from qcnn_tpu_torch.models import network, resnet, synth, zoo
    from qcnn_tpu_torch.quantizer import kmeans
    from qcnn_tpu_torch.quantizer.sequential import quantize_network

    spec, rspec = zoo.alexnet(), resnet.resnet50()
    dense = synth.random_dense_params(spec, seed=0)
    rdense = resnet.init_dense_params(rspec, seed=0)
    x_cal = np.random.default_rng(1).standard_normal(
        (QUANT_CALIB, spec.in_height, spec.in_width, spec.in_channels)
    ).astype(np.float32)
    runs = {
        "alexnet plain": lambda: quantize_network(
            torch.Generator(device=dev).manual_seed(0), spec, dense),
        "alexnet ec": lambda: quantize_network(
            torch.Generator(device=dev).manual_seed(0), spec, dense,
            x_calib=x_cal, seed=0),
        "resnet50 plain": lambda: resnet.quantize_params(rspec, rdense,
                                                         device=dev),
    }
    init, refit = kmeans._init_centroids, kmeans._refit
    trace = []

    def digest(c):
        return hashlib.sha1(c.float().cpu().numpy().tobytes()).hexdigest()

    def traced_init(*args):
        c = init(*args)
        trace.append(("seeding", digest(c)))
        return c

    def traced_refit(*args):
        c = refit(*args)
        trace.append(("iteration", digest(c)))
        return c

    kmeans._init_centroids, kmeans._refit = traced_init, traced_refit
    try:
        for label, run in runs.items():
            steps, outs = [], []
            for _ in range(2):
                trace.clear()
                t0 = time.perf_counter()
                outs.append(run())
                steps.append(list(trace))
                seconds = time.perf_counter() - t0
            diff = differing_layers(*outs)
            first = next((i for i, (a, b) in enumerate(zip(*steps))
                          if a != b), None)
            seedings = [i for i, (k, _) in enumerate(steps[0])
                        if k == "seeding"]
            where = "none"
            if first is not None:
                start = max(i for i in seedings if i <= first)
                where = (f"k-means run {seedings.index(start) + 1} of "
                         f"{len(seedings)}, {steps[0][first][0]} "
                         f"{first - start}")
            log(f"quantize repro {label}: {len(pq_leaves(outs[0]))} PQ "
                f"layers, {len(diff)} differ bit for bit (first "
                f"{diff[0] if diff else 'none'}); k-means steps "
                f"{len(steps[0])}, first that differs: {where}; "
                f"seconds a run={seconds:.2f} card={smi}")
    finally:
        kmeans._init_centroids, kmeans._refit = init, refit

    def logits(p, x):
        return network.forward(p, x, spec=spec, with_softmax=False,
                               device=dev).float()

    x_held = np.random.default_rng(2).standard_normal(
        (QUANT_HELD_OUT, *x_cal.shape[1:])).astype(np.float32)
    inputs = {"calibration": torch.from_numpy(x_cal).to(dev),
              "held-out": torch.from_numpy(x_held).to(dev)}
    want = {tag: logits(dense, x) for tag, x in inputs.items()}
    for seed in (0, 1, 2):
        for mode, kw in (("plain", {}), ("ec", {"x_calib": x_cal})):
            q = quantize_network(torch.Generator(device=dev).manual_seed(
                seed), spec, dense, seed=seed, **kw)
            log(f"quantize seeds alexnet {mode} seed={seed}: rel_l2 vs "
                "dense " + " ".join(
                    f"{tag}={rel_l2(logits(q, x), want[tag]):.6f}"
                    for tag, x in inputs.items()) + f" card={smi}")


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Chip smoke of the PyTorch + CUDA port on one card.")
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--only-fused", action="store_true",
                      help="stop after the build and the two decode-GEMMs")
    only.add_argument("--only-gather", action="store_true",
                      help="stop after the build and the two gathers "
                           "(pq_fc, pq_decode)")
    only.add_argument("--only-lut-lrn", action="store_true",
                      help="stop after the build, pq_lut_gather and "
                           "lrn_fused")
    only.add_argument("--only-int8", action="store_true",
                      help="stop after the build, the f32 conv check and "
                           "phase 8 (int8)")
    only.add_argument("--only-io", action="store_true",
                      help="stop after the build, the f32 conv check and "
                           "phase 9 (files to top-5)")
    only.add_argument("--only-vit", action="store_true",
                      help="stop after the build, the f32 checks and "
                           "phase 10 (ViT)")
    only.add_argument("--only-serve", action="store_true",
                      help="stop after the build and phase 11 (serving)")
    only.add_argument("--only-quantize", action="store_true",
                      help="stop after the build and phase 12 (the "
                           "quantizer and the A4 conv strategies)")
    only.add_argument("--only-profile", action="store_true",
                      help="stop after the build and phase 13 (the profile "
                           "command)")
    only.add_argument("--gather-times", action="store_true",
                      help="only time pq_fc, pq_decode, pq_lut_gather and "
                           "lrn_fused through the entry points every version "
                           "of the port has")
    only.add_argument("--quantize-repro", action="store_true",
                      help="only quantize AlexNet and ResNet-50 twice each "
                           "with one seed and name where the runs part")
    parser.add_argument("--root", default=None,
                        help="with --gather-times or --quantize-repro: the "
                             "checkout whose qcnn_tpu_torch runs (default: "
                             "this one)")
    args = parser.parse_args()
    t_script = time.perf_counter()
    if args.root and not (args.gather_times or args.quantize_repro):
        parser.error("--root goes with --gather-times or --quantize-repro")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(
        args.root or os.path.dirname(os.path.abspath(__file__))))

    # phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    if args.quantize_repro:
        quantize_repro(torch.device("cuda", 0), smi)
        return 0
    global time_ms, flush_buffer
    from qcnn_tpu_torch.models import resnet, synth, vit, zoo
    from qcnn_tpu_torch.ops import cuda as cuda_ops
    from qcnn_tpu_torch.ops.cuda import _build
    from qcnn_tpu_torch.utils.timing import flush_buffer, time_ms

    dev = torch.device("cuda", 0)
    gpu_name = torch.cuda.get_device_name(0)
    peaks = peaks_for(gpu_name)
    log(f"device {gpu_name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"peaks={peaks}")

    # phase 2: build
    path, build_s, build_log = _build.build()
    log(f"build {os.path.basename(path)} seconds={build_s:.2f}")
    log_ptxas(build_log)

    spec = zoo.alexnet()
    params = synth.random_pq_params(spec, seed=0)
    geo = alexnet_geometry(spec, params)
    flush = flush_buffer(dev)

    if args.gather_times:
        phase_gather_times(geo, spec, dev, flush)
        return 0
    if args.only_serve:
        del flush
        counts, _ = phase_serve(spec, params, synth.random_resnet_pq_params(
            resnet.resnet50(), seed=0), geo, dev, peaks, smi)
        log(json.dumps({"partial": "serve only", "launches": counts}))
        return 0
    if args.only_quantize:
        del flush
        counts, _ = phase_quantize(spec, params, dev, gpu_name)
        log(f"script seconds={time.perf_counter() - t_script:.2f}")
        log(json.dumps({"partial": "quantize only", "launches": counts}))
        return 0
    if args.only_profile:
        del flush
        counts = phase_profile(dev, smi)
        log(f"script seconds={time.perf_counter() - t_script:.2f}")
        log(json.dumps({"partial": "profile only", "launches": counts}))
        return 0
    check_f32_conv(dev)
    t0 = time.perf_counter()
    vparams = {model: synth.random_vit_pq_params(vit.VITS[model](), seed=0)
               for model in ("vit_b16", "vit_l16")}
    log(f"vit synthetic params seconds={time.perf_counter() - t0:.2f}")
    check_f32_vit_block(dev, vparams)
    if args.only_vit:
        counts = phase_vit(dev, gpu_name, vparams)
        log(json.dumps({"partial": "vit only", "launches": counts}))
        return 0
    if args.only_lut_lrn:
        rows = phase_kernels(geo, spec, dev, flush, peaks)
        rows |= phase_other_kernels(spec, geo, dev, flush, peaks)[0]
        log(f"launches since the last reset: {cuda_ops.launches()}")
        log(json.dumps({"partial": "pq_lut_gather and lrn_fused only",
                        "rows": rows}))
        return 0
    rparams = synth.random_resnet_pq_params(resnet.resnet50(), seed=0)
    if args.only_io:
        counts = phase_io(spec, params, rparams, dev, smi)
        log(json.dumps({"partial": "io only", "launches": counts}))
        return 0
    if args.only_int8:
        counts = phase_int8(spec, params, rparams, dev, peaks, gpu_name)
        log(json.dumps({"partial": "int8 only", "launches": counts}))
        return 0
    if args.only_gather:
        rows = phase_gather_kernels(spec, geo, rparams, vparams, dev, flush,
                                    peaks)
        log(json.dumps({"partial": "gather kernels only", "rows": rows}))
        return 0

    # phases 3-4: kernels vs plain versions, then timed; lrn_fused's and
    # the general kernels' own entry points
    rows, general_counts = phase_fused_kernels(spec, geo, rparams, vparams,
                                               dev, flush, peaks)
    if args.only_fused:
        log(json.dumps({"partial": "fused kernels only", "rows": rows}))
        return 0
    rows |= phase_gather_kernels(spec, geo, rparams, vparams, dev, flush,
                                 peaks)
    rows |= phase_kernels(geo, spec, dev, flush, peaks)
    new_rows, lrn_counts, more_general = phase_other_kernels(
        spec, geo, dev, flush, peaks)
    rows |= new_rows
    add_counts(general_counts, more_general)
    del flush

    # phases 5-7: the paths, end to end
    counts = phase_end_to_end(spec, params, dev, gpu_name)
    counts["resnet50 memory"] = phase_resnet(dev, gpu_name)
    # phase 8: int8
    counts["alexnet int8 memory"] = phase_int8(spec, params, rparams, dev,
                                               peaks, gpu_name)
    # phase 9: from files to top-5
    counts |= phase_io(spec, params, rparams, dev, smi)
    # phase 10: the ViT family
    counts |= phase_vit(dev, gpu_name, vparams)
    # phase 11: serving
    serve_counts, fc_err = phase_serve(spec, params, rparams, geo, dev,
                                       peaks, smi)
    counts |= serve_counts
    rows["pq_fc_fused"]["max_abs_err"] = max(
        rows["pq_fc_fused"]["max_abs_err"], fc_err)
    # phase 12: the quantizer and the A4 conv strategies
    quant_counts, family_pq = phase_quantize(spec, params, dev, gpu_name)
    counts |= quant_counts
    # phase 13: the profile command
    counts |= phase_profile(dev, smi, family_pq)
    counts["lrn_fused entry point"] = lrn_counts
    counts["general entry points"] = general_counts
    owners_of = {}
    for label, _, owned in PROFILE_RUNS:
        for name in owned:  # what phase 13 held each run to
            owners_of.setdefault(name, []).append(f"profile {label}")
    owners = {  # the paths that own each kernel
        "pq_decode": ("alexnet memory", "resnet50 memory",
                      "io alexnet classify", "io resnet50 family",
                      "vit_b16 memory", "vit_l16 memory",
                      "io vit_b16 family", "serve alexnet memory",
                      "serve resnet50 memory",
                      f"quantize alexnet memory B={QUANT_BATCH}",
                      "quantize alexnet memory B=1",
                      f"quantize {QUANT_FAMILY} memory", "a4 gemm",
                      "a4 memory", "a4 network memory"),
        "pq_lut_gather": ("alexnet memory", "alexnet int8 memory",
                          "io alexnet classify batch_hint=1",
                          "quantize alexnet memory B=1"),
        "pq_fc_fused": ("alexnet memory", "alexnet int8 memory",
                        "io alexnet classify", "io alexnet evaluate_dataset",
                        "vit_l16 memory", "serve alexnet memory",
                        f"quantize alexnet memory B={QUANT_BATCH}"),
        "lrn_fused": ("lrn_fused entry point",),
        "pq_conv_fused": ("resnet50 memory", "io resnet50 family",
                          "serve resnet50 memory",
                          f"quantize {QUANT_FAMILY} memory"),
        "pq_fc": ("alexnet pallas",),
        "pq_fc_fused_general": ("general entry points",),
        "pq_conv_fused_general": ("general entry points",),
        "pq_lut_gather_general": ("general entry points",),
        "lrn_fused_general": ("general entry points",),
    }
    launches = {}
    for name, paths in owners.items():
        paths = (*paths, *owners_of.get(name, ()))
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
        "pq_lut_gather_general": ("qcnn_tpu_torch/csrc/pq_lut_gather.cu",
                                  "qcnn_tpu/ops/pallas/pq_lut_gather.py:67"),
        "lrn_fused_general": ("qcnn_tpu_torch/csrc/lrn_fused.cu",
                              "qcnn_tpu/ops/pallas/lrn_fused.py:102"),
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
    log(f"script seconds={time.perf_counter() - t_script:.2f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import torch

    sys.exit(main())
