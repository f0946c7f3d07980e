"""Continuous-batching inference engine, ported from ``qcnn_tpu/serve/engine.py``.

The reference processes one image per iteration in a synchronous loop
(CaffeEva.cc:167-210, kDataCntInBatch=1). The serving shape here is a
daemon that coalesces concurrent requests into device-sized batches:

- requests enqueue (image, Future) pairs from any thread;
- one dispatcher thread drains the queue, waiting at most ``max_wait_ms`` to
  fill up to ``max_batch``;
- batches are padded UP to a fixed bucket ladder (1, 8, 32, ..., max_batch)
  so only len(buckets) batch shapes ever run: ``warmup()`` builds the kernels
  and fills the kernel plan caches for each before the first request;
- with a mesh (``mesh=``, ``qcnn_tpu_torch.parallel``) one engine spans
  the ranks of a process group, one device each. The ranks run SPMD: every
  rank must enter the same collectives in the same order. So rank 0 runs
  the queue, the dispatcher and the compute thread, and broadcasts each
  assembled batch (its size first, then the tensor) before the sharded
  forward; every other rank calls :meth:`BatchingEngine.follow`, which
  receives each batch and runs the same forward. Warm-up goes through the
  same broadcast, and ``stop()`` on rank 0 releases the followers.

What the CUDA design changes against the JAX package's:

- Upload buffers. Each (bucket, slot) pair owns a pinned host tensor and a
  device tensor, both allocated once. The dispatcher thread copies the host
  batch to the device with ``non_blocking=True`` on an upload stream of its
  own and records an event; the compute thread makes its stream wait on
  that event before the forward. A slot is released only after the
  forward's result has reached the host, which synchronises the compute
  stream: by then neither buffer is read any more. Buffers allocated once
  keep the caching allocator out of the hand-over between the two streams
  (a tensor allocated on one stream and freed on another would need
  ``record_stream``).
- bf16 uploads. ``submit()`` converts the image on the caller's thread to a
  contiguous CPU tensor of the upload dtype (bf16 when the activations are
  bf16, else float32), so the assembly stripes copy same-dtype rows.
- Results. The forward's output becomes float32 on the device and then a
  NumPy array: each future resolves to a (num_classes,) float32 array.
- Thread-local state. The compute thread enters ``torch.inference_mode()``
  and makes its own stream current itself; kernels launch on the calling
  thread's current stream.

One change of order: a batch is counted in ``stats`` before its futures
resolve (the JAX engine counts it after), so a caller that holds its
answer also sees its batch counted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from qcnn_tpu_torch._device import default_dtype, resolve_device


@dataclasses.dataclass(frozen=True)
class _ShapeOnlySpec:
    """Minimal spec for from_forward engines (warmup/shape checks only)."""

    in_height: int
    in_width: int
    in_channels: int


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the bounded request queue is full.

    Backpressure contract: the caller sheds load (HTTP layer maps this to
    503) instead of queueing unboundedly — queue growth past what the
    device can drain only converts overload into timeout storms."""


class DeadlineExceeded(RuntimeError):
    """Set on a request future whose deadline passed before dispatch.

    Expired requests are dropped at pop time, so a backlog never spends
    device batches computing answers nobody is waiting for."""


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 64
    max_wait_ms: float = 2.0
    buckets: Optional[tuple[int, ...]] = None  # default: 1,8,32,...,max_batch
    with_softmax: bool = True
    max_queue: int = 0        # 0 = unbounded; else submit() raises
                              # EngineOverloaded when this many are pending
    deadline_ms: float = 0.0  # 0 = none; default per-request deadline
                              # (submit(deadline_ms=...) overrides)

    def bucket_ladder(self) -> tuple[int, ...]:
        if self.buckets:
            return tuple(sorted(self.buckets))
        ladder = [1]
        b = 8
        while b < self.max_batch:
            ladder.append(b)
            b *= 4
        ladder.append(self.max_batch)
        return tuple(sorted(set(ladder)))


def _upload_dtype_for(act_dtype) -> torch.dtype:
    """bf16 uploads for bf16 activations (the forward's first op is that
    cast, and it halves the host-to-device bytes), else float32."""
    return torch.bfloat16 if act_dtype == torch.bfloat16 else torch.float32


def _to_numpy_f32(out: torch.Tensor) -> np.ndarray:
    """A forward's (B, classes) output as a float32 NumPy array on the host
    (the float32 cast runs on the device: NumPy has no bf16)."""
    return out.float().cpu().numpy()


class BatchingEngine:
    """Coalesces classify requests into bucketed device batches."""

    @classmethod
    def from_forward(
        cls,
        forward_fn,
        params,
        input_shape: tuple[int, int, int],
        *,
        config: Optional[EngineConfig] = None,
        mesh=None,
        upload_dtype=None,
        device=None,
    ) -> "BatchingEngine":
        """Engine over an arbitrary forward(params, x_nhwc) — e.g. the
        ResNet/ViT families (``models.common.build_family_forward``), whose
        params are nested dicts rather than the linear ModelSpec list.
        ``params`` must already lie on ``device``.

        upload_dtype: the dtype batches are uploaded in (pass
        torch.bfloat16 when forward_fn casts to bf16 anyway: half the
        host-to-device bytes); default float32.
        device: None means "cuda" (raises without a card); pass "cpu" to
        serve with the plain versions.
        mesh: a (data, model) mesh (``parallel.make_mesh``): batches shard
        over ``data`` (``parallel.sharding.make_dp_forward``), ``params``
        whole on every rank; see the module docstring for the ranks' roles.
        """
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.spec = _ShapeOnlySpec(*input_shape)
        config = config if config is not None else EngineConfig()
        self.config = config
        self._buckets = config.bucket_ladder()
        self._upload_dtype = (torch.float32 if upload_dtype is None
                              else upload_dtype)
        self.params = params
        self._fwd = forward_fn
        if mesh is not None:
            from qcnn_tpu_torch.parallel.sharding import make_dp_forward

            self._fwd = make_dp_forward(forward_fn, mesh)
        self._init_runtime()
        self._init_mesh(mesh)
        return self

    def _init_runtime(self) -> None:
        self._queue: queue.Queue = queue.Queue(
            maxsize=self.config.max_queue or 0
        )
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"requests": 0, "batches": 0, "padded_waste": 0,
                      "rejected": 0, "expired": 0,
                      # cumulative per-stage wall time (ms): pop/slot_wait/
                      # assemble/upload accrue on the dispatcher thread,
                      # forward/resolve on the compute thread
                      "stage_ms": {"pop": 0.0, "slot_wait": 0.0,
                                   "assemble": 0.0, "upload": 0.0,
                                   "forward": 0.0, "resolve": 0.0}}
        self._latencies_ms: list[float] = []  # dispatch->result, recent
        # (bucket, rotation slot) -> host buffer (pinned on the card), and
        # its device twin; see _assemble / _BUF_ROT
        self._upload_bufs: dict[tuple[int, int], torch.Tensor] = {}
        self._device_bufs: dict[tuple[int, int], torch.Tensor] = {}
        self._buf_cycle = 0
        # assembly -> compute pipeline: the dispatcher thread pops,
        # assembles and uploads batch N+1 while the compute thread runs the
        # forward of batch N. _slots bounds LIVE batches to _BUF_ROT (one
        # computing + one assembling): the compute stage releases a slot
        # once a batch's result is on the host, when its buffers are
        # provably no longer read. Two is the least that keeps the overlap
        # (the JAX package measured more buffers slower: they thrash the
        # host cache).
        self._compute_q: queue.Queue = queue.Queue()
        self._slots = threading.BoundedSemaphore(self._BUF_ROT)
        self._compute_thread: Optional[threading.Thread] = None
        if self.device.type == "cuda":
            self._upload_stream = torch.cuda.Stream(self.device)
            self._compute_stream = torch.cuda.Stream(self.device)
        else:
            self._upload_stream = self._compute_stream = None
        # parallel batch assembly: the per-image copy into the upload
        # buffer stripes across a small pool. Batch FORMATION stays FIFO on
        # the single dispatcher thread; only the copy fans out (workers
        # write disjoint rows of the slot's own buffer, joined before the
        # upload). torch releases the GIL in copy_, so the stripes run on
        # real cores. Pool size: leave a core each for the dispatcher and
        # compute threads.
        self._asm_workers = max(1, min(8, (os.cpu_count() or 2) - 1))
        self._asm_pool = None  # built lazily on first striped assembly

    def __init__(
        self,
        spec,
        params: Sequence[Optional[dict]],
        *,
        config: Optional[EngineConfig] = None,
        mesh=None,
        compute_dtype=None,
        act_scales: Optional[dict] = None,
        conv_impl: str = "auto",
        fc_impl: str = "auto",
        device=None,
    ) -> None:
        """Engine over a linear ModelSpec: prepares ``params`` (raw PQ or
        dense) once, with the memory-mode strategies resolved for
        ``config.max_batch``.

        compute_dtype: None means bf16 on the card and float32 on the CPU
          (the JAX package picks bf16 on its accelerator); torch.int8
          selects int8 weights with bf16 activations.
        device: None means "cuda" (raises without a card); pass "cpu" to
          serve with the plain versions.
        mesh: a (data, model) mesh (``parallel.make_mesh``): the prepared
          params are cut by ``parallel.shard_params`` (column layout) and
          the forward is ``parallel.make_sharded_forward`` with the
          strategies resolved for ``config.max_batch``; see the module
          docstring for the ranks' roles.
        """
        from qcnn_tpu_torch.models.network import make_forward_fn
        from qcnn_tpu_torch.models.prepare import act_dtype_for, prepare_params

        self.device = resolve_device(device)
        self.spec = spec
        config = config if config is not None else EngineConfig()
        self.config = config
        self._buckets = config.bucket_ladder()
        if compute_dtype is None:
            compute_dtype = default_dtype(self.device)
        act_dtype = act_dtype_for(compute_dtype)
        self._upload_dtype = _upload_dtype_for(act_dtype)
        self.params, conv_impls, fc_impls = prepare_params(
            spec, params, dtype=compute_dtype, act_scales=act_scales,
            conv_impl=conv_impl, fc_impl=fc_impl,
            batch_hint=config.max_batch, device=self.device,
        )
        if mesh is not None:
            from qcnn_tpu_torch.parallel.sharding import (
                make_sharded_forward,
                shard_params,
            )

            self.params = shard_params(spec, self.params, mesh,
                                       device=self.device)
            # the RESOLVED strategies and activation dtype: re-resolving
            # 'auto' here would lose the memory-mode routes of max_batch
            self._fwd = make_sharded_forward(
                spec, mesh, with_softmax=config.with_softmax,
                conv_impls=conv_impls, fc_impls=fc_impls,
                compute_dtype=act_dtype, device=self.device)
        else:
            self._fwd = make_forward_fn(
                spec,
                conv_impls=conv_impls,
                fc_impls=fc_impls,
                compute_dtype=act_dtype,
                with_softmax=config.with_softmax,
                device=self.device,
            )
        self._init_runtime()
        self._init_mesh(mesh)

    # -- ranks of a mesh engine -------------------------------------------

    def _init_mesh(self, mesh) -> None:
        """Without a mesh, one process serves. With one, rank 0 leads:
        every forward it runs is preceded by a broadcast of the batch, which
        the followers run too (:meth:`follow`)."""
        self._mesh = mesh
        self._rank = 0
        self._released = False
        if mesh is None:
            return
        import torch.distributed as dist

        self._rank = dist.get_rank()
        # the batch size travels as a tensor: on the device under NCCL,
        # on the host under gloo
        self._header_device = (self.device if dist.get_backend() == "nccl"
                               else torch.device("cpu"))
        self._sharded_fwd = self._fwd
        self._fwd = self._lead

    def _broadcast_header(self, rows: int) -> int:
        import torch.distributed as dist

        header = torch.tensor([rows], dtype=torch.int64,
                              device=self._header_device)
        dist.broadcast(header, src=0)
        return int(header.item())

    def _lead(self, params, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's forward: the batch's size, the batch, then the sharded
        forward that every rank runs."""
        import torch.distributed as dist

        self._broadcast_header(x.shape[0])
        dist.broadcast(x.contiguous(), src=0)
        return self._sharded_fwd(params, x)

    def follow(self) -> int:
        """On a rank other than 0 of a mesh engine: receive each batch that
        rank 0 broadcasts and run the same forward, until rank 0's
        ``stop()``. Returns the number of forwards run."""
        if self._mesh is None or self._rank == 0:
            raise RuntimeError("follow() runs on the ranks other than 0 of "
                               "a mesh engine")
        import torch.distributed as dist

        shape = (self.spec.in_height, self.spec.in_width,
                 self.spec.in_channels)
        done = 0
        with self._compute_context():
            while True:
                rows = self._broadcast_header(0)
                if rows == 0:
                    return done
                x = torch.empty((rows, *shape), dtype=self._upload_dtype,
                                device=self.device)
                dist.broadcast(x, src=0)
                self._sharded_fwd(self.params, x)
                done += 1

    def _release_followers(self) -> None:
        """Rank 0: a batch size of 0 ends every follower's loop."""
        if self._mesh is not None and self._rank == 0 and not self._released:
            self._released = True
            self._broadcast_header(0)

    def latency_percentiles(self) -> dict:
        """Per-batch COMPUTE-stage latency (forward + result resolution).
        The host-to-device upload runs in the assembly stage and is NOT in
        these numbers; end-to-end request latency is the HTTP layer's to
        measure."""
        if not self._latencies_ms:
            return {}
        arr = np.asarray(self._latencies_ms[-1000:])
        return {
            "p50_ms": round(float(np.percentile(arr, 50)), 3),
            "p95_ms": round(float(np.percentile(arr, 95)), 3),
            "p99_ms": round(float(np.percentile(arr, 99)), 3),
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BatchingEngine":
        if self._rank != 0:
            raise RuntimeError(f"rank {self._rank} of a mesh engine follows "
                               f"rank 0: call follow()")
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="qcnn-dispatch", daemon=True
        )
        self._compute_thread = threading.Thread(
            target=self._compute_loop, name="qcnn-compute", daemon=True
        )
        self._compute_thread.start()
        self._thread.start()
        return self

    def _fail_compute_queue(self) -> None:
        """Fail every batch still in the compute queue."""
        while True:
            try:
                item = self._compute_q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            for fut in item[2]:
                if not fut.done():
                    fut.set_exception(RuntimeError("engine stopped"))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._compute_thread is not None:
            # sentinel AFTER the dispatcher joined: already-uploaded
            # batches complete (the device work is paid), then exit
            try:
                self._compute_q.put(None, timeout=60)
            except queue.Full:
                pass  # compute stage wedged; it is a daemon thread
            self._compute_thread.join(timeout=60)
            if not self._compute_thread.is_alive():
                # fail anything still in the pipeline so callers don't
                # hang for their full classify() timeout
                self._fail_compute_queue()
        # Requests enqueued just before stop would otherwise hang their
        # callers until the full classify() timeout.
        self._drain_stopped()
        # final sweep: a dispatcher that survived its join timeout (e.g.
        # stuck in a slow upload) may have enqueued one more batch after
        # the compute-queue drain above — fail it rather than orphan it
        # (the dispatcher also checks compute-thread liveness before
        # putting; together these close the stop() race)
        self._fail_compute_queue()
        if self._compute_thread is None or not self._compute_thread.is_alive():
            # no forward can be in flight: the followers' collectives end
            self._release_followers()
        if self._asm_pool is not None:
            self._asm_pool.shutdown(wait=False)
            self._asm_pool = None

    def _drain_stopped(self) -> None:
        while True:
            try:
                _, fut, _ = self._queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("engine stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API --------------------------------------------------------

    def _as_row(self, image_nhwc) -> torch.Tensor:
        """One image as a contiguous CPU tensor of the upload dtype (on the
        caller's thread, so the conversion parallelises with the clients).
        float32 first: a float64 image rounds once, as float32 then."""
        a = np.asarray(image_nhwc)
        if a.dtype != np.float32 or not (a.flags.c_contiguous
                                         and a.flags.writeable):
            a = np.array(a, np.float32, order="C")
        row = torch.from_numpy(a)
        if self._upload_dtype != torch.float32:
            row = row.to(self._upload_dtype)
        return row

    def submit(
        self,
        image_nhwc: np.ndarray,
        *,
        deadline_ms: Optional[float] = None,
    ) -> Future:
        """Enqueue one (H, W, C) image; resolves to a (num_classes,) float32
        probs vector. Raises EngineOverloaded when the bounded queue is
        full; the future fails with DeadlineExceeded if `deadline_ms`
        (default: config.deadline_ms) passes before dispatch."""
        if image_nhwc.ndim != 3:
            raise ValueError(f"expected HWC image, got {image_nhwc.shape}")
        want = (self.spec.in_height, self.spec.in_width,
                self.spec.in_channels)
        if tuple(image_nhwc.shape) != want:
            # reject HERE, not in the dispatcher: a mis-shaped image inside
            # a batch would raise in the row copy and kill the dispatch
            # thread (one bad request = total engine DoS)
            raise ValueError(
                f"expected image shape {want}, got {tuple(image_nhwc.shape)}"
            )
        if self._stop.is_set():
            raise RuntimeError("engine is stopped")
        if deadline_ms is None:
            deadline_ms = self.config.deadline_ms
        expiry = (
            time.perf_counter() + deadline_ms / 1e3 if deadline_ms else None
        )
        fut: Future = Future()
        try:
            self._queue.put_nowait((self._as_row(image_nhwc), fut, expiry))
        except queue.Full:
            with self._stats_lock:
                # submit() runs on many HTTP threads concurrently; an
                # unguarded += loses counts exactly when overload makes
                # 'rejected' matter. The other counters are single-writer
                # (dispatcher or compute thread).
                self.stats["rejected"] += 1
            raise EngineOverloaded(
                f"request queue full ({self.config.max_queue} pending)"
            ) from None
        if self._stop.is_set():
            # stop() may have drained the queue between our check above and
            # the put: fail anything still queued so no caller hangs for
            # its full timeout
            self._drain_stopped()
        return fut

    def classify(self, image_nhwc: np.ndarray, timeout: float = 600.0,
                 *, deadline_ms: Optional[float] = None):
        return self.submit(image_nhwc, deadline_ms=deadline_ms).result(
            timeout=timeout
        )

    def _compute_context(self):
        """What the compute stage runs under: inference mode (grad mode is
        thread-local) and, on the card, its own stream as the current one."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self._compute_stream is not None:
            stack.enter_context(torch.cuda.stream(self._compute_stream))
        return stack

    def warmup(self) -> dict[int, float]:
        """Run one forward per bucket, in the upload dtype, before the first
        request: the first launch builds the kernels and each bucket fills
        the kernel plan caches for its shapes. Returns {bucket: ms}."""
        h, w, c = self.spec.in_height, self.spec.in_width, self.spec.in_channels
        times = {}
        with self._compute_context():
            for b in self._buckets:
                t0 = time.perf_counter()
                x = torch.zeros((b, h, w, c), dtype=self._upload_dtype,
                                device=self.device)
                _to_numpy_f32(self._fwd(self.params, x))
                times[b] = (time.perf_counter() - t0) * 1e3
        return times

    # -- dispatcher --------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _pop_live(self, timeout: float):
        """Pop the next request whose deadline has not passed; expired ones
        fail with DeadlineExceeded instead of wasting a batch slot.

        Fast path: drain with get_nowait while the queue is non-empty —
        under load the backlog is deep, and the timed get's lock + clock
        bookkeeping per request is measurable."""
        t_end = None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                if t_end is None:
                    t_end = time.perf_counter() + timeout
                remaining = t_end - time.perf_counter()
                if remaining <= 0:
                    raise
                item = self._queue.get(timeout=remaining)
            expiry = item[2]
            if expiry is not None and time.perf_counter() > expiry:
                self.stats["expired"] += 1
                if not item[1].done():
                    item[1].set_exception(
                        DeadlineExceeded("deadline passed before dispatch")
                    )
                continue
            return item

    # distinct upload buffers per bucket: a buffer may only be reused once
    # its batch's forward has finished and its result reached the host.
    # _slots in _init_runtime caps live batches at _BUF_ROT; a slot is
    # released only after that, and consecutive batches alternate slots,
    # so slot k's buffers are never overwritten while still read.
    _BUF_ROT = 2

    def _assemble(self, batch):
        """Single-pass batch assembly into a ROTATED per-bucket upload
        buffer: each image is written exactly once, pad rows zeroed in
        place. Returns (host buffer, rows, bucket, buffer key)."""
        n = len(batch)
        bucket = self._bucket_for(n)
        self._buf_cycle += 1
        key = (bucket, self._buf_cycle % self._BUF_ROT)
        buf = self._upload_bufs.get(key)
        if buf is None:
            buf = torch.empty(
                (bucket, self.spec.in_height, self.spec.in_width,
                 self.spec.in_channels),
                dtype=self._upload_dtype,
                pin_memory=self.device.type == "cuda",
            )
            self._upload_bufs[key] = buf
        # striped parallel copy: worker w owns rows [lo, hi) — disjoint
        # writes, joined below, so the slot buffer is fully written before
        # the upload reads it. Capture the pool ONCE and fall back to the
        # serial copy if it is gone or shut down: stop() can shut the pool
        # down while a dispatcher stuck in a long upload is still alive,
        # and lazily rebuilding after stop would leak worker threads.
        pool = self._asm_pool
        if (pool is None and n >= 2 * self._asm_workers > 2
                and not self._stop.is_set()):
            from concurrent.futures import ThreadPoolExecutor

            pool = self._asm_pool = ThreadPoolExecutor(
                max_workers=self._asm_workers,
                thread_name_prefix="qcnn-asm",
            )

        def copy_rows(lo: int, hi: int) -> None:
            # submit() guarantees contiguous rows of the buffer's dtype:
            # copy_ is a memcpy
            for i in range(lo, hi):
                buf[i].copy_(batch[i][0])

        stripes = None
        if pool is not None and n >= 2 * self._asm_workers > 2:
            chunk = -(-n // self._asm_workers)
            try:
                stripes = [
                    pool.submit(copy_rows, lo, min(lo + chunk, n))
                    for lo in range(0, n, chunk)
                ]
            except RuntimeError:  # pool shut down mid-batch: go serial
                stripes = None
        if stripes is not None:
            for st in stripes:
                st.result()  # join + re-raise worker exceptions
        else:
            copy_rows(0, n)
        if bucket > n:
            # stale rows from a previous, fuller batch must not leak into
            # this dispatch (padding rows are sliced off the results, but
            # keep them zero so padded compute is deterministic)
            buf[n:].zero_()
        return buf, n, bucket, key

    def _to_device(self, images: torch.Tensor, key):
        """Host batch -> (device batch, event the compute stream waits on;
        None on the CPU). The upload: a non-blocking copy from pinned
        memory into the slot's preallocated device buffer, on the upload
        stream. A seam for harnesses that isolate the engine machinery
        from the upload."""
        if self.device.type != "cuda":
            return images, None
        dev = self._device_bufs.get(key)
        if dev is None:
            dev = torch.empty(images.shape, dtype=images.dtype,
                              device=self.device)
            self._device_bufs[key] = dev
        with torch.cuda.stream(self._upload_stream):
            dev.copy_(images, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._upload_stream)
        return dev, ready

    def _dispatch_loop(self) -> None:
        cfg = self.config
        stage = self.stats["stage_ms"]
        while not self._stop.is_set():
            try:
                first = self._pop_live(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = cfg.max_wait_ms / 1e3
            t0 = time.perf_counter()
            # never exceed the largest bucket: with user-supplied buckets
            # below max_batch, an oversized batch would ship UNPADDED at an
            # arbitrary (never-warmed) shape
            max_n = min(cfg.max_batch, self._buckets[-1])
            while len(batch) < max_n:
                remaining = deadline - (time.perf_counter() - t0)
                if remaining <= 0:
                    break
                try:
                    batch.append(self._pop_live(timeout=remaining))
                except queue.Empty:
                    break
            # claim each future (RUNNING state): client-side fut.cancel()
            # is honoured here, and a claimed future can no longer be
            # cancelled — so set_result below cannot raise InvalidStateError
            # (which would poison the rest of the batch via the except arm)
            batch = [b for b in batch if b[1].set_running_or_notify_cancel()]
            if not batch:
                continue
            t_claim = time.perf_counter()
            stage["pop"] += (t_claim - t0) * 1e3
            # abortable slot acquire (the pipeline-depth bound; released by
            # the compute stage after the forward): a wedged compute stage
            # must not leave the dispatcher, and therefore stop(), blocked
            # forever; on stop, fail this batch's callers instead of
            # hanging them
            while not self._slots.acquire(timeout=0.1):
                if self._stop.is_set():
                    for _, fut, _ in batch:
                        if not fut.done():
                            fut.set_exception(RuntimeError("engine stopped"))
                    batch = None
                    break
            t_pop = time.perf_counter()
            # the back-pressure wait is its OWN stage: folded into 'pop' it
            # would mis-name the bind whenever compute is the bottleneck
            stage["slot_wait"] += (t_pop - t_claim) * 1e3
            if batch is None:
                continue
            futures = [b[1] for b in batch]
            try:
                images, n, bucket, key = self._assemble(batch)
                t_asm = time.perf_counter()
                stage["assemble"] += (t_asm - t_pop) * 1e3
                # the upload happens HERE, on the assembly thread, so it
                # overlaps the compute thread's forward of the previous
                # batch
                dev_images, ready = self._to_device(images, key)
            except Exception as e:  # noqa: BLE001 - propagate to callers
                self._slots.release()
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            stage["upload"] += (time.perf_counter() - t_asm) * 1e3
            if (self._stop.is_set()
                    and self._compute_thread is not None
                    and not self._compute_thread.is_alive()):
                # stop() already joined/drained the compute stage while we
                # were stuck in a slow upload: putting now would orphan the
                # batch in a queue nobody reads and hang each caller for
                # its full classify() timeout
                self._slots.release()
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(RuntimeError("engine stopped"))
                continue
            self._compute_q.put((dev_images, ready, futures, n, bucket))

    def _compute_loop(self) -> None:
        """Second pipeline stage: run the forward on pre-uploaded batches
        and resolve futures. Exits on the stop() sentinel so batches that
        were already assembled/uploaded still complete."""
        with self._compute_context():
            while True:
                item = self._compute_q.get()
                if item is None:
                    return
                self._compute_one(*item)

    def _compute_one(self, dev_images, ready, futures, n: int,
                     bucket: int) -> None:
        stage = self.stats["stage_ms"]
        t_dispatch = time.perf_counter()
        error = None
        try:
            if ready is not None:
                torch.cuda.current_stream().wait_event(ready)
            probs = _to_numpy_f32(self._fwd(self.params, dev_images))
        except Exception as e:  # noqa: BLE001 - propagate to callers
            error = e
        finally:
            # the result is on the host (or the forward failed): the slot's
            # buffers are no longer read; hand the slot back to the
            # assembler (a leaked slot would stall the pipeline)
            del dev_images
            self._slots.release()
        t_fwd = time.perf_counter()
        # the batch is counted before any of its futures resolves, so a
        # caller that holds its answer also sees its batch in the stats
        self.stats["requests"] += n
        self.stats["batches"] += 1
        self.stats["padded_waste"] += bucket - n
        try:
            if error is not None:
                raise error
            stage["forward"] += (t_fwd - t_dispatch) * 1e3
            for i, fut in enumerate(futures):
                fut.set_result(probs[i])
            stage["resolve"] += (time.perf_counter() - t_fwd) * 1e3
        except Exception as e:  # noqa: BLE001 - propagate to callers
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)
        self._latencies_ms.append((time.perf_counter() - t_dispatch) * 1e3)
        if len(self._latencies_ms) > 4000:
            del self._latencies_ms[:2000]
