"""The benchmark's harness: finds a cell's configuration, traffic, load
kind, builder and per-layer metric readers by name, runs the cell, checks
what the timed path produced against the plain reference, and assembles
the result line.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name that ``BENCHMARK.json`` gives:

- ``configs/<config>.json`` (the path is the config entry's ``file``): the
  sizes, the dtype, the PQ geometry, the builder and the limit of the
  comparison;
- ``builders/<builder>.py``: makes the weights from the seed and the
  program's entry points;
- ``traffic/<traffic>.json``: the mix's parameters and its load kind;
- ``loads/<load>.py``: runs a load kind (set-up, window, traced slice);
- ``metrics/<metric>.py``: ``read(ctx)`` of one per-layer metric, None
  where it finds nothing to read;
- ``kernels/<kernel>.json``: the device-kernel names of a port kernel.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from bench_cuda import peaks as peaks_mod
from bench_cuda import trace as trace_mod

BENCH_DIR = "bench_cuda"
FORBIDDEN = ("jax", "jaxlib", "flax", "qcnn_tpu")
MIB = 1 << 20


NOT_FINITE = 1e9  # stands for inf in the result line, which is strict JSON


def finite(x: float) -> float:
    return float(x) if np.isfinite(x) else NOT_FINITE


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the benchmark's own, by its file path."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no file {path} for {name}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load:
    JAX, its libraries and the JAX package (compared whole, so that the
    port, ``qcnn_tpu_torch``, is not among them)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Cell:
    """One ``workloads`` entry with everything it names."""

    def __init__(self, root: str, workload: str):
        self.root = root
        self.bench_dir = os.path.join(root, BENCH_DIR)
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.workload = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(os.path.join(
            root, configs[self.workload["config"]]["file"]))
        self.traffic = load_json(os.path.join(
            self.bench_dir, "traffic", self.workload["traffic"] + ".json"))
        self.builder = load_module(
            os.path.join(self.bench_dir, "builders",
                         self.config["builder"] + ".py"),
            "bench_builder_" + self.config["builder"])
        self.load = load_module(
            os.path.join(self.bench_dir, "loads",
                         self.traffic["load"] + ".py"),
            "bench_load_" + self.traffic["load"])

    def _mine(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"] if self._mine(m)]

    def per_layer(self) -> list:
        return [m for m in self.bench["per_layer"] if self._mine(m)]

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        metric + ".py"),
                           "bench_metric_" + metric.replace(".", "_"))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


# --- the comparison that decides `correct` --------------------------------

def reference_logp(builder, cfg, weights, images, device,
                   block: int = 64) -> tuple:
    """The reference's log-probabilities (float64 on the host) and each
    row's logit standard deviation, for images (N, H, W, C) on the host or
    the device, in blocks of ``block`` rows."""
    logp, sigma = [], []
    for lo in range(0, images.shape[0], block):
        x = torch.as_tensor(images[lo:lo + block]).to(device)
        z = builder.reference_logits(cfg, weights, x).double().cpu()
        logp.append(torch.log_softmax(z, dim=1).numpy())
        sigma.append(z.std(dim=1).numpy())
    return np.concatenate(logp), np.concatenate(sigma)


def answer_errors(ids, probs, image, ref_logp, ref_sigma) -> np.ndarray:
    """Each answer's error: over its five classes (the program's top five),
    the largest |ln p(program) - ln p(reference)| of a class, in units of
    the reference's logit standard deviation on that image."""
    ids = np.asarray(ids, dtype=np.int64)
    image = np.asarray(image, dtype=np.int64)
    got = np.log(np.maximum(np.asarray(probs, dtype=np.float64),
                            np.finfo(np.float32).tiny))
    want = ref_logp[image[:, None], ids]
    return (np.abs(got - want) / ref_sigma[image][:, None]).max(axis=1)


def compare(ans: dict, ref_logp, ref_sigma) -> dict:
    """The numbers compared for a set of answers {"ids", "probs", "image"}:

    - ``logp_err_median`` and ``logp_err_p99``: the median and the 99th
      percentile of :func:`answer_errors`. The median holds the whole
      forward's precision; the 99th percentile a fault confined to a
      minority of the answers (one tile of a batch's rows, one step),
      which leaves the median where it was. Not the largest error, which
      swings from seed to seed (PERF.md gives the readings); 1e9 without
      an answer;
    - ``top1_outside_ref_top5``: answers whose first class is not among
      the reference's five best on that image. A wrong or altered answer
      shows here one by one: a sound bf16 answer's first class lies
      within the noise of the reference's first, far inside its five."""
    ids = np.asarray(ans["ids"], dtype=np.int64)
    image = np.asarray(ans["image"], dtype=np.int64)
    if ids.size == 0:
        return {"logp_err_median": NOT_FINITE, "logp_err_p99": NOT_FINITE,
                "top1_outside_ref_top5": 0}
    err = answer_errors(ids, ans["probs"], image, ref_logp, ref_sigma)
    ref5 = np.argsort(-ref_logp, axis=1, kind="stable")[:, :5]
    outside = ~(ref5[image] == ids[:, :1]).any(axis=1)
    return {"logp_err_median": finite(np.median(err)),
            "logp_err_p99": finite(np.percentile(err, 99)),
            "top1_outside_ref_top5": int(outside.sum())}


def top5(probs: np.ndarray) -> tuple:
    """(ids, probs) of each row's five largest, as ``Classifier`` and the
    server answer."""
    ids = np.argsort(-probs, axis=1, kind="stable")[:, :5]
    return ids, np.take_along_axis(probs, ids, axis=1)


# --- one run ----------------------------------------------------------------

def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             phases=(), entry: str = "offline_forward") -> dict:
    """Run one cell and return the result line's dict; its last key,
    ``checks``, holds each compared number beside its limit.

    t_start: the process's start on ``time.perf_counter``'s clock;
    phases: [phase, seconds from t_start] of set-up before this call;
    entry: the builder's function that makes the timed forward, which a
    control (``control.py``) replaces by one of its own."""
    cell = Cell(root, workload)
    ctx = {
        "cfg": cell.config, "traffic": cell.traffic,
        "builder": cell.builder, "seed": int(seed),
        "seconds": float(seconds), "trace": bool(trace), "device": device,
        "t_start": t_start, "entry": entry, "phases": list(phases),
        "kernel_table": trace_mod.kernel_table(cell.bench_dir),
    }
    mark(ctx, "cell files")
    out = cell.load.run(ctx)

    # the reference, once the program's state is freed
    logp, sigma = reference_logp(cell.builder, cell.config, out["weights"],
                                 out["ref_images"], device)
    got = compare(out["answers"], logp, sigma)
    limits = cell.config["check"]
    checks = {key: [got[key], float(limits[key])]
              for key in ("logp_err_median", "logp_err_p99")}
    checks["top1_outside_ref_top5"] = [got["top1_outside_ref_top5"], 0]
    checks["unanswered"] = [int(out["failed"]), 0]
    correct = bool(all(v <= lim for v, lim in checks.values())
                   and len(out["answers"]["ids"]) > 0)

    if device.type == "cuda":
        dev_info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(device),
                    "count": 1,
                    "memory_peak_bytes": int(out["memory_peak_bytes"])}
        name = dev_info["kind"]
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
        name = ""
    metrics = {}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if not trace:
        for m in cell.end_to_end():
            value = out["e2e"].get(m["name"])
            if value is None:
                raise RuntimeError(f"{workload}: the load reported no "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        tr = out["trace"]
        rctx = dict(out["layer"], trace=tr, peaks=peaks_mod.peaks_for(name),
                    builder=cell.builder, cfg=cell.config)
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = tr["busy_s"]
        dev_info["window_s"] = tr["window_s"]
    result["metrics"] = metrics
    result["device"] = dev_info
    if trace:
        result["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                               "idle_gaps": out["trace"]["idle_gaps"]}
        result["trace_launches"] = out["trace"]["launch_check"]
    if device.type == "cuda":
        result["card"] = power_limit()
    result.update(out.get("extra", {}))
    result["setup_phases"] = ctx.get("phases", [])
    result["checks"] = checks
    return result


def device_pool(gen: torch.Generator, n: int, batch: int, shape,
                device) -> torch.Tensor:
    """(n, batch, H, W, C) float32 images, N(0, 1), on the device."""
    return torch.randn((n, batch, *shape), generator=gen, device=device)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def process_peak(device) -> int:
    """The most bytes the process's tensors held on the device at once, from
    its start: through set-up, which runs every shape the window uses, and
    the window. (A peak reset at the window's start would follow the
    traffic: a served window's peak depends on whether a burst filled the
    largest bucket in it.)"""
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def free_program(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def launches() -> dict:
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    return cuda_ops.launches()


def counted(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def now() -> float:
    return time.perf_counter()


def mark(ctx: dict, phase: str) -> None:
    """Note when a phase of set-up ended, in seconds from the process's
    start (printed with the result as ``setup_phases``)."""
    ctx.setdefault("phases", []).append([phase, now() - ctx["t_start"]])
