"""The benchmark of qcnn_tpu_torch, the PyTorch and CUDA port, on NVIDIA
cards.

    python3 bench_cuda/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. It loads the cell (``BENCHMARK.json``),
sets it up, measures for ``--seconds`` and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; its last key, ``checks``, holds each
number compared with the reference beside its limit, and the last lines on
standard error repeat them. It exits with an error, and prints no result,
without a CUDA card, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), so that set-up
    counts the interpreter's own start."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    # the process's start on perf_counter's clock, read before any import
    # that takes time (torch takes seconds)
    t_start = time.perf_counter() - process_age_s()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    # set-up before the cell, in seconds from the process's start
    phases = [["interpreter", time.perf_counter() - t_start]]
    from bench_cuda import harness
    import torch

    phases.append(["torch imported", time.perf_counter() - t_start])
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the card and has no "
              "CPU fallback", file=sys.stderr)
        return 2
    chips = harness.Cell(ROOT, args.workload).workload["chips"]
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    phases.append(["card found", time.perf_counter() - t_start])
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              t_start, phases)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (JAX or the JAX "
              "package); no result", file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
