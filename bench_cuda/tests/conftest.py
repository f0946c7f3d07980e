"""Tests of the benchmark harness, on the CPU at small sizes; tests marked
``card`` need an NVIDIA card and skip without one.

    python -m pytest bench_cuda/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# small configurations of the two builders, for runs on the CPU
TINY_CONFIGS = {
    "tiny-alexnet": {
        "name": "tiny-alexnet", "model": "alexnet", "builder": "alexnet_pq",
        "dtype": "float32", "input": [35, 35, 3],
        "layers": [
            {"type": "conv", "kernel": 5, "out": 16, "stride": 2, "pad": 0,
             "groups": 1},
            {"type": "relu"},
            {"type": "lrn", "size": 5, "alpha": 0.0001, "beta": 0.75,
             "k": 1.0},
            {"type": "pool", "kernel": 3, "stride": 2},
            {"type": "conv", "kernel": 3, "out": 32, "stride": 1, "pad": 1,
             "groups": 2},
            {"type": "relu"},
            {"type": "pool", "kernel": 3, "stride": 2},
            {"type": "fc", "out": 64}, {"type": "relu"},
            {"type": "dropout", "rate": 0.5},
            {"type": "fc", "out": 64}, {"type": "softmax"}],
        "pq": {"conv": {"K": 128, "D": 8, "scale": 0.05},
               "fc": {"K": 32, "D": 4, "scale": 0.02},
               "classifier": {"K": 16, "D": 1, "scale": 0.02},
               "bias_scale": 0.01},
        "reduced": [],
        "check": {"logp_err_median": 0.025, "logp_err_p99": 0.055}},
    "tiny-resnet": {
        "name": "tiny-resnet", "model": "resnet50", "builder": "resnet_pq",
        "dtype": "float32", "input": [32, 32, 3],
        "stem": {"kernel": 7, "stride": 2, "out": 64},
        "stage_depths": [1, 1], "stage_channels": [64, 128],
        "bottleneck_ratio": 4, "num_classes": 64,
        "pq": {"min_cin": 16, "conv": {"K": 128, "D": 4},
               "fc": {"K": 32, "D": 4}, "bias_scale": 0.01},
        "reduced": [],
        "check": {"logp_err_median": 0.012, "logp_err_p99": 0.02}},
}
TINY_TRAFFIC = {
    "offline-b4": {"load": "offline", "batch": 4, "pool_batches": 2},
}


def write_bench(root: str, configs: dict, traffic: dict, cells: list,
                extra_layer: list = ()) -> None:
    """A checkout in ``root``: a copy of bench_cuda with ``configs`` and
    ``traffic`` added, and a BENCHMARK.json naming ``cells`` [(config,
    traffic)] with the real benchmark's end-to-end and per-layer metrics in
    every cell, and ``extra_layer``."""
    bench_dir = os.path.join(root, "bench_cuda")
    shutil.copytree(os.path.join(ROOT, "bench_cuda"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cfg in configs.items():
        with open(os.path.join(bench_dir, "configs", name + ".json"),
                  "w") as f:
            json.dump(cfg, f)
    for name, tr in traffic.items():
        with open(os.path.join(bench_dir, "traffic", name + ".json"),
                  "w") as f:
            json.dump(tr, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    names = [f"{c}.{t}" for c, t in cells]
    bench["configs"] = [
        {"name": n, "source": "a test", "reduced": [], "why": "a test",
         "file": f"bench_cuda/configs/{n}.json"} for n in configs]
    bench["workloads"] = [
        {"name": f"{c}.{t}", "config": c, "traffic": t, "chips": 1,
         "why": "a test"} for c, t in cells]
    bench["end_to_end"] = [dict(m, workloads=names) if "workloads" in m
                           else m for m in bench["end_to_end"]]
    bench["per_layer"] = [dict(m, workloads=names)
                          for m in bench["per_layer"]] + list(extra_layer)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout with the tiny configurations, each under the tiny
    traffic."""
    cells = [(c, t) for c in TINY_CONFIGS for t in TINY_TRAFFIC]
    write_bench(str(tmp_path), TINY_CONFIGS, TINY_TRAFFIC, cells)
    return str(tmp_path)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs, never when
    a module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")
