"""BENCHMARK.json against the contract's shape, and the harness finding a
configuration, a traffic mix and a per-layer metric by name."""

from __future__ import annotations

import json
import os
import re

import torch

from bench_cuda import harness
from conftest import ROOT, TINY_CONFIGS, write_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LOAD_QUANTITIES = {
    "offline": {"images_per_s", "device_mb", "setup_s"},
}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_has_the_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench_cuda"]
    assert b["command"] == ["python3", "bench_cuda/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in b[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_cuda/")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", [w])
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mine = [m["name"] for m in b["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in b["per_layer"])


def test_every_name_in_benchmark_json_has_its_file():
    b = bench()
    for w in b["workloads"]:
        cell = harness.Cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert callable(cell.builder.make_weights)
        assert callable(cell.load.run)
        for m in cell.per_layer():
            assert callable(cell.reader(m["name"]).read)
        for m in cell.end_to_end():
            assert m["name"] in LOAD_QUANTITIES[cell.traffic["load"]]
    kernels = harness.trace_mod.kernel_table(
        os.path.join(ROOT, "bench_cuda"))
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    assert set(kernels) == set(cuda_ops.KERNELS)


def test_added_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A later change adds a configuration, a traffic mix and a per-layer
    metric as files of their own; the harness runs the new cell and reads
    the new metric without an edit to any file it had."""
    root = str(tmp_path)
    extra = [{"name": "steps.test", "unit": "steps", "better": "higher",
              "source": "program_counter", "layer": "model step",
              "moves": "images_per_s",
              "workloads": ["tiny-alexnet.offline-b4"]}]
    write_bench(root, {"tiny-alexnet": TINY_CONFIGS["tiny-alexnet"]},
                {"offline-b3": {"load": "offline", "batch": 3,
                                "pool_batches": 2}},
                [("tiny-alexnet", "offline-b3")], extra_layer=extra)
    # the metric's own reader, in a file of its own
    with open(os.path.join(root, "bench_cuda", "metrics",
                           "steps.test.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['images_per_s'] / 3\n")
    b = json.load(open(os.path.join(root, "BENCHMARK.json")))
    b["per_layer"][-1]["workloads"] = ["tiny-alexnet.offline-b3"]
    json.dump(b, open(os.path.join(root, "BENCHMARK.json"), "w"))
    r = harness.run_cell(root, "tiny-alexnet.offline-b3", 7, 0.3, True,
                         torch.device("cpu"), harness.now())
    assert r["correct"], r["checks"]
    assert r["metrics"]["steps.test"]["value"] > 0
    assert r["attempted"] % 3 == 0
    assert list(r)[-1] == "checks"
