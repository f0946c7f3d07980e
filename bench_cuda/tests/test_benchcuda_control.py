"""The controls of each configuration's comparison come out not correct:
the program's own int8 path, and the reference computed with fp8 operands,
each run in the program's place through the cell's window and comparison.
On the CPU at the configurations' own widths and a batch of four; on the
card (marked ``card``) at each cell's own size on three seeds."""

from __future__ import annotations

import json
import os

import pytest
import torch

from bench_cuda import control, harness
from conftest import ROOT, write_bench

CONFIGS = ("alexnet-pq-mem", "resnet50-pq-mem")


def load(name: str) -> dict:
    with open(os.path.join(ROOT, "bench_cuda", "configs",
                           name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", sorted(control.CONTROLS))
@pytest.mark.parametrize("name", CONFIGS)
def test_control_is_not_correct_on_the_cpu(tmp_path, name, kind):
    write_bench(str(tmp_path), {name: load(name)},
                {"offline-b4": {"load": "offline", "batch": 4,
                                "pool_batches": 1}},
                [(name, "offline-b4")])
    r = harness.run_cell(str(tmp_path), f"{name}.offline-b4", 2**31 + 21,
                         0.01, False, torch.device("cpu"), harness.now(),
                         entry=control.CONTROLS[kind])
    assert not r["correct"], r["checks"]


def cells() -> list:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("kind", sorted(control.CONTROLS))
@pytest.mark.parametrize("workload", cells())
def test_control_is_not_correct_on_the_card(card, workload, kind):
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        got = control.reading(workload, seed, 2.0, card,
                              control.CONTROLS[kind])
        assert not got["correct"], (seed, got)
