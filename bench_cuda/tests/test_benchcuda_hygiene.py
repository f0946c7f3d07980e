"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: the port, ``qcnn_tpu_torch``, begins with the JAX
package's name."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from bench_cuda import harness
from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "qcnn_tpu"}
BENCH = os.path.join(ROOT, "bench_cuda")


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(sub: str = "") -> list:
    return sorted(glob.glob(os.path.join(BENCH, sub, "**", "*.py"),
                            recursive=True))


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(
    p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = top_level_imports(path)
        assert "qcnn_tpu_torch" not in names, path
        assert names <= {"__future__", "math", "torch", "bench_cuda"}, path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "qcnn_tpu_torch_probe", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "qcnn_tpu.probe", sys)
    assert harness.forbidden_modules() == ["qcnn_tpu"]


def test_a_run_loads_no_jax(tiny_root):
    """A whole run of a cell in a fresh process, then the modules it
    holds."""
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from bench_cuda import harness as H\n"
        f"r = H.run_cell({tiny_root!r}, 'tiny-alexnet.offline-b4', 5, "
        "0.5, False, torch.device('cpu'), H.now())\n"
        "print(json.dumps([r['correct'], H.forbidden_modules(), "
        "'torch' in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, found, torch_loaded = json.loads(out.stdout.splitlines()[-1])
    assert correct and found == [] and torch_loaded


def test_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure it")
    out = subprocess.run(
        [sys.executable, "bench_cuda/run.py", "--workload",
         "alexnet-pq-mem.offline-b256", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_without_the_program_fails_and_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "bench_cuda",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "bench_cuda/run.py", "--workload",
         "alexnet-pq-mem.offline-b256", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    with open(tmp_path / "BENCHMARK.json") as f:
        assert json.load(f)["paths"] == ["bench_cuda"]
