"""Port hygiene: the PyTorch port imports nothing of JAX, of the JAX package
or of ml_dtypes (checked in a fresh interpreter, since this test process
has already imported JAX), never builds a kernel at import, and never
falls back to the CPU silently."""

import ast
import json
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import qcnn_tpu_torch
from qcnn_tpu_torch import _device
from qcnn_tpu_torch.core import FCSpec, ModelSpec, SoftmaxSpec
from qcnn_tpu_torch.models import (
    calibrate,
    common,
    network,
    prepare,
    resnet,
    synth,
    vit,
)
from qcnn_tpu_torch.models.interop import (
    family_params_from_jax,
    params_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "qcnn_tpu", "ml_dtypes")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        qcnn_tpu_torch.__path__, "qcnn_tpu_torch."))


def test_port_modules_import_no_jax_in_a_fresh_interpreter():
    mods = _port_modules()
    for name in ("ops.cuda.pq_fc_fused", "ops.cuda.pq_conv_fused",
                 "ops.cuda.pq_fc", "ops.cuda.lrn_fused", "models.resnet",
                 "models.vit", "models.torch_import", "models.common",
                 "models.synth", "models.interop",
                 "models.calibrate", "models.loader", "native_build",
                 "formats.reference_codec", "formats.checkpoint",
                 "formats.native", "preproc.bmp", "preproc.pipeline",
                 "preproc.native", "utils.timing", "eval.harness"):
        assert f"qcnn_tpu_torch.{name}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, f"the port pulled in {bad}"


def _imports_of(path: str) -> list[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_no_forbidden_import_anywhere_in_the_sources():
    """Also catches imports inside functions, which importing alone would
    not run."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.dirname(qcnn_tpu_torch.__file__)):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        bad = [n for n in _imports_of(path) if _forbidden(n)]
        assert not bad, f"{path} imports {bad}"


def _strings_of(path: str) -> list[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)]


def test_no_string_names_a_jax_package_module():
    """A module path in a string (``importlib`` tables such as the
    checkpoint store's family specs) is an import the AST check above does
    not see; docstrings are held to the same rule."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.dirname(qcnn_tpu_torch.__file__)):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    pattern = re.compile(r"\b(qcnn_tpu|jax|ml_dtypes)\.[a-z_]")
    for path in paths:
        bad = [s for s in _strings_of(path) if pattern.search(s)]
        assert not bad, f"{path} names {bad}"


def test_import_builds_nothing():
    from qcnn_tpu_torch.ops.cuda import _build

    assert _build._library.cache_info().currsize == 0


def test_importing_every_module_starts_no_compiler():
    """In a fresh interpreter where starting a process raises: importing
    every module of the port compiles and loads no library (nvcc's or
    g++'s)."""
    code = (
        "import importlib, subprocess\n"
        "def refuse(*a, **k): raise AssertionError(f'started {a}')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "from qcnn_tpu_torch.formats import native as f\n"
        "from qcnn_tpu_torch.preproc import native as p\n"
        "from qcnn_tpu_torch.ops.cuda import _build\n"
        "assert f.LIBRARY._lib is None and p.LIBRARY._lib is None\n"
        "assert _build._library.cache_info().currsize == 0\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _device.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _device.resolve_device("cuda")
    assert _device.resolve_device("cpu") == torch.device("cpu")
    assert _device.default_dtype(torch.device("cpu")) == torch.float32
    assert _device.default_dtype(torch.device("cuda")) == torch.bfloat16


def test_entry_points_never_run_on_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ModelSpec(name="t", in_height=4, in_width=4, in_channels=2,
                     layers=(FCSpec(3), SoftmaxSpec()))
    params = synth.random_pq_params(spec, seed=0)
    x = synth.random_input(spec, 1, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare.prepare_params(spec, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        network.forward(params, x, spec=spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare.prepare_params(spec, params, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate.calibrate_act_scales(spec, params, x)
    prepared, conv_impls, fc_impls = prepare.prepare_params(
        spec, params, device="cpu")
    assert prepared[0]["weight"].dtype == torch.bfloat16  # the default
    out = network.forward(prepared, x, spec=spec, conv_impls=conv_impls,
                          fc_impls=fc_impls, device="cpu")
    assert out.shape == (1, 3) and np.allclose(out.sum().item(), 1.0)
    scales = calibrate.calibrate_act_scales(spec, params, x, device="cpu")
    prepared, conv_impls, fc_impls = prepare.prepare_params(
        spec, params, dtype=torch.int8, act_scales=scales, device="cpu")
    assert prepared[0]["weight_q"].dtype == torch.int8
    with pytest.raises(RuntimeError, match="device='cpu'"):
        network.forward(prepared, x, spec=spec, conv_impls=conv_impls,
                        fc_impls=fc_impls, compute_dtype=torch.bfloat16)
    out = network.forward(prepared, x, spec=spec, conv_impls=conv_impls,
                          fc_impls=fc_impls, compute_dtype=torch.bfloat16,
                          device="cpu")
    assert out.shape == (1, 3) and np.allclose(out.sum().item(), 1.0)


def test_family_entry_points_never_run_on_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = resnet.ResNetSpec("t", (1,), (64,), num_classes=3, in_size=16,
                             bottleneck=False)
    params = synth.random_resnet_pq_params(spec, seed=0)
    x = np.zeros((1, 16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet.prepare_params(spec, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.build_family_forward("resnet", spec, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.build_family_forward("resnet", spec, params,
                                    compute_dtype=torch.int8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        family_params_from_jax(params)
    prepared, fwd, act = common.build_family_forward("resnet", spec, params,
                                                     device="cpu")
    assert act == torch.float32  # f32 on the CPU
    assert prepared["s0b0"]["conv1"]["kernel"].dtype == torch.float32
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet.forward(prepared, x, spec=spec)
    out = fwd(prepared, x)
    assert out.shape == (1, 3) and np.allclose(out.sum().item(), 1.0)
    # the ViT family, the same way
    vspec = vit.ViTSpec("t", patch=8, image_size=16, dim=32, depth=1,
                        heads=2, num_classes=3)
    vparams = synth.random_vit_pq_params(vspec, seed=0)
    for memory in (False, True):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            vit.prepare_params(vspec, vparams, memory=memory)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            common.build_family_forward("vit", vspec, vparams,
                                        memory=memory)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.build_family_forward("vit", vspec, vparams,
                                    compute_dtype=torch.int8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        family_params_from_jax(vparams)
    prepared, fwd, act = common.build_family_forward("vit", vspec, vparams,
                                                     device="cpu")
    assert act == torch.float32
    assert prepared["blk0"]["qkv"]["weight"].dtype == torch.float32
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vit.forward(prepared, x, spec=vspec)
    out = fwd(prepared, x)
    assert out.shape == (1, 3) and np.allclose(out.sum().item(), 1.0)


def test_classifiers_never_run_on_the_cpu_unasked(monkeypatch, tmp_path):
    from qcnn_tpu_torch.eval import Classifier, FamilyClassifier
    from qcnn_tpu_torch.formats import write_bin
    from qcnn_tpu_torch.formats.checkpoint import (
        save_family_checkpoint,
        save_preprocessor,
    )
    from qcnn_tpu_torch.models import loader, zoo
    from qcnn_tpu_torch.preproc import TorchPreprocessor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ModelSpec(name="t", in_height=4, in_width=4, in_channels=3,
                     layers=(FCSpec(3), SoftmaxSpec()))
    pre = TorchPreprocessor.imagenet(crop=4, resize=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Classifier(spec, synth.random_pq_params(spec, seed=0), pre)
    d = tmp_path / "AlexNet"
    loader.save_reference_model(zoo.alexnet(),
                                synth.random_pq_params(zoo.alexnet(), seed=0),
                                str(d / "Bin.Files"), "bvlc_alexnet_aCaF")
    write_bin(d / "imagenet_mean.single.bin",
              np.zeros((3, 256, 256), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Classifier.from_reference("alexnet", str(tmp_path))
    rspec = resnet.ResNetSpec("t", (1,), (64,), num_classes=3, in_size=16,
                              bottleneck=False)
    rparams = synth.random_resnet_pq_params(rspec, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FamilyClassifier("resnet", rspec, rparams, pre)
    ck = str(tmp_path / "family")
    save_family_checkpoint(ck, "resnet", rspec, rparams)
    save_preprocessor(ck, pre)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FamilyClassifier.from_checkpoint(ck)
    clf = FamilyClassifier.from_checkpoint(ck, device="cpu")
    assert clf.device == torch.device("cpu")
    assert clf.params["fc"]["weight"].dtype == torch.float32
