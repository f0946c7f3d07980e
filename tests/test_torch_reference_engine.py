"""The port's cross-engine parity harness
(``qcnn_tpu_torch/eval/reference_engine.py``) against the JAX package's
(``qcnn_tpu/eval/reference_engine.py``), on the CPU and without the
reference checkout: ``synthesize_live_pq_params`` gives the same codebooks
(within 1e-4 relative) and assignments from one seed and one calibration
image, ``prepare_synth_data_dir`` writes the same bytes and symlinks, and
``run_reference`` parses a stub binary's ``PARITY_IMG`` / ``PARITY_ROW``
lines as the JAX function does. The comparison with the reference binary
itself is ``tests/test_torch_reference_parity.py``."""

import os
import stat

import numpy as np
import pytest

from qcnn_tpu.eval import reference_engine as jref
from qcnn_tpu.models import zoo as jzoo
from qcnn_tpu_torch.eval import reference_engine as tref
from qcnn_tpu_torch.models import zoo as tzoo
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


def _calib(spec, seed=0):
    """One preprocessed-looking image: pixels less a mean, ~N(0, 50)."""
    return (50.0 * np.random.default_rng(seed).standard_normal(
        (1, spec.in_height, spec.in_width, spec.in_channels))).astype(
            np.float32)


@pytest.fixture(scope="module")
def live_alexnet():
    """Both packages' live params of full-width AlexNet (seed 7): batch-1
    prefix forwards, a few seconds on the CPU."""
    spec = tzoo.alexnet()
    calib = _calib(spec)
    return (tref.synthesize_live_pq_params(spec, calib, seed=7,
                                           device="cpu"),
            jref.synthesize_live_pq_params(jzoo.alexnet(), calib, seed=7))


def test_synthesize_live_pq_params_matches_jax(live_alexnet):
    got, want = live_alexnet
    assert len(got) == len(want)
    scaled = 0
    for p, q in zip(got, want):
        assert (p is None) == (q is None)
        if p is None:
            continue
        assert sorted(p) == sorted(q)
        np.testing.assert_array_equal(p["assignments"], q["assignments"])
        np.testing.assert_array_equal(p["bias"], q["bias"])
        assert p["codebooks"].dtype == q["codebooks"].dtype == np.float32
        rel = (np.abs(p["codebooks"] - q["codebooks"]).max()
               / np.abs(q["codebooks"]).max())
        assert rel <= 1e-4
        scaled += 1
    assert scaled == 8  # conv1-5, fc6-8


def test_live_params_keep_every_layer_at_the_target_scale(live_alexnet):
    """What the rescale is for: each quantized layer's pre-activation absmax
    on the calibration image is the target, 3.0 (within 1e-2: the bias is
    not scaled), so the logits neither explode nor go input-independent."""
    import dataclasses

    import torch

    from qcnn_tpu_torch.core import ConvSpec, FCSpec
    from qcnn_tpu_torch.models import network
    from qcnn_tpu_torch.models.prepare import prepare_params

    params, _ = live_alexnet
    spec = tzoo.alexnet()
    calib = _calib(spec)
    for i, layer in enumerate(spec.layers):
        if not isinstance(layer, (ConvSpec, FCSpec)):
            continue
        sub = dataclasses.replace(spec, layers=spec.layers[:i + 1])
        prep, ci, fi = prepare_params(sub, params[:i + 1],
                                      dtype=torch.float32, device="cpu")
        out = network.forward(prep, calib, spec=sub, conv_impls=ci,
                              fc_impls=fi, compute_dtype=torch.float32,
                              device="cpu")
        assert abs(float(out.abs().max()) - 3.0) < 1e-2, i
    other = _calib(spec, seed=1)
    prep, ci, fi = prepare_params(spec, params, dtype=torch.float32,
                                  device="cpu")
    probs = network.forward(prep, np.concatenate([calib, other]), spec=spec,
                            conv_impls=ci, fc_impls=fi, device="cpu")
    assert torch.isfinite(probs).all()
    assert float((probs[0] - probs[1]).abs().max()) > 1e-4


@pytest.mark.parametrize("model", ["alexnet", "vgg_cnn_s"])
def test_prepare_synth_data_dir_writes_the_same_files(tmp_path, model):
    spec = tzoo.get_model(model)
    from qcnn_tpu_torch.models import synth

    params = synth.random_pq_params(spec, seed=5)
    ref_dir = str(tmp_path / "reference")  # need not exist: symlinks only
    dirs = {}
    for name, mod, zoo in (("t", tref, tzoo), ("j", jref, jzoo)):
        dirs[name] = mod.prepare_synth_data_dir(
            zoo.get_model(model), params, "data_synth", model=model,
            scratch_dir=str(tmp_path / name), reference_dir=ref_dir)
    assert dirs["t"] == str(tmp_path / "t" / "data_synth")
    assert tref.synth_mean_path(dirs["t"], model).startswith(dirs["t"])

    def walk(root):
        out = {}
        for d, subdirs, files in os.walk(root):
            for n in subdirs + files:
                p = os.path.join(d, n)
                out[os.path.relpath(p, root)] = p
        return out

    t_files, j_files = walk(dirs["t"]), walk(dirs["j"])
    assert sorted(t_files) == sorted(j_files)
    links = 0
    for rel, tp in t_files.items():
        jp = j_files[rel]
        assert os.path.islink(tp) == os.path.islink(jp), rel
        if os.path.islink(tp):
            assert os.readlink(tp) == os.readlink(jp), rel
            assert os.readlink(tp).startswith(ref_dir)
            links += 1
        elif os.path.isfile(tp):
            with open(tp, "rb") as f, open(jp, "rb") as g:
                assert f.read() == g.read(), rel
    # Cls.Names always; the mean too, except vgg_cnn_s's (written)
    assert links == (1 if model == "vgg_cnn_s" else 2)
    # a second call keeps what is there
    again = tref.prepare_synth_data_dir(
        spec, params, "data_synth", model=model,
        scratch_dir=str(tmp_path / "t"), reference_dir=ref_dir)
    assert again == dirs["t"]


def test_tables_and_defaults_match():
    assert tref.MODEL_WIRING == jref.MODEL_WIRING
    assert tref._REF_SOURCES == jref._REF_SOURCES
    assert tref.REFERENCE_DIR == jref.REFERENCE_DIR
    assert tref.REPO_ROOT == jref.REPO_ROOT
    assert tref.SCRATCH_DIR == jref.SCRATCH_DIR == os.path.join(
        tref.REPO_ROOT, ".parity")
    assert tref.available(tref.REFERENCE_DIR) == jref.available(
        jref.REFERENCE_DIR)


def _stub(tmp_path, body: str) -> str:
    path = tmp_path / "stub_bin"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


STUB_OUT = (
    "echo loading\n"
    "echo 'PARITY_IMG /a/x.BMP'\n"
    "echo 'PARITY_ROW 0 7 0.75'\n"
    "echo 'PARITY_ROW 1 3 0.25'\n"
    "echo 'PARITY_IMG /a/y.BMP'\n"
    "echo 'PARITY_ROW 0 2 1.0'\n"
)


@pytest.mark.parametrize("mod", [tref, jref], ids=["port", "jax"])
def test_run_reference_parses_a_stub_binary(tmp_path, monkeypatch, mod):
    """run_reference on a stub that prints the driver's lines: the argv
    it builds, the parsed distributions, and its errors on a short result
    list and on a failed run (held alike in both packages)."""
    argv_file = tmp_path / "argv"
    binary = _stub(tmp_path, f'echo "$@" > {argv_file}\n' + STUB_OUT)
    monkeypatch.setattr(mod, "build_reference_binary", lambda *a: binary)
    data_dir = str(tmp_path / "data")
    res = mod.run_reference(["x.BMP", "y.BMP"], top_k=2, data_dir=data_dir,
                            model="caffenet")
    assert [r.bmp_path for r in res] == ["/a/x.BMP", "/a/y.BMP"]
    assert res[0].class_ids.tolist() == [7, 3]
    assert res[0].class_ids.dtype == np.int64
    np.testing.assert_array_equal(res[0].probs, [0.75, 0.25])
    assert res[1].class_ids.tolist() == [2] and res[1].probs.tolist() == [1.0]
    argv = argv_file.read_text().split()
    assert argv[:5] == ["caffenet", data_dir,
                        os.path.join(data_dir, "Cls.Names",
                                     "class_names.txt"),
                        os.path.join(data_dir, "Cls.Names",
                                     "image_labels.txt"), "2"]
    assert argv[5:] == [os.path.abspath("x.BMP"), os.path.abspath("y.BMP")]
    with pytest.raises(RuntimeError, match="parsed 2 results for 3 images"):
        mod.run_reference(["x.BMP", "y.BMP", "z.BMP"], data_dir=data_dir)
    broken = _stub(tmp_path, "echo oops >&2\nexit 3\n")
    monkeypatch.setattr(mod, "build_reference_binary", lambda *a: broken)
    with pytest.raises(RuntimeError, match=r"rc=3\):\noops"):
        mod.run_reference(["x.BMP"], data_dir=data_dir)


def test_build_reference_binary_is_cached_on_mtimes(tmp_path, monkeypatch):
    """No g++ runs when the binary is newer than every source."""
    import subprocess

    ref = tmp_path / "reference"
    (ref / "src").mkdir(parents=True)
    for name in tref._REF_SOURCES:
        (ref / "src" / name).write_text("")
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    binary = scratch / "parity_bin"
    binary.write_text("")
    driver = os.path.join(tref.REPO_ROOT, "tools", "parity_driver.cc")
    future = max(os.path.getmtime(driver),
                 os.path.getmtime(ref / "src" / "CaffeEva.cc")) + 1e6
    os.utime(binary, (future, future))
    calls = []
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: calls.append(a))
    assert tref.build_reference_binary(str(scratch), str(ref)) == str(binary)
    assert calls == []
    os.utime(binary, (0, 0))
    tref.build_reference_binary(str(scratch), str(ref))
    (cmd,), = calls
    assert cmd[:4] == ["g++", "-O2", "-std=c++11", "-w"]
    assert cmd[4] == f"-I{ref / 'include'}"
    assert cmd[-2:] == ["-o", str(binary)]
    assert cmd[-3] == driver


def test_synthesize_live_pq_params_needs_the_card_unless_asked(monkeypatch):
    """device=None means the card: without one it raises, naming the CPU
    way out, before any work."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tzoo.alexnet()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tref.synthesize_live_pq_params(spec, _calib(spec))
