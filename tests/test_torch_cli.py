"""The port's command-line entry points (cli.py, __main__.py) against the
JAX package's, on the CPU: both packages' ``main([...])`` run on the same
files in a tmp_path, a reference layout holding full-width AlexNet-PQ (the
JAX package's synthetic params, seed 0, written by its
save_reference_model, as tests/test_torch_harness.py does), a mean image,
class names, image labels, BMPs of mixed sizes and a small preprocessed
validation blob.

What is compared: classify's printed ids, names and ground truth equal and
its probabilities within 1e-4 (printed with four decimals); eval's
accuracy lines equal; import, export and convert write the same bytes (a
checkpoint's params.npz member by member: the zip container carries its
write time); calibrate's scales within 1e-5 relative (see
test_calibrate_matches_jax). The port runs with ``--device cpu``.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from qcnn_tpu import cli as jcli
from qcnn_tpu.models import synth as jsynth
from qcnn_tpu.models import zoo as jzoo
from qcnn_tpu.models.loader import save_reference_model
from qcnn_tpu_torch import cli as tcli
from qcnn_tpu_torch.formats import write_bin
from qcnn_tpu_torch.formats.checkpoint import (
    save_family_checkpoint,
    save_preprocessor,
)
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models import synth as tsynth
from qcnn_tpu_torch.preproc import TorchPreprocessor, encode_bmp24
from qcnn_tpu_torch.serve.engine import EngineConfig
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(256, 256), (181, 257), (333, 250)]
PREFIX = "bvlc_alexnet_aCaF"
ROWS = 4  # images in the validation blob


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("reference")
    rng = np.random.default_rng(0)
    save_reference_model(jzoo.alexnet(),
                         jsynth.random_pq_params(jzoo.alexnet(), seed=0),
                         str(d / "AlexNet" / "Bin.Files"), PREFIX)
    write_bin(d / "AlexNet" / "imagenet_mean.single.bin",
              rng.uniform(100, 130, (3, 256, 256)).astype(np.float32))
    (d / "Cls.Names").mkdir()
    (d / "Cls.Names" / "class_names.txt").write_text(
        "".join(f"class {i}\n" for i in range(1000)))
    (d / "Bmp.Files").mkdir()
    labels = []
    for i, (h, w) in enumerate(SIZES):
        stem = f"ILSVRC2012_val_{i + 1:08d}"
        (d / "Bmp.Files" / f"{stem}.BMP").write_bytes(encode_bmp24(
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
        labels.append(f"{stem}.JPEG {(37 * i) % 1000}\n")
    (d / "Cls.Names" / "image_labels.txt").write_text("".join(labels))
    blob = d / "ILSVRC12.227x227.IMG"
    blob.mkdir()
    # small enough that the random net's softmax does not saturate, so the
    # accuracy lines rank real probabilities
    write_bin(blob / "dataMatTst.single.bin",
              rng.standard_normal((ROWS, 3, 227, 227)).astype(np.float32)
              * 0.1)
    write_bin(blob / "lablVecTst.uint16.bin",
              rng.integers(0, 1000, ROWS).astype(np.uint16))
    return d


def _bmps(ref):
    return sorted(str(p) for p in (ref / "Bmp.Files").glob("*.BMP"))


def _run(main, argv, capsys):
    """(rc, stdout, stderr) of one package's main."""
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv, capsys, port_extra=("--device", "cpu")):
    """Both packages' stdout for the same argv (the port's with --device
    cpu); each must exit 0."""
    rc_t, out_t, err_t = _run(tcli.main, [*argv, *port_extra], capsys)
    rc_j, out_j, err_j = _run(jcli.main, list(argv), capsys)
    assert rc_t == 0, err_t
    assert rc_j == 0, err_j
    return out_t, out_j


PROB_LINE = re.compile(r"^  (\d\.\d{4})  +(\d+)  (.*)$")


def _same_classify_output(got, want):
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        mg, mw = PROB_LINE.match(g), PROB_LINE.match(w)
        if mw is None:
            assert g == w
            continue
        assert mg is not None, g
        assert mg.group(2, 3) == mw.group(2, 3)
        assert abs(float(mg.group(1)) - float(mw.group(1))) <= 1e-4 + 1e-9


@pytest.fixture(scope="module")
def checkpoint(ref, tmp_path_factory):
    """The reference layout imported into a self-contained checkpoint by
    the JAX package's CLI."""
    ck = str(tmp_path_factory.mktemp("ck") / "alexnet")
    assert jcli.main(["import", ck, "--weights-dir",
                      str(ref / "AlexNet" / "Bin.Files")]) == 0
    return ck


def test_classify_from_reference_matches_jax(ref, capsys):
    out_t, out_j = _both(["classify", *_bmps(ref)[:2],
                          "--reference-dir", str(ref)], capsys)
    assert "ground truth: class 37 (" in out_t
    _same_classify_output(out_t, out_j)


def test_classify_from_checkpoint_matches_jax(ref, checkpoint, capsys):
    for extra in ([], ["--memory-mode"]):
        out_t, out_j = _both(["classify", *_bmps(ref), "--checkpoint",
                              checkpoint, *extra], capsys)
        assert out_t.count("ILSVRC2012_val_") == len(SIZES)
        _same_classify_output(out_t, out_j)


def _accuracy_lines(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("ACCURACY@")]
    assert len(lines) == 5
    return lines


def test_eval_dataset_matches_jax(ref, capsys):
    out_t, out_j = _both(["eval", "--reference-dir", str(ref), "--batch",
                          "2", "--limit", str(ROWS)], capsys)
    assert _accuracy_lines(out_t) == _accuracy_lines(out_j)
    assert f"{ROWS} images" in out_t


def test_eval_images_from_checkpoint_matches_jax(ref, checkpoint, capsys):
    out_t, out_j = _both(["eval", "--checkpoint", checkpoint,
                          "--reference-dir", str(ref), "--memory-mode",
                          "--images", str(ref / "Bmp.Files" / "*.BMP"),
                          "--batch", "2"], capsys)
    assert _accuracy_lines(out_t) == _accuracy_lines(out_j)
    assert f"{len(SIZES)} images" in out_t


def _same_tree_bytes(d1, d2):
    names = sorted(os.listdir(d1))
    assert names == sorted(os.listdir(d2)) and names
    for name in names:
        p1, p2 = os.path.join(d1, name), os.path.join(d2, name)
        if name.endswith(".npz"):
            with zipfile.ZipFile(p1) as z1, zipfile.ZipFile(p2) as z2:
                assert z1.namelist() == z2.namelist()
                for member in z1.namelist():
                    assert z1.read(member) == z2.read(member), member
            continue
        with open(p1, "rb") as f1, open(p2, "rb") as f2:
            assert f1.read() == f2.read(), name


def test_import_writes_the_same_checkpoint(ref, checkpoint, tmp_path,
                                          capsys):
    ck = str(tmp_path / "port")
    rc, _, err = _run(tcli.main, ["import", ck, "--weights-dir",
                                  str(ref / "AlexNet" / "Bin.Files")], capsys)
    assert rc == 0, err
    assert "embedded preprocessing config" in err
    assert "embedded class names" in err
    _same_tree_bytes(ck, checkpoint)


@pytest.mark.parametrize("encoding", ["cbn", "bin"])
def test_export_writes_the_same_files(checkpoint, tmp_path, capsys,
                                      encoding):
    dirs = [str(tmp_path / pkg) for pkg in ("port", "jax")]
    for main, d in zip((tcli.main, jcli.main), dirs):
        rc, _, err = _run(main, ["export", checkpoint, d, "--prefix", "p",
                                 "--encoding", encoding], capsys)
        assert rc == 0, err
    assert len(os.listdir(dirs[0])) == 24
    _same_tree_bytes(*dirs)


def test_convert_writes_the_same_files(ref, tmp_path, capsys):
    src = str(ref / "AlexNet" / "Bin.Files" / f"{PREFIX}.asmtLst.01.cbn")
    for main, pkg in ((tcli.main, "port"), (jcli.main, "jax")):
        mid, back = str(tmp_path / f"{pkg}.bin"), str(tmp_path / f"{pkg}.cbn")
        assert _run(main, ["convert", src, mid], capsys)[0] == 0
        assert _run(main, ["convert", mid, back], capsys)[0] == 0
    for ext in ("bin", "cbn"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes())
    assert (tmp_path / "port.cbn").read_bytes() == open(src, "rb").read()


def test_calibrate_matches_jax(checkpoint, tmp_path, capsys):
    """One bf16 pass over 2 synthetic images in each package. Each scale is
    amax(|input|) of a layer over 127: conv1's is the input's own amax;
    later ones are bf16 values that both frameworks must round alike."""
    dirs = [str(tmp_path / pkg) for pkg in ("port", "jax")]
    for d in dirs:
        shutil.copytree(checkpoint, d)
    for main, d, extra in ((tcli.main, dirs[0], ["--device", "cpu"]),
                           (jcli.main, dirs[1], [])):
        rc, _, err = _run(main, ["calibrate", d, "--batch", "2", *extra],
                          capsys)
        assert rc == 0, err
    got, want = (json.load(open(os.path.join(d, "act_scales.json")))
                 for d in dirs)
    assert got.keys() == want.keys() and len(got) == 8
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k


# ---- serve's building blocks ------------------------------------------------


def _post_bmp(server, path):
    port = server.server_address[1]
    req = urllib.request.Request(f"http://127.0.0.1:{port}/classify",
                                 data=open(path, "rb").read(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _serve_one(engine, pre, names, bmp, http_serve):
    engine.start()
    server = http_serve(engine, port=0, block=False, preprocessor=pre,
                        class_names=names)
    try:
        return _post_bmp(server, bmp)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


def test_serve_linear_checkpoint_answers_a_bmp(ref, checkpoint):
    from qcnn_tpu_torch.serve.http import serve as http_serve

    config = EngineConfig(max_batch=2, max_wait_ms=2.0)
    engine, pre, names = tcli.linear_engine_from_checkpoint(
        checkpoint, config, conv_impl="memory", fc_impl="memory",
        device="cpu")
    assert pre is not None and pre.crop_h == 227 and len(names) == 1000
    assert engine.config is config
    out = _serve_one(engine, pre, names, _bmps(ref)[0], http_serve)
    assert len(out["class_ids"]) == 5
    assert out["class_names"] == [f"class {i}" for i in out["class_ids"]]


def test_serve_family_checkpoint_matches_jax(ref, tmp_path):
    """A ResNet tiny family checkpoint with its torch-style preprocessing
    and class names, served by both packages' builders: one BMP each."""
    from qcnn_tpu.serve.engine import EngineConfig as JConfig
    from qcnn_tpu.serve.http import serve as jserve
    from qcnn_tpu_torch.serve.http import serve as tserve

    spec = tresnet.ResNetSpec("rn-cli", (1,), (64,), num_classes=7,
                              in_size=16, bottleneck=False)
    ck = str(tmp_path / "family")
    save_family_checkpoint(ck, "resnet", spec,
                           tsynth.random_resnet_pq_params(spec, seed=3))
    save_preprocessor(ck, TorchPreprocessor.imagenet(crop=16, resize=20))
    with open(os.path.join(ck, "class_names.txt"), "w") as f:
        f.writelines(f"c{i}\n" for i in range(7))
    bmp = _bmps(ref)[1]
    got = _serve_one(*tcli.family_engine_from_checkpoint(
        ck, EngineConfig(max_batch=2), memory_mode=True, device="cpu"),
        bmp, tserve)
    want = _serve_one(*jcli.family_engine_from_checkpoint(
        ck, JConfig(max_batch=2), memory_mode=True), bmp, jserve)
    assert got["class_ids"] == want["class_ids"]
    assert got["class_names"] == want["class_names"]
    assert got["class_names"][0].startswith("c")
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0,
                               atol=1e-5)


# ---- what is not ported, and the entry point -------------------------------


@pytest.mark.parametrize("argv, item", [
    (["quantize", "a", "b"], "A11"),
    (["make-family", "resnet50", "out"], "A11"),
    (["serve", "--model", "resnet50", "--device", "cpu"], "A11"),
    (["profile", "--model", "resnet50"], "A13.1"),
])
def test_unported_subcommands_exit_nonzero_naming_the_item(argv, item,
                                                           monkeypatch):
    """Every subcommand is ported now: the quantizer's (A11) and the
    profiler's (A13.1). Without a card and without --device cpu they raise
    rather than run on the CPU, and serve --model <family> builds its
    weights with the family's quantize_params
    (tests/test_torch_sequential_quantize.py runs them,
    tests/test_torch_profiler.py runs profile)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if argv[0] != "serve":
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(argv)
        return

    class Reached(Exception):
        pass

    def reached(*args, **kwargs):
        raise Reached

    monkeypatch.setattr(tresnet, "quantize_params", reached)
    with pytest.raises(Reached):
        tcli.main(argv)


def test_help_in_a_fresh_interpreter_loads_no_jax():
    code = (
        "import json, sys\n"
        "from qcnn_tpu_torch.cli import main\n"
        "for argv in (['--help'], ['serve', '--help']):\n"
        "    try:\n"
        "        main(argv)\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded
                if m.split(".")[0] in ("jax", "jaxlib", "qcnn_tpu",
                                       "ml_dtypes")]
    assert "torch" not in loaded  # parsing the flags imports no model
    proc = subprocess.run([sys.executable, "-m", "qcnn_tpu_torch", "--help"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "usage: qcnn_tpu_torch" in proc.stdout
    for name in ("classify", "eval", "serve", "route", "quantize", "profile"):
        assert name in proc.stdout
