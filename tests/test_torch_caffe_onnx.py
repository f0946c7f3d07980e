"""The port's weight-file importers (formats/caffe_pb.py,
formats/onnx_import.py) and the quantize CLI on weight files, against the
JAX package's, on the CPU.

The files are the ones the JAX package's own tests write (its caffemodel
encoder, tests/test_onnx_import.py's hand-encoded ModelProto,
tests/test_torch_import.py's state_dicts): both packages must read the same
params from them bit for bit, and raise the same exception types on
malformed bytes. `quantize` on a .caffemodel, a .onnx and a .pth runs with
--device cpu and writes a PQ checkpoint the JAX package loads.
"""

import numpy as np
import pytest
import torch

from qcnn_tpu.formats import caffe_pb as jcaffe
from qcnn_tpu.formats import checkpoint as jckpt
from qcnn_tpu.formats import onnx_import as jonnx
from qcnn_tpu_torch import cli as tcli
from qcnn_tpu_torch.formats import caffe_pb as tcaffe
from qcnn_tpu_torch.formats import checkpoint as tckpt
from qcnn_tpu_torch.formats import onnx_import as tonnx
from qcnn_tpu_torch.models import network as tnet
from qcnn_tpu_torch.models import zoo as tzoo
from qcnn_tpu_torch.preproc import TorchPreprocessor
from tests.test_caffe_import import _tiny_net, _tiny_spec
from tests.test_onnx_import import _mk_onnx
from tests.test_torch_import import _mini_vgg_spec, _mk_linear_state_dict
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


def tspec_of(jspec):
    return tckpt.spec_from_dict(jckpt.spec_to_dict(jspec))


def same_params(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert sorted(g) == sorted(w)
        for key in g:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("v1", [False, True])
def test_caffemodel_reads_and_imports_as_jax(tmp_path, v1):
    net = _tiny_net(np.random.default_rng(2))
    path = tmp_path / "tiny.caffemodel"
    jcaffe.write_caffemodel(path, net, v1=v1)
    got, want = tcaffe.read_caffemodel(path), jcaffe.read_caffemodel(path)
    assert got.name == want.name
    assert [(l.name, l.type) for l in got.layers] == \
        [(l.name, l.type) for l in want.layers]
    for a, b in zip(got.layers, want.layers):
        for ba, bb in zip(a.blobs, b.blobs):
            np.testing.assert_array_equal(ba, bb)
    jspec = _tiny_spec()
    same_params(tcaffe.import_caffemodel(path, tspec_of(jspec)),
                jcaffe.import_caffemodel(path, jspec))


def test_port_writer_gives_the_jax_writers_bytes(tmp_path):
    net = _tiny_net(np.random.default_rng(3))
    for v1 in (False, True):
        tcaffe.write_caffemodel(tmp_path / "t", net, v1=v1)
        jcaffe.write_caffemodel(tmp_path / "j", net, v1=v1)
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


@pytest.mark.parametrize("case", ["wrong_kernel", "missing_layer",
                                  "truncated", "fixed32"])
def test_caffe_malformed_input_raises_as_jax(tmp_path, case):
    jspec = _tiny_spec()
    net = _tiny_net(np.random.default_rng(4))
    if case == "wrong_kernel":
        net.layers[1].blobs[0] = net.layers[1].blobs[0][:, :, :2, :2]
    elif case == "missing_layer":
        net.layers = net.layers[:-1]
    path = tmp_path / "bad.caffemodel"
    jcaffe.write_caffemodel(path, net)
    blob = path.read_bytes()
    if case == "truncated":
        blob = blob[: len(blob) // 2]
    elif case == "fixed32":
        blob = jcaffe._key(2, 5) + b"\x01\x02"
    errors = []
    for mod, spec in ((jcaffe, jspec), (tcaffe, tspec_of(jspec))):
        with pytest.raises(Exception) as info:
            mod.import_caffemodel(blob, spec)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] is ValueError


def test_onnx_reads_and_imports_as_jax():
    sd = _mk_linear_state_dict(np.random.default_rng(21))
    blob = _mk_onnx(sd)
    tn, ti = tonnx.read_onnx(blob)
    jn, ji = jonnx.read_onnx(blob)
    assert [(n.op_type, n.inputs, n.attrs) for n in tn] == \
        [(n.op_type, n.inputs, n.attrs) for n in jn]
    assert sorted(ti) == sorted(ji)
    for k in ti:
        np.testing.assert_array_equal(ti[k], ji[k])
    jspec = _mini_vgg_spec()
    same_params(tonnx.import_onnx(blob, tspec_of(jspec)),
                jonnx.import_onnx(blob, jspec))


@pytest.mark.parametrize("blob", [
    b"", b"\x08", b"\x3a\xff\xff\xff\xff\x7f", b"\x00" * 64,
    bytes(range(256)), "truncated", "packed_dims", "count",
])
def test_onnx_malformed_input_raises_as_jax(blob):
    jspec = _mini_vgg_spec()
    if blob == "truncated":
        full = _mk_onnx(_mk_linear_state_dict(np.random.default_rng(30)))
        blob = full[: len(full) // 3]
    elif blob == "packed_dims":
        graph = jcaffe._len_field(5, jcaffe._len_field(1, b"\x80"))
        blob = (jcaffe._key(1, 0) + jcaffe._write_varint(7)
                + jcaffe._len_field(7, graph))
    elif blob == "count":
        from qcnn_tpu.core import FCSpec, ModelSpec

        blob = _mk_onnx(_mk_linear_state_dict(np.random.default_rng(24)))
        jspec = ModelSpec(name="x", in_height=4, in_width=4, in_channels=3,
                          layers=(FCSpec(4),))
    errors = []
    for mod, spec in ((jonnx, jspec), (tonnx, tspec_of(jspec))):
        with pytest.raises(Exception) as info:
            mod.import_onnx(blob, spec)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] is ValueError


def _quantize(tmp_path, src, arch):
    out = str(tmp_path / "pq")
    assert tcli.main([
        "quantize", str(src), out, "--arch", arch, "--device", "cpu",
        "--conv-subvec-len", "4", "--conv-codewords", "8",
        "--fc-subvec-len", "4", "--fc-codewords", "8",
    ]) == 0
    spec_t, params_t = tckpt.load_checkpoint(out)
    spec_j, params_j = jckpt.load_checkpoint(out)
    assert tckpt.spec_to_dict(spec_t) == jckpt.spec_to_dict(spec_j)
    for pt, pj in zip(params_t, params_j):
        for key in pt or {}:
            np.testing.assert_array_equal(np.asarray(pt[key]),
                                          np.asarray(pj[key]))
    return out, spec_t, params_t


@pytest.mark.parametrize("fmt", ["onnx", "pth"])
def test_quantize_cli_from_torch_formats(tmp_path, monkeypatch, fmt):
    """quantize <mini.onnx | mini.pth> out --arch minivgg: a PQ checkpoint
    (read by the JAX package too) with the torch eval transform embedded,
    whose forward keeps the imported dense net's top-1 on most rows."""
    from qcnn_tpu_torch.models.torch_import import (
        linear_from_torch_state_dict,
    )

    tspec = tspec_of(_mini_vgg_spec())
    monkeypatch.setitem(tzoo.MODELS, "minivgg", lambda: tspec)
    sd = _mk_linear_state_dict(np.random.default_rng(23))
    src = tmp_path / f"mini.{fmt}"
    if fmt == "onnx":
        src.write_bytes(_mk_onnx(sd))
    else:
        torch.save(sd, src)
    out, spec, params = _quantize(tmp_path, src, "minivgg")
    assert spec.name == "MiniVGG"
    assert all("codebooks" in p for p in params if p is not None)
    pre = tckpt.load_preprocessor(out)
    assert isinstance(pre, TorchPreprocessor) and pre.crop == 16
    dense = linear_from_torch_state_dict(tspec, sd)
    x = np.random.default_rng(7).standard_normal(
        (16, 16, 16, 3)).astype(np.float32)
    ref = tnet.forward(dense, x, spec=tspec, device="cpu").numpy()
    got = tnet.forward(params, x, spec=tspec, device="cpu").numpy()
    assert np.isfinite(got).all()
    assert (ref.argmax(-1) == got.argmax(-1)).mean() >= 0.5


def test_quantize_cli_on_caffemodel(tmp_path, monkeypatch):
    """quantize tiny.caffemodel out --arch tiny: as the JAX package's
    test_quantize_cli_on_caffemodel, on the port (top-1 kept)."""
    tspec = tspec_of(_tiny_spec())
    monkeypatch.setitem(tzoo.MODELS, "tiny", lambda: tspec)
    net = _tiny_net(np.random.default_rng(6))
    for layer in net.layers:
        for i, b in enumerate(layer.blobs):
            layer.blobs[i] = (b * 0.05).astype(np.float32)
    src = tmp_path / "tiny.caffemodel"
    tcaffe.write_caffemodel(src, net)
    out = str(tmp_path / "pq")
    assert tcli.main([
        "quantize", str(src), out, "--arch", "tiny", "--cpu",
        "--conv-subvec-len", "2", "--conv-codewords", "16",
        "--fc-subvec-len", "2", "--fc-codewords", "32",
    ]) == 0
    spec, params = tckpt.load_checkpoint(out)
    assert spec.name == tspec.name
    x = (np.random.default_rng(7).standard_normal((2, 15, 15, 8)) * 0.1
         ).astype(np.float32)
    dense = tcaffe.import_caffemodel(src, tspec)
    ref = tnet.forward(dense, x, spec=tspec, device="cpu").numpy()
    got = tnet.forward(params, x, spec=tspec, device="cpu").numpy()
    assert np.argmax(got, -1).tolist() == np.argmax(ref, -1).tolist()


def test_weight_file_needs_arch(tmp_path, capsys):
    src = tmp_path / "w.onnx"
    src.write_bytes(b"")
    assert tcli.main(["quantize", str(src), str(tmp_path / "o"),
                      "--device", "cpu"]) == 2
    assert "--arch is required" in capsys.readouterr().err
