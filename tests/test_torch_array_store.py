"""The port's second array store, ``store="dcp"`` (``params_dcp/``, written
with ``torch.distributed.checkpoint``), on the CPU: linear and family
checkpoints round-trip with their dtypes, a dcp load gives what a
JAX-written npz checkpoint of the same params gives, re-saving with the
other store removes the stale one (as ``tests/test_checkpoint.py`` holds for
the JAX package's pair), an Orbax store written by the JAX package raises a
message that names ``--store npz``, and the CLI saves with ``--store dcp``.
On 2 gloo ranks (``tests/torch_parallel_worker.py``'s store suite) every
rank saves one dcp checkpoint and every rank loads the same arrays; the
4-rank case is in ``tests/test_torch_parallel.py``."""

import json
import os

import numpy as np
import pytest

import qcnn_tpu.core as jcore
import qcnn_tpu_torch.core as tcore
from qcnn_tpu.formats import checkpoint as jckpt
from qcnn_tpu.models import resnet as jresnet
from qcnn_tpu.models import vit as jvit
from qcnn_tpu_torch import cli as tcli
from qcnn_tpu_torch.eval import Classifier
from qcnn_tpu_torch.formats import checkpoint as tckpt
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models import synth as tsynth
from qcnn_tpu_torch.models import vit as tvit
from qcnn_tpu_torch.models import zoo as tzoo
from qcnn_tpu_torch.preproc import TorchPreprocessor
from tests import torch_parallel_worker as W
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


def _spec(core):
    """A grouped strided conv, an LRN with a channel map, two PQ FCs."""
    return core.ModelSpec(
        name="store", in_height=15, in_width=15, in_channels=8,
        layers=(core.ConvSpec(kernel=3, out_channels=32, pad=1, groups=2,
                              stride=2),
                core.ReLUSpec(),
                core.LRNSpec(5, 1e-4, 0.75, 1.0, channel_map=(0, 1, 2)),
                core.PoolSpec(kernel=3, stride=2),
                core.FCSpec(64), core.ReLUSpec(), core.DropoutSpec(0.5),
                core.FCSpec(16), core.SoftmaxSpec()))


def _params(kind):
    if kind == "dense":
        return tsynth.random_dense_params(_spec(tcore), seed=2)
    params = tsynth.random_pq_params(_spec(tcore), seed=2)
    if kind == "opq":
        params[4] = dict(params[4], perm=np.random.default_rng(0)
                         .permutation(512).astype(np.int32))
    return params


def _same_params(a, b):
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        assert (pa is None) == (pb is None)
        if pa is None:
            continue
        assert sorted(pa) == sorted(pb)
        for k in pa:
            x, y = np.asarray(pa[k]), np.asarray(pb[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
        return
    x, y = np.asarray(a), np.asarray(b)
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(x, y)


def _manifest(path):
    return json.loads((path / "manifest.json").read_text())


@pytest.mark.parametrize("kind", ["pq", "dense", "opq"])
def test_dcp_round_trips_a_linear_checkpoint(tmp_path, kind):
    params = _params(kind)
    npz, dcp = tmp_path / "npz", tmp_path / "dcp"
    tckpt.save_checkpoint(str(npz), _spec(tcore), params)
    tckpt.save_checkpoint(str(dcp), _spec(tcore), params, store="dcp")
    assert sorted(os.listdir(dcp)) == ["manifest.json", "params_dcp",
                                       "spec.json"]
    assert sorted(os.listdir(dcp / "params_dcp")) == [".metadata",
                                                      "__0_0.distcp"]
    assert (dcp / "spec.json").read_text() == (npz / "spec.json").read_text()
    m_dcp, m_npz = _manifest(dcp), _manifest(npz)
    assert m_dcp.pop("array_store") == "dcp"
    assert m_npz.pop("array_store") == "npz"
    assert m_dcp == m_npz  # the same keys, shapes, dtypes and packed bits
    spec, back = tckpt.load_checkpoint(str(dcp))
    assert spec == _spec(tcore)
    _same_params(back, params)
    _same_params(back, tckpt.load_checkpoint(str(npz))[1])
    # the store holds the bit-packed assignments, as params.npz does
    with np.load(npz / "params.npz") as want:
        got = tckpt._read_arrays(str(dcp))
        assert sorted(got) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


def _small_resnet(mod):
    return mod.ResNetSpec("small", (1, 2), (64, 256), num_classes=10,
                          in_size=32, bottleneck=False)


@pytest.mark.parametrize("family", ["resnet", "vit"])
def test_dcp_round_trips_a_family_checkpoint(tmp_path, family):
    if family == "resnet":
        spec = _small_resnet(tresnet)
        params = tsynth.random_resnet_pq_params(spec, seed=0)
    else:
        spec = tvit.vit_tiny_test()
        params = tsynth.random_vit_pq_params(spec, seed=0)
    npz, dcp = tmp_path / "npz", tmp_path / "dcp"
    tckpt.save_family_checkpoint(str(npz), family, spec, params)
    tckpt.save_family_checkpoint(str(dcp), family, spec, params, store="dcp")
    assert not (dcp / "params.npz").exists()
    assert (dcp / "spec.json").read_text() == (npz / "spec.json").read_text()
    m_dcp, m_npz = _manifest(dcp), _manifest(npz)
    assert (m_dcp.pop("array_store"), m_npz.pop("array_store")) == (
        "dcp", "npz")
    assert m_dcp == m_npz
    got_family, got_spec, got = tckpt.load_family_checkpoint(str(dcp))
    assert got_family == family and got_spec == spec
    _same_tree(got, params)


def test_dcp_load_equals_a_jax_written_npz_checkpoint(tmp_path):
    params = _params("opq")
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jckpt.save_checkpoint(str(jdir), _spec(jcore), params)
    tckpt.save_checkpoint(str(tdir), _spec(tcore), params, store="dcp")
    _same_params(tckpt.load_checkpoint(str(tdir))[1],
                 tckpt.load_checkpoint(str(jdir))[1])
    rspec = _small_resnet(tresnet)
    rparams = tsynth.random_resnet_pq_params(rspec, seed=1)
    jdir, tdir = tmp_path / "jr", tmp_path / "tr"
    jckpt.save_family_checkpoint(str(jdir), "resnet", _small_resnet(jresnet),
                                 rparams)
    tckpt.save_family_checkpoint(str(tdir), "resnet", rspec, rparams,
                                 store="dcp")
    _same_tree(tckpt.load_family_checkpoint(str(tdir))[2],
               tckpt.load_family_checkpoint(str(jdir))[2])


def test_resave_with_the_other_store_removes_stale_arrays(tmp_path):
    """The port's counterpart of tests/test_checkpoint.py's
    test_resave_with_different_store_removes_stale_arrays: load prefers
    params.npz, so a stale npz would silently serve the OLD weights."""
    spec = tcore.ModelSpec(name="st", in_height=2, in_width=2, in_channels=2,
                           layers=(tcore.FCSpec(3), tcore.SoftmaxSpec()))

    def params(val):
        return [tcore.dense_fc_params(np.full((8, 3), val, np.float32),
                                      np.zeros(3, np.float32)), None]

    def weight():
        return tckpt.load_checkpoint(out)[1][0]["weight"]

    out = str(tmp_path / "ck")
    tckpt.save_checkpoint(out, spec, params(1.0), store="npz")
    tckpt.save_checkpoint(out, spec, params(2.0), store="dcp")
    assert not os.path.exists(os.path.join(out, "params.npz"))
    np.testing.assert_array_equal(weight(), np.full((8, 3), 2.0, np.float32))
    # a second rank's file of an earlier save goes with the old store
    stale = os.path.join(out, "params_dcp", "__1_0.distcp")
    open(stale, "wb").close()
    tckpt.save_checkpoint(out, spec, params(3.0), store="dcp")
    assert not os.path.exists(stale)
    np.testing.assert_array_equal(weight(), np.full((8, 3), 3.0, np.float32))
    tckpt.save_checkpoint(out, spec, params(4.0), store="npz")
    assert sorted(os.listdir(out)) == ["manifest.json", "params.npz",
                                       "spec.json"]
    np.testing.assert_array_equal(weight(), np.full((8, 3), 4.0, np.float32))
    # a JAX package save with its orbax store goes too
    jspec = jcore.ModelSpec(name="st", in_height=2, in_width=2, in_channels=2,
                            layers=(jcore.FCSpec(3), jcore.SoftmaxSpec()))
    jckpt.save_checkpoint(out, jspec, params(5.0), store="orbax")
    assert os.path.isdir(os.path.join(out, "params_ts"))
    tckpt.save_checkpoint(out, spec, params(6.0), store="dcp")
    assert sorted(os.listdir(out)) == ["manifest.json", "params_dcp",
                                       "spec.json"]
    np.testing.assert_array_equal(weight(), np.full((8, 3), 6.0, np.float32))


def test_a_jax_orbax_store_raises_naming_store_npz(tmp_path):
    """A real params_ts/ (OCDBT over zarr chunks) written by the JAX
    package: the port has no reader for it and says how to re-save."""
    params = _params("pq")
    d = tmp_path / "ts"
    jckpt.save_checkpoint(str(d), _spec(jcore), params, store="orbax")
    assert sorted(os.listdir(d)) == ["manifest.json", "params_ts",
                                     "spec.json"]
    with pytest.raises(NotImplementedError, match="--store npz"):
        tckpt.load_checkpoint(str(d))
    vspec = jvit.vit_tiny_test()
    vd = tmp_path / "vts"
    jckpt.save_family_checkpoint(
        str(vd), "vit", vspec,
        tsynth.random_vit_pq_params(tvit.vit_tiny_test(), seed=0),
        store="orbax")
    with pytest.raises(NotImplementedError, match="--store npz"):
        tckpt.load_family_checkpoint(str(vd))
    # what the message asks for: the JAX package re-saves with npz, and
    # the port reads that
    jspec, jparams = jckpt.load_checkpoint(str(d))
    jckpt.save_checkpoint(str(d), jspec, jparams, store="npz")
    _same_params(tckpt.load_checkpoint(str(d))[1], params)


@pytest.mark.parametrize("what", ["linear", "family"])
def test_store_orbax_is_refused_naming_npz_and_dcp(tmp_path, what):
    with pytest.raises(NotImplementedError) as e:
        if what == "linear":
            tckpt.save_checkpoint(str(tmp_path), _spec(tcore),
                                  _params("pq"), store="orbax")
        else:
            spec = _small_resnet(tresnet)
            tckpt.save_family_checkpoint(
                str(tmp_path), "resnet", spec,
                tsynth.random_resnet_pq_params(spec, seed=0), store="orbax")
    assert "store='npz'" in str(e.value) and "store='dcp'" in str(e.value)
    assert "A13" not in str(e.value)
    assert os.listdir(tmp_path) == []


def _seq_spec():
    return tcore.ModelSpec(
        name="seqtest", in_height=12, in_width=12, in_channels=8,
        layers=(tcore.ConvSpec(kernel=3, out_channels=16, pad=1),
                tcore.ReLUSpec(), tcore.PoolSpec(kernel=2, stride=2),
                tcore.FCSpec(48), tcore.ReLUSpec(), tcore.FCSpec(10),
                tcore.SoftmaxSpec()))


def test_classifier_from_a_dcp_checkpoint_gives_the_npz_copys_bits(tmp_path):
    params = tsynth.random_pq_params(_seq_spec(), seed=3)
    pre = TorchPreprocessor(resize=14, crop=12,
                            mean=np.zeros(3, np.float32),
                            std=np.ones(3, np.float32))
    x = tsynth.random_input(_seq_spec(), 3, seed=4)
    probs = []
    for store in ("npz", "dcp"):
        d = str(tmp_path / store)
        tckpt.save_checkpoint(d, _seq_spec(), params, store=store)
        tckpt.save_preprocessor(d, pre)
        clf = Classifier.from_checkpoint(d, conv_impl="memory",
                                         fc_impl="memory", device="cpu")
        probs.append(clf._probs(x))
    np.testing.assert_array_equal(probs[0], probs[1])


def test_quantize_cli_saves_with_store_dcp(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(tzoo.MODELS, "seqtest", _seq_spec)
    src = str(tmp_path / "dense")
    tckpt.save_checkpoint(src, _seq_spec(),
                          tsynth.random_dense_params(_seq_spec(), seed=0))
    outs = {}
    for store in ("npz", "dcp"):
        outs[store] = str(tmp_path / store)
        assert tcli.main(["quantize", src, outs[store], "--cpu", "--store",
                          store, "--conv-subvec-len", "4",
                          "--conv-codewords", "8", "--fc-subvec-len", "4",
                          "--fc-codewords", "8"]) == 0
    assert os.path.isdir(os.path.join(outs["dcp"], "params_dcp"))
    assert json.loads(open(os.path.join(outs["dcp"], "manifest.json")).read()
                      )["array_store"] == "dcp"
    spec, got = tckpt.load_checkpoint(outs["dcp"])
    assert spec == _seq_spec()
    assert all(tcore.is_pq(p) for p in got if p is not None)
    # one seed: the same codebooks and ids as the npz run
    _same_params(got, tckpt.load_checkpoint(outs["npz"])[1])
    # a JAX user's --store orbax fails with the store's message, not
    # argparse's, before it quantizes
    capsys.readouterr()
    assert tcli.main(["quantize", src, str(tmp_path / "o"), "--cpu",
                      "--store", "orbax"]) == 2
    err = capsys.readouterr().err
    assert "store='npz'" in err and "store='dcp'" in err
    assert "quantiz" not in err.replace("error:", "")
    assert not os.path.exists(tmp_path / "o")


def test_dcp_save_on_two_gloo_ranks(tmp_path):
    """Both ranks of a gloo group save one linear and one family
    checkpoint with store="dcp"; rank 0 and rank 1 load the same arrays,
    those saved, with their dtypes."""
    ranks = W.Ranks("store", str(tmp_path), world=2)
    try:
        outs = ranks.results()
    finally:
        ranks.close()
    assert list(outs[0]["dcp_files"])[0] == ".metadata"
    want = W.store_expected()
    for key, v in want.items():
        for rank in (0, 1):
            got = outs[rank][key]
            assert got.dtype == v.dtype, (rank, key)
            np.testing.assert_array_equal(got, v, err_msg=f"{rank} {key}")
    assert sorted(k for k in outs[1] if k.startswith("dcp_family")) == \
        sorted(k for k in want if k.startswith("dcp_family"))
