"""The port's reference-layout loader (models/loader.py) and npz checkpoint
store (formats/checkpoint.py) against the JAX package's: files written by
either package load bit-equal in the other, in both directions, at the full
width of AlexNet-PQ (13 MB) and on small specs."""

import json
import os

import numpy as np
import pytest

import qcnn_tpu.core as jcore
import qcnn_tpu_torch.core as tcore
from qcnn_tpu.formats import checkpoint as jckpt
from qcnn_tpu.models import loader as jloader
from qcnn_tpu.models import resnet as jresnet
from qcnn_tpu.models import vit as jvit
from qcnn_tpu.models import zoo as jzoo
from qcnn_tpu.preproc import pipeline as jpipe
from qcnn_tpu_torch.formats import checkpoint as tckpt
from qcnn_tpu_torch.models import loader as tloader
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models import synth as tsynth
from qcnn_tpu_torch.models import vit as tvit
from qcnn_tpu_torch.models import zoo as tzoo
from qcnn_tpu_torch.preproc import pipeline as tpipe
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

PREFIX = "bvlc_alexnet_aCaF"


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


def _same_files(d1, d2):
    names = sorted(os.listdir(d1))
    assert names == sorted(os.listdir(d2))
    for n in names:
        with open(os.path.join(d1, n), "rb") as f1, \
                open(os.path.join(d2, n), "rb") as f2:
            assert f1.read() == f2.read(), n


@pytest.fixture(scope="module")
def alexnet_params():
    return tsynth.random_pq_params(tzoo.alexnet(), seed=0)


@pytest.mark.parametrize("encoding", ["cbn", "bin"])
def test_full_width_alexnet_crosses_both_ways(tmp_path, alexnet_params,
                                              encoding):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jloader.save_reference_model(jzoo.alexnet(), alexnet_params, jdir,
                                 PREFIX, encoding=encoding)
    tloader.save_reference_model(tzoo.alexnet(), alexnet_params, tdir,
                                 PREFIX, encoding=encoding)
    _same_files(jdir, tdir)
    assert len(os.listdir(tdir)) == 24
    got = tloader.load_reference_model(tzoo.alexnet(), jdir, PREFIX,
                                       encoding=encoding)
    back = jloader.load_reference_model(jzoo.alexnet(), tdir, PREFIX,
                                        encoding=encoding)
    assert got.synthesized_layers == back.synthesized_layers == []
    assert got.is_authentic
    _same_params(got.params, alexnet_params)
    _same_params(got.params, back.params)


def test_synthesize_missing_fills_the_same_bytes(tmp_path, alexnet_params):
    d = str(tmp_path)
    jloader.save_reference_model(jzoo.alexnet(), alexnet_params, d, PREFIX)
    fc6 = next(i for i, layer in enumerate(tzoo.alexnet().layers)
               if isinstance(layer, tcore.FCSpec))
    os.remove(os.path.join(d, f"{PREFIX}.asmtLst.{fc6 + 1:02d}.cbn"))
    for loader, zoo in ((tloader, tzoo), (jloader, jzoo)):
        with pytest.raises(FileNotFoundError):
            loader.load_reference_model(zoo.alexnet(), d, PREFIX)
    got = tloader.load_reference_model(tzoo.alexnet(), d, PREFIX,
                                       synthesize_missing=True)
    want = jloader.load_reference_model(jzoo.alexnet(), d, PREFIX,
                                        synthesize_missing=True)
    assert got.synthesized_layers == want.synthesized_layers == [fc6]
    assert not got.is_authentic
    _same_params(got.params, want.params)


def test_load_alexnet_reference_reads_the_reference_layout(tmp_path,
                                                           alexnet_params):
    d = tmp_path / "AlexNet" / "Bin.Files"
    tloader.save_reference_model(tzoo.alexnet(), alexnet_params, str(d),
                                 PREFIX)
    got = tloader.load_alexnet_reference(str(tmp_path))
    want = jloader.load_alexnet_reference(str(tmp_path))
    _same_params(got.params, want.params)


def _dense_tiny(core, seed=4):
    spec = core.ModelSpec(
        name="tiny", in_height=9, in_width=9, in_channels=4,
        layers=(core.ConvSpec(kernel=3, out_channels=8, pad=1, groups=2),
                core.ReLUSpec(), core.FCSpec(6), core.SoftmaxSpec()))
    return spec


def test_dense_reference_layout_crosses_both_ways(tmp_path):
    params = tsynth.random_dense_params(_dense_tiny(tcore), seed=4)
    jloader.save_reference_model(_dense_tiny(jcore), params,
                                 str(tmp_path / "j"), "p")
    tloader.save_reference_model(_dense_tiny(tcore), params,
                                 str(tmp_path / "t"), "p")
    _same_files(tmp_path / "j", tmp_path / "t")
    got = tloader.load_reference_model(_dense_tiny(tcore), str(tmp_path / "j"),
                                       "p", quantized=False)
    want = jloader.load_reference_model(_dense_tiny(jcore),
                                        str(tmp_path / "t"), "p",
                                        quantized=False)
    _same_params(got.params, want.params)
    _same_params(got.params, [None if p is None else {
        k: np.asarray(v, np.float32) for k, v in p.items()} for p in params])


def test_export_refusals_match(tmp_path):
    spec_t, spec_j = tzoo.alexnet(), jzoo.alexnet()
    params = tsynth.random_pq_params(spec_t, seed=1)
    params[0] = dict(params[0], perm=np.arange(3, dtype=np.int32))
    msgs = []
    for loader, spec in ((tloader, spec_t), (jloader, spec_j)):
        with pytest.raises(ValueError, match="OPQ") as e:
            loader.save_reference_model(spec, params, str(tmp_path), PREFIX)
        msgs.append(str(e.value))
    params = tsynth.random_pq_params(spec_t, seed=1)
    cb = params[0]["codebooks"]
    params[0] = dict(params[0],
                     codebooks=np.concatenate([cb] * 3, axis=1)[:, :256],
                     assignments=np.full_like(params[0]["assignments"], 255))
    for loader, spec in ((tloader, spec_t), (jloader, spec_j)):
        with pytest.raises(ValueError, match="1-based") as e:
            loader.save_reference_model(spec, params, str(tmp_path), PREFIX,
                                        encoding="bin")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[2] == msgs[3]


def test_class_names_and_image_labels_match(tmp_path):
    names = tmp_path / "names.txt"
    names.write_bytes(b"tench\r\ngoldfish\n\n  \ngreat white shark\n")
    labels = tmp_path / "labels.txt"
    labels.write_text("a/ILSVRC_1.JPEG 5\nILSVRC_2.bmp 7\nbad line here\n"
                      "ILSVRC_3.JPEG 0\n\n")
    assert tloader.load_class_names(str(names)) \
        == jloader.load_class_names(str(names)) \
        == ["tench", "goldfish", "great white shark"]
    assert tloader.load_image_labels(str(labels)) \
        == jloader.load_image_labels(str(labels)) \
        == {"ILSVRC_1": 5, "ILSVRC_2": 7, "ILSVRC_3": 0}


def _pq_tiny(core):
    return core.ModelSpec(
        name="tiny", in_height=15, in_width=15, in_channels=8,
        layers=(core.ConvSpec(kernel=3, out_channels=32, pad=1, groups=2,
                              stride=2),
                core.ReLUSpec(),
                core.LRNSpec(5, 1e-4, 0.75, 1.0, channel_map=(0, 1, 2)),
                core.PoolSpec(kernel=3, stride=2),
                core.FCSpec(64), core.ReLUSpec(), core.DropoutSpec(0.5),
                core.FCSpec(16), core.SoftmaxSpec()))


@pytest.mark.parametrize("kind", ["pq", "dense", "opq"])
def test_linear_checkpoints_cross_both_ways(tmp_path, kind):
    if kind == "dense":
        params = tsynth.random_dense_params(_pq_tiny(tcore), seed=2)
    else:
        params = tsynth.random_pq_params(_pq_tiny(tcore), seed=2)
    if kind == "opq":
        params[4] = dict(params[4], perm=np.random.default_rng(0)
                         .permutation(512).astype(np.int32))
    scales = {0: 0.5, 4: 1.25, 7: 3.0}
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_checkpoint(jdir, _pq_tiny(jcore), params)
    jckpt.save_act_scales(jdir, scales)
    tckpt.save_checkpoint(tdir, _pq_tiny(tcore), params)
    tckpt.save_act_scales(tdir, scales)
    for name in ("spec.json", "manifest.json", "act_scales.json"):
        assert (open(os.path.join(jdir, name)).read()
                == open(os.path.join(tdir, name)).read()), name
    with np.load(os.path.join(jdir, "params.npz")) as a, \
            np.load(os.path.join(tdir, "params.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    tspec, tparams = tckpt.load_checkpoint(jdir)
    jspec, jparams = jckpt.load_checkpoint(tdir)
    assert tspec == _pq_tiny(tcore) and jspec == _pq_tiny(jcore)
    assert tckpt.spec_to_dict(tspec) == jckpt.spec_to_dict(jspec)
    _same_params(tparams, params)
    _same_params(tparams, jparams)
    assert tckpt.load_act_scales(jdir) == jckpt.load_act_scales(tdir) \
        == scales
    assert tckpt.load_act_scales(str(tmp_path)) is None


@pytest.mark.parametrize("k", [2, 3, 16, 200, 256])
def test_pack_indices_match(k):
    asmt = np.random.default_rng(k).integers(0, k, size=(37, 5),
                                             dtype=np.uint8)
    packed, bits = tckpt.pack_indices(asmt, k)
    jpacked, jbits = jckpt.pack_indices(asmt, k)
    assert bits == jbits
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(tckpt.unpack_indices(packed, bits, (37, 5)),
                                  asmt)
    with pytest.raises(ValueError, match="does not fit"):
        tckpt.pack_indices(np.array([1 << bits]), k)


def _small_resnet(mod):
    return mod.ResNetSpec("small", (1, 2), (64, 256), num_classes=10,
                          in_size=32, bottleneck=False)


def test_family_checkpoint_crosses_both_ways(tmp_path):
    params = tsynth.random_resnet_pq_params(_small_resnet(tresnet), seed=0)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_family_checkpoint(jdir, "resnet", _small_resnet(jresnet),
                                 params)
    tckpt.save_family_checkpoint(tdir, "resnet", _small_resnet(tresnet),
                                 params)
    for name in ("spec.json", "manifest.json"):
        assert (open(os.path.join(jdir, name)).read()
                == open(os.path.join(tdir, name)).read()), name
    family, tspec, tparams = tckpt.load_family_checkpoint(jdir)
    jfamily, jspec, jparams = jckpt.load_family_checkpoint(tdir)
    assert family == jfamily == "resnet"
    assert tspec == _small_resnet(tresnet) and jspec == _small_resnet(jresnet)
    assert type(tspec) is tresnet.ResNetSpec
    _same_tree(tparams, params)
    _same_tree(tparams, jparams)
    with pytest.raises(ValueError, match="family checkpoint"):
        tckpt.load_checkpoint(jdir)


@pytest.mark.parametrize("kind", ["caffe", "torch"])
def test_preprocessor_config_crosses_both_ways(tmp_path, kind):
    def make(pipe):
        if kind == "torch":
            return pipe.TorchPreprocessor.imagenet(crop=200, resize=230)
        mean = np.random.default_rng(1).uniform(
            90, 130, (256, 256, 3)).astype(np.float32)
        return pipe.Preprocessor(
            full_h=256, full_w=256, crop_h=224, crop_w=224,
            resz_type=pipe.ReszType.RELAXED, mean_type=pipe.MeanType.CROP,
            mean_image=mean)

    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    jckpt.save_preprocessor(str(jdir), make(jpipe))
    tckpt.save_preprocessor(str(tdir), make(tpipe))
    _same_files(jdir, tdir)
    got, back = tckpt.load_preprocessor(str(jdir)), \
        jckpt.load_preprocessor(str(tdir))
    assert type(got).__name__ == type(back).__name__
    assert type(got).__module__ == "qcnn_tpu_torch.preproc.pipeline"
    want = make(tpipe)
    for field in ("resize", "crop", "full_h", "full_w", "crop_h", "crop_w"):
        if hasattr(want, field):
            assert getattr(got, field) == getattr(want, field)
    for field in ("mean", "std", "mean_image"):
        if hasattr(want, field):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
            np.testing.assert_array_equal(getattr(back, field),
                                          getattr(want, field))
    if kind == "caffe":
        assert got.resz_type is tpipe.ReszType.RELAXED
        assert got.mean_type is tpipe.MeanType.CROP
    assert tckpt.load_preprocessor(str(tmp_path)) is None


def test_unported_stores_and_families_raise_naming_the_roadmap(tmp_path):
    # the orbax store is the JAX package's: a save names the two stores
    # the port writes, a load of params_ts/ alone names the way out
    params = tsynth.random_pq_params(_pq_tiny(tcore), seed=2)
    with pytest.raises(NotImplementedError, match="store='npz'.*store='dcp'"):
        tckpt.save_checkpoint(str(tmp_path / "o"), _pq_tiny(tcore), params,
                              store="orbax")
    rparams = tsynth.random_resnet_pq_params(_small_resnet(tresnet), seed=0)
    with pytest.raises(NotImplementedError, match="store='npz'.*store='dcp'"):
        tckpt.save_family_checkpoint(str(tmp_path / "f"), "resnet",
                                     _small_resnet(tresnet), rparams,
                                     store="orbax")
    # a checkpoint that holds only the orbax store
    d = tmp_path / "ts"
    tckpt.save_checkpoint(str(d), _pq_tiny(tcore), params)
    os.remove(d / "params.npz")
    (d / "params_ts").mkdir()
    with pytest.raises(NotImplementedError, match="--store npz"):
        tckpt.load_checkpoint(str(d))
    # the ViT family is ported: a ViT checkpoint crosses both ways, with
    # the same spec.json and manifest.json as the JAX package's
    vparams = tsynth.random_vit_pq_params(tvit.vit_tiny_test(), seed=0)
    vj, vt = tmp_path / "vj", tmp_path / "vt"
    jckpt.save_family_checkpoint(str(vj), "vit", jvit.vit_tiny_test(),
                                 vparams)
    tckpt.save_family_checkpoint(str(vt), "vit", tvit.vit_tiny_test(),
                                 vparams)
    for name in ("spec.json", "manifest.json"):
        assert (vj / name).read_text() == (vt / name).read_text(), name
    assert json.loads((vt / "manifest.json").read_text())["family"] == "vit"
    family, vspec, got = tckpt.load_family_checkpoint(str(vj))
    jfamily, jspec, back = jckpt.load_family_checkpoint(str(vt))
    assert family == jfamily == "vit"
    assert type(vspec) is tvit.ViTSpec and vspec == tvit.vit_tiny_test()
    assert jspec == jvit.vit_tiny_test()
    _same_tree(got, vparams)
    _same_tree(back, vparams)
    with pytest.raises(ValueError, match="unknown family"):
        tckpt.save_family_checkpoint(str(tmp_path / "x"), "vgg",
                                     _small_resnet(tresnet), rparams)
    with pytest.raises(ValueError, match="unknown array store"):
        tckpt.save_checkpoint(str(tmp_path / "s"), _pq_tiny(tcore), params,
                              store="zarr")


def test_newer_format_versions_are_refused(tmp_path):
    params = tsynth.random_pq_params(_pq_tiny(tcore), seed=2)
    tckpt.save_checkpoint(str(tmp_path), _pq_tiny(tcore), params)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    manifest["format_version"] = tckpt.FORMAT_VERSION + 1
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    msgs = []
    for ck in (tckpt, jckpt):
        with pytest.raises(ValueError, match="newer") as e:
            ck.load_checkpoint(str(tmp_path))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
