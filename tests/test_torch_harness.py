"""The port's eval harness (eval/harness.py, utils/timing.py) against the JAX
package's, on the same files and BMPs in a tmp_path: full-width AlexNet-PQ
written by the JAX package's save_reference_model, classified by both
packages' Classifier.from_reference on the CPU (f32, the default there).

What is compared, and why: strategy names equal; logits (the forward with
with_softmax=False on the preprocessed batch) within 1e-5 of the largest
|logit|; the top-5 class ids, the ground-truth ids and the top-1
probability (1e-5). At pixel-range inputs the random net's logits reach
about 1500, so its softmax saturates: the top-1 probability is 1.0 and the
next ones are 0 or near it, and the probabilities of ranks 2-5 carry no
information to compare.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.eval import harness as jharness
from qcnn_tpu.formats import checkpoint as jckpt
from qcnn_tpu.models import network as jnet
from qcnn_tpu.models import resnet as jresnet
from qcnn_tpu.models import synth as jsynth
from qcnn_tpu.models import vit as jvit
from qcnn_tpu.models import zoo as jzoo
from qcnn_tpu.models.loader import save_reference_model
from qcnn_tpu.models.prepare import prepare_params as jprepare
from qcnn_tpu.preproc import pipeline as jpipe
from qcnn_tpu_torch.eval import harness as tharness
from qcnn_tpu_torch.formats import checkpoint as tckpt
from qcnn_tpu_torch.formats import write_bin
from qcnn_tpu_torch.models import network as tnet
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models import synth as tsynth
from qcnn_tpu_torch.models import vit as tvit
from qcnn_tpu_torch.models.prepare import prepare_params as tprepare
from qcnn_tpu_torch.preproc import encode_bmp24
from qcnn_tpu_torch.utils.timing import StopWatch, TimerSet

SIZES = [(256, 256), (181, 257), (333, 250), (200, 301)]


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    """A reference layout: AlexNet/Bin.Files, the mean image, class names,
    image labels and BMPs of mixed sizes."""
    d = tmp_path_factory.mktemp("reference")
    rng = np.random.default_rng(0)
    save_reference_model(jzoo.alexnet(),
                         jsynth.random_pq_params(jzoo.alexnet(), seed=0),
                         str(d / "AlexNet" / "Bin.Files"),
                         "bvlc_alexnet_aCaF")
    write_bin(d / "AlexNet" / "imagenet_mean.single.bin",
              rng.uniform(100, 130, (3, 256, 256)).astype(np.float32))
    (d / "names.txt").write_text(
        "".join(f"class {i}\n" for i in range(1000)))
    paths, labels = [], []
    for i, (h, w) in enumerate(SIZES):
        p = d / f"ILSVRC2012_val_{i:08d}.BMP"
        p.write_bytes(encode_bmp24(rng.integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)))
        paths.append(str(p))
        labels.append(f"ILSVRC2012_val_{i:08d}.JPEG {(37 * i) % 1000}\n")
    (d / "labels.txt").write_text("".join(labels[:-1]))  # one unlabelled
    return d, paths


def _build(pkg, d, **kwargs):
    kwargs = dict(class_names_path=str(d / "names.txt"),
                  image_labels_path=str(d / "labels.txt"), **kwargs)
    if pkg is tharness:
        kwargs["device"] = "cpu"
    return pkg.Classifier.from_reference("alexnet", str(d), **kwargs)


def _logits_close(got, want, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.class_ids == w.class_ids
        assert g.class_names == w.class_names
        assert g.ground_truth_id == w.ground_truth_id
        assert g.ground_truth == w.ground_truth
        assert abs(g.probs[0] - w.probs[0]) <= 1e-5


@pytest.mark.parametrize("impl, batch_hint", [("auto", 64), ("memory", 64),
                                              ("memory", 1)])
def test_classifier_from_reference_matches_jax(ref_dir, impl, batch_hint):
    d, paths = ref_dir
    kw = dict(conv_impl=impl, fc_impl=impl, batch_hint=batch_hint)
    clf, jclf = _build(tharness, d, **kw), _build(jharness, d, **kw)
    assert clf.load_result.synthesized_layers == []
    assert clf.device == torch.device("cpu")
    _, jconv, jfc = jprepare(jclf.spec, jclf.raw_params, dtype=jnp.float32,
                             **kw)
    assert (clf.conv_impls, clf.fc_impls) == (jconv, jfc)

    results, jresults = clf.classify_batch(paths), jclf.classify_batch(paths)
    _same_results(results, jresults)
    assert [r.ground_truth_id for r in results] == [0, 37, 74, None]
    assert results[1].ground_truth == "class 37"
    _same_results([clf.classify(paths[2])], [jclf.classify(paths[2])])

    x = clf.pre.load_batch(paths)
    np.testing.assert_array_equal(x, jclf.pre.load_batch(paths))
    got = tnet.forward(clf.params, x, spec=clf.spec,
                       conv_impls=clf.conv_impls, fc_impls=clf.fc_impls,
                       with_softmax=False, device="cpu")
    want = jnet.forward(jclf.params, jnp.asarray(x), spec=jclf.spec,
                        conv_impls=jconv, fc_impls=jfc, with_softmax=False)
    _logits_close(got, want)
    report = clf.timers.report()
    assert report["preproc"]["count"] == report["forward"]["count"] == 2


def test_bf16_memory_classifier_runs_the_kernels_plain_versions(ref_dir):
    """bf16 (the card's default) resolves the FC kernels' strategies as the
    JAX package does; on the CPU their plain versions run and agree with
    f32 decode-at-load at the smoke's end-to-end limits."""
    d, paths = ref_dir
    ref = _build(tharness, d)
    x = ref.pre.load_batch(paths)
    want = ref._probs(x)
    for batch_hint, fc in ((64, "fgather"), (1, "lutgather")):
        kw = dict(conv_impl="memory", fc_impl="memory", batch_hint=batch_hint)
        clf = _build(tharness, d, compute_dtype=torch.bfloat16, **kw)
        _, jconv, jfc = jprepare(jzoo.alexnet(), clf.raw_params,
                                 dtype=jnp.bfloat16, **kw)
        assert (clf.conv_impls, clf.fc_impls) == (jconv, jfc)
        assert sorted(set(clf.fc_impls) - {"-"}) == [fc]
        got = clf._probs(x)
        assert got.dtype == np.float32
        assert float(np.abs(got - want).max()) <= 1e-2
        assert (got.argmax(1) == want.argmax(1)).all()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_classifier_from_checkpoint_round_trips(ref_dir, tmp_path, writer):
    d, paths = ref_dir
    ref = _build(tharness, d)
    ck = str(tmp_path / "ck")
    ckpt, pipe = (tckpt, None) if writer == "port" else (jckpt, jpipe)
    pre = ref.pre if pipe is None else pipe.Preprocessor.alexnet(
        str(d / "AlexNet" / "imagenet_mean.single.bin"))
    spec = ref.spec if writer == "port" else jzoo.alexnet()
    ckpt.save_checkpoint(ck, spec, ref.raw_params)
    with pytest.raises(ValueError, match="no preprocessing config"):
        tharness.Classifier.from_checkpoint(ck, device="cpu")
    ckpt.save_preprocessor(ck, pre)
    shutil.copy(d / "names.txt", os.path.join(ck, "class_names.txt"))
    clf = tharness.Classifier.from_checkpoint(ck, device="cpu")
    assert clf.spec == ref.spec and clf.class_names == ref.class_names
    got, want = clf.classify_batch(paths), ref.classify_batch(paths)
    for g, w in zip(got, want):
        assert g.class_ids == w.class_ids and g.probs == w.probs
    # the act_scales sidecar reaches prepare_params (int8 static scales)
    scales = {0: 60.0, 4: 40.0}
    ckpt.save_act_scales(ck, scales)
    clf8 = tharness.Classifier.from_checkpoint(ck, device="cpu",
                                               compute_dtype=torch.int8)
    assert float(clf8.params[0]["act_scale"]) == 60.0
    assert float(clf8.params[4]["act_scale"]) == 40.0


def _small_resnet(mod):
    # stage 1's 3x3 convs take 256 channels: memory mode fuses them
    return mod.ResNetSpec("small", (1, 2), (64, 256), num_classes=10,
                          in_size=32, bottleneck=False)


def test_family_classifier_memory_matches_jax(ref_dir, tmp_path):
    d, paths = ref_dir
    params = tsynth.random_resnet_pq_params(_small_resnet(tresnet), seed=0)
    ck = str(tmp_path / "family")
    jckpt.save_family_checkpoint(ck, "resnet", _small_resnet(jresnet),
                                 params)
    jckpt.save_preprocessor(ck, jpipe.TorchPreprocessor.imagenet(
        crop=32, resize=40))
    clf = tharness.FamilyClassifier.from_checkpoint(ck, memory=True,
                                                    device="cpu")
    jclf = jharness.FamilyClassifier.from_checkpoint(ck, memory=True)
    assert clf.spec == _small_resnet(tresnet)
    got, want = clf.classify_batch(paths), jclf.classify_batch(paths)
    for g, w in zip(got, want):
        assert g.class_ids[0] == w.class_ids[0]
        assert max(abs(a - b) for a, b in zip(g.probs, w.probs)) <= 1e-6
    x = clf.pre.load_batch(paths)
    np.testing.assert_array_equal(x, jclf.pre.load_batch(paths))
    assert np.abs(clf._probs(x) - np.asarray(jclf._fwd(
        jclf.params, jnp.asarray(x)))).max() <= 1e-6
    # the ViT family through the same surface, from a checkpoint of the
    # JAX package's
    vspec = dict(name="small", patch=8, image_size=32, dim=64, depth=2,
                 heads=4, num_classes=10)
    vck = str(tmp_path / "vit")
    jckpt.save_family_checkpoint(vck, "vit", jvit.ViTSpec(**vspec),
                                 tsynth.random_vit_pq_params(
                                     tvit.ViTSpec(**vspec), seed=0))
    jckpt.save_preprocessor(vck, jpipe.TorchPreprocessor.imagenet(
        crop=32, resize=40))
    for memory in (True, False):
        vclf = tharness.FamilyClassifier.from_checkpoint(
            vck, memory=memory, device="cpu")
        jvclf = jharness.FamilyClassifier.from_checkpoint(vck,
                                                          memory=memory)
        assert vclf.family == "vit" and vclf.spec == tvit.ViTSpec(**vspec)
        got, want = vclf.classify_batch(paths), jvclf.classify_batch(paths)
        for g, w in zip(got, want):
            assert g.class_ids[0] == w.class_ids[0]
            assert max(abs(a - b) for a, b in zip(g.probs, w.probs)) <= 1e-6


def _tiny(core):
    return core.ModelSpec(
        name="tiny", in_height=15, in_width=15, in_channels=8,
        layers=(core.ConvSpec(kernel=3, out_channels=32, pad=1, groups=2,
                              stride=2),
                core.ReLUSpec(), core.PoolSpec(kernel=3, stride=2),
                core.FCSpec(64), core.ReLUSpec(), core.FCSpec(16),
                core.SoftmaxSpec()))


@pytest.mark.parametrize("source", ["array", "chunks", "empty"])
def test_evaluate_dataset_matches_jax(source):
    import qcnn_tpu.core as jcore
    import qcnn_tpu_torch.core as tcore

    jspec, tspec = _tiny(jcore), _tiny(tcore)
    params = jsynth.random_pq_params(jspec, seed=3)
    tprep, tconv, tfc = tprepare(tspec, params, dtype=torch.float32,
                                 device="cpu")
    jprep, jconv, jfc = jprepare(jspec, params, dtype=jnp.float32)
    tfwd = tnet.make_forward_fn(tspec, conv_impls=tconv, fc_impls=tfc,
                                device="cpu")
    jfwd = jnet.make_forward_fn(jspec, conv_impls=jconv, fc_impls=jfc)
    n = 0 if source == "empty" else 70
    x = tsynth.random_input(tspec, 70, seed=4)[:n]
    # labels whose outcome no rounding decides: each row's top class, its
    # fourth or its last (far below the top 5), by the JAX probabilities
    labels = np.zeros(0, np.int64)
    if n:
        order = np.argsort(-np.asarray(jfwd(jprep, jnp.asarray(x))), axis=1)
        labels = order[np.arange(n), np.array([0, 3, 15] * 24)[:n]]

    chunks = [x[:5], x[5:40], x[40:]]
    got = tharness.evaluate_dataset(
        tfwd, tprep, iter(chunks) if source == "chunks" else x, labels,
        batch_size=16)
    # the JAX package's array branch raises TypeError (its generator reads
    # its own name), so it reads the same rows as chunks
    want = jharness.evaluate_dataset(jfwd, jprep, iter(chunks), labels,
                                     batch_size=16)
    assert got["images"] == want["images"] == n
    assert got["accuracy"] == want["accuracy"]
    if n:
        third = 24 / 70
        assert got["accuracy"][1] == pytest.approx(third)
        assert got["accuracy"][5] == pytest.approx(2 * third - 1 / 70)
        assert got["images_per_s"] > 0
    else:
        assert got["accuracy"] == {k: 0.0 for k in (1, 2, 3, 4, 5)}
        assert got["forward_s"] == 0.0 and got["images_per_s"] == 0.0


def test_accuracy_at_k_exact_values_and_parity():
    probs = np.array([[0.1, 0.5, 0.4], [0.7, 0.2, 0.1]])
    labels = np.array([2, 0])
    assert tharness.accuracy_at_k(probs, labels, ks=(1, 2, 3)) \
        == {1: 0.5, 2: 1.0, 3: 1.0}
    rng = np.random.default_rng(1)
    probs, labels = rng.random((50, 10)), rng.integers(0, 10, 50)
    acc = tharness.accuracy_at_k(probs, labels)
    assert acc == jharness.accuracy_at_k(probs, labels)
    vals = [acc[k] for k in sorted(acc)]
    assert vals == sorted(vals)


def test_timer_set_counts_and_fences():
    timers = TimerSet()
    for _ in range(3):
        with timers.time("a", result=torch.ones(2)):
            pass
    with timers.time("b", result={"x": [torch.zeros(1), None]}):
        pass
    with pytest.raises(KeyError):
        with timers.time("a"):
            raise KeyError("inside")
    report = timers.report()
    assert report["a"]["count"] == 4 and report["b"]["count"] == 1
    assert report["a"]["total_s"] >= 0.0
    assert report["a"]["mean_ms"] == pytest.approx(
        1e3 * report["a"]["total_s"] / 4)
    w = StopWatch()
    with pytest.raises(RuntimeError, match="not running"):
        w.pause()
    w.resume()
    w.pause()
    assert w.count == 1
    w.reset()
    assert (w.count, w.total) == (0, 0.0)
