"""Cross-engine parity of the port: its Classifier against the COMPILED
reference C++ binary, the port's counterpart of
``tests/test_reference_parity.py`` with the same runs, tolerances and skip
condition (g++ and a reference checkout at ``REFERENCE_DIR``), driven through
``qcnn_tpu_torch/eval/reference_engine.py`` on the CPU in float32.

Two complementary runs:

1. Shipped weights (real codebooks + real .cbn assignments; the missing fc6
   assignment blob is injected identically into both engines).
2. Fully-synthetic calibrated PQ weights (every layer alive and
   input-dependent; see synthesize_live_pq_params), for AlexNet and three
   other zoo models: agreement there is sensitive to the whole stack.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from qcnn_tpu_torch.eval import reference_engine as refeng
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or not refeng.available(),
    reason="g++ or reference checkout unavailable",
)


@pytest.fixture(scope="module")
def bmps(reference_dir):
    paths = sorted(
        glob.glob(os.path.join(reference_dir, "Bmp.Files", "*.BMP"))
    )
    if not paths:
        pytest.skip("no BMP fixtures")
    return paths


def _probs_matrix(results, num_classes=1000):
    """(N, C) dense probability matrix from sorted (ids, probs) results."""
    out = np.zeros((len(results), num_classes), np.float64)
    for i, r in enumerate(results):
        out[i, r.class_ids] = r.probs
    return out


def test_shipped_weights_parity(bmps, reference_dir):
    """Reference binary vs the port's Classifier on the shipped AlexNet
    artifacts (identical synthesized fc6 assignments injected into both)."""
    from qcnn_tpu_torch.eval.harness import Classifier

    ref = refeng.run_reference(bmps, top_k=1000)
    clf = Classifier.from_reference(
        "alexnet", reference_dir, compute_dtype=torch.float32, device="cpu"
    )
    assert clf.load_result.synthesized_layers == [15]
    ours = clf.classify_batch(bmps, top_k=1000)
    ref_probs = _probs_matrix(ref)
    our_probs = _probs_matrix(ours)
    print(f"shipped-weights parity: max prob delta "
          f"{np.abs(ref_probs - our_probs).max():.3g}")
    np.testing.assert_allclose(our_probs, ref_probs, atol=1e-4, rtol=1e-3)
    for i in range(len(bmps)):
        assert list(ref[i].class_ids[:5]) == ours[i].class_ids[:5], (
            f"top-5 mismatch on {os.path.basename(bmps[i])}"
        )


def _synthetic_run(reference_dir, model, paths, seed, subdir):
    """Both engines on identical synthetic calibrated PQ weights; returns
    (reference probs, the port's probs)."""
    from qcnn_tpu_torch.eval.harness import Classifier
    from qcnn_tpu_torch.formats.reference_codec import write_bin
    from qcnn_tpu_torch.models import zoo
    from qcnn_tpu_torch.preproc.pipeline import Preprocessor

    spec = zoo.get_model(model)
    if model == "vgg_cnn_s":
        # the crop-sized mean the scratch dir will carry, written first:
        # the calibration's preprocessor needs it
        data_dir = os.path.join(refeng.SCRATCH_DIR, subdir)
        mean_path = refeng.synth_mean_path(data_dir, model)
        os.makedirs(os.path.dirname(mean_path), exist_ok=True)
        if not os.path.exists(mean_path):
            rng = np.random.default_rng(11)
            write_bin(mean_path, (
                110.0 + 20.0 * rng.standard_normal((3, 224, 224))
            ).astype(np.float32))
        pre = Preprocessor.vgg_cnn_s(mean_path)
    else:
        pre = Preprocessor.alexnet(os.path.join(
            reference_dir, "AlexNet", "imagenet_mean.single.bin"))
    calib = pre.load(paths[0])
    params = refeng.synthesize_live_pq_params(spec, calib, seed=seed,
                                              device="cpu")
    data_dir = refeng.prepare_synth_data_dir(spec, params, subdir,
                                             model=model)
    # top_k > num_classes heap-corrupts the REFERENCE engine
    # (CaffeEvaWrapper.cc:185-205 + CaffeEva.cc:1174-1188)
    top_k = min(1000, spec.num_classes)
    ref = refeng.run_reference(paths, top_k=top_k, data_dir=data_dir,
                               model=model)
    clf = Classifier(spec, params, pre, compute_dtype=torch.float32,
                     device="cpu")
    ours = clf.classify_batch(paths, top_k=top_k)
    return ref, ours


def _hold(ref, ours, paths, label):
    ref_probs, our_probs = _probs_matrix(ref), _probs_matrix(ours)
    # sensitivity guard: the run must actually be input-dependent, else a
    # conv-stack bug could hide behind a constant distribution
    assert np.abs(ref_probs[0] - ref_probs[1]).max() > 1e-4
    assert np.abs(our_probs[0] - our_probs[1]).max() > 1e-4
    print(f"{label}: max prob delta "
          f"{np.abs(ref_probs - our_probs).max():.3g}")
    np.testing.assert_allclose(our_probs, ref_probs, atol=1e-4, rtol=1e-2)
    for i in range(len(paths)):
        assert ref[i].class_ids[0] == ours[i].class_ids[0], (
            f"top-1 mismatch on {os.path.basename(paths[i])}"
        )


# caffenet_fgb (518 classes) is excluded, as in the JAX package's test: the
# REFERENCE engine's hand-unrolled x8 FC gather (CaffeEva.cc:1008-1016)
# writes past a classifier whose width is not a multiple of 8
@pytest.mark.parametrize("model", ["caffenet", "vgg_cnn_s", "caffenet_fgd"])
def test_synthetic_parity_other_models(bmps, reference_dir, model):
    paths = bmps[:3]
    ref, ours = _synthetic_run(reference_dir, model, paths, seed=9,
                               subdir=f"torch_data_synth_{model}")
    _hold(ref, ours, paths, f"{model} synthetic parity")


def test_synthetic_model_parity_full_stack(bmps, reference_dir):
    ref, ours = _synthetic_run(reference_dir, "alexnet", bmps, seed=7,
                               subdir="torch_data_synth")
    _hold(ref, ours, bmps, "synthetic full-stack parity")
