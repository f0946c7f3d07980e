"""Evaluation harness: single-image classification facade + dataset accuracy.

A port of ``qcnn_tpu/eval/harness.py``, which replaces CaffeEvaWrapper
(src/CaffeEvaWrapper.cc) and the accuracy loop of UT_CaffeEva
(src/UnitTest.cc:27-65, CaffeEva::CalcPredAccu CaffeEva.cc:263-295).

Preprocessing stays host-side NumPy; a batch goes up from pinned host memory
with ``non_blocking=True`` and the probabilities come back with one
``.float().cpu()``. Classifiers run on the card unless built with
``device="cpu"``: none falls back to the CPU when the card is missing.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from qcnn_tpu_torch._device import default_dtype, iter_tensors, resolve_device
from qcnn_tpu_torch.core import ModelSpec
from qcnn_tpu_torch.models.loader import (
    load_class_names,
    load_image_labels,
    load_reference_model,
)
from qcnn_tpu_torch.models.common import build_family_forward
from qcnn_tpu_torch.models.network import make_forward_fn
from qcnn_tpu_torch.models.prepare import act_dtype_for, prepare_params
from qcnn_tpu_torch.models.zoo import get_model
from qcnn_tpu_torch.preproc import Preprocessor
from qcnn_tpu_torch.utils.timing import TimerSet


@dataclasses.dataclass
class ClassifyResult:
    """Top-k classification result (CaffeEvaRslt, CaffeEvaWrapper.h:22-30)."""

    class_ids: list[int]
    probs: list[float]
    class_names: list[str]
    ground_truth: Optional[str]
    time_total_s: float
    # the id form: ImageNet has duplicate NAMES (two 'crane', two
    # 'maillot' classes), so hit-testing must compare ids, not names
    ground_truth_id: Optional[int] = None


# Preprocessing/model wiring per reference model name
# (CaffeEvaWrapper.cc:54-131).
_MODEL_WIRING = {
    "alexnet": ("AlexNet", "bvlc_alexnet_aCaF", Preprocessor.alexnet),
    "caffenet": ("CaffeNet", "bvlc_caffenet_aCaF", Preprocessor.alexnet),
    "caffenet_fgb": ("CaffeNetFGB", "bvlc_caffenetfgb_aCaF", Preprocessor.alexnet),
    "caffenet_fgd": ("CaffeNetFGD", "bvlc_caffenetfgd_aCaF", Preprocessor.alexnet),
    "vgg_cnn_s": ("VggCnnS", "vgg_cnn_s_aCaF", Preprocessor.vgg_cnn_s),
}


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch as a tensor on ``device``: through pinned memory and an
    asynchronous copy on the card, as it is on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def _params_device(params) -> torch.device:
    """The device of the first tensor in prepared (nested) params."""
    first = next(iter_tensors(params), None)
    if first is None:
        raise ValueError("evaluate_dataset: params hold no tensor")
    return first.device


class _ClassifierBase:
    """Shared classify surface: preprocess → forward → top-k decode.
    Subclasses set spec/params/pre/class_names/image_labels/timers/_fwd/
    device."""

    def _result(self, probs, bmp_path, top_k, elapsed) -> ClassifyResult:
        idx = np.argsort(-probs)[:top_k]
        names = [
            self.class_names[i] if i < len(self.class_names) else str(i)
            for i in idx
        ]
        stem = os.path.splitext(os.path.basename(bmp_path))[0]
        gt_id = self.image_labels.get(stem)
        gt = None
        if gt_id is not None:
            gt = (
                self.class_names[gt_id]
                if gt_id < len(self.class_names)
                else str(gt_id)
            )
        return ClassifyResult(
            class_ids=[int(i) for i in idx],
            probs=[float(probs[i]) for i in idx],
            class_names=names,
            ground_truth=gt,
            time_total_s=elapsed,
            ground_truth_id=(int(gt_id) if gt_id is not None else None),
        )

    def _probs(self, x: np.ndarray) -> np.ndarray:
        """(N, H, W, C) host batch -> (N, classes) float32 probabilities."""
        probs = self._fwd(self.params, upload(x, self.device))
        return probs.float().cpu().numpy()

    def classify(self, bmp_path: str, top_k: int = 5) -> ClassifyResult:
        t0 = time.perf_counter()
        with self.timers.time("preproc"):
            x = self.pre.load(bmp_path)
        with self.timers.time("forward"):
            probs = self._probs(x)[0]
        return self._result(
            probs, bmp_path, top_k, time.perf_counter() - t0
        )

    def classify_batch(
        self, bmp_paths: Sequence[str], top_k: int = 5
    ) -> list[ClassifyResult]:
        """One preprocessing pass (threaded native pipeline) + one batched
        forward for all images (the reference loops batch-1,
        CaffeEva.cc:23,167)."""
        t0 = time.perf_counter()
        with self.timers.time("preproc"):
            x = self.pre.load_batch(bmp_paths)
        with self.timers.time("forward"):
            probs = self._probs(x)
        elapsed = time.perf_counter() - t0
        per = elapsed / max(len(bmp_paths), 1)
        return [
            self._result(probs[i], p, top_k, per)
            for i, p in enumerate(bmp_paths)
        ]


class Classifier(_ClassifierBase):
    """End-to-end classifier: preprocess → forward → top-k decode.

    device: None means the card (raises without one); pass "cpu" to run
      the plain versions on the CPU.
    compute_dtype: None means bf16 on the card and f32 on the CPU, as the
      JAX package picks bf16 on its accelerator; torch.int8 selects int8
      weights with bf16 activations.
    """

    def __init__(
        self,
        spec: ModelSpec,
        params: Sequence[Optional[dict]],
        preprocessor: Preprocessor,
        class_names: Optional[list[str]] = None,
        image_labels: Optional[dict[str, int]] = None,
        *,
        conv_impl: str = "auto",
        fc_impl: str = "auto",
        compute_dtype=None,
        act_scales: Optional[dict] = None,
        batch_hint: int = 64,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.spec = spec
        self.raw_params = params  # pre-preparation (PQ) form
        self.pre = preprocessor
        self.class_names = class_names or []
        self.image_labels = image_labels or {}
        self.timers = TimerSet()
        if compute_dtype is None:
            compute_dtype = default_dtype(self.device)
        # int8 selects the weight representation; activations stay bf16 and
        # are quantized inside the int8 ops.
        act_dtype = act_dtype_for(compute_dtype)
        # Prepare once (decode-at-load). batch_hint defaults to the
        # evaluate_dataset batch size so memory-mode strategies resolve for
        # BATCHED use (the JAX package's round-5 review: an implicit hint of
        # 1 picked the batch-1 lutgather kernel — linear in B — and baked it
        # into every 64-image eval batch); pass batch_hint=1 for
        # latency-shaped use.
        self.params, self.conv_impls, self.fc_impls = prepare_params(
            spec, params,
            conv_impl=conv_impl, fc_impl=fc_impl, dtype=compute_dtype,
            act_scales=act_scales, batch_hint=batch_hint, device=self.device,
        )
        self._fwd = make_forward_fn(
            spec, conv_impls=self.conv_impls, fc_impls=self.fc_impls,
            compute_dtype=act_dtype, device=self.device,
        )

    @classmethod
    def from_reference(
        cls,
        model: str,
        main_dir: str,
        *,
        class_names_path: Optional[str] = None,
        image_labels_path: Optional[str] = None,
        synthesize_missing: bool = True,
        **kwargs,
    ) -> "Classifier":
        key = model.lower().replace("-", "_")
        if key not in _MODEL_WIRING:
            raise KeyError(f"unsupported reference model {model!r}")
        subdir, prefix, pre_factory = _MODEL_WIRING[key]
        spec = get_model(key)
        res = load_reference_model(
            spec,
            os.path.join(main_dir, subdir, "Bin.Files"),
            prefix,
            synthesize_missing=synthesize_missing,
        )
        pre = pre_factory(
            os.path.join(main_dir, subdir, "imagenet_mean.single.bin")
        )
        names = load_class_names(class_names_path) if class_names_path else None
        labels = load_image_labels(image_labels_path) if image_labels_path else None
        clf = cls(spec, res.params, pre, names, labels, **kwargs)
        clf.load_result = res
        return clf

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "Classifier":
        """Build from a self-contained native checkpoint (params + embedded
        preprocessing + class names, written by either package)."""
        from qcnn_tpu_torch.formats.checkpoint import (
            load_act_scales,
            load_checkpoint,
            load_preprocessor,
        )

        spec, params = load_checkpoint(path)
        pre = load_preprocessor(path)
        if pre is None:
            raise ValueError(
                f"{path} carries no preprocessing config; re-import with "
                "the reference layout or construct Classifier directly"
            )
        names_path = os.path.join(path, "class_names.txt")
        names = (
            load_class_names(names_path) if os.path.exists(names_path)
            else None
        )
        kwargs.setdefault("act_scales", load_act_scales(path))
        return cls(spec, params, pre, names, **kwargs)


class FamilyClassifier(_ClassifierBase):
    """Classify surface for the nested-dict model families
    (models/resnet.py, models/vit.py, models/swin.py, models/maxvit.py) —
    the family analogue of Classifier, fed by checkpoints whose embedded
    preprocessing is the torch-style TorchPreprocessor."""

    def __init__(
        self,
        family: str,
        spec,
        params: dict,
        preprocessor,
        class_names: Optional[list[str]] = None,
        image_labels: Optional[dict[str, int]] = None,
        *,
        memory: bool = False,
        compute_dtype=None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.family = family
        self.spec = spec
        self.pre = preprocessor
        self.class_names = class_names or []
        self.image_labels = image_labels or {}
        self.timers = TimerSet()
        self.params, self._fwd, _ = build_family_forward(
            family, spec, params, memory=memory,
            compute_dtype=compute_dtype, device=self.device,
        )

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "FamilyClassifier":
        from qcnn_tpu_torch.formats.checkpoint import (
            load_family_checkpoint,
            load_preprocessor,
        )

        family, spec, params = load_family_checkpoint(path)
        pre = load_preprocessor(path)
        if pre is None:
            raise ValueError(
                f"{path} carries no preprocessing config; save one with "
                "formats.checkpoint.save_preprocessor or construct "
                "FamilyClassifier directly"
            )
        names_path = os.path.join(path, "class_names.txt")
        names = (
            load_class_names(names_path) if os.path.exists(names_path)
            else None
        )
        return cls(family, spec, params, pre, names, **kwargs)


def accuracy_at_k(
    probs: np.ndarray, labels: np.ndarray, ks: Sequence[int] = (1, 2, 3, 4, 5)
) -> dict[int, float]:
    """Cumulative top-k accuracy (CalcPredAccu, CaffeEva.cc:263-295)."""
    order = np.argsort(-probs, axis=1)
    out = {}
    for k in ks:
        hits = (order[:, :k] == labels[:, None]).any(axis=1)
        out[k] = float(hits.mean())
    return out


def evaluate_dataset(
    forward_fn,
    params,
    images,
    labels: np.ndarray,
    *,
    batch_size: int = 64,
    ks: Sequence[int] = (1, 2, 3, 4, 5),
) -> dict:
    """Batched dataset evaluation (UT_CaffeEva analogue with real batching;
    the reference fixes batch=1, CaffeEva.cc:23).

    ``images`` is either an in-memory (N, H, W, C) array or an ITERATOR of
    row-chunk arrays (e.g. ``formats.read_bin_batches`` over the 500 MB
    ILSVRC val blob) — accuracy is accumulated per batch so nothing
    proportional to the dataset ever materializes.  A chunk larger than
    ``batch_size`` is re-split; a final ragged batch runs as-is. Each batch
    goes to the device of the prepared ``params``."""
    if isinstance(images, np.ndarray):
        # bind the array: a generator reading `images` would see itself (the
        # JAX package's version raises TypeError on an array for that)
        array = images
        images = (array[i : i + batch_size]
                  for i in range(0, array.shape[0], batch_size))
    device = None
    timers = TimerSet()
    n = 0
    hits = {k: 0 for k in ks}
    for chunk in images:
        for j in range(0, chunk.shape[0], batch_size):
            if device is None:
                device = _params_device(params)
            xb = upload(chunk[j : j + batch_size], device)
            lb = labels[n : n + xb.shape[0]]
            with timers.time("forward"):
                pb = forward_fn(params, xb).float().cpu().numpy()
            order = np.argsort(-pb, axis=1)
            for k in ks:
                hits[k] += int((order[:, :k] == lb[:, None]).any(axis=1).sum())
            n += xb.shape[0]
    acc = {k: hits[k] / max(n, 1) for k in ks}
    report = timers.report()
    # empty dataset (e.g. a --limit that truncates to zero rows): report
    # zero images cleanly instead of KeyError on the never-started timer
    fwd = report.get("forward", {"total_s": 0.0})
    return {
        "accuracy": acc,
        "images": n,
        "forward_s": fwd["total_s"],
        "images_per_s": n / fwd["total_s"] if fwd["total_s"] else 0.0,
    }
