"""Command-line entry points of the port: ``python -m qcnn_tpu_torch ...``.

A port of ``qcnn_tpu/cli.py`` with the same subcommands, flags and printed
output. The reference selects between its three scenarios by editing
src/Main.cc:10-23 and recompiling; here each scenario (and the ones the
reference lacks) is a subcommand.

Every subcommand that runs a model takes ``--device {cuda,cpu}``, default
``cuda``: it raises without a card unless the CPU is asked for, and then
runs the kernels' plain versions (``quantize`` and ``make-family`` also take
the JAX package's ``--cpu`` as an alias of ``--device cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# classify — single/multi image (UT_CaffeEvaWrapper, src/UnitTest.cc:67-124)
# ---------------------------------------------------------------------------

# Family-model registry names (models/resnet.py RESNETS + models/vit.py
# VITS), kept as a literal so parser construction stays import-light.
_FAMILY_MODELS = ("resnet18", "resnet50", "resnet101", "resnet152",
                  "vit_s16", "vit_b16", "vit_l16")
_DTYPES = ("bfloat16", "float32", "int8")


def _impl_kwargs(args) -> dict:
    """--memory-mode -> keep only compressed PQ params resident (in-step
    decode); --dtype -> execution dtype (int8 = int8 weights with bf16
    activations); --device -> the card or, when asked, the CPU."""
    kw = {"device": args.device}
    if getattr(args, "memory_mode", False):
        kw.update(conv_impl="memory", fc_impl="memory")
    if getattr(args, "dtype", None):
        kw["compute_dtype"] = _dtype_arg(args.dtype)
    # memory-mode strategies resolve per batch (models/common.py): eval
    # runs batched, so the hint must be the eval batch, not 1 (the batch-1
    # lutgather kernel is linear in B)
    if getattr(args, "batch", None):
        kw["batch_hint"] = args.batch
    return kw


def _dtype_arg(name: str):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "int8": torch.int8}[name]


def _family_kwargs(args) -> dict:
    """FamilyClassifier kwargs from the shared CLI flags (classify/eval)."""
    kw = {"memory": bool(getattr(args, "memory_mode", False)),
          "device": args.device}
    if getattr(args, "dtype", None):
        kw["compute_dtype"] = _dtype_arg(args.dtype)
    return kw


def _class_names_in(path: str):
    """The checkpoint's embedded class names, or None."""
    from qcnn_tpu_torch.models.loader import load_class_names

    names_path = os.path.join(path, "class_names.txt")
    return load_class_names(names_path) if os.path.exists(names_path) else None


def cmd_classify(args) -> int:
    from qcnn_tpu_torch.eval.harness import Classifier, FamilyClassifier

    paths = []
    for pattern in args.images:
        matched = sorted(glob.glob(pattern))
        paths.extend(matched if matched else [pattern])
    # classify runs ONE batch over the expanded image list: resolve
    # memory-mode strategies for that exact batch (a single image keeps
    # the batch-1 lutgather kernel; many images get the batched fgather
    # one — models/common.py)
    ik = dict(_impl_kwargs(args), batch_hint=max(1, len(paths)))
    if args.checkpoint:
        with open(os.path.join(args.checkpoint, "manifest.json")) as f:
            manifest = json.load(f)
        if "family" in manifest:
            clf = FamilyClassifier.from_checkpoint(
                args.checkpoint, **_family_kwargs(args)
            )
        else:
            clf = Classifier.from_checkpoint(args.checkpoint, **ik)
    else:
        clf = Classifier.from_reference(
            args.model,
            args.reference_dir,
            class_names_path=os.path.join(
                args.reference_dir, "Cls.Names", "class_names.txt"
            ),
            image_labels_path=os.path.join(
                args.reference_dir, "Cls.Names", "image_labels.txt"
            ),
            **ik,
        )
    if getattr(clf, "load_result", None) and clf.load_result.synthesized_layers:
        log(f"[WARN] layers {clf.load_result.synthesized_layers} use "
            "synthesized assignments (upstream blob missing); predictions "
            "from those layers are not meaningful")
    correct = 0
    judged = 0
    # One batched forward over all images (threaded native preprocessing);
    # the reference loops batch-1 (CaffeEva.cc:23,167).
    results = clf.classify_batch(paths, top_k=args.top_k)
    for p, res in zip(paths, results):
        print(f"{os.path.basename(p)}:")
        for cid, prob, name in zip(res.class_ids, res.probs, res.class_names):
            print(f"  {prob:6.4f}  {cid:4d}  {name}")
        if res.ground_truth is not None:
            # compare by id: ImageNet names are not unique (two 'crane'
            # classes), so name membership over-counts hits
            hit = (res.ground_truth_id in res.class_ids
                   if res.ground_truth_id is not None
                   else res.ground_truth in res.class_names)
            judged += 1
            correct += hit
            print(f"  ground truth: {res.ground_truth}"
                  f" ({'HIT' if hit else 'MISS'} in top-{args.top_k})")
    if judged:
        print(f"top-{args.top_k} accuracy over {judged} labeled images: "
              f"{correct / judged:.3f}")
    return 0


# ---------------------------------------------------------------------------
# eval — dataset accuracy (UT_CaffeEva, src/UnitTest.cc:27-65)
# ---------------------------------------------------------------------------

def cmd_eval(args) -> int:
    import numpy as np

    from qcnn_tpu_torch.eval.harness import (
        Classifier, FamilyClassifier, accuracy_at_k,
    )

    is_family = False
    if args.checkpoint:
        from qcnn_tpu_torch.models.loader import load_image_labels

        with open(os.path.join(args.checkpoint, "manifest.json")) as f:
            is_family = "family" in json.load(f)
        if is_family:
            clf = FamilyClassifier.from_checkpoint(
                args.checkpoint, **_family_kwargs(args)
            )
        else:
            clf = Classifier.from_checkpoint(
                args.checkpoint, **_impl_kwargs(args)
            )
        labels_path = args.labels or os.path.join(
            args.reference_dir, "Cls.Names", "image_labels.txt"
        )
        if os.path.exists(labels_path):
            clf.image_labels = load_image_labels(labels_path)
        elif args.labels:
            log(f"error: --labels file not found: {args.labels}")
            return 2
    else:
        clf = Classifier.from_reference(
            args.model,
            args.reference_dir,
            class_names_path=os.path.join(
                args.reference_dir, "Cls.Names", "class_names.txt"
            ),
            image_labels_path=os.path.join(
                args.reference_dir, "Cls.Names", "image_labels.txt"
            ),
            **_impl_kwargs(args),
        )
    if args.images:
        # BMP-set eval through the checkpoint's own preprocessing — the
        # dataset-accuracy surface for imported pretrained weights (the
        # reference blob is pre-preprocessed Caffe tensors, wrong semantics
        # for torch-trained models)
        paths = sorted(
            p for pattern in args.images for p in glob.glob(pattern)
        )
        labeled = [
            p for p in paths
            if os.path.splitext(os.path.basename(p))[0] in clf.image_labels
        ]
        if not labeled:
            log("error: no images matched --images with a label in the "
                "labels file")
            return 1
        if args.limit:
            labeled = labeled[: args.limit]
        import time as _time

        ks = (1, 2, 3, 4, 5)
        hits = {k: 0 for k in ks}
        n = 0
        t0 = _time.perf_counter()
        for j in range(0, len(labeled), args.batch):
            chunk = labeled[j : j + args.batch]
            probs = clf._probs(clf.pre.load_batch(chunk))
            lab = np.asarray([
                clf.image_labels[os.path.splitext(os.path.basename(p))[0]]
                for p in chunk
            ])
            order = np.argsort(-probs, axis=1)
            for k in ks:
                hits[k] += int(
                    (order[:, :k] == lab[:, None]).any(axis=1).sum()
                )
            n += len(chunk)
        dt = _time.perf_counter() - t0
        for k in ks:
            print(f"ACCURACY@{k}: {hits[k] / n:.4f}")
        print(f"{n} images, {n / dt:.1f} img/s (incl. host preprocessing)")
        return 0
    data_path = os.path.join(
        args.reference_dir, "ILSVRC12.227x227.IMG", "dataMatTst.single.bin"
    )
    labl_path = os.path.join(
        args.reference_dir, "ILSVRC12.227x227.IMG", "lablVecTst.uint16.bin"
    )
    if is_family and os.path.exists(data_path):
        log("note: the reference val blob is Caffe-preprocessed 227x227 "
            "tensors — wrong semantics for a family checkpoint; use "
            "--images GLOB --labels FILE instead. Falling back to "
            "shipped BMPs.")
    elif os.path.exists(data_path):
        from qcnn_tpu_torch.eval.harness import evaluate_dataset
        from qcnn_tpu_torch.formats import read_bin, read_bin_batches

        # --limit 0 = unlimited (matches the streaming generator below)
        labels = read_bin(labl_path, np.uint16).reshape(-1)
        if args.limit:
            labels = labels[: args.limit]

        def batches():
            # stream the (500 MB at full size) val blob in batch-row chunks,
            # NCHW -> NHWC per chunk; never materialize the whole tensor
            done = 0
            for chunk in read_bin_batches(data_path, np.float32, args.batch):
                if args.limit and done + chunk.shape[0] > args.limit:
                    chunk = chunk[: args.limit - done]
                if chunk.shape[0] == 0:
                    return
                done += chunk.shape[0]
                yield np.transpose(chunk, (0, 2, 3, 1))
                if args.limit and done >= args.limit:
                    return

        rep = evaluate_dataset(
            clf._fwd, clf.params, batches(), labels.astype(np.int64),
            batch_size=args.batch,
        )
        for k, v in rep["accuracy"].items():
            print(f"ACCURACY@{k}: {v:.4f}")
        print(f"{rep['images']} images, {rep['images_per_s']:.1f} img/s")
        return 0
    # Fallback: the 10 shipped BMPs with labels (the big .bin is a
    # download-only blob, reference README.md:7-11)
    if not (is_family and os.path.exists(data_path)):
        # (the family case already logged its wrong-semantics note above)
        log(f"dataset blob not found at {data_path}; evaluating shipped BMPs")
    bmps = sorted(
        glob.glob(os.path.join(args.reference_dir, "Bmp.Files", "*.BMP"))
    )
    if args.limit:
        bmps = bmps[: args.limit]
    if not bmps:
        log("no BMP files found either — nothing to evaluate")
        return 1
    labeled = [
        p for p in bmps
        if os.path.splitext(os.path.basename(p))[0] in clf.image_labels
    ]
    if not labeled:
        log("error: none of the shipped BMPs have a ground-truth label "
            "(labels file missing or mismatched) — nothing to evaluate")
        return 1
    probs = clf._probs(clf.pre.load_batch(labeled))  # threaded native
    labels = [
        clf.image_labels[os.path.splitext(os.path.basename(p))[0]]
        for p in labeled
    ]
    acc = accuracy_at_k(probs, np.asarray(labels))
    for k, v in acc.items():
        print(f"ACCURACY@{k}: {v:.4f}  ({len(labels)} images)")
    return 0


# ---------------------------------------------------------------------------
# convert — assignment encoding round-trip (UT_CaffePara, UnitTest.cc:15-25)
# ---------------------------------------------------------------------------

def cmd_convert(args) -> int:
    from qcnn_tpu_torch.formats import convert_asmt

    convert_asmt(args.src, args.dst)
    log(f"converted {args.src} -> {args.dst}")
    return 0


# ---------------------------------------------------------------------------
# calibrate — static int8 activation scales (checkpoint sidecar)
# ---------------------------------------------------------------------------

def cmd_calibrate(args) -> int:
    """One bf16 pass over calibration inputs -> act_scales.json sidecar.
    int8 serving then skips the dynamic per-tensor amax."""
    import numpy as np
    import torch

    from qcnn_tpu_torch.formats.checkpoint import (
        load_checkpoint, load_preprocessor, save_act_scales,
    )
    from qcnn_tpu_torch.models.calibrate import calibrate_act_scales
    from qcnn_tpu_torch.models.prepare import prepare_params

    spec, params = load_checkpoint(args.checkpoint)
    prepared, ci, fi = prepare_params(spec, params, dtype=torch.bfloat16,
                                      device=args.device)
    if args.images:
        pre = load_preprocessor(args.checkpoint)
        if pre is None:
            log("error: checkpoint has no preprocessing config; "
                "use synthetic calibration (omit --images)")
            return 2
        paths = sorted(sum((glob.glob(p) for p in args.images), []))
        if not paths:
            log("error: no calibration images matched")
            return 2
        x = pre.load_batch(paths)
        log(f"calibrating on {len(paths)} images")
    else:
        rng = np.random.default_rng(args.seed)
        x = rng.standard_normal(
            (args.batch, spec.in_height, spec.in_width, spec.in_channels)
        ).astype(np.float32)
        log(f"calibrating on {args.batch} synthetic inputs (prefer --images "
            "with real data for production scales)")
    scales = calibrate_act_scales(
        spec, prepared, x,
        conv_impls=ci, fc_impls=fi, margin=args.margin, device=args.device,
    )
    save_act_scales(args.checkpoint, scales)
    log(f"wrote {len(scales)} act scales to "
        f"{os.path.join(args.checkpoint, 'act_scales.json')}")
    return 0


# ---------------------------------------------------------------------------
# import / export — reference files <-> native checkpoint
# ---------------------------------------------------------------------------

def cmd_import(args) -> int:
    from qcnn_tpu_torch.formats.checkpoint import save_checkpoint
    from qcnn_tpu_torch.models.loader import load_reference_model
    from qcnn_tpu_torch.models.zoo import get_model

    spec = get_model(args.model)
    res = load_reference_model(
        spec, args.weights_dir, args.prefix,
        synthesize_missing=args.synthesize_missing,
    )
    if res.synthesized_layers:
        log(f"[WARN] synthesized assignments for layers "
            f"{res.synthesized_layers}")
    save_checkpoint(args.checkpoint, spec, res.params, store=args.store)
    # self-contained serving artifact: embed preprocessing + class names
    # when the reference layout provides them
    try:
        from qcnn_tpu_torch.eval.harness import _MODEL_WIRING
        from qcnn_tpu_torch.formats.checkpoint import save_preprocessor

        key = args.model.lower().replace("-", "_")
        if key in _MODEL_WIRING:
            subdir, _, pre_factory = _MODEL_WIRING[key]
            mean_path = os.path.join(
                os.path.dirname(args.weights_dir.rstrip("/")),
                "imagenet_mean.single.bin",
            )
            if os.path.exists(mean_path):
                save_preprocessor(args.checkpoint, pre_factory(mean_path))
                log("embedded preprocessing config")
        names_path = os.path.join(
            os.path.dirname(os.path.dirname(args.weights_dir.rstrip("/"))),
            "Cls.Names", "class_names.txt",
        )
        if os.path.exists(names_path):
            import shutil

            shutil.copy(names_path,
                        os.path.join(args.checkpoint, "class_names.txt"))
            log("embedded class names")
    except Exception as e:  # noqa: BLE001 - extras are best-effort
        log(f"[WARN] could not embed preproc/class names: {e}")
    log(f"wrote checkpoint {args.checkpoint}")
    return 0


def cmd_export(args) -> int:
    from qcnn_tpu_torch.formats.checkpoint import load_checkpoint
    from qcnn_tpu_torch.models.loader import save_reference_model

    spec, params = load_checkpoint(args.checkpoint)
    save_reference_model(
        spec, params, args.weights_dir, args.prefix, encoding=args.encoding
    )
    log(f"exported {args.checkpoint} -> {args.weights_dir}/{args.prefix}.*")
    return 0


# ---------------------------------------------------------------------------
# quantize — FP32 checkpoint -> PQ checkpoint (the reference delegates this
# to offline MATLAB; here it is a PyTorch program on the card)
# ---------------------------------------------------------------------------

def _quantizer_generator(args):
    """The quantizer's generator, seeded with --seed, on the device asked
    for (--cpu is --device cpu); raises without a card unless the CPU is
    asked for."""
    import torch

    from qcnn_tpu_torch._device import resolve_device

    device = resolve_device("cpu" if args.cpu else args.device)
    return torch.Generator(device=device).manual_seed(args.seed)


def cmd_quantize(args) -> int:
    import numpy as np

    from qcnn_tpu_torch.formats.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    gen = _quantizer_generator(args)
    src = str(args.checkpoint)
    embed_torch_preproc = False
    if src.endswith((".caffemodel", ".pt", ".pth", ".onnx")):
        # FP32 weight files: Caffe protobuf (the reference lineage's
        # format), a torchvision-style state_dict (features./classifier.
        # naming), or an ONNX graph (Conv/Gemm/MatMul weights in node order)
        if not args.arch:
            log("error: --arch is required for weight-file input "
                "(the file carries weights, not topology)")
            return 2
        from qcnn_tpu_torch.models import zoo

        spec = zoo.get_model(args.arch)
        if src.endswith(".caffemodel"):
            from qcnn_tpu_torch.formats.caffe_pb import import_caffemodel

            params = import_caffemodel(args.checkpoint, spec)
        elif src.endswith(".onnx"):
            from qcnn_tpu_torch.formats.onnx_import import import_onnx

            params = import_onnx(args.checkpoint, spec)
            # ONNX exports on this lineage come from torch/TF training
            # stacks whose eval transform is the [0,1] mean/std one
            embed_torch_preproc = True
        else:
            from qcnn_tpu_torch.models.torch_import import load_torch_linear

            params = load_torch_linear(spec, args.checkpoint)
            embed_torch_preproc = True
        log(f"imported {args.checkpoint} into {spec.name} "
            f"({sum(p is not None for p in params)} learnable layers)")
    else:
        spec, params = load_checkpoint(args.checkpoint)
    # per-layer overrides: the reference's codebook geometry varies per
    # layer (SURVEY.md §2a: fc8 uses scalar sub-spaces with 16 codewords
    # while fc6/fc7 use 4-wide/32); --layer-config exposes that as JSON,
    # e.g. '{"21": {"subvec_len": 1, "codewords": 16}}' (keys = indices)
    overrides = {}
    if args.layer_config:
        overrides = {
            int(k): v for k, v in json.loads(args.layer_config).items()
        }
    x_calib = None
    if args.calib_npy:
        x_calib = np.load(args.calib_npy).astype(np.float32)
        if x_calib.ndim != 4:
            log(f"error: --calib-npy must be (B, H, W, C); got "
                f"{x_calib.shape}")
            return 2
        log(f"sequential error-corrected PQ over {x_calib.shape[0]} "
            "calibration inputs (quantized-prefix activations per layer)")
    elif args.calib_random:
        x_calib = np.random.default_rng(args.seed + 1).standard_normal(
            (args.calib_random, spec.in_height, spec.in_width,
             spec.in_channels)
        ).astype(np.float32)
        log(f"sequential error-corrected PQ over {args.calib_random} "
            "random calibration inputs (mechanics only; use --calib-npy "
            "with real preprocessed images for accuracy-relevant scales)")

    from qcnn_tpu_torch.quantizer.sequential import quantize_network

    out_params = quantize_network(
        gen, spec, params,
        conv_subvec_len=args.conv_subvec_len,
        conv_codewords=args.conv_codewords,
        fc_subvec_len=args.fc_subvec_len,
        fc_codewords=args.fc_codewords,
        overrides=overrides, x_calib=x_calib, seed=args.seed,
        opq=args.opq, log=log,
    )
    save_checkpoint(args.out, spec, out_params, store=args.store)
    if embed_torch_preproc:
        # torch-trained weights expect the torch eval transform (RGB,
        # mean/std): embed it so classify/serve use correct semantics
        from qcnn_tpu_torch.formats.checkpoint import save_preprocessor
        from qcnn_tpu_torch.preproc import TorchPreprocessor

        save_preprocessor(
            args.out, TorchPreprocessor.imagenet(crop=spec.in_height)
        )
    log(f"wrote PQ checkpoint {args.out}")
    return 0


# ---------------------------------------------------------------------------
# make-family — build a quantized ResNet/ViT checkpoint (random dense init,
# or a torch state_dict)
# ---------------------------------------------------------------------------

def _family_module(model: str):
    """(family name, module, spec) of a family registry name."""
    if model.startswith("resnet"):
        from qcnn_tpu_torch.models import resnet as fam

        return "resnet", fam, fam.RESNETS[model]()
    from qcnn_tpu_torch.models import vit as fam

    return "vit", fam, fam.VITS[model]()


def cmd_make_family(args) -> int:
    from qcnn_tpu_torch.formats.checkpoint import save_family_checkpoint

    gen = _quantizer_generator(args)
    family, fam, spec = _family_module(args.model)
    if args.from_torch:
        from qcnn_tpu_torch.models import torch_import

        if family == "resnet":
            dense = torch_import.load_torch_resnet(spec, args.from_torch)
            log(f"imported torchvision-format weights from "
                f"{args.from_torch} (BatchNorms folded)")
        else:
            dense = torch_import.load_torch_vit(spec, args.from_torch)
            log(f"imported timm-format ViT weights from {args.from_torch}")
    else:
        dense = fam.init_dense_params(spec, seed=args.seed)
    if args.dense:
        params = dense
    elif args.calib_npy or args.calib_random:
        # sequential error-corrected PQ against (quantized-prefix)
        # activations — the CVPR'16 scheme, family edition
        import numpy as np

        if args.calib_npy:
            x_calib = np.load(args.calib_npy).astype(np.float32)
        else:
            size = spec.in_size if family == "resnet" else spec.image_size
            x_calib = np.random.default_rng(args.seed + 1).standard_normal(
                (args.calib_random, size, size, 3)).astype(np.float32)
        from qcnn_tpu_torch.quantizer import sequential as seq

        log(f"sequential error-corrected PQ over {x_calib.shape[0]} "
            "calibration inputs")
        if family == "resnet":
            params = seq.quantize_resnet_ec(gen, spec, dense, x_calib,
                                            seed=args.seed)
        else:
            params = seq.quantize_vit_ec(gen, spec, dense, x_calib,
                                         seed=args.seed)
    else:
        params = fam.quantize_params(spec, dense, device=gen.device)
    save_family_checkpoint(args.out, family, spec, params, store=args.store)
    # Embed the torch-ecosystem eval transform so the checkpoint is a
    # self-contained classify/serve artifact (like the linear import path;
    # the reference wires preproc in code, CaffeEvaWrapper.cc:54-85).
    from qcnn_tpu_torch.formats.checkpoint import save_preprocessor
    from qcnn_tpu_torch.preproc import TorchPreprocessor

    crop = spec.in_size if family == "resnet" else spec.image_size
    save_preprocessor(
        args.out, TorchPreprocessor.imagenet(crop=crop,
                                             resize=max(256, crop))
    )
    if args.class_names:
        import shutil

        shutil.copyfile(args.class_names,
                        os.path.join(args.out, "class_names.txt"))
    log(f"wrote {'dense' if args.dense else 'PQ'} {args.model} "
        f"checkpoint {args.out}")
    return 0


# ---------------------------------------------------------------------------
# serve — continuous-batching HTTP daemon (the reference has no serving
# story; its loop is synchronous batch-1, CaffeEva.cc:167-210)
# ---------------------------------------------------------------------------

def _build_family_engine(family: str, spec, params, config, *,
                         memory_mode: bool, compute_dtype, device=None):
    """One engine builder for every family-params source: compute-dtype
    defaulting, the int8->bf16 activation rule, prepare, the partial
    forward, and the bf16 upload dtype."""
    from qcnn_tpu_torch.models.common import build_family_forward
    from qcnn_tpu_torch.serve.engine import BatchingEngine, _upload_dtype_for

    prepared, fwd, act_dtype = build_family_forward(
        family, spec, params, memory=memory_mode,
        compute_dtype=compute_dtype, device=device,
    )
    size = getattr(spec, "in_size", None) or spec.image_size
    return BatchingEngine.from_forward(
        fwd, prepared, (size, size, 3), config=config,
        upload_dtype=_upload_dtype_for(act_dtype), device=device,
    )


def family_engine_from_checkpoint(path: str, config,
                                  *, memory_mode: bool = False,
                                  compute_dtype=None, device=None):
    """Build (engine, preprocessor, class_names) from a family checkpoint
    — a self-contained serving artifact: the embedded torch-style eval
    transform makes BMP uploads work like the linear models (raw X-Shape
    tensors remain accepted). The engine is returned un-started."""
    from qcnn_tpu_torch.formats.checkpoint import (
        load_family_checkpoint, load_preprocessor,
    )

    family, spec, params = load_family_checkpoint(path)
    engine = _build_family_engine(
        family, spec, params, config,
        memory_mode=memory_mode, compute_dtype=compute_dtype, device=device,
    )
    return engine, load_preprocessor(path), _class_names_in(path)


def linear_engine_from_checkpoint(path: str, config, **engine_kwargs):
    """Build (engine, preprocessor, class_names) from a linear-spec
    checkpoint, with its calibrated int8 activation scales when it carries
    them (the calibrate sidecar; without them int8 takes the dynamic
    amax). The engine is returned un-started."""
    from qcnn_tpu_torch.formats.checkpoint import (
        load_act_scales, load_checkpoint, load_preprocessor,
    )
    from qcnn_tpu_torch.serve.engine import BatchingEngine

    spec, params = load_checkpoint(path)
    engine_kwargs.setdefault("act_scales", load_act_scales(path))
    engine = BatchingEngine(spec, params, config=config, **engine_kwargs)
    return engine, load_preprocessor(path), _class_names_in(path)


def cmd_serve(args) -> int:
    from qcnn_tpu_torch.serve.engine import BatchingEngine, EngineConfig
    from qcnn_tpu_torch.serve.http import serve as http_serve

    manifest = None
    if args.checkpoint:
        with open(os.path.join(args.checkpoint, "manifest.json")) as f:
            manifest = json.load(f)
    max_batch = args.max_batch
    buckets = None
    if not max_batch:
        # per-family serving defaults (models/common.serving_defaults,
        # copied from the JAX package). For a checkpoint, the manifest
        # decides (its spec's name when present, else the family string).
        from qcnn_tpu_torch.models.common import serving_defaults

        if manifest is not None:
            key = manifest.get("family") or ""
            spec_path = os.path.join(args.checkpoint, "spec.json")
            if os.path.exists(spec_path):  # family ckpts: the model name
                with open(spec_path) as f:
                    key = json.load(f).get("name", key)
        else:
            key = args.model
        defaults = serving_defaults(key)
        max_batch = defaults["max_batch"]
        buckets = defaults["buckets"]
    config = EngineConfig(
        max_batch=max_batch, max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue, deadline_ms=args.deadline_ms,
        buckets=buckets,
    )
    compute_dtype = _dtype_arg(args.dtype) if args.dtype else None
    preprocessor = None
    class_names = None
    if args.checkpoint:
        if "family" in manifest:
            engine, preprocessor, class_names = family_engine_from_checkpoint(
                args.checkpoint, config, memory_mode=args.memory_mode,
                compute_dtype=compute_dtype, device=args.device,
            )
        else:
            engine, preprocessor, class_names = linear_engine_from_checkpoint(
                args.checkpoint, config, **_impl_kwargs(args)
            )
    elif args.model in _FAMILY_MODELS:
        # family models: synthetic PQ weights (no pretrained checkpoints
        # ship offline), quantized on the serving device from a random
        # dense init; serves raw preprocessed tensors via X-Shape.
        # --memory-mode keeps only compressed params resident.
        family, fam, spec = _family_module(args.model)
        pq = fam.quantize_params(spec, fam.init_dense_params(spec, seed=0),
                                 device=args.device)
        engine = _build_family_engine(
            family, spec, pq, config, memory_mode=args.memory_mode,
            compute_dtype=compute_dtype, device=args.device,
        )
    else:
        from qcnn_tpu_torch.eval.harness import _MODEL_WIRING
        from qcnn_tpu_torch.models.loader import (
            load_class_names, load_reference_model,
        )
        from qcnn_tpu_torch.models.zoo import get_model

        key = args.model.lower().replace("-", "_")
        if key not in _MODEL_WIRING:
            raise KeyError(f"unsupported reference model {args.model!r}")
        subdir, prefix, pre_factory = _MODEL_WIRING[key]
        spec = get_model(key)
        res = load_reference_model(
            spec, os.path.join(args.reference_dir, subdir, "Bin.Files"),
            prefix, synthesize_missing=True,
        )
        engine = BatchingEngine(
            spec, res.params, config=config, **_impl_kwargs(args)
        )
        preprocessor = pre_factory(os.path.join(
            args.reference_dir, subdir, "imagenet_mean.single.bin"))
        names_path = os.path.join(args.reference_dir, "Cls.Names",
                                  "class_names.txt")
        class_names = (load_class_names(names_path)
                       if os.path.exists(names_path) else None)
    engine.start()
    log("warming up bucket programs...")
    for bucket, ms in engine.warmup().items():
        log(f"  bucket {bucket}: {ms:.1f} ms")
    log(f"serving on http://{args.host}:{args.port}")
    http_serve(
        engine,
        host=args.host,
        port=args.port,
        preprocessor=preprocessor,
        class_names=class_names,
    )
    return 0


def cmd_route(args) -> int:
    from qcnn_tpu_torch.serve.router import serve_router

    log(f"routing on http://{args.host}:{args.port} -> {args.backends}")
    serve_router(
        args.backends, host=args.host, port=args.port,
        cooldown_s=args.cooldown_s,
    )
    return 0


# ---------------------------------------------------------------------------
# profile — per-layer device times (DispElpsTime, CaffeEva.cc:297-326)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _profiler_trace(directory, device):
    """With a directory: the block under ``torch.profiler`` (host and, on
    the card, device activity), its Chrome trace written into the
    directory at the end. A trace that cannot be written raises."""
    if directory is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(directory, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(directory, "profile_trace.json")
    prof.export_chrome_trace(path)
    log(f"wrote profiler trace {path}")


def cmd_profile(args) -> int:
    from qcnn_tpu_torch._device import resolve_device
    from qcnn_tpu_torch.eval.profiler import (
        format_table,
        profile_layers,
        profile_step_decode,
    )
    from qcnn_tpu_torch.models import synth
    from qcnn_tpu_torch.models.loader import load_alexnet_reference
    from qcnn_tpu_torch.models.prepare import act_dtype_for, prepare_params
    from qcnn_tpu_torch.models.zoo import get_model

    device = resolve_device(args.device)
    if args.model in _FAMILY_MODELS:
        return _profile_family(args, device)
    spec = get_model(args.model)
    if args.model == "alexnet" and os.path.isdir(args.reference_dir):
        params = load_alexnet_reference(
            args.reference_dir, synthesize_missing=True
        ).params
    else:
        params = synth.random_pq_params(spec, seed=0)
    dtype = _dtype_arg(args.dtype)
    prepared, ci, fi = prepare_params(
        spec, params, batch_hint=args.batch, conv_impl=args.conv_impl,
        fc_impl=args.fc_impl, dtype=dtype, device=device,
    )
    # the one activation-dtype rule (an inline copy could drift from what
    # the forwards execute)
    act_dtype = act_dtype_for(dtype)
    x = synth.random_input(spec, args.batch, seed=1)
    with _profiler_trace(args.trace, device):
        profs = profile_layers(spec, prepared, x, conv_impls=ci, fc_impls=fi,
                               compute_dtype=act_dtype, device=device)
        step_decode = profile_step_decode(spec, prepared, ci, device=device)
    print(format_table(profs, step_decode_seconds=step_decode))
    return 0


def _profile_family(args, device) -> int:
    """Per-segment time table for ResNet/ViT (the family analogue of the
    per-layer DispElpsTime tables). --conv-impl/--fc-impl 'auto' decodes
    the weights at load, as the JAX package's command does; 'memory' keeps
    them compressed and decodes in the step (prepare_params(memory=True))."""
    import numpy as np

    from qcnn_tpu_torch.eval.profiler import profile_segments
    from qcnn_tpu_torch.models.prepare import act_dtype_for

    impls = {args.conv_impl, args.fc_impl}
    if not impls <= {"auto", "memory"}:
        raise ValueError(f"profile --model {args.model}: the families take "
                         f"--conv-impl/--fc-impl auto or memory, got "
                         f"{sorted(impls)}")
    memory = "memory" in impls
    family, fam, spec = _family_module(args.model)
    size = spec.in_size if family == "resnet" else spec.image_size
    dtype = _dtype_arg(args.dtype)
    pq = fam.quantize_params(spec, fam.init_dense_params(spec, seed=0),
                             device=device)
    prepared = fam.prepare_params(spec, pq, dtype=dtype, memory=memory,
                                  device=device)
    act_dtype = act_dtype_for(dtype)
    x = np.random.default_rng(1).standard_normal(
        (args.batch, size, size, 3)
    ).astype(np.float32)
    segs = fam.forward_segments(spec, compute_dtype=act_dtype)
    with _profiler_trace(args.trace, device):
        rows = profile_segments(segs, x, prepared, device=device)
    total = sum(t for _, t in rows)
    mode = "memory mode" if memory else "decoded at load"
    print(f"{args.model} batch={args.batch} {args.dtype} {mode} "
          f"(synthetic PQ weights)")
    print(f"{'segment':<12} {'ms':>9} {'%':>6}")
    for name, t in rows:
        print(f"{name:<12} {t*1e3:>9.3f} {100*t/max(total,1e-12):>6.1f}")
    print(f"{'total':<12} {total*1e3:>9.3f}")
    return 0


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default; raises without one) or "
                        "on the CPU with the kernels' plain versions")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="qcnn_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    dtype_help = ("execution dtype (default: bf16 on the card, f32 on the "
                  "CPU; int8 = weight mode with bf16 activations)")
    memory_help = ("keep only compressed PQ params resident "
                   "(in-step decode)")

    c = sub.add_parser("classify", help="classify BMP images")
    c.add_argument("images", nargs="+")
    c.add_argument("--model", default="alexnet")
    c.add_argument("--reference-dir", default="/root/reference")
    c.add_argument("--checkpoint", default=None,
                   help="classify with a self-contained native checkpoint")
    c.add_argument("--top-k", type=int, default=5)
    c.add_argument("--memory-mode", action="store_true", help=memory_help)
    c.add_argument("--dtype", default=None, choices=_DTYPES, help=dtype_help)
    _add_device(c)
    c.set_defaults(fn=cmd_classify)

    e = sub.add_parser("eval", help="dataset accuracy")
    e.add_argument("--model", default="alexnet")
    e.add_argument("--reference-dir", default="/root/reference")
    e.add_argument("--checkpoint", default=None,
                   help="evaluate a self-contained native checkpoint")
    e.add_argument("--batch", type=int, default=64)
    e.add_argument("--limit", type=int, default=1000)
    e.add_argument("--memory-mode", action="store_true", help=memory_help)
    e.add_argument("--images", nargs="+", default=None, metavar="GLOB",
                   help="evaluate over these BMPs through the checkpoint's "
                        "own preprocessing (instead of the reference's "
                        "pre-preprocessed val blob)")
    e.add_argument("--labels", default=None, metavar="PATH",
                   help="image-labels file ('<stem> <class id>' per line) "
                        "for --images; defaults to the reference's "
                        "Cls.Names/image_labels.txt")
    e.add_argument("--dtype", default=None, choices=_DTYPES, help=dtype_help)
    _add_device(e)
    e.set_defaults(fn=cmd_eval)

    cal = sub.add_parser(
        "calibrate",
        help="static int8 activation scales -> checkpoint sidecar",
    )
    cal.add_argument("checkpoint")
    cal.add_argument("--images", nargs="+",
                     help="BMP globs for calibration (default: synthetic)")
    cal.add_argument("--batch", type=int, default=32)
    cal.add_argument("--margin", type=float, default=1.0)
    cal.add_argument("--seed", type=int, default=0)
    _add_device(cal)
    cal.set_defaults(fn=cmd_calibrate)

    v = sub.add_parser("convert", help="convert assignment .bin <-> .cbn")
    v.add_argument("src")
    v.add_argument("dst")
    v.set_defaults(fn=cmd_convert)

    im = sub.add_parser("import", help="reference files -> native checkpoint")
    im.add_argument("checkpoint")
    im.add_argument("--model", default="alexnet")
    im.add_argument("--weights-dir",
                    default="/root/reference/AlexNet/Bin.Files")
    im.add_argument("--prefix", default="bvlc_alexnet_aCaF")
    im.add_argument("--synthesize-missing", action="store_true")
    im.add_argument("--store", default="npz", choices=["npz", "orbax"],
                    help="parameter array store backend (orbax: not "
                         "ported yet, ROADMAP.md A13.2)")
    im.set_defaults(fn=cmd_import)

    ex = sub.add_parser("export", help="native checkpoint -> reference files")
    ex.add_argument("checkpoint")
    ex.add_argument("weights_dir")
    ex.add_argument("--prefix", default="exported")
    ex.add_argument("--encoding", default="cbn", choices=["cbn", "bin"])
    ex.set_defaults(fn=cmd_export)

    q = sub.add_parser("quantize", help="FP32 checkpoint -> PQ checkpoint")
    q.add_argument("checkpoint",
                   help="native checkpoint, a Caffe .caffemodel, a "
                        "torchvision-style .pt/.pth state_dict, or an "
                        ".onnx graph (weight files require --arch)")
    q.add_argument("out")
    q.add_argument("--arch", default=None,
                   help="zoo architecture name for weight-file input "
                        "(e.g. vgg16 for both a .caffemodel and a "
                        "torchvision vgg16 .pth)")
    q.add_argument("--conv-subvec-len", type=int, default=8)
    q.add_argument("--conv-codewords", type=int, default=128)
    q.add_argument("--fc-subvec-len", type=int, default=4)
    q.add_argument("--fc-codewords", type=int, default=32)
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--layer-config", default=None,
                   help='per-layer JSON overrides, e.g. '
                        '\'{"21": {"subvec_len": 1, "codewords": 16}}\'')
    q.add_argument("--calib-npy", default=None, metavar="PATH",
                   help="preprocessed (B, H, W, C) float32 .npy calibration "
                        "batch -> sequential ERROR-CORRECTED PQ: each layer "
                        "quantizes against activations from the already-"
                        "quantized prefix (the CVPR'16 scheme)")
    q.add_argument("--calib-random", type=int, default=0, metavar="N",
                   help="like --calib-npy but with N random inputs "
                        "(exercises the error-corrected path without data)")
    q.add_argument("--opq", default=None, choices=["variance"],
                   help="OPQ input permutation before sub-space splitting "
                        "(balanced variance allocation); lower quantization "
                        "error, same compression — but the result cannot be "
                        "exported to the reference file layout")
    q.add_argument("--cpu", action="store_true",
                   help="run the quantizer on the host CPU (--device cpu)")
    q.add_argument("--store", default="npz", choices=["npz", "orbax"],
                   help="parameter array store backend")
    _add_device(q)
    q.set_defaults(fn=cmd_quantize)

    mf = sub.add_parser("make-family",
                        help="build a ResNet/ViT PQ checkpoint")
    mf.add_argument("model", choices=list(_FAMILY_MODELS))
    mf.add_argument("out")
    mf.add_argument("--seed", type=int, default=0)
    mf.add_argument("--from-torch", default=None, metavar="PATH",
                    help="import a .pt/.pth state_dict instead of synthetic "
                         "weights: torchvision naming for ResNet "
                         "(BatchNorms folded), timm naming for ViT")
    mf.add_argument("--dense", action="store_true",
                    help="skip quantization (FP32 checkpoint)")
    mf.add_argument("--cpu", action="store_true",
                    help="run the quantizer on the host CPU (--device cpu)")
    mf.add_argument("--store", default="npz", choices=["npz", "orbax"],
                    help="parameter array store backend")
    mf.add_argument("--class-names", default=None, metavar="PATH",
                    help="embed a class-names file (one name per line) "
                         "into the checkpoint")
    mf.add_argument("--calib-npy", default=None, metavar="PATH",
                    help="preprocessed (B, H, W, 3) float32 .npy batch -> "
                         "sequential error-corrected PQ (each layer "
                         "quantizes against quantized-prefix activations)")
    mf.add_argument("--calib-random", type=int, default=0, metavar="N",
                    help="like --calib-npy with N random inputs")
    _add_device(mf)
    mf.set_defaults(fn=cmd_make_family)

    s = sub.add_parser("serve", help="continuous-batching HTTP daemon")
    s.add_argument("--model", default="alexnet")
    s.add_argument("--checkpoint", default=None,
                   help="serve a native checkpoint (linear or family) "
                        "instead of --model")
    s.add_argument("--reference-dir", default="/root/reference")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--max-batch", type=int, default=0,
                   help="0 = model-aware default (32 for ViT, 128 for "
                        "resnet101, else 64; models/common.serving_defaults)")
    s.add_argument("--max-wait-ms", type=float, default=2.0)
    s.add_argument("--max-queue", type=int, default=0,
                   help="bound the request queue; beyond it /classify "
                        "returns 503 (0 = unbounded)")
    s.add_argument("--memory-mode", action="store_true", help=memory_help)
    s.add_argument("--deadline-ms", type=float, default=0.0,
                   help="default per-request deadline; expired requests "
                        "get 504 without spending a batch slot (0 = none)")
    s.add_argument("--dtype", default=None, choices=_DTYPES, help=dtype_help)
    _add_device(s)
    s.set_defaults(fn=cmd_serve)

    rt = sub.add_parser("route",
                        help="multi-host router over serve backends")
    rt.add_argument("backends", nargs="+",
                    help="backend URLs, e.g. http://host1:8000")
    rt.add_argument("--host", default="127.0.0.1")
    rt.add_argument("--port", type=int, default=8080)
    rt.add_argument("--cooldown-s", type=float, default=5.0)
    rt.set_defaults(fn=cmd_route)

    p = sub.add_parser("profile",
                       help="per-layer (zoo) / per-segment (family) "
                            "device times")
    p.add_argument("--model", default="alexnet",
                   choices=["alexnet", "caffenet", "vgg_cnn_s", "vgg16",
                            "caffenet_fgb", "caffenet_fgd",
                            "resnet50", "resnet18", "vit_b16", "vit_s16"])
    p.add_argument("--reference-dir", default="/root/reference")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16", choices=_DTYPES)
    p.add_argument("--conv-impl", default="auto")
    p.add_argument("--fc-impl", default="auto")
    p.add_argument("--trace", default=None,
                   help="directory for a torch.profiler Chrome trace")
    _add_device(p)
    p.set_defaults(fn=cmd_profile)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except NotImplementedError as e:
        log(f"error: {e}")
        return 2
