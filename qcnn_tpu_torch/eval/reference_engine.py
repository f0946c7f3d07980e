"""Cross-engine parity harness: build and drive the REFERENCE C++ engine.

A copy of ``qcnn_tpu/eval/reference_engine.py`` over the port's writers
(``formats.reference_codec``, ``models.loader``) and forward pass: the same
binary, the same scratch layout, the same parser.

The reference (its checkout at ``REFERENCE_DIR``) is a dependency-free
C++11 binary (Makefile.native builds with naive BLAS fallbacks). This module
compiles its sources verbatim together with ``tools/parity_driver.cc`` (an
argv-driven replacement for the hard-coded UT_CaffeEvaWrapper driver,
src/UnitTest.cc:67-124), prepares a scratch data directory with the shipped
AlexNet weights, and runs the resulting binary on BMPs — giving the
reference engine's *actual output distribution* as a correctness oracle
instead of a re-derived one.

The upstream fc6 assignment blob is a missing large download
(.MISSING_LARGE_BLOBS). Parity is still exact in every other respect: the
scratch dir injects the loader's deterministic synthesized fc6 assignments
(models/loader.py:_synth_assignments) as a ``.cbn`` file, so both engines
run the *identical* weights end-to-end.

Everything lives under ``<repo>/.parity`` (gitignored) unless the caller
names another scratch directory; the reference checkout is never written
to.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np

REFERENCE_DIR = "/root/reference"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
SCRATCH_DIR = os.path.join(REPO_ROOT, ".parity")

# Reference translation units the driver needs (Main.cc is replaced by
# tools/parity_driver.cc; UnitTest.cc is unused).
_REF_SOURCES = (
    "BlasWrapper.cc",
    "BmpImgIO.cc",
    "CaffeEva.cc",
    "CaffeEvaWrapper.cc",
    "CaffePara.cc",
)


def available(reference_dir: str = REFERENCE_DIR) -> bool:
    return os.path.isdir(os.path.join(reference_dir, "src"))


def build_reference_binary(
    scratch_dir: str = SCRATCH_DIR, reference_dir: str = REFERENCE_DIR
) -> str:
    """Compile reference sources + parity driver; returns the binary path.

    Equivalent to Makefile.native (g++ -O2 -std=c++11, no external BLAS ->
    the naive fallback kernels in BlasWrapper compile in), with the repo's
    driver as main. Cached on source mtimes.
    """
    os.makedirs(scratch_dir, exist_ok=True)
    binary = os.path.join(scratch_dir, "parity_bin")
    driver = os.path.join(REPO_ROOT, "tools", "parity_driver.cc")
    srcs = [os.path.join(reference_dir, "src", s) for s in _REF_SOURCES]
    srcs.append(driver)
    if os.path.exists(binary):
        newest = max(os.path.getmtime(s) for s in srcs)
        if os.path.getmtime(binary) >= newest:
            return binary
    cmd = [
        "g++", "-O2", "-std=c++11", "-w",
        f"-I{os.path.join(reference_dir, 'include')}",
        *srcs,
        "-o", binary,
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return binary


def prepare_data_dir(
    scratch_dir: str = SCRATCH_DIR, reference_dir: str = REFERENCE_DIR
) -> str:
    """Scratch main-dir with shipped AlexNet assets symlinked in and the
    missing fc6 assignment file written from the loader's synthesized
    values.

    Layout mirrors what CaffeEvaWrapper::SetModel resolves relative to its
    main-dir argument (CaffeEvaWrapper.cc:88-95): AlexNet/Bin.Files/*,
    AlexNet/imagenet_mean.single.bin, plus Cls.Names/.
    """
    from qcnn_tpu_torch.formats.reference_codec import write_cbn
    from qcnn_tpu_torch.models.loader import load_alexnet_reference

    data_dir = os.path.join(scratch_dir, "data")
    bin_dir = os.path.join(data_dir, "AlexNet", "Bin.Files")
    os.makedirs(bin_dir, exist_ok=True)

    src_bin = os.path.join(reference_dir, "AlexNet", "Bin.Files")
    for name in os.listdir(src_bin):
        dst = os.path.join(bin_dir, name)
        if not os.path.lexists(dst):
            os.symlink(os.path.join(src_bin, name), dst)
    mean_dst = os.path.join(data_dir, "AlexNet", "imagenet_mean.single.bin")
    if not os.path.lexists(mean_dst):
        os.symlink(
            os.path.join(reference_dir, "AlexNet", "imagenet_mean.single.bin"),
            mean_dst,
        )
    cls_dst = os.path.join(data_dir, "Cls.Names")
    if not os.path.lexists(cls_dst):
        os.symlink(os.path.join(reference_dir, "Cls.Names"), cls_dst)

    # Inject the synthesized fc6 assignments both engines share. Layer 15
    # (0-based) -> file index 16 (CaffePara.cc:263-265 naming). write_cbn
    # stores 0-based bits; the reference's ReadCbnFile +1 then the MATLAB
    # fixup -1 (CaffePara.cc:284-288) recover exactly these values.
    fc6_path = os.path.join(bin_dir, "bvlc_alexnet_aCaF.asmtLst.16.cbn")
    if not os.path.exists(fc6_path):
        res = load_alexnet_reference(reference_dir, synthesize_missing=True)
        for i in res.synthesized_layers:
            asmt = np.asarray(res.params[i]["assignments"], np.uint8)
            write_cbn(
                os.path.join(
                    bin_dir, f"bvlc_alexnet_aCaF.asmtLst.{i + 1:02d}.cbn"
                ),
                asmt,
            )
    return data_dir


def synthesize_live_pq_params(
    spec, calib_image: np.ndarray, *, seed: int = 7,
    target_absmax: float = 3.0, device=None,
):
    """Random PQ params rescaled so every conv/FC output stays ~unit scale.

    Uncalibrated random codebooks explode AlexNet logits to ~1e3, which the
    reference's UNSTABILIZED softmax (exp without max-subtraction,
    CaffeEva.cc:1098-1116) turns into inf/NaN, and saturated ReLUs make the
    output input-independent — blinding a parity test to conv-stack bugs.
    This LSUV-style pass scales each quantized layer's codebooks so the
    layer's pre-activation absmax on a calibration image hits
    ``target_absmax``, keeping all 23 layers alive and input-dependent.
    Each prefix runs decoded at load in float32 on ``device`` (None means
    the card; pass "cpu" for the CPU, where batch-1 prefixes are cheap).
    Returns NumPy params, as ``models.synth.random_pq_params`` does.
    """
    import dataclasses as dc

    import torch

    from qcnn_tpu_torch._device import resolve_device
    from qcnn_tpu_torch.core import ConvSpec, FCSpec
    from qcnn_tpu_torch.models import network, synth
    from qcnn_tpu_torch.models.prepare import prepare_params

    device = resolve_device(device)
    params = synth.random_pq_params(spec, seed=seed)
    x = torch.as_tensor(np.asarray(calib_image, np.float32), device=device)
    for i, layer in enumerate(spec.layers):
        if not isinstance(layer, (ConvSpec, FCSpec)) or params[i] is None:
            continue
        n = i + 1
        sub = dc.replace(spec, layers=spec.layers[:n])
        prep, ci, fi = prepare_params(sub, params[:n], dtype=torch.float32,
                                      device=device)
        out = network.forward(
            prep, x, spec=sub, conv_impls=ci, fc_impls=fi,
            compute_dtype=torch.float32, device=device,
        )
        absmax = float(out.abs().max())
        if absmax > 0:
            params[i]["codebooks"] = (
                params[i]["codebooks"] * (target_absmax / absmax)
            ).astype(np.float32)
    return params


@dataclasses.dataclass
class ReferenceResult:
    """Per-image sorted class distribution from the reference engine."""

    bmp_path: str
    class_ids: np.ndarray   # (top_k,) int, sorted by prob desc
    probs: np.ndarray       # (top_k,) float


# model key -> (data subdir, file prefix) — the reference wrapper's wiring
# (CaffeEvaWrapper.cc:88-131). VGG16 is declared unsupported by the wrapper
# (:77-80). vgg_cnn_s is the only Relaxed-resize + Crop-mean model, so its
# parity run uniquely covers that preprocessing path.
MODEL_WIRING = {
    "alexnet": ("AlexNet", "bvlc_alexnet_aCaF"),
    "caffenet": ("CaffeNet", "bvlc_caffenet_aCaF"),
    "vgg_cnn_s": ("VggCnnS", "vgg_cnn_s_aCaF"),
    "caffenet_fgb": ("CaffeNetFGB", "bvlc_caffenetfgb_aCaF"),
    "caffenet_fgd": ("CaffeNetFGD", "bvlc_caffenetfgd_aCaF"),
}


def synth_mean_path(data_dir: str, model: str) -> str:
    return os.path.join(data_dir, MODEL_WIRING[model][0],
                        "imagenet_mean.single.bin")


def prepare_synth_data_dir(
    spec,
    params,
    subdir: str,
    *,
    model: str = "alexnet",
    scratch_dir: str = SCRATCH_DIR,
    reference_dir: str = REFERENCE_DIR,
) -> str:
    """Scratch main-dir carrying a FULLY synthetic quantized model written
    in the reference's loose-file layout (save_reference_model). Both engines
    then run identical synthetic weights with every layer input-dependent —
    the conv-stack-sensitive complement to the shipped-weights parity run.

    Mean image: Full-mean models (256x256) symlink the shipped AlexNet mean;
    vgg_cnn_s needs a CROP-sized (3, 224, 224) mean (RmMeanImg hard-requires
    the crop size, BmpImgIO.cc:203-224) which no asset ships — a
    deterministic synthetic mean is written so subtraction is exercised
    identically in both engines."""
    from qcnn_tpu_torch.formats.reference_codec import write_bin
    from qcnn_tpu_torch.models.loader import save_reference_model

    model_dir, prefix = MODEL_WIRING[model]
    data_dir = os.path.join(scratch_dir, subdir)
    bin_dir = os.path.join(data_dir, model_dir, "Bin.Files")
    os.makedirs(bin_dir, exist_ok=True)
    save_reference_model(spec, params, bin_dir, prefix)
    mean_dst = synth_mean_path(data_dir, model)
    if model == "vgg_cnn_s":
        if not os.path.exists(mean_dst):
            rng = np.random.default_rng(11)
            mean = (
                110.0 + 20.0 * rng.standard_normal((3, 224, 224))
            ).astype(np.float32)
            write_bin(mean_dst, mean)
    elif not os.path.lexists(mean_dst):
        os.symlink(
            os.path.join(reference_dir, "AlexNet", "imagenet_mean.single.bin"),
            mean_dst,
        )
    cls_dst = os.path.join(data_dir, "Cls.Names")
    if not os.path.lexists(cls_dst):
        os.symlink(os.path.join(reference_dir, "Cls.Names"), cls_dst)
    return data_dir


def run_reference(
    bmp_paths: list[str],
    *,
    top_k: int = 1000,
    scratch_dir: str = SCRATCH_DIR,
    reference_dir: str = REFERENCE_DIR,
    data_dir: str | None = None,
    model: str = "alexnet",
    timeout_s: float = 900.0,
) -> list[ReferenceResult]:
    """Run the reference engine on BMPs; returns its sorted distributions."""
    binary = build_reference_binary(scratch_dir, reference_dir)
    if data_dir is None:
        data_dir = prepare_data_dir(scratch_dir, reference_dir)
    cmd = [
        binary,
        model,
        data_dir,
        os.path.join(data_dir, "Cls.Names", "class_names.txt"),
        os.path.join(data_dir, "Cls.Names", "image_labels.txt"),
        str(top_k),
        *[os.path.abspath(p) for p in bmp_paths],
    ]
    proc = subprocess.run(
        cmd, capture_output=True, text=True, timeout=timeout_s
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"reference engine failed (rc={proc.returncode}):\n"
            f"{proc.stderr[-2000:]}\n{proc.stdout[-2000:]}"
        )
    results: list[ReferenceResult] = []
    ids: list[int] = []
    probs: list[float] = []
    cur: str | None = None

    def flush():
        if cur is not None:
            results.append(
                ReferenceResult(
                    cur, np.asarray(ids, np.int64), np.asarray(probs)
                )
            )

    for line in proc.stdout.splitlines():
        if line.startswith("PARITY_IMG "):
            flush()
            cur = line[len("PARITY_IMG "):]
            ids, probs = [], []
        elif line.startswith("PARITY_ROW "):
            _, _, cid, p = line.split()
            ids.append(int(cid))
            probs.append(float(p))
    flush()
    if len(results) != len(bmp_paths):
        raise RuntimeError(
            f"parsed {len(results)} results for {len(bmp_paths)} images; "
            f"stdout tail:\n{proc.stdout[-2000:]}"
        )
    return results


def main() -> None:  # pragma: no cover - manual harness entry
    import glob

    bmps = sorted(glob.glob(os.path.join(REFERENCE_DIR, "Bmp.Files", "*.BMP")))
    for r in run_reference(bmps, top_k=5):
        print(os.path.basename(r.bmp_path), r.class_ids[:5], r.probs[:5])


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
