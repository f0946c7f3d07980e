"""Image preprocessing pipeline: resize → (mean, crop) → NHWC tensor.

A copy of ``qcnn_tpu/preproc/pipeline.py``: the same NumPy code, so both
packages feed their models the same arrays.

Reproduces BmpImgIO (src/BmpImgIO.cc) semantics exactly:

- bilinear resize with align-corners scale factors (src-1)/(dst-1) and
  explicit 4-tap weight normalization (ReszImg, BmpImgIO.cc:105-178);
- Strict (exact HxW) vs Relaxed (keep aspect, min scale) sizing policies
  (BmpImgIO.h:22-25);
- center crop (CropImg, :180-201);
- mean-image subtraction either before the crop on the full-size image
  (MeanType.FULL) or after on the cropped image (MeanType.CROP)
  (Load, :56-68).

All host-side NumPy: preprocessing is IO-bound and stays off the device; the
device receives ready NHWC float32 batches.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from qcnn_tpu_torch.formats import read_bin
from qcnn_tpu_torch.preproc.bmp import read_image


class ReszType(enum.Enum):
    STRICT = "strict"
    RELAXED = "relaxed"


class MeanType(enum.Enum):
    FULL = "full"
    CROP = "crop"


_EPS = 1e-7


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int,
                    policy: ReszType = ReszType.STRICT) -> np.ndarray:
    """img: (H, W, C) float32 -> resized (H', W', C).

    STRICT gives exactly (out_h, out_w); RELAXED scales both axes by the
    smaller align-corners factor, preserving aspect ratio (the output is at
    least (out_h, out_w) along each axis)."""
    h, w, _ = img.shape
    if out_h < 2 or out_w < 2:
        raise ValueError(f"degenerate resize output: ({out_h}, {out_w})")
    if policy is ReszType.RELAXED and (h < 2 or w < 2):
        # a 1-pixel axis makes the relaxed scale 0 and the int() of
        # inf/NaN below undefined (STRICT is fine: taps clamp to pixel 0;
        # the C++ pipeline raises the same way)
        raise ValueError(f"relaxed resize needs >= 2px per axis: ({h}, {w})")
    scale_h = (h - 1) / (out_h - 1)
    scale_w = (w - 1) / (out_w - 1)
    if policy is ReszType.RELAXED:
        scale_h = scale_w = min(scale_h, scale_w)
        out_h = int((h - 1) / scale_h + _EPS) + 1
        out_w = int((w - 1) / scale_w + _EPS) + 1

    def taps(scale: float, n_out: int, n_src: int):
        c = scale * np.arange(n_out, dtype=np.float64)
        lo = np.maximum(0, c.astype(np.int64))
        hi = np.minimum(n_src - 1, lo + 1)
        w_lo = 1.0 - (c - lo)
        w_hi = 1.0 - (hi - c)
        return lo, hi, w_lo, w_hi

    hl, hh, whl, whh = taps(scale_h, out_h, h)
    wl, wh, wwl, wwh = taps(scale_w, out_w, w)

    # 4-tap gather with the reference's explicit weight renormalization
    # (degenerate at borders where lo == hi, BmpImgIO.cc:160-174);
    # row gathers hoisted — img[hl]/img[hh] were each materialized twice
    rows_lo = img[hl]
    rows_hi = img[hh]
    v_lt = rows_lo[:, wl]
    v_rt = rows_lo[:, wh]
    v_lb = rows_hi[:, wl]
    v_rb = rows_hi[:, wh]
    w_lt = (whl[:, None] * wwl[None, :])[..., None]
    w_rt = (whl[:, None] * wwh[None, :])[..., None]
    w_lb = (whh[:, None] * wwl[None, :])[..., None]
    w_rb = (whh[:, None] * wwh[None, :])[..., None]
    num = v_lt * w_lt + v_rt * w_rt + v_lb * w_lb + v_rb * w_rb
    den = w_lt + w_rt + w_lb + w_rb
    return (num / den).astype(np.float32)


def resize_bilinear_halfpixel(img: np.ndarray, out_h: int,
                              out_w: int) -> np.ndarray:
    """Half-pixel-convention bilinear resize (torch's
    F.interpolate(mode='bilinear', align_corners=False) / standard
    imaging convention), for torch-ecosystem model preprocessing. The
    reference's own resize is align-corners (resize_bilinear above)."""
    h, w, _ = img.shape

    def taps(n_out: int, n_src: int):
        c = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_src / n_out) - 0.5
        c = np.clip(c, 0.0, n_src - 1)
        lo = c.astype(np.int64)
        hi = np.minimum(n_src - 1, lo + 1)
        frac = c - lo
        return lo, hi, 1.0 - frac, frac

    hl, hh, whl, whh = taps(out_h, h)
    wl, wh, wwl, wwh = taps(out_w, w)
    rows_lo = img[hl] * whl[:, None, None] + img[hh] * whh[:, None, None]
    out = (
        rows_lo[:, wl] * wwl[None, :, None]
        + rows_lo[:, wh] * wwh[None, :, None]
    )
    return out.astype(np.float32)


def center_crop(img: np.ndarray, crop_h: int, crop_w: int) -> np.ndarray:
    h, w, _ = img.shape
    oh = (h - crop_h) // 2
    ow = (w - crop_w) // 2
    return img[oh : oh + crop_h, ow : ow + crop_w]


@dataclasses.dataclass
class Preprocessor:
    """Model-specific preprocessing config (the reference wires these per model
    in CaffeEvaWrapper::SetModel, CaffeEvaWrapper.cc:54-85)."""

    full_h: int
    full_w: int
    crop_h: int
    crop_w: int
    resz_type: ReszType
    mean_type: MeanType
    mean_image: np.ndarray  # (H, W, 3) float32 BGR

    @classmethod
    def alexnet(cls, mean_path: str) -> "Preprocessor":
        mean_chw = read_bin(mean_path, np.float32)  # (3, 256, 256) BGR
        return cls(
            full_h=256, full_w=256, crop_h=227, crop_w=227,
            resz_type=ReszType.STRICT, mean_type=MeanType.FULL,
            mean_image=np.transpose(mean_chw, (1, 2, 0)).copy(),
        )

    @classmethod
    def vgg_cnn_s(cls, mean_path: str) -> "Preprocessor":
        mean_chw = read_bin(mean_path, np.float32)
        return cls(
            full_h=256, full_w=256, crop_h=224, crop_w=224,
            resz_type=ReszType.RELAXED, mean_type=MeanType.CROP,
            mean_image=np.transpose(mean_chw, (1, 2, 0)).copy(),
        )

    def __call__(self, img_bgr_hwc: np.ndarray) -> np.ndarray:
        """(H, W, 3) BGR float32 -> (crop_h, crop_w, 3) mean-subtracted."""
        full = resize_bilinear(
            img_bgr_hwc, self.full_h, self.full_w, self.resz_type
        )
        if self.mean_type is MeanType.FULL:
            if full.shape != self.mean_image.shape:
                raise ValueError(
                    f"mean image {self.mean_image.shape} != full {full.shape}"
                )
            full = full - self.mean_image
            return center_crop(full, self.crop_h, self.crop_w)
        cropped = center_crop(full, self.crop_h, self.crop_w)
        mean = self.mean_image
        if mean.shape != cropped.shape:
            mean = center_crop(mean, self.crop_h, self.crop_w)
        return cropped - mean

    def load(self, bmp_path: str) -> np.ndarray:
        """BMP file -> (1, crop_h, crop_w, 3) NHWC batch-of-one
        (the reference's BmpImgIO::Load, BmpImgIO.cc:40-71)."""
        return self(read_image(bmp_path))[None]

    def load_batch(self, bmp_paths, native: str = "auto") -> np.ndarray:
        """Batch images -> (N, crop_h, crop_w, 3). native='auto' uses the
        threaded C++ pipeline (preproc/native/imgproc.cc) when it compiles,
        'never' forces the NumPy path, 'require' errors when the native
        library is unavailable (non-BMP inputs always take the PIL route —
        there is no native decoder for them)."""
        if native == "never":
            return np.stack([self(read_image(p)) for p in bmp_paths])
        blobs = [open(p, "rb").read() for p in bmp_paths]
        out = self.process_blobs(blobs, require=(native == "require"))
        if out is not None:
            return out
        if native == "require":
            raise RuntimeError("native imgproc unavailable")
        from qcnn_tpu_torch.preproc.bmp import decode_image

        return np.stack([self(decode_image(b)) for b in blobs])

    def process_blobs(self, blobs, require: bool = False):
        """Image byte blobs -> (N, crop_h, crop_w, 3): the C++ pipeline for
        all-BMP batches, the NumPy(+PIL) path otherwise. Native
        unavailable: require=True returns None (caller reports), else the
        NumPy fallback runs here — the same contract as
        TorchPreprocessor.process_blobs (round-5 review: the flag was
        accepted but ignored, silently diverging from the sibling API)."""
        from qcnn_tpu_torch.preproc.bmp import decode_image

        if any(b[:2] != b"BM" for b in blobs):
            return np.stack([self(decode_image(b)) for b in blobs])
        from qcnn_tpu_torch.preproc import native as native_mod

        if not native_mod.available():
            if require:
                return None
            return np.stack([self(decode_image(b)) for b in blobs])
        out, failures = native_mod.preproc_batch(
            blobs,
            full_h=self.full_h, full_w=self.full_w,
            crop_h=self.crop_h, crop_w=self.crop_w,
            relaxed=self.resz_type is ReszType.RELAXED,
            mean_hwc=self.mean_image,
            mean_full=self.mean_type is MeanType.FULL,
        )
        if failures:
            # the hardened C++ decoder bounds dimensions more tightly
            # than the NumPy path (hostile-input limits); a batch with
            # one such image must not fail wholesale when the NumPy
            # decoder accepts it — fall back, and genuinely corrupt
            # images still raise their per-image ValueError there
            # (round-5 review: environment-dependent batch failures)
            return np.stack([self(decode_image(b)) for b in blobs])
        return out


@dataclasses.dataclass
class TorchPreprocessor:
    """torch-ecosystem ImageNet inference preprocessing, for the family
    models ingested from torchvision/timm checkpoints
    (``models.torch_import``): RGB channel order, aspect-preserving
    shorter-side bilinear resize (half-pixel convention), center crop,
    scale to [0, 1], per-channel mean/std normalize.

    Semantically the standard torchvision/timm eval transform; pixel-exact
    parity with PIL's antialiased resize is not claimed (antialiasing
    differs on strong downscales), which costs well under 0.1% top-1 in
    practice. Same call surface as Preprocessor so Classifier / the serve
    handler accept either."""

    resize: int
    crop: int
    mean: np.ndarray  # (3,) float32, RGB, in [0, 1] units
    std: np.ndarray   # (3,) float32, RGB, in [0, 1] units

    def __post_init__(self):
        if self.crop > self.resize:
            # the native crop would compute negative offsets and read out
            # of bounds; torchvision raises for the same configuration
            raise ValueError(
                f"crop ({self.crop}) must be <= resize ({self.resize})"
            )

    @classmethod
    def imagenet(cls, crop: int = 224, resize: int = 256
                 ) -> "TorchPreprocessor":
        return cls(
            resize=resize, crop=crop,
            mean=np.array([0.485, 0.456, 0.406], np.float32),
            std=np.array([0.229, 0.224, 0.225], np.float32),
        )

    @property
    def crop_h(self) -> int:  # shape-contract parity with Preprocessor
        return self.crop

    @property
    def crop_w(self) -> int:
        return self.crop

    def __call__(self, img_bgr_hwc: np.ndarray) -> np.ndarray:
        """(H, W, 3) BGR float32 in [0, 255] -> (crop, crop, 3) RGB
        normalized."""
        img = np.ascontiguousarray(img_bgr_hwc[..., ::-1])  # BGR -> RGB
        h, w, _ = img.shape
        if h <= w:
            oh = self.resize
            ow = max(self.crop, round(w * self.resize / h))
        else:
            ow = self.resize
            oh = max(self.crop, round(h * self.resize / w))
        full = resize_bilinear_halfpixel(img, oh, ow)
        cropped = center_crop(full, self.crop, self.crop)
        return ((cropped / 255.0 - self.mean) / self.std).astype(np.float32)

    def load(self, bmp_path: str) -> np.ndarray:
        return self(read_image(bmp_path))[None]

    def load_batch(self, bmp_paths, native: str = "auto") -> np.ndarray:
        if native != "never":
            out = self.process_blobs(
                [open(p, "rb").read() for p in bmp_paths],
                require=(native == "require"),
            )
            if out is not None:
                return out
            if native == "require":
                raise RuntimeError("native imgproc unavailable")
        return np.stack([self(read_image(p)) for p in bmp_paths])

    def process_blobs(self, blobs, require: bool = False):
        """BMP byte blobs -> (N, crop, crop, 3) via the threaded C++
        pipeline (imgproc.cc qcnn_preproc_batch_torch); NumPy fallback when
        the native library is unavailable (require=False returns it
        directly so callers need no second path)."""
        from qcnn_tpu_torch.preproc import native as native_mod
        from qcnn_tpu_torch.preproc.bmp import decode_image

        if any(b[:2] != b"BM" for b in blobs):
            # JPEG/PNG (serve uploads): PIL decode + NumPy transform
            return np.stack([self(decode_image(b)) for b in blobs])
        if not native_mod.available():
            if require:
                return None
            return np.stack([self(decode_image(b)) for b in blobs])
        out, failures = native_mod.preproc_batch_torch(
            blobs, resize=self.resize, crop=self.crop,
            mean=self.mean, std=self.std,
        )
        if failures:
            # same contract as Preprocessor.process_blobs: NumPy decides
            # whether an image the bounded C++ decoder refused is truly
            # invalid (per-image error) or just outside its limits
            return np.stack([self(decode_image(b)) for b in blobs])
        return out
