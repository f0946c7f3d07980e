"""The port's preprocessing (preproc/bmp.py, preproc/pipeline.py,
preproc/native) against the JAX package's on the same arrays and BMPs. The
NumPy code is the same, so its outputs must be the same arrays; the native
pipeline is held to the port's NumPy path at the tolerances of
tests/test_native_preproc.py."""

import struct
import sys

import numpy as np
import pytest

from qcnn_tpu.preproc import bmp as jbmp
from qcnn_tpu.preproc import pipeline as jpipe
from qcnn_tpu_torch.preproc import bmp as tbmp
from qcnn_tpu_torch.preproc import native as tnative
from qcnn_tpu_torch.preproc import pipeline as tpipe
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

# (height, width): square, below the 256-px resize, non-square, and widths
# that are not multiples of 4 (padded BMP rows)
SIZES = [(256, 256), (181, 257), (333, 250), (100, 150), (64, 97)]


def _pixels(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def bmp_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("bmps")
    paths = []
    for i, (h, w) in enumerate(SIZES):
        p = d / f"img{i}.bmp"
        p.write_bytes(jbmp.encode_bmp24(_pixels(h, w, i)))
        paths.append(str(p))
    return paths


def _mean(seed=2):
    return np.random.default_rng(seed).uniform(
        90, 130, (256, 256, 3)).astype(np.float32)


@pytest.mark.parametrize("policy", ["STRICT", "RELAXED"])
@pytest.mark.parametrize("hw", [(256, 256), (181, 257), (40, 33), (2, 9)])
def test_resize_bilinear_is_the_same_array(policy, hw):
    img = np.random.default_rng(1).uniform(0, 255, (*hw, 3)).astype(np.float32)
    for out in ((256, 256), (227, 300), (7, 5)):
        got = tpipe.resize_bilinear(img, *out, tpipe.ReszType[policy])
        want = jpipe.resize_bilinear(img, *out, jpipe.ReszType[policy])
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_resize_refusals_match():
    img = np.zeros((1, 30, 3), np.float32)
    for args in ((img, 1, 5), (img, 10, 10, "RELAXED")):
        msgs = []
        for pipe in (tpipe, jpipe):
            a = args[:3] + tuple(pipe.ReszType[p] for p in args[3:])
            with pytest.raises(ValueError) as e:
                pipe.resize_bilinear(*a)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("hw", [(256, 256), (181, 257), (500, 375)])
def test_halfpixel_resize_and_crop_are_the_same_array(hw):
    img = np.random.default_rng(2).uniform(0, 255, (*hw, 3)).astype(np.float32)
    for out in ((256, 341), (224, 224), (31, 17)):
        got = tpipe.resize_bilinear_halfpixel(img, *out)
        np.testing.assert_array_equal(
            got, jpipe.resize_bilinear_halfpixel(img, *out))
        np.testing.assert_array_equal(tpipe.center_crop(got, 13, 11),
                                      jpipe.center_crop(got, 13, 11))


def _caffe_pre(pipe, kind):
    mean = _mean()
    if kind == "alexnet":
        return pipe.Preprocessor(
            full_h=256, full_w=256, crop_h=227, crop_w=227,
            resz_type=pipe.ReszType.STRICT, mean_type=pipe.MeanType.FULL,
            mean_image=mean)
    return pipe.Preprocessor(
        full_h=256, full_w=256, crop_h=224, crop_w=224,
        resz_type=pipe.ReszType.RELAXED, mean_type=pipe.MeanType.CROP,
        mean_image=mean)


@pytest.mark.parametrize("kind", ["alexnet", "vgg_cnn_s"])
def test_preprocessor_factories_give_the_jax_arrays(tmp_path, bmp_paths,
                                                    kind):
    from qcnn_tpu.formats import write_bin

    mean_path = str(tmp_path / "mean.bin")
    write_bin(mean_path, np.transpose(_mean(), (2, 0, 1)).copy())
    tp = getattr(tpipe.Preprocessor, kind)(mean_path)
    jp = getattr(jpipe.Preprocessor, kind)(mean_path)
    np.testing.assert_array_equal(tp.mean_image, jp.mean_image)
    assert (tp.crop_h, tp.crop_w, tp.resz_type.value, tp.mean_type.value) \
        == (jp.crop_h, jp.crop_w, jp.resz_type.value, jp.mean_type.value)
    for p in bmp_paths:
        np.testing.assert_array_equal(tp.load(p), jp.load(p))
    np.testing.assert_array_equal(tp.load_batch(bmp_paths, native="never"),
                                  jp.load_batch(bmp_paths, native="never"))


def test_torch_preprocessor_gives_the_jax_arrays(bmp_paths):
    tp = tpipe.TorchPreprocessor.imagenet()
    jp = jpipe.TorchPreprocessor.imagenet()
    for p in bmp_paths:
        np.testing.assert_array_equal(tp.load(p), jp.load(p))
    got = tp.load_batch(bmp_paths, native="never")
    assert got.shape == (len(bmp_paths), 224, 224, 3)
    np.testing.assert_array_equal(got, jp.load_batch(bmp_paths,
                                                     native="never"))
    with pytest.raises(ValueError, match="crop"):
        tpipe.TorchPreprocessor(resize=100, crop=101, mean=tp.mean,
                                std=tp.std)


@pytest.mark.parametrize("kind", ["alexnet", "vgg_cnn_s"])
def test_native_pipeline_matches_numpy(bmp_paths, kind):
    tnative.LIBRARY.build()
    pre = _caffe_pre(tpipe, kind)
    got = pre.load_batch(bmp_paths, native="require")
    want = pre.load_batch(bmp_paths, native="never")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_native_torch_transform_matches_numpy(bmp_paths):
    tnative.LIBRARY.build()
    pre = tpipe.TorchPreprocessor.imagenet(crop=224, resize=256)
    got = pre.load_batch(bmp_paths, native="require")
    want = pre.load_batch(bmp_paths, native="never")
    assert got.shape == want.shape == (len(bmp_paths), 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_native_require_raises_when_disabled(bmp_paths, monkeypatch):
    monkeypatch.setenv("QCNN_DISABLE_NATIVE", "1")
    assert not tnative.available()
    for pre in (_caffe_pre(tpipe, "alexnet"),
                tpipe.TorchPreprocessor.imagenet()):
        with pytest.raises(RuntimeError, match="native imgproc unavailable"):
            pre.load_batch(bmp_paths, native="require")
        # 'auto' falls back to the NumPy path, as in the JAX package
        np.testing.assert_array_equal(
            pre.load_batch(bmp_paths), pre.load_batch(bmp_paths,
                                                      native="never"))


def test_native_hostile_blobs_count_as_failures():
    tnative.LIBRARY.build()
    bad = [b"not a bmp at all", _header(2**31 - 1, 2**31 - 1),
           _header(16, 0), _header(100, 100) + b"\0" * 64]
    out, failures = tnative.preproc_batch(
        bad, full_h=256, full_w=256, crop_h=227, crop_w=227, relaxed=False,
        mean_hwc=np.zeros((256, 256, 3), np.float32), mean_full=True)
    assert failures == len(bad) and not out.any()


def _header(width, height, bpp=24, compression=0, header_size=40):
    h = bytearray(54)
    h[0:2] = b"BM"
    struct.pack_into("<I", h, 10, 54)
    struct.pack_into("<I", h, 14, header_size)
    struct.pack_into("<i", h, 18, width)
    struct.pack_into("<i", h, 22, height)
    struct.pack_into("<H", h, 28, bpp)
    struct.pack_into("<I", h, 30, compression)
    return bytes(h)


@pytest.mark.parametrize("hw", SIZES)
def test_bmp_codec_matches_bottom_up_top_down_and_padded(hw):
    px = _pixels(*hw, seed=9)
    data = tbmp.encode_bmp24(px)
    assert data == jbmp.encode_bmp24(px)
    assert tbmp.encode_bmp24(px[..., ::-1], input_order="bgr") == data
    got = tbmp.decode_bmp(data)
    np.testing.assert_array_equal(got, jbmp.decode_bmp(data))
    np.testing.assert_array_equal(got, px[..., ::-1].astype(np.float32))
    # the same pixels stored top-down (negative height)
    h, w = hw
    top_down = bytearray(data)
    struct.pack_into("<i", top_down, 22, -h)
    row = (3 * w + 3) & ~3
    rows = [data[54 + r * row: 54 + (r + 1) * row] for r in range(h)]
    top_down[54:] = b"".join(reversed(rows))
    np.testing.assert_array_equal(tbmp.decode_bmp(bytes(top_down)), got)
    np.testing.assert_array_equal(jbmp.decode_bmp(bytes(top_down)), got)


def test_bmp_errors_match():
    good = tbmp.encode_bmp24(_pixels(4, 5, 0))
    bad = [b"PK\x03\x04" + good[4:], _header(4, 4, header_size=12),
           _header(4, 4, bpp=32), _header(4, 4, compression=1),
           _header(-1, 4), _header(4, 0), good[:-10]]
    for data in bad:
        msgs = []
        for mod in (tbmp, jbmp):
            with pytest.raises(ValueError) as e:
                mod.decode_bmp(data, name="x.bmp")
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="input_order"):
        tbmp.encode_bmp24(_pixels(2, 2, 0), input_order="rgba")


def test_read_image_non_bmp(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    from PIL import Image

    px = _pixels(12, 9, 3)
    p = tmp_path / "x.png"
    Image.fromarray(px).save(p)
    np.testing.assert_array_equal(tbmp.read_image(str(p)),
                                  jbmp.read_image(str(p)))
    np.testing.assert_array_equal(tbmp.decode_image(p.read_bytes()),
                                  px[..., ::-1].astype(np.float32))
    with pytest.raises(ValueError, match="undecodable"):
        tbmp.decode_image(b"\x89PNG garbage")
    # no PIL (as on the card's machine): the same clear error
    monkeypatch.setitem(sys.modules, "PIL", None)
    for fn, arg in ((tbmp.read_image, str(p)),
                    (tbmp.decode_image, p.read_bytes())):
        with pytest.raises(ValueError, match="PIL is unavailable"):
            fn(arg)
