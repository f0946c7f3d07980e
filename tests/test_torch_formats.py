"""The port's reference codec (formats/reference_codec.py, formats/native,
native_build.py) against the JAX package's on the same files: ``.bin`` and
``.cbn`` written by either package read the same in the other and are the
same bytes, the native and NumPy page codecs give the same bits, and the
errors say the same."""

import os

import numpy as np
import pytest

from qcnn_tpu.formats import reference_codec as jcodec
from qcnn_tpu_torch import native_build
from qcnn_tpu_torch.formats import native as tnative
from qcnn_tpu_torch.formats import reference_codec as tcodec
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


def _counts(bits):
    """Element counts around the page boundaries of a bit width."""
    per = jcodec.elems_per_page(bits)
    return (1, per - 1, per, per + 1, 3 * per + 5)


def _values(bits, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, size=n, dtype=np.uint8)


@pytest.mark.parametrize("bits", range(1, 9))
def test_cbn_crosses_both_ways_bit_for_bit(tmp_path, bits):
    for n in _counts(bits):
        vals = _values(bits, n, seed=bits * 100 + n % 97)
        arr = vals.reshape(1, n)
        jpath, tpath = tmp_path / f"j{n}.cbn", tmp_path / f"t{n}.cbn"
        assert jcodec.write_cbn(jpath, arr, bits=bits) == bits
        assert tcodec.write_cbn(tpath, arr, bits=bits) == bits
        assert jpath.read_bytes() == tpath.read_bytes()
        got_t, got_j = tcodec.read_cbn(jpath), jcodec.read_cbn(tpath)
        assert got_t.dtype == got_j.dtype == np.uint8
        np.testing.assert_array_equal(got_t, arr)
        np.testing.assert_array_equal(got_j, arr)
        np.testing.assert_array_equal(tcodec.read_cbn(jpath, one_based=True),
                                      jcodec.read_cbn(jpath, one_based=True))


@pytest.mark.parametrize("bits", range(1, 9))
def test_native_and_numpy_page_codecs_give_the_same_bits(bits):
    tnative.LIBRARY.build()
    lib = tnative.get_lib()
    assert lib is not None
    for n in _counts(bits):
        vals = _values(bits, n, seed=bits + n).astype(np.uint32)
        pages = tcodec._pack_pages_numpy(vals, bits)
        np.testing.assert_array_equal(lib.pack_pages(vals, bits), pages)
        np.testing.assert_array_equal(lib.unpack_pages(pages, n, bits), vals)
        np.testing.assert_array_equal(
            tcodec._unpack_pages_numpy(pages, n, bits), vals)


def test_native_library_goes_to_the_hashed_build_dir():
    path, _ = tnative.LIBRARY.build()
    assert os.path.dirname(path) == native_build.BUILD_DIR
    assert os.path.basename(path).startswith("libcbncodec_")
    assert path == tnative.LIBRARY.library_path()
    assert not [f for f in os.listdir(os.path.dirname(tnative.__file__))
                if f.endswith(".so")]


def test_disable_native_is_honoured(tmp_path, monkeypatch):
    monkeypatch.setenv("QCNN_DISABLE_NATIVE", "1")
    assert tnative.get_lib() is None
    arr = _values(5, 10000, seed=0).reshape(100, 100)
    tcodec.write_cbn(tmp_path / "t.cbn", arr)
    jcodec.write_cbn(tmp_path / "j.cbn", arr)
    assert (tmp_path / "t.cbn").read_bytes() == (tmp_path / "j.cbn").read_bytes()
    np.testing.assert_array_equal(tcodec.read_cbn(tmp_path / "j.cbn"), arr)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.uint16])
def test_bin_crosses_both_ways(tmp_path, dtype):
    rng = np.random.default_rng(7)
    arr = (rng.standard_normal((3, 5, 7)) * 100).astype(dtype)
    jcodec.write_bin(tmp_path / "j.bin", arr)
    tcodec.write_bin(tmp_path / "t.bin", arr)
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    for got in (tcodec.read_bin(tmp_path / "j.bin", dtype),
                jcodec.read_bin(tmp_path / "t.bin", dtype)):
        assert got.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("batch_rows", [1, 3, 7, 10, 11])
def test_read_bin_batches_ragged_tails_match(tmp_path, batch_rows):
    arr = np.arange(10 * 2 * 3, dtype=np.float32).reshape(10, 2, 3)
    tcodec.write_bin(tmp_path / "a.bin", arr)
    got = list(tcodec.read_bin_batches(tmp_path / "a.bin", np.float32,
                                       batch_rows))
    want = list(jcodec.read_bin_batches(tmp_path / "a.bin", np.float32,
                                        batch_rows))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got), arr)


def test_read_asmt_and_convert_asmt_match(tmp_path):
    rng = np.random.default_rng(3)
    zero_based = rng.integers(0, 200, size=(64, 12), dtype=np.uint8)
    jcodec.write_bin(tmp_path / "raw.bin", zero_based + 1)
    np.testing.assert_array_equal(tcodec.read_asmt(tmp_path / "raw.bin"),
                                  jcodec.read_asmt(tmp_path / "raw.bin"))
    tcodec.convert_asmt(tmp_path / "raw.bin", tmp_path / "t.cbn")
    jcodec.convert_asmt(tmp_path / "raw.bin", tmp_path / "j.cbn")
    assert (tmp_path / "t.cbn").read_bytes() == (tmp_path / "j.cbn").read_bytes()
    tcodec.convert_asmt(tmp_path / "t.cbn", tmp_path / "back_t.bin")
    jcodec.convert_asmt(tmp_path / "j.cbn", tmp_path / "back_j.bin")
    assert ((tmp_path / "back_t.bin").read_bytes()
            == (tmp_path / "back_j.bin").read_bytes()
            == (tmp_path / "raw.bin").read_bytes())
    # index 255 cannot be stored 1-based in uint8: both refuse alike
    tcodec.write_cbn(tmp_path / "wide.cbn", np.array([[0, 255]], np.uint8))
    errs = []
    for codec in (tcodec, jcodec):
        with pytest.raises(ValueError) as e:
            codec.convert_asmt(tmp_path / "wide.cbn", tmp_path / "w.bin")
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    jcodec.write_bin(tmp_path / "zero.bin", np.zeros((2, 2), np.uint8))
    with pytest.raises(ValueError, match="1-based"):
        tcodec.read_asmt(tmp_path / "zero.bin")


def test_txt_crosses_both_ways(tmp_path):
    rng = np.random.default_rng(5)
    for arr in (rng.standard_normal((2, 3, 4)).astype(np.float32),
                rng.integers(-50, 50, (6,)).astype(np.int32)):
        tcodec.write_txt(tmp_path / "t.txt", arr)
        jcodec.write_txt(tmp_path / "j.txt", arr)
        assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
        np.testing.assert_array_equal(
            tcodec.read_txt(tmp_path / "j.txt", arr.dtype),
            jcodec.read_txt(tmp_path / "t.txt", arr.dtype))


def _bad_files(tmp_path):
    good = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    jcodec.write_bin(tmp_path / "good.bin", good)
    data = (tmp_path / "good.bin").read_bytes()
    (tmp_path / "trunc.bin").write_bytes(data[:-8])
    (tmp_path / "dims.bin").write_bytes(np.int32(9).tobytes() + data[4:])
    (tmp_path / "neg.bin").write_bytes(
        np.array([2, 3, -1], np.int32).tobytes())
    jcodec.write_cbn(tmp_path / "good.cbn", np.zeros((5000,), np.uint8),
                     bits=3)
    cbn = (tmp_path / "good.cbn").read_bytes()
    (tmp_path / "trunc.cbn").write_bytes(cbn[:-100])
    (tmp_path / "bits.cbn").write_bytes(cbn[:8] + np.int32(9).tobytes()
                                        + cbn[12:])
    (tmp_path / "empty.txt").write_text("")
    (tmp_path / "short.txt").write_text("2 2 2\n1 2 3\n")
    return {
        "trunc.bin": lambda c, p: c.read_bin(p, np.float32),
        "dims.bin": lambda c, p: c.read_bin(p, np.float32),
        "neg.bin": lambda c, p: c.read_bin(p, np.float32),
        "trunc.cbn": lambda c, p: c.read_cbn(p),
        "bits.cbn": lambda c, p: c.read_cbn(p),
        "empty.txt": lambda c, p: c.read_txt(p, np.float32),
        "short.txt": lambda c, p: c.read_txt(p, np.float32),
        "trunc_batches": lambda c, p: list(c.read_bin_batches(
            os.path.join(os.path.dirname(p), "trunc.bin"), np.float32, 1)),
    }


def test_errors_on_corrupt_files_match(tmp_path):
    for name, read in _bad_files(tmp_path).items():
        path = str(tmp_path / name)
        msgs = []
        for codec in (tcodec, jcodec):
            with pytest.raises(ValueError) as e:
                read(codec, path)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], name


def test_write_cbn_refusals_match(tmp_path):
    for arr, bits in ((np.array([300], np.int32), None),
                      (np.array([4], np.uint8), 2),
                      (np.array([1], np.uint8), 9)):
        msgs = []
        for codec in (tcodec, jcodec):
            with pytest.raises(ValueError) as e:
                codec.write_cbn(tmp_path / "x.cbn", arr, bits=bits)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
