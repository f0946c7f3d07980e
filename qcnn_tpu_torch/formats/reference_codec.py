"""Codec for the reference on-disk weight formats (``.bin`` and ``.cbn``), a
copy of ``qcnn_tpu/formats/reference_codec.py`` (the port imports nothing of
the JAX package); files written by either package read the same in both.

Format specification (reverse-engineered from the reference implementation's
``include/FileIO.h``; all integers little-endian):

``.bin`` (FileIO.h:56-107)::

    int32 dim_cnt
    int32 dims[dim_cnt]
    T     data[prod(dims)]        # row-major, dtype known by the caller

``.cbn`` "compact binary" (FileIO.h:110-178 read, :281-350 write)::

    int32 dim_cnt
    int32 dims[dim_cnt]
    int32 bits_per_element
    u8    pages[ceil(n / elems_per_page) * 4096]

Each 4096-byte page holds ``elems_per_page = 4096*8 // bits`` elements packed
MSB-first as one contiguous bitstream; elements never straddle a page boundary
and the final page is zero-padded to exactly 4096 bytes.  The *stored* bit
values are ``value - 1`` relative to the in-memory (MATLAB, 1-based) values
(FileIO.h:165,330), and the engine's loader subtracts another 1 after reading
(CaffePara.cc:284-288) — so the stored bits are exactly the 0-based codeword
indices.  This module exposes 0-based indices everywhere and keeps the ±1
convention only at the file boundary.

A C++ fast path for page (un)packing lives in ``formats/native`` (built by
``qcnn_tpu_torch.native_build``); this module transparently uses it when the
shared library is available and falls back to vectorized NumPy otherwise.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

PAGE_BYTES = 4096
_HEADER_INT = struct.Struct("<i")


def _read_header(f) -> tuple[int, ...]:
    (dim_cnt,) = _HEADER_INT.unpack(f.read(4))
    if not 1 <= dim_cnt <= 8:
        raise ValueError(f"implausible dim_cnt={dim_cnt}; not a reference file?")
    dims = struct.unpack(f"<{dim_cnt}i", f.read(4 * dim_cnt))
    if any(d <= 0 for d in dims):
        raise ValueError(f"non-positive dimension in header: {dims}")
    return dims


def read_bin(path: str | os.PathLike, dtype) -> np.ndarray:
    """Read a reference ``.bin`` tensor.  The format does not encode the element
    dtype; the caller supplies it (float32 for ctrdLst/biasVec/convKnl/fcntWei,
    uint8 for raw asmtLst, uint16 for label vectors)."""
    dtype = np.dtype(dtype)
    with open(path, "rb") as f:
        dims = _read_header(f)
        n = int(np.prod(dims))
        data = np.fromfile(f, dtype=dtype.newbyteorder("<"), count=n)
    if data.size != n:
        raise ValueError(f"{path}: expected {n} elements, got {data.size}")
    return data.astype(dtype, copy=False).reshape(dims)


def read_bin_batches(
    path: str | os.PathLike, dtype, batch_rows: int
):
    """Stream a reference ``.bin`` tensor in axis-0 chunks of ``batch_rows``
    rows without materializing the whole tensor (the 500 MB ILSVRC val set
    does not need to live in RAM to be evaluated; the reference reads the
    whole blob too, FileIO.h:110-178 — streaming is the batched upgrade).
    Yields np.ndarray of shape (<=batch_rows, *dims[1:])."""
    dtype = np.dtype(dtype)
    with open(path, "rb") as f:
        dims = _read_header(f)
        row_elems = int(np.prod(dims[1:])) if len(dims) > 1 else 1
        tail = tuple(dims[1:])
        for start in range(0, dims[0], batch_rows):
            rows = min(batch_rows, dims[0] - start)
            data = np.fromfile(
                f, dtype=dtype.newbyteorder("<"), count=rows * row_elems
            )
            if data.size != rows * row_elems:
                raise ValueError(
                    f"{path}: truncated at row {start} "
                    f"(wanted {rows * row_elems}, got {data.size})"
                )
            yield data.astype(dtype, copy=False).reshape((rows,) + tail)


def write_bin(path: str | os.PathLike, arr: np.ndarray) -> None:
    """Write a reference ``.bin`` tensor (FileIO.h:229-278)."""
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        f.write(_HEADER_INT.pack(arr.ndim))
        f.write(struct.pack(f"<{arr.ndim}i", *arr.shape))
        arr.astype(arr.dtype.newbyteorder("<"), copy=False).tofile(f)


def elems_per_page(bits: int) -> int:
    return (PAGE_BYTES * 8) // bits


def _unpack_pages_numpy(pages: np.ndarray, n: int, bits: int) -> np.ndarray:
    """Unpack MSB-first `bits`-wide elements from 4096-byte pages."""
    per_page = elems_per_page(bits)
    n_pages = pages.size // PAGE_BYTES
    # bits of each page, shape (n_pages, PAGE_BYTES*8)
    page_bits = np.unpackbits(pages.reshape(n_pages, PAGE_BYTES), axis=1)
    used = per_page * bits
    vals = page_bits[:, :used].reshape(n_pages, per_page, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint32)
    out = (vals.astype(np.uint32) * weights).sum(axis=2).reshape(-1)[:n]
    return out


def _pack_pages_numpy(values: np.ndarray, bits: int) -> np.ndarray:
    per_page = elems_per_page(bits)
    n = values.size
    n_pages = -(-n // per_page)
    padded = np.zeros(n_pages * per_page, dtype=np.uint32)
    padded[:n] = values
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint32)
    bits_arr = ((padded[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    bits_arr = bits_arr.reshape(n_pages, per_page * bits)
    page_bits = np.zeros((n_pages, PAGE_BYTES * 8), dtype=np.uint8)
    page_bits[:, : per_page * bits] = bits_arr
    return np.packbits(page_bits, axis=1).reshape(-1)


def _native_codec():
    try:
        from qcnn_tpu_torch.formats import native

        return native.get_lib()
    except Exception:
        return None


def read_cbn(path: str | os.PathLike, *, one_based: bool = False) -> np.ndarray:
    """Read a reference ``.cbn`` assignment tensor as uint8 codeword indices.

    By default returns 0-based indices (what the stored bits encode, and what
    the engine uses after the MATLAB fixup CaffePara.cc:284-288). Pass
    ``one_based=True`` to reproduce the raw in-memory value of the reference's
    ``ReadCbnFile`` (stored + 1).
    """
    with open(path, "rb") as f:
        dims = _read_header(f)
        (bits,) = _HEADER_INT.unpack(f.read(4))
        if not 1 <= bits <= 8:
            raise ValueError(f"{path}: unsupported bits_per_element={bits}")
        n = int(np.prod(dims))
        n_pages = -(-n // elems_per_page(bits))
        pages = np.fromfile(f, dtype=np.uint8, count=n_pages * PAGE_BYTES)
    if pages.size != n_pages * PAGE_BYTES:
        raise ValueError(f"{path}: truncated page data")
    lib = _native_codec()
    if lib is not None:
        out = lib.unpack_pages(pages, n, bits)
    else:
        out = _unpack_pages_numpy(pages, n, bits)
    out = out.astype(np.uint8)
    if one_based:
        if out.size and int(out.max()) == 255:
            # 1-based values for an 8-bit index reach 256, which uint8
            # cannot hold (the += 1 would silently wrap 255 -> 0)
            out = out.astype(np.uint16)
        out += 1
    return out.reshape(dims)


def write_cbn(
    path: str | os.PathLike, arr: np.ndarray, bits: Optional[int] = None
) -> int:
    """Write 0-based uint8 indices as a reference ``.cbn`` file.

    ``bits`` defaults to the minimum width that represents ``arr.max()``
    (the reference's CalcBitCntPerEle, CaffePara.cc:360-378). Returns the bit
    width used.
    """
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8:
        if arr.min() < 0 or arr.max() > 255:
            raise ValueError("cbn indices must fit in uint8")
        arr = arr.astype(np.uint8)
    if bits is None:
        bits = max(1, int(arr.max()).bit_length())
    if not 1 <= bits <= 8:
        # the on-disk format is uint8 indices; read_cbn rejects the same
        # range — writing wider would produce a file nothing can read
        raise ValueError(f"cbn bits_per_element must be 1..8, got {bits}")
    if int(arr.max()) >= (1 << bits):
        raise ValueError(f"max index {int(arr.max())} does not fit in {bits} bits")
    lib = _native_codec()
    if lib is not None:
        pages = lib.pack_pages(arr.reshape(-1).astype(np.uint32), bits)
    else:
        pages = _pack_pages_numpy(arr.reshape(-1).astype(np.uint32), bits)
    with open(path, "wb") as f:
        f.write(_HEADER_INT.pack(arr.ndim))
        f.write(struct.pack(f"<{arr.ndim}i", *arr.shape))
        f.write(_HEADER_INT.pack(bits))
        pages.tofile(f)
    return bits


def read_txt(path: str | os.PathLike, dtype) -> np.ndarray:
    """Read a reference ``.txt`` tensor (ReadTxtFile, FileIO.h:180-227).

    Layout: a header line ``dim_cnt dims...`` followed by whitespace-
    separated values (the reference reads with fscanf, so any whitespace
    splits tokens). Like ``.bin``, the format does not encode the element
    dtype; the caller supplies it.
    """
    dtype = np.dtype(dtype)
    with open(path, "r", encoding="ascii") as f:
        tokens = f.read().split()
    if not tokens:
        raise ValueError(f"{os.fspath(path)}: empty .txt tensor file")
    dim_cnt = int(tokens[0])
    if not 1 <= dim_cnt <= 8:
        raise ValueError(f"implausible dim_cnt={dim_cnt}; not a reference file?")
    dims = tuple(int(t) for t in tokens[1 : 1 + dim_cnt])
    if any(d <= 0 for d in dims):
        raise ValueError(f"non-positive dimension in header: {dims}")
    n = int(np.prod(dims))
    vals = tokens[1 + dim_cnt :]
    if len(vals) != n:
        raise ValueError(
            f"{os.fspath(path)}: header promises {n} elements, found {len(vals)}"
        )
    return np.array(vals, dtype=dtype).reshape(dims)


def write_txt(path: str | os.PathLike, arr: np.ndarray) -> None:
    """Write a reference ``.txt`` tensor (WriteTxtFile, FileIO.h:353-391).

    Header line ``dim_cnt dims...``; then one line per trailing-dimension
    row, space-separated. Floats print as ``%.4f`` (GetTypeInfo,
    FileIO.h:394-445) — the reference's debug format is lossy by design.
    """
    arr = np.asarray(arr)
    if arr.ndim < 1:
        arr = arr.reshape(1)
    fmt = "%.4f" if np.issubdtype(arr.dtype, np.floating) else "%d"
    last = arr.shape[-1]
    with open(path, "w", encoding="ascii") as f:
        f.write(" ".join(str(d) for d in (arr.ndim, *arr.shape)) + "\n")
        flat = arr.reshape(-1, last)
        for row in flat:
            f.write(" ".join(fmt % v for v in row) + "\n")


def read_asmt(path: str | os.PathLike) -> np.ndarray:
    """Read an assignment tensor from either encoding, returning 0-based uint8
    indices (the engine-facing convention). ``.bin`` raw assignment files store
    1-based MATLAB indices (CaffePara.cc:284-288); ``.cbn`` bits are 0-based."""
    path = os.fspath(path)
    if path.endswith(".cbn"):
        return read_cbn(path)
    raw = read_bin(path, np.uint8)
    if raw.min() < 1:
        raise ValueError(f"{path}: raw assignments must be 1-based")
    return raw - 1


def convert_asmt(src: str | os.PathLike, dst: str | os.PathLike) -> None:
    """Raw↔Compact assignment re-encoding (reference CvtAsmtEnc,
    CaffePara.cc:308-358): .bin (1-based uint8) ↔ .cbn (0-based packed)."""
    src, dst = os.fspath(src), os.fspath(dst)
    vals = read_asmt(src)
    if dst.endswith(".cbn"):
        write_cbn(dst, vals)
    else:
        if vals.max(initial=0) >= 255:
            # the 1-based .bin format stores uint8: index 255 would wrap
            # to 0 under +1 (silently corrupt; round-5 review). The
            # reference's own loader has the same uint8 ceiling
            # (CaffePara.cc:267-288), so this is a format limit, not ours.
            raise ValueError(
                f"{src}: codeword index {int(vals.max())} cannot be "
                "stored 1-based in the uint8 .bin format (K must be "
                "<= 255 for raw encoding; keep .cbn)"
            )
        write_bin(dst, vals + 1)
