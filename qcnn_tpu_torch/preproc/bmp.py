"""Minimal BMP decoder (24-bit uncompressed), replacing the reference's
third-party bitmap_image.hpp (only get_pixel on 24-bpp files is used there,
BmpImgIO.cc:73-103). Pure NumPy; returns float32 HWC in **BGR** channel order —
the reference's native layout (Caffe models are BGR-trained). A copy of
``qcnn_tpu/preproc/bmp.py``."""

from __future__ import annotations

import struct

import numpy as np


def read_bmp(path: str) -> np.ndarray:
    """Decode a 24-bit BI_RGB BMP file to a (H, W, 3) float32 BGR array."""
    with open(path, "rb") as f:
        return decode_bmp(f.read(), name=path)


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode 24-bit BI_RGB BMP bytes to a (H, W, 3) float32 BGR array."""
    path = name
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    (pixel_offset,) = struct.unpack_from("<I", data, 10)
    (header_size,) = struct.unpack_from("<I", data, 14)
    if header_size < 40:
        raise ValueError(f"{path}: unsupported BMP header size {header_size}")
    width, height = struct.unpack_from("<ii", data, 18)
    (planes, bpp) = struct.unpack_from("<HH", data, 26)
    (compression,) = struct.unpack_from("<I", data, 30)
    if bpp != 24 or compression != 0:
        raise ValueError(
            f"{path}: only 24-bpp uncompressed BMP supported (bpp={bpp}, "
            f"compression={compression})"
        )
    top_down = height < 0
    height = abs(height)
    if width <= 0 or height == 0:
        # width=-1 would otherwise flow into reshape(h, -1, 3) as NumPy
        # dimension INFERENCE and silently yield an empty image
        # (round-5 review); the native C++ decoder rejects these too
        raise ValueError(f"{path}: invalid BMP dimensions "
                         f"{width}x{height}")
    row_bytes = (width * 3 + 3) & ~3
    end = pixel_offset + row_bytes * height
    if len(data) < end:
        raise ValueError(f"{path}: truncated pixel data")
    rows = np.frombuffer(data[pixel_offset:end], dtype=np.uint8)
    rows = rows.reshape(height, row_bytes)[:, : width * 3]
    img = rows.reshape(height, width, 3)  # stored as BGR triples
    if not top_down:
        img = img[::-1]
    return img.astype(np.float32)


def read_image(path: str) -> np.ndarray:
    """Decode any supported image file to (H, W, 3) float32 BGR.

    BMPs go through this repo's own decoder (bit-exact with the
    reference's pipeline, BmpImgIO.cc:73-103); anything else (JPEG, PNG,
    ...) decodes via PIL when available — the reference is BMP-only, but
    real-world inputs (and the torch-trained family models' data) are
    JPEGs."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"BM":
        return read_bmp(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError(
            f"{path}: not a BMP and PIL is unavailable for other formats"
        ) from e
    img = Image.open(path).convert("RGB")
    rgb = np.asarray(img, np.float32)
    return np.ascontiguousarray(rgb[..., ::-1])  # RGB -> BGR


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode image bytes to (H, W, 3) float32 BGR: own decoder for BMP,
    PIL for anything else (JPEG/PNG uploads on the serve path)."""
    if data[:2] == b"BM":
        return decode_bmp(data, name=name)
    import io

    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError(
            f"{name}: not a BMP and PIL is unavailable for other formats"
        ) from e
    try:
        img = Image.open(io.BytesIO(data)).convert("RGB")
    except Exception as e:  # PIL raises various decode errors
        raise ValueError(f"{name}: undecodable image ({e})") from e
    rgb = np.asarray(img, np.float32)
    return np.ascontiguousarray(rgb[..., ::-1])


def encode_bmp24(pixels_hwc: "np.ndarray", *, input_order: str = "rgb"
                 ) -> bytes:
    """Encode (H, W, 3) uint8 pixels as a 24-bpp BI_RGB bottom-up BMP.

    The write-side counterpart of decode_bmp (the reference's
    bitmap_image.hpp both reads and writes this layout) and the ONE
    encoder behind every test/sanitize corpus — four hand-rolled copies
    had started to drift. input_order names the channel order of the
    input array; the file stores BGR either way.
    """
    import struct

    arr = np.asarray(pixels_hwc, np.uint8)
    h, w, _ = arr.shape
    if input_order == "rgb":
        arr = arr[..., ::-1]
    elif input_order != "bgr":
        raise ValueError(f"unknown input_order {input_order!r}")
    row_bytes = (3 * w + 3) & ~3
    header = bytearray(54)
    header[0:2] = b"BM"
    struct.pack_into("<I", header, 2, 54 + row_bytes * h)
    struct.pack_into("<I", header, 10, 54)
    struct.pack_into("<I", header, 14, 40)
    struct.pack_into("<i", header, 18, w)
    struct.pack_into("<i", header, 22, h)
    struct.pack_into("<H", header, 26, 1)
    struct.pack_into("<H", header, 28, 24)
    pad = b"\0" * (row_bytes - 3 * w)
    rows = bytearray()
    for r in range(h - 1, -1, -1):
        rows += arr[r].tobytes() + pad
    return bytes(header) + bytes(rows)
