"""Baseline JPEG writer: the bytes Pillow's default save(..., "JPEG")
writes through its libjpeg(-turbo), without Pillow.

The defaults are libjpeg's: quality 75 (the Annex K tables scaled by
jcparam.c's jpeg_quality_scaling, clamped to 1..255), YCbCr with Y at 2x2
and Cb, Cr at 1x1 (4:2:0) for RGB, one component for gray, the standard
Huffman tables, no optimisation, no restart interval. The markers, in
libjpeg's order: SOI; APP0 JFIF 1.01, density unit 0, 1:1; one DQT
segment per table; SOF0; one DHT segment per table (DC0, AC0, DC1, AC1);
SOS; the entropy-coded data; EOI. The data comes from the native library
(native/imageencode.cpp); without it the writer raises
NativeDecoderError, as the JPEG reader does.
"""

from __future__ import annotations

import struct

import numpy as np

from cybervision_tpu_torch.imageio.errors import NativeDecoderError

DEFAULT_QUALITY = 75

# Annex K.1's tables, natural (row-major) order.
_STD_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32,
], np.int64)

# Annex K.3's Huffman tables: 16 code counts, then the symbols.
STD_HUFF = [bytes.fromhex(h) for h in (
    # DC luminance
    "00010501010101010100000000000000000102030405060708090a0b",
    # AC luminance
    "0002010303020403050504040000017d01020300041105122131410613516107"
    "227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
    "292a3435363738393a434445464748494a535455565758595a63646566676869"
    "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
    "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
    "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    # DC chrominance
    "00030101010101010101010000000000000102030405060708090a0b",
    # AC chrominance
    "0002010204040304070504040001027700010203110405213106124151076171"
    "1322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
    "2728292a35363738393a434445464748494a535455565758595a636465666768"
    "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
    "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
    "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa",
)]
# (table class << 4 | id) of each, in the order DHT segments are written.
_HUFF_IDS = (0x00, 0x10, 0x01, 0x11)

# Zigzag position -> natural position (DQT stores its tables in zigzag).
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])


def quant_tables(quality: int = DEFAULT_QUALITY) -> np.ndarray:
    """(2, 64) uint16: the luma and chroma tables at `quality`, natural
    order (jcparam.c jpeg_set_quality with force_baseline)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((_STD_QUANT * scale + 50) // 100, 1, 255).astype(np.uint16)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(pixels: np.ndarray, quality: int = DEFAULT_QUALITY) -> bytes:
    """JPEG bytes of an (H, W, 3) RGB or (H, W) gray uint8 image, equal to
    Pillow's Image.fromarray(pixels).save(fh, "JPEG", quality=quality)."""
    from cybervision_tpu_torch import native

    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8 or not (
            pixels.ndim == 2 or (pixels.ndim == 3 and pixels.shape[2] == 3)):
        raise ValueError(f"encode_jpeg: need (H, W) or (H, W, 3) uint8, got {pixels.dtype}"
                         f" {pixels.shape}")
    h, w = pixels.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"encode_jpeg: {w}x{h} does not fit a JPEG frame")
    try:
        native.load()
    except ImportError as err:
        raise NativeDecoderError(
            "JPEG output needs the native encoder, which could not be built"
            " (the native library needs make and a C++ compiler, g++)") from err
    color = pixels.ndim == 3
    quant = quant_tables(quality)
    huff = np.zeros((4, 272), np.uint8)
    for k, spec in enumerate(STD_HUFF):
        huff[k, : len(spec)] = np.frombuffer(spec, np.uint8)
    tables = 2 if color else 1
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(tables):
        out.append(_segment(0xDB, bytes([t]) + quant[t][_NATURAL].astype(np.uint8).tobytes()))
    comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)] if color else [(1, 0x11, 0)]
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, len(comps))
                        + b"".join(bytes(c) for c in comps)))
    for k in range(2 * tables):
        out.append(_segment(0xC4, bytes([_HUFF_IDS[k]]) + STD_HUFF[k]))
    scan = [(1, 0x00), (2, 0x11), (3, 0x11)] if color else [(1, 0x00)]
    out.append(_segment(0xDA, bytes([len(scan)]) + b"".join(bytes(c) for c in scan)
                        + b"\x00\x3f\x00"))
    out.append(native.jpeg_encode_scan(pixels, quant, huff))
    out.append(b"\xff\xd9")
    return b"".join(out)
