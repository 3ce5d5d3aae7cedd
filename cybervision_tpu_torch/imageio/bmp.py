"""BMP container, as Pillow's BmpImagePlugin opens it, with its file
header or without it (DibImageFile: a headerless DIB, and the bitmaps
inside ICO and CUR files): the core (12-byte), INFO (40), V2/V3 (52/56),
OS/2 v2 (64), V4 (108) and V5 (124) headers; 1-, 4- and 8-bit palettes
("1" or "L" when the palette is Pillow's gray one, else "P"), 16-bit
5-5-5 and 24- and 32-bit BI_RGB
("RGB", the 32-bit X byte ignored), BI_BITFIELDS with the masks Pillow
accepts (5-5-5, 5-6-5, 24-bit BGR and the 32-bit byte layouts, "RGBA"
where one holds alpha), RLE8 and RLE4; bottom-up or top-down rows from
bfOffBits, or, without a file header, from the byte after the info
header, its bit fields and its palette. BMP carries no metadata the
readers use.

Raw rows are unpacked with numpy. RLE runs in the native library
(imagedecode.cpp's bmp_rle, which also says where the port follows the
BMP specification over Pillow); without it an RLE file raises
NativeDecoderError.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    TruncatedImageError,
    UnsupportedImageError,
    native_missing,
)

_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_DEPTH_MODES = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
                24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
# BI_BITFIELDS masks Pillow accepts -> its raw mode (the byte order of
# each pixel, X unused).
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "L": 8, "P": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}


@dataclasses.dataclass
class BmpFile:
    data: bytes
    width: int
    height: int
    bits: int
    compression: int
    mode: str  # "1", "L", "P", "RGB" or "RGBA"
    rawmode: str
    palette: np.ndarray | None  # (256, 3) uint8 for "P"
    offset: int  # of the pixel data
    top_down: bool


def parse(data: bytes) -> BmpFile:
    """The headers and palette of a BMP file, or the error Pillow's open
    raises (named)."""
    if len(data) < 18 or not data.startswith(b"BM"):
        raise CorruptImageError("not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    return bitmap(data, 14, offset)


def parse_dib(data: bytes) -> BmpFile:
    """A headerless bitmap (DibImageFile): the info header at the file's
    start, the pixels after it."""
    return bitmap(data, 0, 0)


def bitmap(data: bytes, at: int, offset: int, raw_alpha: bool = False) -> BmpFile:
    """BmpImageFile._bitmap: the info header at `at`, the pixels at
    `offset` (bfOffBits; 0: right after the header, its bit fields and
    its palette). raw_alpha: 32-bit BI_RGB pixels read as BGRA (Pillow's
    rule for a cursor's bitmap at offset 22)."""
    if len(data) < at + 4:
        raise NotThisFormat("bitmap header past the file's end")
    (size,) = struct.unpack_from("<I", data, at)
    if size not in _HEADERS:
        raise UnsupportedImageError(f"BMP header of {size} bytes")
    head = data[at + 4 : at + size]
    if len(head) < size - 4:
        raise TruncatedImageError("BMP header past the file's end")
    pos = at + size
    top_down = False
    if size == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", head)
        compression, colors, padding = _RAW, 0, 3
    else:
        top_down = head[7] == 0xFF
        width, height = struct.unpack_from("<II", head)
        if top_down:
            height = 2**32 - height
        bits, compression = struct.unpack_from("<HI", head, 10)
        (colors,) = struct.unpack_from("<I", head, 28)
        padding = 4
        if compression == _BITFIELDS:
            if len(head) >= 48:
                masks = struct.unpack_from("<4I" if len(head) >= 52 else "<3I", head, 36)
            else:
                # A 40-byte header: the three masks follow it.
                masks = struct.unpack_from("<3I", data[pos : pos + 12].ljust(12, b"\0"))
                pos += 12
            masks = tuple(masks) + (0,) * (4 - len(masks))
    colors = colors or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    if bits not in _DEPTH_MODES:
        raise UnsupportedImageError(f"BMP of {bits} bits per pixel")
    mode, rawmode = _DEPTH_MODES[bits]
    if compression == _BITFIELDS:
        key = masks if bits == 32 else masks[:3]
        if (bits, key) not in _MASK_MODES:
            raise UnsupportedImageError(f"BMP bit fields {[hex(m) for m in key]} at {bits} bits")
        rawmode = _MASK_MODES[(bits, key)]
        if "A" in rawmode:
            mode = "RGBA"
    elif compression not in (_RAW, _RLE8, _RLE4):
        raise UnsupportedImageError(f"BMP compression {compression} (JPEG or PNG inside a BMP)")
    elif compression == _RAW and bits == 32 and raw_alpha:
        mode, rawmode = "RGBA", "BGRA"
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise CorruptImageError(f"BMP palette of {colors} colours")
        raw = data[pos : pos + padding * colors]
        pos += padding * colors  # where the pixels start when bfOffBits is 0
        entries = [raw[i * padding : i * padding + 3] for i in range(colors)]
        # Pillow's gray palettes: black and white for two colours, else
        # entry i = (i, i, i) throughout.
        gray = (0, 255) if colors == 2 else range(colors)
        if all(entries[k] == bytes([v & 255] * 3) for k, v in enumerate(gray)):
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            bgr = np.frombuffer(raw, np.uint8)
            n = min(len(bgr) // padding, 256)
            palette = np.zeros((256, 3), np.uint8)
            palette[:n] = bgr[: n * padding].reshape(n, padding)[:, 2::-1]
    return BmpFile(data, width, height, bits, compression, mode, rawmode, palette, offset or pos,
                   top_down)


def _unpack(rows: np.ndarray, rawmode: str, width: int) -> np.ndarray:
    """(H, row bytes) uint8 -> the mode's pixels: indices or gray (H, W),
    "1" as 0 / 255, colour (H, W, 3) or (H, W, 4) in R, G, B(, A) order."""
    if rawmode in ("1", "P;1"):
        px = np.unpackbits(rows, axis=1)[:, :width]
        return px * np.uint8(255) if rawmode == "1" else px
    if rawmode == "P;4":
        return np.stack([rows >> 4, rows & 15], axis=2).reshape(len(rows), -1)[:, :width]
    if rawmode in ("L", "P"):
        return rows[:, :width]
    if rawmode in ("BGR;15", "BGR;16"):
        v = rows[:, : 2 * width].copy().view("<u2").astype(np.uint32)
        if rawmode == "BGR;15":
            r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
            scale = (31, 31, 31)
        else:
            r, g, b = v >> 11, (v >> 5) & 63, v & 31
            scale = (31, 63, 31)
        return np.stack([c * 255 // s for c, s in zip((r, g, b), scale)], axis=2).astype(np.uint8)
    step = len(rawmode)
    px = rows[:, : step * width].reshape(len(rows), width, step)
    order = [rawmode.index(c) for c in ("RGBA" if "A" in rawmode else "RGB")]
    return px[:, :, order]


def decode(b: BmpFile, native) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette) as imageio.ImageFile.decode gives them."""
    w, h = b.width, b.height
    if w < 1 or h < 1:
        raise CorruptImageError("BMP without pixels")
    if b.compression in (_RLE8, _RLE4):
        if b.mode == "1":
            raise CorruptImageError("an RLE BMP with a two-colour gray palette")
        if native is None:
            raise native_missing("RLE-compressed BMP")
        px, n = native.bmp_rle(b.data[b.offset :], b.offset, w, h, b.compression == _RLE4)
        if n < w * h:
            raise TruncatedImageError("the BMP's RLE data ends before its pixels")
    else:
        bits = _RAW_BITS.get(b.rawmode, 32)
        stride = ((w * b.bits + 31) >> 3) & ~3
        row_bytes = (w * bits + 7) // 8
        if row_bytes > stride:
            raise CorruptImageError("BMP rows shorter than its pixel mode")
        need = (h - 1) * stride + row_bytes
        raw = b.data[b.offset : b.offset + need]
        if len(raw) < need:
            raise TruncatedImageError("the BMP ends before its pixels")
        rows = np.frombuffer(raw.ljust(h * stride, b"\0"), np.uint8).reshape(h, stride)
        px = _unpack(rows, b.rawmode, w)
    if not b.top_down:
        px = px[::-1]
    return b.mode, np.ascontiguousarray(px), b.palette
