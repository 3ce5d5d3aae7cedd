"""TGA as Pillow's TgaImagePlugin opens it: an 18-byte header (colour-map
type 0 or 1, a width and height above 0, depth 1, 8, 16, 24 or 32), the
ID field skipped, the colour map read where the colour-map type is 1
(16-bit "BGRA;15Z", 24-bit BGR or 32-bit BGRA entries, the first index
counted as that many black entries; 15-bit entries are refused, as
Pillow refuses them), then uncompressed (image types 1-3) or RLE (9-11)
pixels. Modes, as Pillow picks them: gray (3, 11) "L", "1" at depth 1,
"LA" at depth 16; colour-mapped (1, 9) "P", or "L" without a map (which
Pillow then cannot load); true-colour (2, 10) "RGB" at depth 24, else
"RGBA" (16-bit 5-5-5 pixels, 32-bit BGRA). A gray image with a colour
map keeps it for convert("RGB") and a gray-alpha one becomes "PA", as
Pillow's do; a colour map of 32-bit entries or past 256 entries, or on a
"1" or true-colour image, fails Pillow's load. Rows are bottom-up
unless bit 5 of the descriptor is set; bit 4 mirrors them. TGA carries no
metadata the readers use.

Raw pixels are unpacked with numpy; RLE runs in the native library
(imagedecode.cpp's tga_rle), without which an RLE file raises
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
    bomb_check,
    native_missing,
)

# (image type & 7, depth) -> Pillow's raw mode; a layout without one opens
# but cannot load.
_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
             (2, 24): "BGR", (2, 32): "BGRA"}


@dataclasses.dataclass
class TgaFile:
    data: bytes
    size: tuple[int, int]
    mode: str  # "1", "L", "LA", "P", "RGB" or "RGBA"
    rawmode: str | None
    depth: int
    rle: bool
    top_down: bool
    mirrored: bool
    palette: np.ndarray | None  # (256, 3) uint8, black past the map
    map_depth: int
    map_entries: int  # the first index plus the entry count
    offset: int


def _bgr15(v: np.ndarray) -> np.ndarray:
    """16-bit 5-5-5 words -> (..., 3) RGB as Pillow's BGR;15 unpackers
    scale them (v * 255 / 31)."""
    v = v.astype(np.uint32)
    return np.stack([((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)], axis=-1).astype(np.uint8)


def parse(data: bytes) -> TgaFile:
    """The header and colour map, or the error Pillow's open raises
    (NotThisFormat where it tries the next plugin)."""
    if len(data) < 18:
        raise NotThisFormat("not a TGA header")
    id_len, cmap_type, image_type = data[0], data[1], data[2]
    depth, flags = data[16], data[17]
    size = struct.unpack_from("<HH", data, 12)
    if cmap_type not in (0, 1) or size[0] <= 0 or size[1] <= 0 or depth not in (1, 8, 16, 24, 32):
        raise NotThisFormat("not a TGA header")
    if image_type in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif image_type in (1, 9):
        mode = "P" if cmap_type else "L"
    elif image_type in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThisFormat(f"TGA image type {image_type}")
    pos = 18 + id_len
    palette, map_depth, start, count = None, 0, 0, 0
    if cmap_type:
        start, count, map_depth = struct.unpack_from("<HHB", data, 3)
        nbytes = {16: 2, 24: 3, 32: 4}.get(map_depth)
        if nbytes is None:
            raise NotThisFormat(f"TGA colour map of {map_depth}-bit entries")
        raw = data[pos : pos + nbytes * count]
        pos += len(raw)
        n = len(raw) // nbytes
        entries = np.frombuffer(raw[: n * nbytes], np.uint8).reshape(n, nbytes)
        rgb = _bgr15(entries.view("<u2")[:, 0]) if nbytes == 2 else entries[:, 2::-1]
        palette = np.zeros((256, 3), np.uint8)
        k = min(start, 256)
        palette[k : min(start + n, 256)] = rgb[: 256 - k]
    bomb_check(size, "TGA image")
    return TgaFile(data, size, mode, _RAWMODES.get((image_type & 7, depth)), depth,
                   bool(image_type & 8), flags & 0x20 != 0, flags & 0x10 != 0, palette, map_depth,
                   start + count, pos)


def _unpack(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    """(H, row bytes) -> the mode's pixels."""
    h = len(rows)
    if rawmode == "1":
        return np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
    if rawmode in ("L", "P"):
        return rows[:, :w]
    if rawmode == "LA":
        return rows[:, : 2 * w].reshape(h, w, 2)
    if rawmode == "BGRA;15Z":
        v = rows[:, : 2 * w].copy().view("<u2")
        alpha = np.where(v & 0x8000, 0, 255).astype(np.uint8)
        return np.concatenate([_bgr15(v), alpha[:, :, None]], axis=2)
    step = 3 if rawmode == "BGR" else 4
    px = rows[:, : step * w].reshape(h, w, step)
    return px[:, :, [2, 1, 0, 3][:step]]


def decode(t: TgaFile, native) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette) as imageio.ImageFile.decode gives them."""
    w, h = t.size
    if t.rawmode is None or (t.mode == "L" and t.rawmode == "P"):
        raise CorruptImageError(f"TGA of mode {t.mode} at depth {t.depth}: Pillow opens it but"
                                " cannot load it")
    if t.palette is not None and (t.map_depth == 32 or t.map_entries > 256
                                  or t.mode not in ("L", "LA", "P")):
        # Pillow has no "BGRA" palette raw mode, no palette past 256
        # entries and none on a "1", "RGB" or "RGBA" image.
        raise CorruptImageError(f"TGA {t.mode} image with a colour map of {t.map_entries}"
                                f" {t.map_depth}-bit entries: Pillow opens it but cannot load it")
    bits = {"1": 1, "L": 8, "P": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24, "BGRA": 32}[t.rawmode]
    row_bytes = (w * bits + 7) // 8
    src = t.data[t.offset :]
    if t.rle:
        if native is None:
            raise native_missing("RLE-compressed TGA")
        rows = native.tga_rle(src, t.depth // 8, row_bytes, h)
    else:
        if len(src) < row_bytes * h:
            raise TruncatedImageError("the TGA ends before its pixels")
        rows = np.frombuffer(src, np.uint8, row_bytes * h).reshape(h, row_bytes)
    px = _unpack(rows, t.rawmode, w)
    if not t.top_down:
        px = px[::-1]
    if t.mirrored:
        px = px[:, ::-1]
    # A colour map turns Pillow's "LA" image into "PA" underneath, which
    # convert() then reads; an "L" one keeps its plane and maps its RGB.
    mode = "PA" if t.mode == "LA" and t.palette is not None else t.mode
    return mode, np.ascontiguousarray(px), t.palette
