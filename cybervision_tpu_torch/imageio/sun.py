"""Sun raster files as Pillow's SunImagePlugin opens them: magic
0x59A66A95, a 32-byte big-endian header, depths 1 ("1", set bits black:
raw mode "1;I"), 4 ("L", each nibble times 17), 8 ("L"), 24 (BGR, or RGB
for file type 3) and 32 (BGRX, or RGBX for type 3), an RGB colour map of
at most 1,024 bytes (planar: the reds, then the greens, then the blues,
len // 3 entries, black past them) that makes the 4 and 8-bit gray "P";
Pillow cannot load a 1, 24 or 32-bit file with a map. File types 0, 1,
3, 4 and 5 are raw rows padded to 16 bits (the last row's padding need
not be there); type 2 is byte-encoded (0x80 escapes, runs across rows),
and Pillow decodes it into rows of (width * depth + 7) // 8 bytes, with
no padding: the port does the same. Another depth, file type or map
type fails Pillow's open. Sun raster carries no metadata the readers
use.

Raw files are read with numpy; the byte encoding runs in the native
library (imagedecode.cpp's sun_rle), without which such a file raises
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

MAGIC = 0x59A66A95
_HEADER = 32


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack_from(">I", prefix)[0] == MAGIC


@dataclasses.dataclass
class SunFile:
    data: bytes
    size: tuple[int, int]
    depth: int
    file_type: int
    offset: int
    palette: np.ndarray | None  # (256, 3) uint8


def parse(data: bytes) -> SunFile:
    """The header and colour map, or the error Pillow's open raises
    (NotThisFormat where it tries the next plugin)."""
    if len(data) < _HEADER or not accept(data):
        raise NotThisFormat("not a Sun raster header")
    w, h, depth, _, file_type, map_type, map_length = struct.unpack_from(">7I", data, 4)
    if depth not in (1, 4, 8, 24, 32):
        raise NotThisFormat(f"Sun raster of depth {depth}")
    palette = None
    if map_length:
        if map_length > 1024 or map_type != 1:
            raise NotThisFormat("Sun raster colour map Pillow does not read")
        entries = np.frombuffer(data, np.uint8, max(0, min(map_length, len(data) - _HEADER)),
                                _HEADER)
        n = len(entries) // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = entries[: 3 * n].reshape(3, n).T
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat(f"Sun raster file type {file_type}")
    if w == 0 or h == 0:
        raise NotThisFormat("Sun raster without pixels")
    bomb_check((w, h), "Sun raster")
    return SunFile(data, (w, h), depth, file_type, _HEADER + map_length, palette)


def decode(s: SunFile, native) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette) as imageio.ImageFile.decode gives them."""
    w, h = s.size
    if s.palette is not None and s.depth not in (4, 8):
        raise CorruptImageError(f"a {s.depth}-bit Sun raster with a colour map, which Pillow"
                                " opens but cannot load")
    row_bytes = (w * s.depth + 7) // 8
    if s.file_type == 2:
        if native is None:
            raise native_missing("byte-encoded Sun raster")
        rows = native.sun_rle(s.data[s.offset :], row_bytes * h).reshape(h, row_bytes)
    else:
        stride = (w * s.depth + 15) // 16 * 2
        need = (h - 1) * stride + row_bytes
        raw = s.data[s.offset : s.offset + need]
        if len(raw) < need:
            raise TruncatedImageError("the Sun raster ends before its pixels")
        padded = np.frombuffer(raw + bytes(stride - row_bytes), np.uint8).reshape(h, stride)
        rows = padded[:, :row_bytes]
    if s.depth == 1:
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return "1", np.ascontiguousarray((1 - bits) * np.uint8(255)), None
    if s.depth == 4:
        idx = np.stack([rows >> 4, rows & 15], axis=2).reshape(h, -1)[:, :w]
        if s.palette is None:
            return "L", np.ascontiguousarray(idx * np.uint8(17)), None
        return "P", np.ascontiguousarray(idx), s.palette
    if s.depth == 8:
        return ("L" if s.palette is None else "P"), np.ascontiguousarray(rows), s.palette
    px = rows.reshape(h, w, s.depth // 8)[:, :, :3]
    return "RGB", np.ascontiguousarray(px if s.file_type == 3 else px[:, :, ::-1]), None
