"""SPIDER, the electron-microscopy image format, as Pillow's
SpiderImagePlugin opens it: no magic, but a header of 4-byte floats,
big-endian tried first, whose fields 1, 2, 5, 12, 13, 22 and 23 are
integers, iform (5) one of 1, 3, -11, -12, -21, -22 and the header's byte
length (22) the product of its record count (13) and record length (23).
Only a 2D image (iform 1) opens: a single image, or a stack's first image
after the stack's header. The pixels are 32-bit floats in the header's
byte order, rows top-down, mode "F" (converted as the float TIFF is:
clipped and truncated). SPIDER carries no metadata the readers use.
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
)

_IFORMS = (1, 3, -11, -12, -21, -22)


@dataclasses.dataclass
class SpiderFile:
    data: bytes
    size: tuple[int, int]
    big: bool
    offset: int


def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _header_bytes(t: tuple) -> int:
    """isSpiderHeader: the header's length in bytes, or 0."""
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _IFORMS:
        return 0
    labbyt = int(h[22])
    return labbyt if labbyt == int(h[13]) * int(h[23]) else 0


def _int(v: float) -> int:
    try:
        return int(v)
    except (ValueError, OverflowError) as err:
        raise CorruptImageError(f"SPIDER header field {v} is not a number") from err


def parse(data: bytes) -> SpiderFile:
    """The header, or the error Pillow's open raises (NotThisFormat where
    it tries the next plugin)."""
    if len(data) < 27 * 4:
        raise NotThisFormat("not a SPIDER header")
    big = True
    t = struct.unpack(">27f", data[:108])
    hdrlen = _header_bytes(t)
    if hdrlen == 0:
        big = False
        t = struct.unpack("<27f", data[:108])
        hdrlen = _header_bytes(t)
    if hdrlen == 0:
        raise NotThisFormat("not a SPIDER header")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NotThisFormat("not a SPIDER 2D image")
    size = (int(h[12]), int(h[2]))
    istack, imgnumber = _int(h[24]), _int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        _int(h[26])  # the stack's image count, which Pillow reads
        offset = 2 * hdrlen
    elif istack == 0 and imgnumber > 0:
        # Pillow's plugin opens a stack's later image only through seek().
        raise CorruptImageError("a SPIDER image inside a stack, without the stack's header")
    else:
        raise NotThisFormat("inconsistent SPIDER stack header values")
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("SPIDER image without pixels")
    bomb_check(size, "SPIDER image")
    return SpiderFile(data, size, big, offset)


def decode(s: SpiderFile, native=None) -> tuple[str, np.ndarray, None]:
    """("F", (H, W) float32, None)."""
    w, h = s.size
    if s.offset < 0:
        raise CorruptImageError("SPIDER header of a negative length")
    raw = s.data[s.offset : s.offset + 4 * w * h]
    if len(raw) < 4 * w * h:
        raise TruncatedImageError("the SPIDER file ends before its pixels")
    px = np.frombuffer(raw, ">f4" if s.big else "<f4").reshape(h, w)
    return "F", px.astype(np.float32), None
