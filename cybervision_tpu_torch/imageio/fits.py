"""FITS files as Pillow 12.1's FitsImagePlugin opens them: 80-byte
header cards ("KEYWORD = value / comment") in 2880-byte blocks, the
first "SIMPLE = T"; a header of NAXIS 0 leads on to the next one
(XTENSION), whose cards replace its values; the first header with axes
gives the image, and its data unit the pixels. NAXIS 1 is a 1 x NAXIS1
image, more axes NAXIS1 x NAXIS2. BITPIX 8 is "L", 16 "I;16", 32 "I",
-32 and -64 "F"; any other leaves no mode, which fails Pillow's open (the
file passes on to the next plugin).

Pillow reads the data unit with the image's mode as its raw mode: 16 and
32-bit samples little-endian, though FITS stores them big-endian, floats
as little-endian float32 (of a -64 file, half the bytes), rows from the
bottom up; BZERO and BSCALE are not applied. The port reads the same
planes. A tile-compressed image (XTENSION 'BINTABLE', ZIMAGE T, ZCMPTYPE
'GZIP_1') is Pillow's fits_gzip decoder: gzip.decompress of the file
from the heap (after the NAXIS1 x NAXIS2 table) on, the last min(ZBITPIX
/ 8, 4) bytes of each 4-byte word as a pixel in the raw mode, the rows
reversed (a negative ZBITPIX keeps no bytes, and fails).

"No image data" (no header with axes) and "Truncated FITS file" (the
file ends inside a header) fail Pillow's open outright, as do numbers
that int() does not read. FITS carries no metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import gzip
import zlib

import numpy as np

from cybervision_tpu_torch.imageio import raw
from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    TruncatedImageError,
    bomb_check,
)

_BLOCK, _CARD = 2880, 80
_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}
_DTYPES = {"L": "u1", "I;16": "<u2", "I": "<i4", "F": "<f4"}


@dataclasses.dataclass
class FitsFile:
    data: bytes
    size: tuple[int, int]
    mode: str
    offset: int
    gzip_bits: int | None  # ZBITPIX of a GZIP_1 image, None for raw data


def _number(headers: dict, key: bytes) -> int:
    if key not in headers:
        raise NotThisFormat(f"FITS header without {key.decode()}")
    try:
        return int(headers[key])
    except ValueError as err:
        raise CorruptImageError(f"FITS {key.decode()} {headers[key]!r} is not a number") from err


def _size(headers: dict, prefix: bytes) -> tuple[int, int] | None:
    naxis = _number(headers, prefix + b"NAXIS")
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _number(headers, prefix + b"NAXIS1")
    return _number(headers, prefix + b"NAXIS1"), _number(headers, prefix + b"NAXIS2")


def _image(headers: dict):
    """FitsImageFile._parse_headers: (size, mode, offset in the data unit,
    gzip bits) or None for a header without axes."""
    prefix, offset, gzip_bits = b"", 0, None
    if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T":
        if b"ZCMPTYPE" not in headers:
            raise NotThisFormat("FITS compressed image without ZCMPTYPE")
        if headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
            table = _size(headers, b"") or (0, 0)
            offset = table[0] * table[1] * (_number(headers, b"BITPIX") // 8)
            prefix = b"Z"
    size = _size(headers, prefix)
    if not size:
        return None
    bits = _number(headers, prefix + b"BITPIX")
    if prefix:
        gzip_bits = bits
    return size, _MODES.get(bits, ""), offset, gzip_bits


def parse(data: bytes) -> FitsFile:
    """The headers up to the image's data unit, or the error Pillow's
    open raises (NotThisFormat where it passes the file on)."""
    fp = raw.Reader(data)
    headers: dict = {}
    in_header = False
    image = None
    while True:
        card = fp.read(_CARD)
        if not card:
            raise TruncatedImageError("Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break
        elif keyword == b"END":
            fp.pos = -(-fp.pos // _BLOCK) * _BLOCK
            if not image:
                image = _image(headers)
            in_header = False
            continue
        if image:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise NotThisFormat("not a FITS file")
        headers[keyword] = value
    if not image:
        raise CorruptImageError("No image data")
    size, mode, offset, gzip_bits = image
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat(f"FITS image of {size} without a mode")
    bomb_check(size, "FITS image")
    return FitsFile(data, size, mode, offset + fp.pos - _CARD, gzip_bits)


def decode(f: FitsFile, native=None) -> tuple[str, np.ndarray, None]:
    """("L", uint8), ("I;16", uint16), ("I", int32) or ("F", float32), (H, W)."""
    w, h = f.size
    dtype = np.dtype(_DTYPES[f.mode])
    if f.gzip_bits is None:
        rows = raw.rows(f.data, f.offset, w * dtype.itemsize, h, bottom_up=True,
                        mapped=f.mode in raw.MAP_MODES)
        return f.mode, rows.view(dtype).reshape(h, w).astype(dtype.newbyteorder("=")), None
    if f.offset < 0:
        raise CorruptImageError("FITS heap before the file's start")
    try:
        value = gzip.decompress(f.data[f.offset :])
    except (OSError, EOFError, ValueError, zlib.error) as err:
        raise CorruptImageError(f"FITS GZIP_1 data: {err}") from err
    keep = min(f.gzip_bits // 8, 4)
    if keep <= 0 or keep != dtype.itemsize or len(value) < 4 * w * h:
        raise CorruptImageError("FITS GZIP_1 data short of the image (Pillow: not enough image"
                                " data)")
    words = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)[::-1, :, 4 - keep :]
    return f.mode, np.ascontiguousarray(words).view(dtype).reshape(h, w).astype(
        dtype.newbyteorder("=")), None
