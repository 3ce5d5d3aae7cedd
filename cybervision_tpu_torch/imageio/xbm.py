"""X11 bitmaps (XBM) as Pillow's XbmImagePlugin opens them: its header
regex on the first 512 bytes (#define lines of the width and height, an
optional hot spot, then up to the last "_bits[" + "]" within them), mode
"1". The pixels are read as XbmDecode.c reads them: from the header's
end, each "x" and the two bytes after it are one byte of hex digits
(anything else counts as 0), the search going on after those two;
rows of (width + 7) // 8 bytes, least significant bit first, set bits
white. XBM carries no metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from cybervision_tpu_torch.imageio.errors import NotThisFormat, TruncatedImageError, bomb_check

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]"
)
_BYTE = re.compile(rb"x[\000-\377]{2}")
# XbmDecode.c's HEX(): a digit's value, 0 for any other byte.
_HEX = np.zeros(256, np.uint8)
for _k, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _k
    _HEX[ord(chr(_c).upper())] = _k


def accept(prefix: bytes) -> bool:
    return prefix[:16].lstrip().startswith(b"#define")


@dataclasses.dataclass
class XbmFile:
    data: bytes
    size: tuple[int, int]
    offset: int


def parse(data: bytes) -> XbmFile:
    """The header, or NotThisFormat where Pillow's open fails and tries
    the next plugin."""
    m = _HEAD.match(data[:512])
    if not m:
        raise NotThisFormat("not an XBM header")
    size = int(m.group("width")), int(m.group("height"))
    if size[0] == 0 or size[1] == 0:
        raise NotThisFormat("XBM image without pixels")
    bomb_check(size, "XBM image")
    return XbmFile(data, size, m.end())


def decode(x: XbmFile, native=None) -> tuple[str, np.ndarray, None]:
    """("1", (H, W) uint8 of 0 and 255, None)."""
    w, h = x.size
    need = (w + 7) // 8 * h
    found = b"".join(_BYTE.findall(x.data, x.offset))
    if len(found) < 3 * need:
        raise TruncatedImageError("the XBM file ends before its pixels")
    digits = _HEX[np.frombuffer(found, np.uint8, 3 * need).reshape(need, 3)[:, 1:]]
    rows = (digits[:, 0] << 4 | digits[:, 1]).reshape(h, -1)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
    return "1", np.ascontiguousarray(bits * np.uint8(255)), None
