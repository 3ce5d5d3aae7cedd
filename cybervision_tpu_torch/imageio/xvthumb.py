"""XV thumbnails as Pillow's XVThumbImagePlugin opens them: the magic
"P7 332", the rest of its line, "#" comment lines, a line whose first two
fields are the width and height (int() of each), then width x height
bytes of raw pixels, "P" through the fixed 3-3-2 palette (red r * 255 //
7, green g * 255 // 7, blue b * 255 // 3 of the index's bits rrrgggbb).
A file that ends among its comments, or whose size is not above 0,
fails Pillow's open (the file passes on); a size line without two
numbers fails it outright. XV thumbnails carry no metadata the readers
use.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cybervision_tpu_torch.imageio import raw
from cybervision_tpu_torch.imageio.errors import CorruptImageError, NotThisFormat, bomb_check

MAGIC = b"P7 332"
_I = np.arange(256)
PALETTE = np.stack([(_I >> 5) * 255 // 7, ((_I >> 2) & 7) * 255 // 7, (_I & 3) * 255 // 3],
                   axis=1).astype(np.uint8)


@dataclasses.dataclass
class XvFile:
    data: bytes
    size: tuple[int, int]
    offset: int


def parse(data: bytes) -> XvFile:
    if not data.startswith(MAGIC):
        raise NotThisFormat("not an XV thumbnail")
    fp = raw.Reader(data, len(MAGIC))
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise NotThisFormat("XV thumbnail ends before its size")
        if s[0] != ord("#"):
            break
    try:
        w, h = s.strip().split(maxsplit=2)[:2]
        size = int(w), int(h)
    except ValueError as err:
        raise CorruptImageError(f"XV thumbnail size line {s!r}") from err
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("XV thumbnail without pixels")
    bomb_check(size, "XV thumbnail")
    return XvFile(data, size, fp.pos)


def decode(x: XvFile, native=None) -> tuple[str, np.ndarray, np.ndarray]:
    """("P", (H, W) uint8, the 3-3-2 palette)."""
    w, h = x.size
    return "P", raw.rows(x.data, x.offset, w, h, mapped=True), PALETTE
