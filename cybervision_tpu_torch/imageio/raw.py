"""What the small readers share of Pillow's ImageFile: a file position
that reads as Python's file objects do (a short read at the end, a seek
past it allowed), and the read of one "raw" tile by ImageFile.load for a
file opened from its path, as the JAX package opens its inputs.

Where the tile's raw mode is the image's mode and one Pillow maps
(Image._MAPMODES), load maps the file: the rows lie at offset + y *
stride (a stride of 0 or less: the row's own bytes), every one inside
the file, else it fails (ValueError), and an offset that leaves no room
for `height * stride` bytes falls back to the raw decoder. The decoder
reads each row's bytes and skips stride minus that between rows (a
stride below the row's bytes is a configuration error), and fails where
the file ends first. Either way `bottom_up` puts the first row last.
"""

from __future__ import annotations

import numpy as np

from cybervision_tpu_torch.imageio.errors import CorruptImageError, TruncatedImageError

MAP_MODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")


class Reader:
    """A file position over `data`."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int = -1) -> bytes:
        end = len(self.data) if n < 0 else self.pos + n
        chunk = self.data[self.pos : end]
        self.pos += len(chunk)
        return chunk

    def readline(self) -> bytes:
        end = self.data.find(b"\n", self.pos)
        return self.read(len(self.data) - self.pos if end < 0 else end + 1 - self.pos)


def rows(data: bytes, offset: int, row_bytes: int, height: int, stride: int = 0,
         bottom_up: bool = False, mapped: bool = False) -> np.ndarray:
    """(height, row_bytes) uint8 of a raw tile (see the module's doc);
    `mapped`: the tile's raw mode is the image's mode and in MAP_MODES."""
    n = len(data)
    if mapped:
        if offset < 0:
            raise CorruptImageError("a tile offset below 0")
        if offset + height * stride <= n:
            step = stride if stride > 0 else row_bytes
            if offset + height * step > n:
                raise TruncatedImageError("the file ends before its pixels")
            return _strided(data, offset, row_bytes, height, step, bottom_up)
    step = stride or row_bytes
    if step < row_bytes:
        raise CorruptImageError("a row stride below the row's bytes")
    if offset < 0 or offset + (height - 1) * step + row_bytes > n:
        raise TruncatedImageError("the file ends before its pixels")
    return _strided(data, offset, row_bytes, height, step, bottom_up)


def _strided(data: bytes, offset: int, row_bytes: int, height: int, step: int,
             bottom_up: bool) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    view = np.lib.stride_tricks.as_strided(buf[offset:], (height, row_bytes), (step, 1),
                                           writeable=False)
    return np.ascontiguousarray(view[::-1] if bottom_up else view)
