"""PIXAR raster files as Pillow's PixarImagePlugin opens them: the magic
0x80E80000, the size in the 16-bit little-endian words at 418 (width)
and 416 (height) of the 512-byte header, and the one layout Pillow names,
(14, 2) in the words at 424 and 426: "RGB", raw from byte 1024. Any other
layout opens without a mode, which fails Pillow's open (the file passes
on to the next plugin). PIXAR carries no metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio import raw
from cybervision_tpu_torch.imageio.errors import NotThisFormat, bomb_check

MAGIC = b"\x80\xe8\x00\x00"
_OFFSET = 1024


@dataclasses.dataclass
class PixarFile:
    data: bytes
    size: tuple[int, int]


def parse(data: bytes) -> PixarFile:
    if not data.startswith(MAGIC) or len(data) < 428:
        raise NotThisFormat("not a PIXAR file")
    height, width = struct.unpack_from("<2H", data, 416)
    if struct.unpack_from("<2H", data, 424) != (14, 2) or width == 0 or height == 0:
        raise NotThisFormat("PIXAR layout Pillow opens without a mode")
    bomb_check((width, height), "PIXAR image")
    return PixarFile(data, (width, height))


def decode(p: PixarFile, native=None) -> tuple[str, np.ndarray, None]:
    """("RGB", (H, W, 3) uint8)."""
    w, h = p.size
    return "RGB", raw.rows(p.data, _OFFSET, 3 * w, h).reshape(h, w, 3), None
