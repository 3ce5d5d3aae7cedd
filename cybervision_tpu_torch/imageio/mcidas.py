"""McIdas area files as Pillow's McIdasImagePlugin opens them: the magic
(eight bytes, 0 0 0 0 0 0 0 4) starting a 256-byte directory of 64
big-endian signed words w[1..64]; w[11] bytes a sample: 1 "L", 2 "I;16B",
4 "I" (big-endian signed); the size (w[10], w[9]); the pixels raw from
w[34] + w[15], each row w[15] + w[10] * w[11] * w[14] bytes after the
last (read as raw.rows reads a tile: mapped for "L" and "I;16B"). Any
other sample size fails Pillow's open (the file passes on). McIdas
carries no metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio import raw
from cybervision_tpu_torch.imageio.errors import NotThisFormat, bomb_check

MAGIC = b"\x00\x00\x00\x00\x00\x00\x00\x04"
_MODES = {1: ("L", "u1"), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}


@dataclasses.dataclass
class McIdasFile:
    data: bytes
    size: tuple[int, int]
    mode: str
    bytes_per: int
    offset: int
    stride: int


def parse(data: bytes) -> McIdasFile:
    if len(data) < 256 or not data.startswith(MAGIC):
        raise NotThisFormat("not a McIdas area file")
    w = (0,) + struct.unpack_from(">64i", data)
    if w[11] not in _MODES:
        raise NotThisFormat(f"McIdas samples of {w[11]} bytes")
    size = w[10], w[9]
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("McIdas area without pixels")
    bomb_check(size, "McIdas area")
    return McIdasFile(data, size, _MODES[w[11]][0], w[11], w[34] + w[15],
                      w[15] + w[10] * w[11] * w[14])


def decode(m: McIdasFile, native=None) -> tuple[str, np.ndarray, None]:
    """("L", uint8), ("I;16B", uint16) or ("I", int32), (H, W)."""
    w, h = m.size
    rows = raw.rows(m.data, m.offset, w * m.bytes_per, h, m.stride, mapped=m.mode != "I")
    dtype = _MODES[m.bytes_per][1]
    px = rows.view(dtype).reshape(h, w).astype({"L": np.uint8, "I;16B": np.uint16}.get(
        m.mode, np.int32))
    return m.mode, px, None
