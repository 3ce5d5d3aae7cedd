"""GIMP brushes (GBR) as Pillow's GbrImagePlugin opens them: a
big-endian header of its size (at least 20), version (1, or 2 with the
magic "GIMP" and a spacing), width, height and colour depth (1: "L", 4:
"RGBA"); a comment to the header's end; then width x height x depth
bytes of raw pixels. Any other header fails Pillow's open, which passes
the file on to the next plugin. GBR carries no metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio.errors import NotThisFormat, TruncatedImageError, bomb_check


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 8 and struct.unpack_from(">I", prefix)[0] >= 20 \
        and struct.unpack_from(">I", prefix, 4)[0] in (1, 2)


@dataclasses.dataclass
class GbrFile:
    data: bytes
    size: tuple[int, int]
    depth: int  # bytes a pixel
    offset: int  # of the pixels


def parse(data: bytes) -> GbrFile:
    """The header, or NotThisFormat where Pillow's open fails."""
    if len(data) < 20 or not accept(data):
        raise NotThisFormat("not a GIMP brush")
    header, version, width, height, depth = struct.unpack_from(">5I", data)
    if width == 0 or height == 0 or depth not in (1, 4):
        raise NotThisFormat("not a GIMP brush of depth 1 or 4")
    if version == 2 and (len(data) < 28 or data[20:24] != b"GIMP"):
        raise NotThisFormat("not a GIMP brush, bad magic number")
    # The comment's length is the header's size less what was read; a
    # negative one reads the rest of the file, leaving no pixels.
    comment = header - (20 if version == 1 else 28)
    bomb_check((width, height), "GBR image")
    return GbrFile(data, (width, height), depth, header if comment >= 0 else len(data))


def decode(g: GbrFile, native=None) -> tuple[str, np.ndarray, None]:
    """("L", (H, W)) or ("RGBA", (H, W, 4)) uint8."""
    w, h = g.size
    n = w * h * g.depth
    raw = g.data[g.offset : g.offset + n]
    if len(raw) < n:
        raise TruncatedImageError("the GBR file ends before its pixels")
    px = np.frombuffer(raw, np.uint8).reshape((h, w) if g.depth == 1 else (h, w, 4))
    return ("L" if g.depth == 1 else "RGBA"), px.copy(), None
