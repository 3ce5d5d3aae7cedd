"""IM Tools files as Pillow's ImtImagePlugin opens them: "key value"
lines (a "*" line a comment) up to a form feed, which the raw 8-bit
pixels follow; "width", "height" and "pixel n8" make a gray image.
Pillow reads the header from a 100-byte buffer topped up a line at a
time, and stops at a line of one byte or of more than 100, or one that
is not a key and a value; a file it stops on before the form feed opens
without pixels, and fails to load. A header without a size or without
"pixel n8" fails its open (the file passes on to the next plugin); a
width or height that is not a number fails it outright. IM Tools
carries no metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from cybervision_tpu_torch.imageio import raw
from cybervision_tpu_torch.imageio.errors import CorruptImageError, NotThisFormat, bomb_check

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


@dataclasses.dataclass
class ImtFile:
    data: bytes
    size: tuple[int, int]
    offset: int | None  # of the pixels; None: no form feed, nothing to load


def parse(data: bytes) -> ImtFile:
    """The header, or the error Pillow's open raises (NotThisFormat where
    it passes the file on)."""
    fp = raw.Reader(data)
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise NotThisFormat("not an IM Tools file")
    width = height = 0
    gray = False
    offset = None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = fp.pos - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord("*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        key, value = m.group(1, 2)
        try:
            if key == b"width":
                width = int(value)
            elif key == b"height":
                height = int(value)
        except ValueError as err:
            raise CorruptImageError(f"IM Tools {key.decode()} {value!r} is not a number") from err
        gray |= key == b"pixel" and value == b"n8"
    if not gray or width <= 0 or height <= 0:
        raise NotThisFormat("IM Tools file without a gray image")
    bomb_check((width, height), "IM Tools image")
    return ImtFile(data, (width, height), offset)


def decode(f: ImtFile, native=None) -> tuple[str, np.ndarray, None]:
    """("L", (H, W) uint8)."""
    if f.offset is None:
        raise CorruptImageError("IM Tools file without its form feed: Pillow cannot load it")
    w, h = f.size
    return "L", raw.rows(f.data, f.offset, w, h, mapped=True), None
