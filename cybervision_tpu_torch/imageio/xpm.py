"""X11 pixmaps (XPM) as Pillow's XpmImagePlugin opens them: "/* XPM */",
then the first line that starts with '"' and four numbers (width,
height, colours, characters per pixel), then one line per colour: its
key (the characters after the line's first), and of its words up to the
line's last two characters the value after the first "c", "#" and hex
digits (the low 24 bits read as RGB) or "None" (a transparent key, which
Pillow leaves out of the palette, so a pixel of it fails the load); any
other value, or no "c", raises ValueError, as in Pillow. Up to 256
colours the image is "P" (each key's index among the colours), past
that "RGB". The pixels, as XpmDecoder reads them: every line after the
colours (but a first "/* pixels */"), the text between its first and
last '"', cut into keys; the keys of all lines, one stream, fill the
image's rows, and the lines stop once they have. XPM carries no
metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    TruncatedImageError,
    bomb_check,
)

MAGIC = b"/* XPM */"
_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def accept(prefix: bytes) -> bool:
    return prefix.startswith(MAGIC)


@dataclasses.dataclass
class XpmFile:
    data: bytes
    size: tuple[int, int]
    bpp: int
    colours: dict  # key -> (r, g, b), in the file's order
    rgb: bool
    offset: int


def _readline(data: bytes, pos: int) -> tuple[bytes, int]:
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def parse(data: bytes) -> XpmFile:
    """The header and colours, or the error Pillow's open raises
    (NotThisFormat where it tries the next plugin)."""
    if not accept(data):
        raise NotThisFormat("not an XPM file")
    pos = len(MAGIC)
    while True:
        line, pos = _readline(data, pos)
        if not line:
            raise NotThisFormat("broken XPM file")
        m = _HEAD.match(line)
        if m:
            break
    try:
        size = int(m.group(1)), int(m.group(2))
        n_colours, bpp = int(m.group(3)), int(m.group(4))
    except ValueError as err:
        raise CorruptImageError(f"XPM header {line[:40]!r} lacks a number") from err
    colours = {}
    for _ in range(n_colours):
        line, pos = _readline(data, pos)
        line = line.rstrip()
        key, words = line[1 : bpp + 1], line[bpp + 1 : -2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                if i + 1 >= len(words):
                    raise NotThisFormat("XPM colour key without a value")
                value = words[i + 1]
                if value.startswith(b"#"):
                    try:
                        v = int(value[1:], 16)
                    except ValueError as err:
                        raise CorruptImageError(f"XPM colour {value!r}") from err
                    colours[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                elif value != b"None":
                    raise CorruptImageError(f"XPM colour {value!r}: Pillow reads only #rgb"
                                            " and None")
                break
        else:
            raise CorruptImageError("XPM colour line without a colour key")
    if size[0] == 0 or size[1] == 0:
        raise NotThisFormat("XPM image without pixels")
    bomb_check(size, "XPM image")
    return XpmFile(data, size, bpp, colours, n_colours > 256, pos)


def decode(x: XpmFile, native=None) -> tuple[str, np.ndarray, np.ndarray | None]:
    """("P", (H, W) indices, (256, 3) palette) or ("RGB", (H, W, 3), None)."""
    w, h = x.size
    if x.bpp == 0:
        raise CorruptImageError("XPM of 0 characters a pixel")
    keys = list(x.colours)
    lut = {key: i for i, key in enumerate(keys)}
    out: list[int] = []
    pos, header = x.offset, False
    while len(out) < w * h:
        line, pos = _readline(x.data, pos)
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        try:
            out += [lut[line[i : i + x.bpp]] for i in range(0, len(line), x.bpp)]
        except KeyError as err:
            raise CorruptImageError(f"XPM pixel of key {err.args[0]!r}, which names no"
                                    " colour Pillow reads") from err
    if len(out) < w * h:
        raise TruncatedImageError("the XPM file ends before its pixels")
    idx = np.array(out[: w * h], np.int64).reshape(h, w)
    palette = np.zeros((max(256, len(keys)), 3), np.uint8)
    if keys:
        palette[: len(keys)] = np.array([x.colours[k] for k in keys], np.uint8)
    if x.rgb:
        return "RGB", palette[idx], None
    return "P", idx.astype(np.uint8), palette[:256]
