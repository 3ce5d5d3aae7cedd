"""GIF container, as Pillow's GifImagePlugin opens and loads a file's
first frame (LOADING_STRATEGY RGB_AFTER_FIRST): the header and logical
screen, the global colour table, every extension block up to the first
image descriptor (a graphic control extension's transparency index
read, the rest skipped by their sub-block lengths, stray bytes between
blocks skipped one at a time), the descriptor's position, size,
interlace flag and local colour table, and its LZW minimum code size.

The mode is Pillow's: "P" with the frame's colour table (the local one,
else the global one), or "L" where the table is absent or the identity
gray ramp (entry i = (i, i, i)), which Pillow drops — except that an "L"
frame with an identity local table keeps the global one for its colour
plane, as Pillow's does. The canvas is the
logical screen, widened to hold the frame; the pixels outside the frame
are the transparency index, else 0. Palette entries past the table are
black, as in Pillow. GIF carries no metadata the readers use.

The LZW data decodes in the native library (imagedecode.cpp's gif_lzw);
without it a GIF raises NativeDecoderError.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    TruncatedImageError,
    bomb_check,
    native_missing,
)

SIGNATURES = (b"GIF87a", b"GIF89a")


@dataclasses.dataclass
class GifFile:
    data: bytes
    size: tuple[int, int]  # the canvas (width, height)
    extent: tuple[int, int, int, int]  # the frame's x0, y0, x1, y1
    interlace: bool
    mode: str  # "P" or "L"
    palette: np.ndarray | None  # (256, 3) uint8 for "P" (and an "L" frame's, see parse)
    transparency: int | None
    bits: int  # the LZW minimum code size
    offset: int  # of the frame's first data sub-block


class _Reader:
    """A file object's read() over the bytes: short at the end."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += len(out)
        return out

    def block(self) -> bytes | None:
        """One sub-block (GifImageFile.data): None at a zero length or the
        file's end."""
        s = self.read(1)
        return self.read(s[0]) if s and s[0] else None


def _table(p: bytes) -> np.ndarray | None:
    """A colour table as Pillow keeps it: None for the identity gray ramp
    (_is_palette_needed), else (256, 3), black past its entries."""
    for i in range(0, len(p), 3):
        # Pillow compares i // 3, R, G and B in turn, indexing past a
        # partial last entry only while they are equal.
        for k in range(3):
            if i + k >= len(p):
                raise CorruptImageError("GIF colour table ends inside an entry")
            if p[i + k] != i // 3:
                break
        else:
            continue
        break
    else:
        return None
    palette = np.zeros((256, 3), np.uint8)
    n = len(p) // 3
    palette[:n] = np.frombuffer(p[: 3 * n], np.uint8).reshape(n, 3)
    return palette


def parse(data: bytes) -> GifFile:
    """The container up to the first frame's data, or the error Pillow's
    open raises (named)."""
    if len(data) < 13 or data[:6] not in SIGNATURES:
        raise CorruptImageError("not a GIF file, or its screen descriptor is cut")
    width, height, flags = struct.unpack_from("<HHB", data, 6)
    fp = _Reader(data, 13)
    global_palette = None
    if flags & 128:
        global_palette = _table(fp.read(3 << ((flags & 7) + 1)))
    s = fp.read(1)
    if not s or s == b";":
        raise CorruptImageError("GIF without an image")
    transparency = None
    while True:
        if not s:
            s = fp.read(1)
        if not s or s == b";":
            raise TruncatedImageError("GIF ends before its first image")
        if s == b"!":
            label = fp.read(1)
            if not label:
                raise TruncatedImageError("GIF ends inside an extension")
            block = fp.block()
            if label[0] == 249 and block is not None:
                if not block:
                    raise TruncatedImageError("GIF ends inside an extension")
                if block[0] & 1:
                    if len(block) < 4:
                        raise CorruptImageError("GIF graphic control extension too short")
                    transparency = block[3]
                if len(block) < 3:
                    raise CorruptImageError("GIF graphic control extension too short")
            elif label[0] == 254:
                while block:
                    block = fp.block()
                s = b""
                continue
            elif label[0] == 255 and block is not None and block.startswith(b"NETSCAPE2.0"):
                fp.block()
            while fp.block():
                pass
        elif s == b",":
            desc = fp.read(9)
            if len(desc) < 9:
                raise TruncatedImageError("GIF ends inside an image descriptor")
            x0, y0, w, h, flags = struct.unpack("<HHHHB", desc)
            palette, local_identity = global_palette, False
            if flags & 128:
                palette = _table(fp.read(3 << ((flags & 7) + 1)))
                local_identity = palette is None
            code = fp.read(1)
            if not code:
                raise TruncatedImageError("GIF ends before its image data")
            break
        s = b""
    x1, y1 = x0 + w, y0 + h
    size = (max(x1, width), max(y1, height))
    bomb_check(size, "GIF canvas")
    mode = "L" if palette is None else "P"
    if local_identity:
        # Pillow keeps the global table on such an "L" frame: its image is
        # "P" underneath, and convert("RGB") applies the table.
        palette = global_palette
    return GifFile(data, size, (x0, y0, x1, y1), bool(flags & 64), mode, palette,
                   transparency, code[0], fp.pos)


def decode(g: GifFile, native) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette) as imageio.ImageFile.decode gives them."""
    x0, y0, x1, y1 = g.extent
    if x0 == 0 and x1 == 0:
        # Pillow's decoder takes a tile of no width at x 0 for the whole
        # image.
        x1, y0, y1 = g.size[0], 0, g.size[1]
    if x1 <= x0 or y1 <= y0:
        raise CorruptImageError("GIF frame without pixels")
    if native is None:
        raise native_missing("GIF")
    frame = native.gif_lzw(g.data[g.offset :], g.bits, g.interlace, x1 - x0, y1 - y0)
    canvas = np.full((g.size[1], g.size[0]), g.transparency or 0, np.uint8)
    canvas[y0:y1, x0:x1] = frame
    return g.mode, canvas, g.palette
