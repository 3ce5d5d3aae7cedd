"""Photoshop files (PSD) as Pillow's PsdImagePlugin opens them: the
composite image, never the layers. The 26-byte header (version 1) gives
the channels, size, depth and colour mode, mapped through Pillow's MODES:
bitmap "1"; gray, multichannel and duotone "L"; indexed "P" (its palette
the colour-mode data when that is 768 bytes, planar R, G, B; else
black); RGB "RGB", or "RGBA" with 4 channels; CMYK "CMYK", each channel
inverted (Pillow's "C;I" raw modes); Lab "LAB". Another depth or mode
(16 and 32-bit files) is a KeyError in Pillow's open, which passes the
file on to the next plugin; fewer channels than the mode's fails it
outright. The colour-mode data, the image resources and the layer and
mask section are skipped as Pillow walks them (a walk that runs out of
file passes the file on).

The composite is raw (compression 0), each of the mode's channels
width x height bytes after the last, rows of (width + 7) // 8 bytes for
"1"; or PackBits (1): a table of 16-bit byte counts, one per row of the
mode's channels (Pillow reads no more of it, even where the file has
more channels), then each channel's rows, the channel starting where
the counts of the rows before it say. Pillow's packbits decoder reads a
channel's rows as one stream, dropping what a run or literal holds past
its row's end (imagedecode.cpp's packbits_rows; without the native
library such a file raises NativeDecoderError). Another compression
opens without pixels, and fails to load.

Pillow converts "LAB" to "RGB" through LittleCMS and cannot convert it
to "L". PSD carries no metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio import raw
from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    bomb_check,
    native_missing,
)

MAGIC = b"8BPS"
# (colour mode, bits) -> (mode, channels read): PsdImagePlugin.MODES.
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
         (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
         (9, 8): ("LAB", 3)}


@dataclasses.dataclass
class PsdFile:
    data: bytes
    size: tuple[int, int]
    mode: str
    channels: int  # read
    compression: int
    offsets: list  # of each channel's data
    palette: np.ndarray | None


def _u32(fp: raw.Reader) -> int:
    c = fp.read(4)
    if len(c) < 4:
        raise NotThisFormat("PSD section cut short")
    return struct.unpack(">I", c)[0]


def parse(data: bytes) -> PsdFile:
    """The sections up to the composite image, or the error Pillow's open
    raises (NotThisFormat where it passes the file on)."""
    s = data[:26]
    if len(s) < 26 or not s.startswith(MAGIC) or struct.unpack_from(">H", s, 4)[0] != 1:
        raise NotThisFormat("not a PSD file")
    channels, height, width, bits, psd_mode = struct.unpack_from(">HIIHH", s, 12)
    if (psd_mode, bits) not in MODES:
        raise NotThisFormat(f"PSD of {bits} bits in colour mode {psd_mode}")
    mode, need = MODES[(psd_mode, bits)]
    if need > channels:
        raise CorruptImageError("not enough channels")
    if mode == "RGB" and channels == 4:
        mode, need = "RGBA", 4
    fp = raw.Reader(data, 26)
    palette = None
    n = _u32(fp)
    if n:
        table = fp.read(n)
        if mode == "P" and n == 768:
            palette = np.zeros((256, 3), np.uint8)
            planes = np.frombuffer(table.ljust(768, b"\0"), np.uint8).reshape(3, 256)
            palette[:] = planes.T
    if mode == "P" and palette is None:
        palette = np.zeros((256, 3), np.uint8)
    n = _u32(fp)
    if n:  # the image resources
        end = fp.pos + n
        while fp.pos < end:
            fp.read(4)  # the signature
            if len(fp.read(2)) < 2:
                raise NotThisFormat("PSD resource cut short")
            length = fp.read(1)
            if not length:
                raise NotThisFormat("PSD resource cut short")
            if not len(fp.read(length[0])) & 1:
                fp.read(1)
            if len(fp.read(_u32(fp))) & 1:
                fp.read(1)
    n = _u32(fp)
    if n:  # the layer and mask information
        end = fp.pos + n
        _u32(fp)
        fp.pos = end
    c = fp.read(2)
    if len(c) < 2:
        raise NotThisFormat("PSD without its composite image")
    (compression,) = struct.unpack(">H", c)
    offset = fp.pos
    offsets = []
    if compression == 0:
        offsets = [offset + k * width * height for k in range(need)]
    elif compression == 1:
        counts = fp.read(need * height * 2)
        offset = fp.pos
        if len(counts) < need * height * 2:
            raise NotThisFormat("PSD row byte counts cut short")
        per_channel = np.frombuffer(counts, ">u2").reshape(need, height).sum(axis=1, dtype=np.int64)
        offsets = (offset + np.concatenate([[0], np.cumsum(per_channel)[:-1]])).tolist()
    if width <= 0 or height <= 0:
        raise NotThisFormat("PSD without pixels")
    bomb_check((width, height), "PSD image")
    return PsdFile(data, (width, height), mode, need, compression, offsets, palette)


def decode(p: PsdFile, native) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette): "1", "L" and "P" (H, W), "RGB", "RGBA",
    "CMYK" and "LAB" (H, W, C) uint8."""
    if p.compression not in (0, 1):
        raise CorruptImageError(f"PSD composite of compression {p.compression}: Pillow cannot"
                                " load it")
    w, h = p.size
    row_bytes = (w + 7) // 8 if p.mode == "1" else w
    planes = []
    for offset in p.offsets:
        if p.compression == 0:
            planes.append(raw.rows(p.data, offset, row_bytes, h,
                                   mapped=p.channels == 1 and p.mode in ("L", "P")))
        elif native is None:
            raise native_missing("PackBits PSD")
        else:
            planes.append(native.packbits_rows(p.data[offset:], row_bytes, h))
    if p.mode == "1":
        return "1", np.unpackbits(planes[0], axis=1)[:, :w] * np.uint8(255), None
    if p.channels == 1:
        return p.mode, planes[0], p.palette
    px = np.stack(planes, axis=2)
    return p.mode, (255 - px if p.mode == "CMYK" else px), None
