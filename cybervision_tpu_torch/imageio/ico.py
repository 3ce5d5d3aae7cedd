"""Windows icons (ICO) and cursors (CUR), as Pillow's IcoImagePlugin and
CurImagePlugin open them.

ICO: the directory's entries sorted by colour depth, then (stably) by
area, largest first; Image.open loads the first, a PNG (read by the PNG
reader, in its own mode and size) or a DIB whose height counts its XOR
bitmap and its AND mask: the first half of its rows is the image, made
"RGBA" with the alpha of a 32-bit entry's every fourth byte or of the
1-bit AND mask (rows padded to 32 bits, bottom-up, set bits transparent)
at the entry's end. CUR: the largest entry by its width and height bytes
(a later one must beat both), its bitmap's first half of the rows, in the
bitmap's own mode (32-bit pixels with alpha when the bitmap sits at offset
22, right after a one-entry directory). Neither carries EXIF or SEM
metadata.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np

from cybervision_tpu_torch.imageio import bmp, png
from cybervision_tpu_torch.imageio.convert import to_rgb
from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    TruncatedImageError,
    bomb_check,
)


@dataclasses.dataclass
class IcoFile:
    data: bytes
    bpp: int  # the entry's bit count
    end: int  # the entry's offset + size: where its AND mask ends
    frame: object  # png.PngFile, or the bmp.BmpFile of its XOR half


def _entries(data: bytes) -> list[tuple]:
    n = struct.unpack_from("<H", data, 4)[0]
    return [data[6 + 16 * k : 22 + 16 * k] for k in range(n)]


def parse(data: bytes) -> IcoFile:
    """IcoFile and IcoImageFile._open: the entry Pillow loads, its frame's
    container parsed."""
    heads = []
    for e in _entries(data):
        width, height, colors = e[0] or 256, e[1] or 256, e[2]
        bpp, size, offset = struct.unpack_from("<HII", e, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        heads.append((width * height, depth, bpp, size, offset))
    if not heads:
        raise NotThisFormat("an ICO directory without entries")
    heads.sort(key=lambda h: h[1])
    heads.sort(key=lambda h: h[0], reverse=True)
    _, _, bpp, size, offset = heads[0]
    if data[offset : offset + 8] == png.SIGNATURE:
        frame = png.parse(data[offset:])
        bomb_check((frame.width, frame.height), "an ICO frame")
    else:
        frame = bmp.bitmap(data, offset, 0)
        bomb_check((frame.width, frame.height), "an ICO frame")
        frame.height = int(frame.height / 2)
    return IcoFile(data, bpp, offset + size, frame)


def parse_cur(data: bytes) -> bmp.BmpFile:
    """CurImageFile._open: the largest cursor's bitmap, its XOR half."""
    best = b""
    for e in _entries(data):
        if not best or (e[0] > best[0] and e[1] > best[1]):
            best = e
    if not best:
        raise NotThisFormat("a CUR directory without entries")
    at = struct.unpack_from("<I", best, 12)[0]
    frame = bmp.bitmap(data, at or 6 + 16 * len(_entries(data)), 0, raw_alpha=at == 22)
    frame.height //= 2
    bomb_check((frame.width, frame.height), "a CUR bitmap")
    return frame


def _and_mask(f: IcoFile, w: int, h: int) -> np.ndarray:
    """The alpha of a BMP frame's AND mask: 0 where a bit is set."""
    stride = (w + 31) // 32 * 4
    at = f.end - stride * h
    if at < 0:
        raise CorruptImageError("an ICO entry's AND mask starts before the file")
    raw = f.data[at : at + stride * h]
    if h and len(raw) < (h - 1) * stride + (w + 7) // 8:
        raise TruncatedImageError("an ICO entry's AND mask runs past the file's end")
    rows = np.frombuffer(raw.ljust(stride * h, b"\0"), np.uint8).reshape(h, stride)
    bits = np.unpackbits(rows, axis=1)[:, :w]
    return np.where(bits[::-1], 0, 255).astype(np.uint8)


def decode(f: IcoFile, native) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette): a PNG frame's own, or "RGBA" (H, W, 4)."""
    if isinstance(f.frame, png.PngFile):
        return png.decode(f.frame, native)
    b = f.frame
    mode, px, palette = bmp.decode(b, native)
    h, w = px.shape[:2]
    if f.bpp == 32:
        raw = f.data[b.offset : b.offset + w * h * 4][3::4]
        if len(raw) < w * h:
            raise TruncatedImageError("an ICO entry's alpha runs past the file's end")
        alpha = np.frombuffer(raw, np.uint8)[: w * h].reshape(h, w)[::-1]
    else:
        alpha = _and_mask(f, w, h)
    rgb = to_rgb(mode, px, palette)
    return "RGBA", np.ascontiguousarray(np.dstack([rgb, alpha])), None
