"""Blizzard textures (BLP) as Pillow 12.1's BlpImagePlugin reads them.

The header: "BLP1" or "BLP2", a signed compression, then for BLP1 a
32-bit alpha flag and for BLP2 the signed bytes encoding, alpha flag and
alpha encoding and a byte of mipmap count; the size; for BLP1 a signed
encoding and a subtype. The mode is "RGBA" where the alpha flag is not 0,
else "RGB"; a header the file ends inside, or a size of 0, passes the file
on to the next plugin. The decoder then reads, from byte 28 (BLP1) or 20
(BLP2) on, the 16 mipmap offsets and 16 lengths, every read all there or
failing ("Truncated File Read"), and only the first mipmap:

  * BLP1 of compression 0, JPEG: a 32-bit header size and that many bytes
    of JPEG header, a skip to offsets[0] where it lies ahead, lengths[0]
    bytes of data; header and data are one JPEG (imageio/jpeg.py; a
    4-component one read as CMYK whatever its Adobe transform, as Pillow
    sets its JPEG mode), converted to RGB and taken back as "BGR", so red
    and blue swap;
  * BLP1 of compression 1, encoding 4 or 5, and BLP2 of compression 1,
    encoding 1: a 256-entry BGRA palette after the offsets and lengths,
    then lengths[0] bytes of indices (BLP2 from offsets[0], BLP1 straight
    after the palette), each its palette entry's RGB, and its alpha for
    "RGBA";
  * BLP2 of compression 1, encoding 2: the palette is read all the same,
    then from offsets[0] rows of DXT1 (alpha encoding 0), DXT3 (1) or DXT5
    (7) blocks through the plugin's own Python decoders
    (native/bcndecode.cpp's blp_dxt: colours widened by a shift, DXT1's
    three-colour mode but four colours for DXT3 and DXT5), each block row
    four rows of the blocks' full width, 3 bytes a pixel for DXT1 without
    alpha, else 4.

The pixels are one flat stream that fills the image row by row at the
image's own width and its mode's bytes a pixel: a width that is not a
multiple of 4 shears the DXT rows, a 4-byte stream read as "RGB" (DXT3 or
DXT5 without the alpha flag) shifts, and a stream short of the image fails
("not enough image data"). Any other compression, encoding or alpha
encoding is a BLPFormatError, which fails the JAX package: the port
refuses it by name. BLP carries no metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio import jpeg
from cybervision_tpu_torch.imageio.convert import to_rgb
from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    TruncatedImageError,
    UnsupportedImageError,
    bomb_check,
    native_missing,
)

_DXT = {0: 1, 1: 3, 7: 5}  # BLP2 alpha encoding -> DXT kind


@dataclasses.dataclass
class BlpFile:
    data: bytes
    version: int  # 1 or 2
    size: tuple[int, int]
    compression: int
    encoding: int
    alpha: bool
    alpha_encoding: int = 0

    @property
    def mode(self) -> str:
        return "RGBA" if self.alpha else "RGB"


def parse(data: bytes) -> BlpFile:
    """The header, or NotThisFormat where Pillow's open passes the file on."""
    if data[:4] == b"BLP1" and len(data) >= 28:
        compression, alpha, width, height, encoding = struct.unpack_from("<iIIIi", data, 4)
        blp = BlpFile(data, 1, (width, height), compression, encoding, alpha != 0)
    elif data[:4] == b"BLP2" and len(data) >= 20:
        compression, encoding, alpha, alpha_encoding = struct.unpack_from("<ibbb", data, 4)
        width, height = struct.unpack_from("<II", data, 12)
        blp = BlpFile(data, 2, (width, height), compression, encoding, alpha != 0,
                      alpha_encoding)
    else:
        raise NotThisFormat("not a BLP file, or one ending in its header")
    if width == 0 or height == 0:
        raise NotThisFormat("BLP of width or height 0")
    bomb_check(blp.size, "BLP image")
    return blp


class _Reader:
    """The decoder's reads: each all there, or "Truncated File Read"."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        if self.pos + n > len(self.data):
            raise TruncatedImageError("Truncated File Read (the BLP file ends first)")
        self.pos += n
        return self.data[self.pos - n : self.pos]


def _refuse(what: str) -> UnsupportedImageError:
    return UnsupportedImageError(f"BLP of {what}: Pillow does not read it (BLPFormatError)")


def _palette(r: _Reader) -> np.ndarray:
    """(256, 4) BGRA."""
    return np.frombuffer(r.read(1024), np.uint8).reshape(256, 4)


def _indexed(r: _Reader, palette: np.ndarray, length: int, alpha: bool) -> bytes:
    """_read_bgra: each of `length` index bytes its palette entry's RGB(A)."""
    idx = np.frombuffer(r.read(length), np.uint8)
    return palette[idx][:, [2, 1, 0, 3] if alpha else [2, 1, 0]].tobytes()


def _jpeg(r: _Reader, offsets, lengths, native) -> bytes:
    """BLP1Decoder._decode_jpeg_stream: RGB bytes of the JPEG, to be taken
    as BGR."""
    header = r.read(struct.unpack("<I", r.read(4))[0])
    r.read(offsets[0] - r.pos)
    body = header + r.read(lengths[0])
    try:
        jpg = jpeg.parse(body)
    except NotThisFormat as err:
        raise CorruptImageError(f"BLP1 JPEG content Pillow cannot open: {err}") from err
    bomb_check((jpg.width, jpg.height), "a BLP1 JPEG")
    if jpg.mode == "CMYK":
        jpg.color = 0  # the plugin's JPEG mode "CMYK": no YCCK conversion
    mode, px, palette = jpeg.decode(jpg, native)
    return to_rgb(mode, px, palette).tobytes()


def _dxt(b: BlpFile, r: _Reader, native) -> bytes:
    """The DXT rows from the file position on, as the plugin's decoders
    lay them out."""
    if b.alpha_encoding not in _DXT:
        raise _refuse(f"alpha encoding {b.alpha_encoding}")
    kind = _DXT[b.alpha_encoding]
    w, h = b.size
    blocks, rows = (w + 3) // 4, (h + 3) // 4
    block_bytes = blocks * (8 if kind == 1 else 16)
    # Each row of blocks is one read, all there or failing.
    if max(len(b.data) - r.pos, 0) // block_bytes < rows:
        raise TruncatedImageError("Truncated File Read (the BLP file ends inside its blocks)")
    if native is None:
        raise native_missing("A BLP2 DXT texture")
    return native.blp_dxt(b.data[r.pos : r.pos + rows * block_bytes], blocks, rows, kind,
                          b.alpha)


def decode(b: BlpFile, native=None) -> tuple[str, np.ndarray, None]:
    """("RGB" or "RGBA", (H, W, 3|4) uint8)."""
    w, h = b.size
    r = _Reader(b.data, 28 if b.version == 1 else 20)
    offsets = struct.unpack("<16I", r.read(64))
    lengths = struct.unpack("<16I", r.read(64))
    bpp, swap = len(b.mode), False
    if b.version == 1:
        if b.compression == 0:
            stream, swap, bpp = _jpeg(r, offsets, lengths, native), True, 3
        elif b.compression == 1 and b.encoding in (4, 5):
            stream = _indexed(r, _palette(r), lengths[0], b.alpha)
        elif b.compression == 1:
            raise _refuse(f"encoding {b.encoding}")
        else:
            raise _refuse(f"compression {b.compression}")
    else:
        # BLP2 reads its palette first, whatever it then decodes.
        palette = _palette(r)
        r.pos = offsets[0]
        if b.compression != 1:
            raise _refuse(f"compression {b.compression}")
        if b.encoding == 1:
            stream = _indexed(r, palette, lengths[0], b.alpha)
        elif b.encoding == 2:
            stream = _dxt(b, r, native)
        else:
            raise _refuse(f"encoding {b.encoding}" + (" (UNCOMPRESSED_RAW_BGRA)"
                                                       if b.encoding == 3 else ""))
    need = w * h * bpp
    if len(stream) < need:
        raise CorruptImageError("not enough image data for the BLP image")
    px = np.frombuffer(stream, np.uint8, need).reshape(h, w, bpp)
    if swap:
        px = px[:, :, ::-1]
        if b.alpha:
            px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], axis=2)
    return b.mode, np.ascontiguousarray(px), None
