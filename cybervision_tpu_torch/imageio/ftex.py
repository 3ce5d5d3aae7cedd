"""FTEX textures (Independence War 2) as Pillow 12.1's FtexImagePlugin
opens them: the magic "FTEX", a version, the signed 32-bit width and
height, the mipmap and format counts, and the first format's entry: its
format and the file offset `where` of its first mipmap, which is a signed
32-bit size and that many bytes (a size of -1: the rest of the file).
Format 0 is DXT1 ("RGBA", Pillow's "bcn" decoder: native/bcndecode.cpp's
bcn_decode, without which it raises NativeDecoderError), format 1 raw
"RGB" rows. The pixels are read from the mipmap's bytes alone, so a
mipmap short of the image fails ("image file is truncated").

A header the file ends inside, or a `where` at or past the file's last 3
bytes, fails with struct.error in Pillow's open and passes the file on.
A format count other than 1 fails Pillow's assert, another format its
ValueError, a negative `where` its seek, a mipmap size below -1 its read
(from a file, as the JAX package opens it), and a width or height of 0 or
less the next plugin's seek (Pillow's open has closed the file by then):
each fails the JAX package, and the port refuses the file by name. FTEX
carries no metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio import raw
from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    TruncatedImageError,
    UnsupportedImageError,
    bomb_check,
    native_missing,
)

MAGIC = b"FTEX"


@dataclasses.dataclass
class FtexFile:
    mipmap: bytes
    size: tuple[int, int]
    format: int  # 0 DXT1, 1 RGB


def parse(data: bytes) -> FtexFile:
    """The header and the first mipmap's bytes, or NotThisFormat where
    Pillow's open passes the file on."""
    if not data.startswith(MAGIC) or len(data) < 24:
        raise NotThisFormat("not an FTEX file, or one ending in its header")
    width, height, _, format_count = struct.unpack_from("<4i", data, 8)
    if format_count != 1:
        raise UnsupportedImageError(
            f"FTEX of {format_count} formats: Pillow reads only single-format files (its"
            " assert fails)")
    if len(data) < 32:
        raise NotThisFormat("FTEX file ending in its format entry")
    fmt, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise CorruptImageError(f"FTEX mipmap at offset {where}: Pillow's seek fails")
    if where + 4 > len(data):
        raise NotThisFormat("FTEX file ending before its mipmap's size")
    size = struct.unpack_from("<i", data, where)[0]
    if size < -1:  # a file's read() takes no other negative size
        raise CorruptImageError(f"FTEX mipmap of size {size}: Pillow's read fails")
    mipmap = data[where + 4 :] if size == -1 else data[where + 4 : where + 4 + size]
    if fmt not in (0, 1):
        raise UnsupportedImageError(
            f"FTEX of texture format {fmt}: Pillow does not read it (Invalid texture"
            " compression format)")
    if width <= 0 or height <= 0:
        # Pillow's open has closed the file by now, so its next plugin's
        # seek fails instead of passing the file on.
        raise CorruptImageError(f"FTEX of size {width}x{height}: Pillow closes the file before"
                                " it rejects the size, and fails")
    bomb_check((width, height), "FTEX image")
    return FtexFile(mipmap, (width, height), fmt)


def decode(f: FtexFile, native=None) -> tuple[str, np.ndarray, None]:
    """("RGBA", (H, W, 4)) for DXT1, ("RGB", (H, W, 3)) uint8."""
    w, h = f.size
    if f.format == 0:
        if native is None:
            raise native_missing("An FTEX DXT1 texture")
        return "RGBA", native.bcn_decode(f.mipmap, w, h, 1), None
    try:
        px = raw.rows(f.mipmap, 0, 3 * w, h)
    except TruncatedImageError as err:
        raise TruncatedImageError("image file is truncated (the FTEX mipmap is short of its"
                                  " pixels)") from err
    return "RGB", px.reshape(h, w, 3), None
