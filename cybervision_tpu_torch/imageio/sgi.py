"""SGI image files as Pillow's SgiImagePlugin opens them: magic 474, a
512-byte header, storage 0 (uncompressed, one plane per channel) or 1
(RLE rows through the start and length tables), 1 or 2 bytes per sample,
and the (bytes, dimension, zsize) layouts Pillow knows: "L" from
dimension 1 or 2 with zsize 1, "RGB" and "RGBA" from dimension 3 with
zsize 3 or 4; 16-bit samples keep their high byte, as Pillow's "L;16B"
and "RGB;16B" raw modes do. Rows are bottom-up. Another layout fails
Pillow's open; another storage opens but does not load. SGI carries no
metadata the readers use.

Uncompressed files are read with numpy; RLE runs in the native library
(imagedecode.cpp's sgi_rle), without which an RLE file raises
NativeDecoderError.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    TruncatedImageError,
    UnsupportedImageError,
    bomb_check,
    native_missing,
)

MAGIC = 474
_HEADER = 512
# (bytes per sample, dimension, zsize) -> mode, as SgiImagePlugin.MODES.
_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB",
          (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and struct.unpack_from(">H", prefix)[0] == MAGIC


@dataclasses.dataclass
class SgiFile:
    data: bytes
    size: tuple[int, int]
    mode: str
    storage: int
    bpc: int


def parse(data: bytes) -> SgiFile:
    """The header, or the error Pillow's open raises (NotThisFormat where
    it tries the next plugin)."""
    if len(data) < 12:
        raise NotThisFormat("SGI header cut short")
    storage, bpc, dimension, xsize, ysize, zsize = struct.unpack_from(">BBHHHH", data, 2)
    mode = _MODES.get((bpc, dimension, zsize))
    if mode is None:
        raise UnsupportedImageError(f"SGI image of {bpc} bytes a sample, dimension {dimension}"
                                    f" and {zsize} channels is not supported (nor by Pillow)")
    if xsize == 0 or ysize == 0:
        raise NotThisFormat("SGI image without pixels")
    bomb_check((xsize, ysize), "SGI image")
    return SgiFile(data, (xsize, ysize), mode, storage, bpc)


def decode(s: SgiFile, native) -> tuple[str, np.ndarray, None]:
    """(mode, (H, W[, C]) uint8, None)."""
    w, h = s.size
    z = len(s.mode)
    if s.storage == 1:
        if native is None:
            raise native_missing("RLE-compressed SGI")
        rows = native.sgi_rle(s.data[_HEADER:], w, h, z, s.bpc)
        px = rows.reshape(h, w, z, s.bpc)[:, :, :, 0]
    elif s.storage == 0:
        page = w * h * s.bpc
        raw = s.data[_HEADER : _HEADER + z * page]
        if len(raw) < z * page:
            raise TruncatedImageError("the SGI file ends before its pixels")
        planes = np.frombuffer(raw, np.uint8).reshape(z, h, w, s.bpc)[:, ::-1, :, 0]
        px = planes.transpose(1, 2, 0)
    else:
        raise CorruptImageError(f"SGI storage {s.storage}: Pillow opens it but cannot load it")
    return s.mode, np.ascontiguousarray(px if z > 1 else px[:, :, 0]), None
