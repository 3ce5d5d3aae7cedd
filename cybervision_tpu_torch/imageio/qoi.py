"""QOI ("Quite OK Image") as Pillow's QoiImagePlugin opens it: the "qoif"
header (big-endian width and height, 3 channels for "RGB", any other
count for "RGBA", the colour space byte skipped), then the op stream,
decoded in the native library (imagedecode.cpp's qoi_decode, which
follows Pillow's decoder); without it a QOI file raises
NativeDecoderError. QOI carries no metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio.errors import NotThisFormat, bomb_check, native_missing

MAGIC = b"qoif"
_HEADER = 14


@dataclasses.dataclass
class QoiFile:
    data: bytes
    size: tuple[int, int]
    channels: int  # 3 or 4


def parse(data: bytes) -> QoiFile:
    """The header, or NotThisFormat where Pillow's open fails over to the
    next plugin."""
    if not data.startswith(MAGIC) or len(data) < 13:
        raise NotThisFormat("QOI header cut short")
    size = struct.unpack_from(">II", data, 4)
    if size[0] == 0 or size[1] == 0:
        raise NotThisFormat("QOI image without pixels")
    bomb_check(size, "QOI image")
    return QoiFile(data, size, 3 if data[12] == 3 else 4)


def decode(q: QoiFile, native) -> tuple[str, np.ndarray, None]:
    """("RGB" or "RGBA", (H, W, C) uint8, None)."""
    if native is None:
        raise native_missing("QOI")
    w, h = q.size
    px = native.qoi_decode(q.data[_HEADER:], w, h, q.channels)
    return ("RGB" if q.channels == 3 else "RGBA"), px, None
