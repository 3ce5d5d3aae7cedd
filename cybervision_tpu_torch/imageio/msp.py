"""Windows Paint (MSP) files as Pillow's MspImagePlugin opens them: the
magic "DanM" (version 1) or "LinS" (version 2), a 32-byte header of 16
little-endian words whose XOR is 0 (else Pillow's open fails), the size
in words 2 and 3, mode "1" (set bits white). Version 1 is raw rows of
(width + 7) // 8 bytes; version 2 is a row map of byte counts and
run-length coded rows (MspDecoder: a 0 byte is a run of count and value,
any other byte n a literal of the next n bytes, a row of count 0 white),
every row read and their bytes taken as one stream of raw rows, as Pillow
does. MSP carries no metadata the readers use.

Version 2's rows run in the native library (imagedecode.cpp's msp_rle),
without which such a file raises NativeDecoderError.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    NotThisFormat,
    TruncatedImageError,
    bomb_check,
    native_missing,
)

_HEADER = 32


def accept(prefix: bytes) -> bool:
    return prefix.startswith((b"DanM", b"LinS"))


@dataclasses.dataclass
class MspFile:
    data: bytes
    size: tuple[int, int]
    version: int


def parse(data: bytes) -> MspFile:
    """The header, or the error Pillow's open raises (NotThisFormat where
    it tries the next plugin)."""
    if len(data) < _HEADER or not accept(data):
        raise NotThisFormat("not an MSP header")
    words = struct.unpack_from("<16H", data)
    checksum = 0
    for word in words:
        checksum ^= word
    if checksum:
        raise NotThisFormat("bad MSP checksum")
    size = words[2], words[3]
    if size[0] == 0 or size[1] == 0:
        raise NotThisFormat("MSP image without pixels")
    bomb_check(size, "MSP image")
    return MspFile(data, size, 1 if data.startswith(b"DanM") else 2)


def decode(m: MspFile, native) -> tuple[str, np.ndarray, None]:
    """("1", (H, W) uint8 of 0 and 255, None)."""
    w, h = m.size
    row_bytes = (w + 7) // 8
    if m.version == 1:
        raw = m.data[_HEADER : _HEADER + row_bytes * h]
        if len(raw) < row_bytes * h:
            raise TruncatedImageError("the MSP file ends before its pixels")
        rows = np.frombuffer(raw, np.uint8).reshape(h, row_bytes)
    else:
        if native is None:
            raise native_missing("version 2 (run-length coded) MSP")
        rows = native.msp_rle(m.data[_HEADER:], row_bytes, h)
    bits = np.unpackbits(rows, axis=1)[:, :w]
    return "1", np.ascontiguousarray(bits * np.uint8(255)), None
