"""PCX (ZSoft Paintbrush) as Pillow's PcxImagePlugin opens it: manufacturer
10 and version 0, 2, 3 or 5; the size from xmin..xmax and ymin..ymax; the
layouts Pillow knows, bits x planes of 1 x 1 ("1"), 1 x 2 and 1 x 4 ("P"
through the header's 16-colour palette), and, at version 5, 8 x 1 ("L",
or "P" when the 769 bytes at the file's end are 0x0C and a palette that
is not the gray ramp; Pillow cannot read that tail from a file shorter
than 769 bytes) and 8 x 3 ("RGB", planar rows); any other layout fails
Pillow's open. Every file is run-length decoded, whatever its encoding
byte, and a run may not cross a row's end.

BytesPerLine, the bytes of each plane of a row, is read as the PCX
specification has it: the header's even value when it holds the row.
Pillow 12.1 trusts it only up to rounding its own count to even, and
does not move the planes of an 8 x 3 row 1 or 3 pixels wide to their
place; the port reads those files as the specification says. PCX
carries no metadata the readers use.

DCX (Intel's multi-page PCX) as Pillow's DcxImagePlugin opens it: the
magic 0x3ADE68B1, a table of up to 1024 little-endian page offsets ended
by 0, and the first page, a PCX read as above from its offset (its
palette tail still the file's last 769 bytes). A file without a page
fails Pillow's open, which passes it on to the next plugin.

The run-length code runs in the native library (imagedecode.cpp's
pcx_rle); without it a PCX raises NativeDecoderError.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    NotThisFormat,
    TruncatedImageError,
    UnsupportedImageError,
    bomb_check,
    native_missing,
)

_HEADER = 128
_TAIL = 769  # 0x0C and a 256-entry palette
DCX_MAGIC = 0x3ADE68B1


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


@dataclasses.dataclass
class PcxFile:
    data: bytes
    size: tuple[int, int]
    mode: str  # "1", "L", "P" or "RGB"
    bits: int
    planes: int
    stride: int  # bytes of each plane of a row
    palette: np.ndarray | None  # (256, 3) uint8
    start: int = 0  # of the PCX header in `data` (a DCX page's offset)


def parse(data: bytes, start: int = 0) -> PcxFile:
    """The header (at `start`) and palette, or the error Pillow's open
    raises (NotThisFormat where it tries the next plugin)."""
    head = data[start : start + 68]
    if len(head) < 68 or not accept(head):
        raise NotThisFormat("not a PCX header")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", head, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NotThisFormat("bad PCX image size")
    version, bits, planes = head[1], head[3], head[65]
    (given,) = struct.unpack_from("<H", head, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(head, np.uint8, 48, 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        if len(data) < _TAIL:
            raise TruncatedImageError("a PCX shorter than its 769-byte palette tail, which Pillow"
                                      " cannot seek to")
        tail = data[-_TAIL:]
        if tail[0] == 12:
            entries = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            if not np.array_equal(entries, np.arange(256)[:, None].repeat(3, axis=1)):
                mode, palette = "P", entries.copy()
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise UnsupportedImageError(f"PCX of {bits} bits x {planes} planes (version {version}) is"
                                    " not supported (nor by Pillow)")
    size = (x1 + 1 - x0, y1 + 1 - y0)
    stride = (size[0] * bits + 7) // 8
    if given >= stride and given % 2 == 0:
        stride = given
    elif given != stride:
        stride += stride % 2
    bomb_check(size, "PCX image")
    return PcxFile(data, size, mode, bits, planes, stride, palette, start)


def parse_dcx(data: bytes) -> PcxFile:
    """A DCX's first page, or NotThisFormat where Pillow's open fails."""
    if len(data) < 4 or struct.unpack_from("<I", data)[0] != DCX_MAGIC:
        raise NotThisFormat("not a DCX file")
    offsets = []
    for i in range(1024):
        if len(data) < 8 + 4 * i:
            raise NotThisFormat("DCX page table cut short")
        (offset,) = struct.unpack_from("<I", data, 4 + 4 * i)
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise NotThisFormat("DCX without a page")
    return parse(data, offsets[0])


def decode(p: PcxFile, native) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette) as imageio.ImageFile.decode gives them."""
    if native is None:
        raise native_missing("PCX")
    w, h = p.size
    lines = native.pcx_rle(p.data[p.start + _HEADER :], p.planes * p.stride, h)
    planes = lines.reshape(h, p.planes, p.stride)
    if p.bits == 1:
        bits = np.unpackbits(planes, axis=2)[:, :, :w]
        if p.mode == "1":
            return "1", np.ascontiguousarray(bits[:, 0] * np.uint8(255)), None
        weights = (1 << np.arange(p.planes, dtype=np.uint8))[None, :, None]
        return "P", (bits * weights).sum(axis=1, dtype=np.uint8), p.palette
    if p.mode == "RGB":
        return "RGB", np.ascontiguousarray(planes[:, :, :w].transpose(0, 2, 1)), None
    return p.mode, np.ascontiguousarray(planes[:, 0, :w]), p.palette
