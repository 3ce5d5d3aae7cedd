"""macOS icons (ICNS), as Pillow's IcnsImagePlugin opens them: the
resource directory, the best size (the largest of IcnsFile.SIZES that
has an entry), then every entry of that size in SIZES' order: a PNG (read
by the PNG reader, in its own mode and size, which must be one Pillow
allows) or JPEG 2000 (not read yet), the 24-bit planes of it32 (after
its four zero bytes), ih32, il32 or is32 (raw where the entry holds
exactly 3 bytes a pixel, else run-length coded: imagedecode.cpp's
icns_rle) and their 8-bit masks (t8mk, h8mk, l8mk, s8mk). A PNG or JPEG
2000 entry wins; else the planes, "RGBA" with a mask or "RGB" without
one. ICNS carries no EXIF or SEM metadata.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio import png
from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    TruncatedImageError,
    UnsupportedImageError,
    bomb_check,
    native_missing,
)

MAGIC = b"icns"
_PNG, _RGB, _RGB_T, _MASK = "png", "rgb", "rgb after 4 zero bytes", "mask"
# IcnsFile.SIZES: (width, height, scale) -> its entry types and readers,
# in Pillow's order.
SIZES = {
    (512, 512, 2): ((b"ic10", _PNG),),
    (512, 512, 1): ((b"ic09", _PNG),),
    (256, 256, 2): ((b"ic14", _PNG),),
    (256, 256, 1): ((b"ic08", _PNG),),
    (128, 128, 2): ((b"ic13", _PNG),),
    (128, 128, 1): ((b"ic07", _PNG), (b"it32", _RGB_T), (b"t8mk", _MASK)),
    (64, 64, 1): ((b"icp6", _PNG),),
    (32, 32, 2): ((b"ic12", _PNG),),
    (48, 48, 1): ((b"ih32", _RGB), (b"h8mk", _MASK)),
    (32, 32, 1): ((b"icp5", _PNG), (b"il32", _RGB), (b"l8mk", _MASK)),
    (16, 16, 2): ((b"ic11", _PNG),),
    (16, 16, 1): ((b"icp4", _PNG), (b"is32", _RGB), (b"s8mk", _MASK)),
}
_JPEG2000 = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")


@dataclasses.dataclass
class IcnsFile:
    data: bytes
    entries: dict  # type -> (start, length) of its data
    sizes: list  # the sizes with an entry, in SIZES' order
    best: tuple  # (width, height, scale)


def parse(data: bytes) -> IcnsFile:
    """IcnsFile: the directory (a later entry of a type replaces an
    earlier one), then bestsize; NotThisFormat where Pillow's open fails
    and passes the file on."""
    if len(data) < 8 or not data.startswith(MAGIC):
        raise NotThisFormat("not an ICNS file")
    filesize = struct.unpack_from(">I", data, 4)[0]
    entries = {}
    i = 8
    while i < filesize:
        if i + 8 > len(data):
            raise NotThisFormat("an ICNS entry header past the file's end")
        kind, block = struct.unpack_from(">4sI", data, i)
        if block <= 0:
            raise NotThisFormat("an ICNS entry of no size")
        entries[kind] = (i + 8, block - 8)
        i += block
    sizes = [size for size, kinds in SIZES.items() if any(k in entries for k, _ in kinds)]
    if not sizes:
        raise NotThisFormat("an ICNS file without an icon Pillow reads")
    return IcnsFile(data, entries, sizes, max(sizes))


def _size_allowed(f: IcnsFile, size: tuple[int, int]) -> bool:
    """IcnsImageFile's size setter: some listed size is an integer multiple
    of `size` in width with the same factor in height."""
    if size[0] <= 0 or size[1] <= 0:
        return False
    for w, h, scale in f.sizes:
        if (h * scale) / size[1] == (w * scale) // size[0]:
            return True
    return False


def decode(f: IcnsFile, native) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette): a PNG entry's own, or "RGB" / "RGBA"
    (H, W, C) uint8."""
    w, h, scale = f.best
    n = w * scale * h * scale
    found = {}
    for kind, reader in SIZES[f.best]:
        if kind not in f.entries:
            continue
        start, length = f.entries[kind]
        if reader == _PNG:
            sig = f.data[start : start + 12]
            if sig.startswith(png.SIGNATURE):
                entry = png.parse(f.data[start:])
                bomb_check((entry.width, entry.height), "an ICNS entry")
                found["RGBA"] = entry
            elif sig.startswith(_JPEG2000) or sig == b"\0\0\0\x0cjP  \r\n\x87\n":
                raise UnsupportedImageError("JPEG 2000 inside an ICNS file is not supported yet")
            else:
                raise CorruptImageError("an ICNS entry that is neither PNG nor JPEG 2000")
        elif reader == _MASK:
            mask = f.data[start : start + n]
            if len(mask) < n:
                raise TruncatedImageError("an ICNS mask runs past the file's end")
            found["A"] = np.frombuffer(mask, np.uint8)
        else:
            if reader == _RGB_T:
                if f.data[start : start + 4] != b"\0\0\0\0":
                    raise CorruptImageError("an it32 entry without its four zero bytes")
                start, length = start + 4, length - 4
            if length == 3 * n:
                raw = f.data[start : start + length]
                if len(raw) < length:
                    raise TruncatedImageError("an ICNS icon runs past the file's end")
                planes = np.frombuffer(raw, np.uint8).reshape(n, 3).T
            elif native is None:
                raise native_missing("a run-length coded ICNS icon")
            else:
                planes = native.icns_rle(f.data[start:], n)
            found["RGB"] = planes
    if "RGBA" in found:
        entry = found["RGBA"]
        if not _size_allowed(f, (entry.width, entry.height)):
            raise CorruptImageError(f"an ICNS PNG of {entry.width}x{entry.height} in a"
                                    f" {w * scale}x{h * scale} entry")
        return png.decode(entry, native)
    if "RGB" not in found:
        raise CorruptImageError("an ICNS size with a mask and no icon")
    bands = [*found["RGB"], found["A"]] if "A" in found else list(found["RGB"])
    px = np.stack(bands, axis=1).reshape(h * scale, w * scale, len(bands))
    return ("RGBA" if "A" in found else "RGB"), np.ascontiguousarray(px), None
