"""DirectDraw Surfaces (DDS) as Pillow 12.1's DdsImagePlugin opens them:
the magic "DDS ", a header of 124 bytes (any other size, or a file that
ends inside it, fails Pillow's open with OSError), the size at bytes 12
(height) and 16 (width), and the pixel format at 76, whose flags decide:

  * RGB (0x40): "RGB", or "RGBA" with ALPHAPIXELS (0x1), from the 3 or 4
    channel masks at 92; Pillow's DdsRgbDecoder reads bitcount // 8 bytes
    a pixel, little-endian, and scales each masked field, shifted down to
    its mask's lowest bit, as int(v / (mask >> shift) * 255) in float64,
    so truncated (a 5-bit 16 gives 131); where the file ends it reads on as
    zeros;
  * LUMINANCE (0x20000): "L" of 8 bits, or "LA" of 16 with ALPHAPIXELS;
  * PALETTEINDEXED8 (0x20): "P" with the 1,024 bytes that follow the
    header as its RGBA palette;
  * FOURCC (0x4): DXT1, DXT3 and DXT5 ("RGBA", BC1-BC3), BC4U and ATI1
    ("L", BC4), BC5S (signed) and BC5U and ATI2 ("RGB", BC5), or DX10,
    whose 20-byte extension names a DXGI format: BC1-BC5 (unsigned or
    typeless; BC5 also signed), BC6H unsigned and signed ("RGB"), BC7
    ("RGBA", sRGB too) and uncompressed R8G8B8A8 ("RGBA").

Pillow's load_seek is a no-op here, so every tile reads from where the
open left the file: after the header, after the DX10 extension, after a
palette. Block-compressed surfaces go through Pillow's "bcn" decoder
(native/bcndecode.cpp's bcn_decode, without which they raise
NativeDecoderError); the others are numpy. A short DX10 extension fails
Pillow's open with struct.error, so the file passes on to the next
plugin; so does a header of width or height 0. The pixel formats Pillow
does not map it refuses with NotImplementedError, which fails the JAX
package: the port refuses them by name. DDS carries no metadata the
readers use.
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

MAGIC = b"DDS "
_ALPHAPIXELS, _FOURCC, _PALETTEINDEXED8, _RGB, _LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
# FourCC -> (mode, bcn kind, signed).
_FOURCCS = {b"DXT1": ("RGBA", 1, False), b"DXT3": ("RGBA", 2, False),
            b"DXT5": ("RGBA", 3, False), b"BC4U": ("L", 4, False), b"ATI1": ("L", 4, False),
            b"BC5S": ("RGB", 5, True), b"BC5U": ("RGB", 5, False), b"ATI2": ("RGB", 5, False)}
# DXGI format -> (mode, bcn kind (0: raw RGBA), signed).
_DXGI = {70: ("RGBA", 1, False), 71: ("RGBA", 1, False), 73: ("RGBA", 2, False),
         74: ("RGBA", 2, False), 76: ("RGBA", 3, False), 77: ("RGBA", 3, False),
         79: ("L", 4, False), 80: ("L", 4, False), 82: ("RGB", 5, False),
         83: ("RGB", 5, False), 84: ("RGB", 5, True), 95: ("RGB", 6, False),
         96: ("RGB", 6, True), 97: ("RGBA", 7, False), 98: ("RGBA", 7, False),
         99: ("RGBA", 7, False), 27: ("RGBA", 0, False), 28: ("RGBA", 0, False),
         29: ("RGBA", 0, False)}


@dataclasses.dataclass
class DdsFile:
    data: bytes
    size: tuple[int, int]
    mode: str
    offset: int  # where the open left the file: the pixels start here
    kind: int = 0  # the bcn decoder's block kind, 0 for the other layouts
    signed: bool = False
    bitcount: int = 0  # an RGB(A) surface's bits a pixel
    masks: tuple | None = None  # and its channel masks; None: raw pixels or blocks
    palette: np.ndarray | None = None  # (n, 4) RGBA of a "P" surface


def parse(data: bytes) -> DdsFile:
    """The header, or NotThisFormat where Pillow's open passes the file on."""
    if not data.startswith(MAGIC) or len(data) < 8:
        raise NotThisFormat("not a DDS file")
    header_size = struct.unpack_from("<I", data, 4)[0]
    if header_size != 124:
        raise CorruptImageError(f"Unsupported header size {header_size}")
    if len(data) < 128:
        raise CorruptImageError(f"Incomplete header: {len(data) - 8} bytes")
    height, width = struct.unpack_from("<2I", data, 12)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    size = (width, height)
    if pfflags & _RGB:
        count = 4 if pfflags & _ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{count}I", data, 92)
        dds = DdsFile(data, size, "RGBA" if count == 4 else "RGB", 128, bitcount=bitcount,
                      masks=masks)
    elif pfflags & _LUMINANCE:
        if bitcount == 8:
            dds = DdsFile(data, size, "L", 128)
        elif bitcount == 16 and pfflags & _ALPHAPIXELS:
            dds = DdsFile(data, size, "LA", 128)
        else:
            raise CorruptImageError(f"Unsupported bitcount {bitcount} for {pfflags}")
    elif pfflags & _PALETTEINDEXED8:
        pal = data[128:1152]
        palette = np.frombuffer(pal[: len(pal) // 4 * 4], np.uint8).reshape(-1, 4)
        dds = DdsFile(data, size, "P", 128 + len(pal), palette=palette)
    elif pfflags & _FOURCC:
        if fourcc == b"DX10":
            if len(data) < 132:  # struct.error in Pillow's open
                raise NotThisFormat("DDS file ending in its DX10 extension")
            dxgi = struct.unpack_from("<I", data, 128)[0]
            if dxgi not in _DXGI:
                raise UnsupportedImageError(
                    f"DDS of DXGI format {dxgi}: Pillow does not map it (Unimplemented DXGI"
                    " format), so it cannot read the file")
            mode, kind, signed = _DXGI[dxgi]
            offset = min(len(data), 148)
        elif fourcc in _FOURCCS:
            (mode, kind, signed), offset = _FOURCCS[fourcc], 128
        else:
            raise UnsupportedImageError(
                f"DDS of pixel format {fourcc!r}: Pillow does not read it (Unimplemented"
                " pixel format)")
        dds = DdsFile(data, size, mode, offset, kind, signed)
    else:
        raise UnsupportedImageError(
            f"DDS of pixel format flags {pfflags}: Pillow does not read them (Unknown pixel"
            " format flags)")
    if width == 0 or height == 0:
        raise NotThisFormat("DDS of width or height 0")
    bomb_check(size, "DDS image")
    return dds


def _channel(values: np.ndarray, mask: int) -> np.ndarray:
    """DdsRgbDecoder's scaling of one mask's field to 8 bits."""
    if mask == 0:
        return np.zeros(values.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    total = mask >> shift
    field = ((values & mask) >> shift).astype(np.float64)
    return (field / total * 255).astype(np.uint8)


def _masked(d: DdsFile) -> np.ndarray:
    """The RGB(A) plane of a surface given by channel masks."""
    w, h = d.size
    n, step = w * h, d.bitcount // 8
    rest = np.frombuffer(d.data, np.uint8)[d.offset :]
    # Only the low 4 bytes of each value reach a 32-bit mask; a value the
    # file ends inside keeps the bytes it has, the later ones read as 0.
    values = np.zeros(n, np.uint32)
    if step:
        have = min(n, -(-len(rest) // step))
        for k in range(min(step, 4)):
            idx = np.arange(have, dtype=np.int64) * step + k
            inside = idx < len(rest)
            values[:have][inside] |= rest[idx[inside]].astype(np.uint32) << (8 * k)
    planes = [_channel(values, m) for m in d.masks]
    return np.stack(planes, axis=1).reshape(h, w, len(d.masks))


def decode(d: DdsFile, native=None) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette): "RGB" and "RGBA" (H, W, 3|4), "L" (H, W),
    "LA" (H, W, 2), or "P" (H, W) with its (n, 4) RGBA palette."""
    w, h = d.size
    if d.masks is not None:
        return d.mode, _masked(d), None
    if d.kind:
        if native is None:
            raise native_missing("A block-compressed DDS surface")
        return d.mode, native.bcn_decode(d.data[d.offset :], w, h, d.kind, d.signed), None
    bands = {"L": 1, "P": 1, "LA": 2, "RGBA": 4}[d.mode]
    try:
        px = raw.rows(d.data, d.offset, w * bands, h)
    except TruncatedImageError as err:
        raise TruncatedImageError("image file is truncated (the DDS surface is short of its"
                                  " pixels)") from err
    return d.mode, px.reshape((h, w, bands) if bands > 1 else (h, w)), d.palette
