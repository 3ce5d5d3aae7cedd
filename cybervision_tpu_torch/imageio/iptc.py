"""IPTC/NAA files as Pillow's IptcImagePlugin opens them: fields of a
0x1C byte, a record and dataset number (record 1-9 or 240) and a size
(16 bits, or a byte above 128 giving how many bytes of size follow; 128
is 0, above 132 fails outright), read up to the first image data field
(8, 10) or the end. Dataset (3, 60) gives the layers and whether they
are components: one layer without is "L"; 3 or 4 with are "RGB" or
"CMYK", one band of which, (3, 65) less 1 (default 0), holds the image;
(3, 20) and (3, 30) the size; (3, 120) the compression, 1 raw or 5
JPEG. A missing or repeated (3, 60) or size field, or a layout without a
mode, fails Pillow's open (the file passes on to the next plugin); an
unknown compression fails it outright.

The pixels are the data of every (8, 10) field from the first on,
opened as an image of its own as Pillow opens it: raw data behind a
"P5" header of the size (a PGM), or a JPEG; a band's image merged with
black ones. Pillow keeps that image's size, whatever the fields said,
and its pixels under the IPTC mode: an inner image that is not "L" is
refused. IPTC carries no metadata the readers use.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    UnsupportedImageError,
    bomb_check,
)

_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)
_COMPRESSION = {1: "raw", 5: "jpeg"}
_BANDS = {"RGB": 3, "CMYK": 4}


@dataclasses.dataclass
class IptcFile:
    data: bytes
    size: tuple[int, int]
    mode: str
    band: int | None
    compression: str
    offset: int | None  # of the first (8, 10) field; None: no image data


def _int(c: bytes) -> int:
    """IptcImagePlugin._i: the last four bytes, big-endian (a TypeError
    for None or a list, which fails Pillow's open)."""
    if not isinstance(c, bytes):
        raise NotThisFormat("IPTC field without one value")
    return int.from_bytes((b"\0\0\0\0" + c)[-4:], "big")


def _field(data: bytes, pos: int) -> tuple[tuple[int, int] | None, int, int]:
    """(tag, size, position after the field's header); NotThisFormat
    where Pillow's field() raises SyntaxError, IndexError or
    struct.error, CorruptImageError where it raises OSError."""
    s = data[pos : pos + 5]
    pos += len(s)
    if not s.strip(b"\x00"):
        return None, 0, pos
    if len(s) < 4:
        raise NotThisFormat("IPTC field cut short")
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _RECORDS:
        raise NotThisFormat("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise CorruptImageError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        c = data[pos : pos + size - 128]
        pos += len(c)
        size = _int(c)
    elif len(s) < 5:
        raise NotThisFormat("IPTC field cut short")
    else:
        size = int.from_bytes(s[3:5], "big")
    return tag, size, pos


def parse(data: bytes) -> IptcFile:
    """The fields up to the image data, or the error Pillow's open
    raises (NotThisFormat where it passes the file on)."""
    info: dict = {}
    pos = 0
    while True:
        offset = pos
        tag, size, pos = _field(data, pos)
        if not tag or tag == (8, 10):
            break
        value = None
        if size:
            value = data[pos : pos + size]
            pos += len(value)
        if tag in info:
            info[tag] = (info[tag] + [value]) if isinstance(info[tag], list) else [info[tag], value]
        else:
            info[tag] = value
    if (3, 60) not in info:
        raise NotThisFormat("IPTC file without its layers")
    layout = info[(3, 60)]
    try:
        layers, component = layout[0], layout[1]
    except (IndexError, TypeError) as err:
        raise NotThisFormat("IPTC layers field cut short") from err
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = 0
        if (3, 65) in info:
            first = info[(3, 65)]
            first = first[0] if isinstance(first, (bytes, list)) and len(first) else None
            if not isinstance(first, int):
                raise NotThisFormat("IPTC band field without one value")
            band = first - 1
    for key in ((3, 20), (3, 30)):
        if key not in info:
            raise NotThisFormat("IPTC file without its size")
    size = _int(info[(3, 20)]), _int(info[(3, 30)])
    if (3, 120) not in info:
        raise CorruptImageError("Unknown IPTC image compression")
    compression = _COMPRESSION.get(_int(info[(3, 120)]))
    if compression is None:
        raise CorruptImageError("Unknown IPTC image compression")
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("IPTC layout without a mode")
    bomb_check(size, "IPTC image")
    return IptcFile(data, size, mode, band, compression, offset if tag == (8, 10) else None)


def decode(f: IptcFile, native) -> tuple[str, np.ndarray, None]:
    """(mode, pixels, None) as imageio.ImageFile.decode gives them."""
    from cybervision_tpu_torch.imageio import ImageFile, identify, to_l

    if f.offset is None:
        raise CorruptImageError("IPTC file without image data: Pillow cannot load it")
    chunks = [b"P5\n%d %d\n255\n" % f.size] if f.compression == "raw" else []
    pos = f.offset
    while True:
        tag, size, pos = _field(f.data, pos)
        if tag != (8, 10):
            break
        chunks.append(f.data[pos : pos + size])
        pos += len(chunks[-1])
    inner = ImageFile(*identify(b"".join(chunks)))
    mode, px, palette = inner.decode()
    if mode != "L":
        # Pillow keeps the inner image's pixels under the outer mode (a
        # "mode mismatch" when it merges a band), which no conversion
        # reads as that mode.
        raise UnsupportedImageError(f"IPTC {f.mode} image whose data is a {mode} image is not"
                                    " supported")
    px = to_l(mode, px, palette)  # at the inner image's size, which Pillow keeps
    if f.band is None:
        return "L", px, None
    n = _BANDS[f.mode]
    if not -n <= f.band < n:
        raise CorruptImageError(f"IPTC band {f.band + 1} of a {n}-band image")
    out = np.zeros(px.shape + (n,), np.uint8)
    out[:, :, f.band] = px
    return f.mode, out, None
