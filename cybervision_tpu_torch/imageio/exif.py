"""TIFF-structured tag directories: a TIFF file's IFD0 (classic or
BigTIFF) and an EXIF block.

Values come back as the JAX package reads them through Pillow's
ImageFileDirectory_v2: BYTE and UNDEFINED as bytes, ASCII as a latin-1
str without its trailing NUL, the integer and float types as numbers,
RATIONAL as a Fraction (nan for a zero denominator); one value alone, or
a tuple when the tag holds several. A directory whose entry or
out-of-line value runs past the data keeps the entries read before it.
"""

from __future__ import annotations

import struct
from fractions import Fraction

EXIF_IFD = 0x8769
FOCAL_LENGTH_35MM = 41989

# type -> (bytes per value, struct code; None: a byte string)
TYPES = {
    1: (1, None),   # BYTE
    2: (1, None),   # ASCII
    3: (2, "H"),    # SHORT
    4: (4, "L"),    # LONG
    5: (8, "L"),    # RATIONAL: two LONGs
    6: (1, "b"),    # SBYTE
    7: (1, None),   # UNDEFINED
    8: (2, "h"),    # SSHORT
    9: (4, "l"),    # SLONG
    10: (8, "l"),   # SRATIONAL
    11: (4, "f"),   # FLOAT
    12: (8, "d"),   # DOUBLE
    13: (4, "L"),   # IFD
    16: (8, "Q"),   # LONG8
    17: (8, "q"),   # SLONG8
    18: (8, "Q"),   # IFD8
}

# Tags whose value is a single number by the TIFF specification even when
# the file stores several (Pillow keeps the first); every other tag read
# here has no declared count.
_SINGLE = {EXIF_IFD}


def tiff_header(data: bytes) -> tuple[str, int]:
    """(struct byte order, IFD0 offset) of a classic TIFF header; raises
    ValueError on anything else (BigTIFF included)."""
    head = data[:8]
    if len(head) < 8:
        raise ValueError("not a TIFF header: too short")
    if head[:4] == b"II*\x00":
        return "<", struct.unpack("<L", head[4:])[0]
    if head[:4] == b"MM\x00*":
        return ">", struct.unpack(">L", head[4:])[0]
    raise ValueError("not a TIFF header")


def tiff_file_header(data: bytes) -> tuple[str, int, bool]:
    """(struct byte order, IFD0 offset, BigTIFF) of a TIFF file's header:
    classic (version 42) or BigTIFF (43, 8-byte offsets)."""
    if data[:4] in (b"II+\x00", b"MM\x00+"):
        endian = "<" if data[:2] == b"II" else ">"
        if len(data) < 16:
            raise ValueError("not a BigTIFF header: too short")
        size, zero, ifd0 = struct.unpack_from(endian + "HHQ", data, 4)
        if size != 8 or zero != 0:
            raise ValueError("BigTIFF header with an offset size other than 8")
        return endian, ifd0, True
    return (*tiff_header(data), False)


def read_ifd(data: bytes, offset: int, endian: str, big: bool = False,
             every_entry: bool = False) -> dict[int, tuple[int, bytes]]:
    """tag -> (type, raw value bytes) of the directory at `offset` (BigTIFF:
    an 8-byte entry count, 20-byte entries, values inline up to 8 bytes).
    Unknown types and empty values are skipped; a short read ends the
    walk, as in Pillow's parser. With `every_entry`, as libtiff reads a
    directory: a value past the file skips only its entry, and the first
    of two entries of a tag wins."""
    entries: dict[int, tuple[int, bytes]] = {}
    count_fmt, entry_fmt, inline_size = ("Q", "HHQ8s", 8) if big else ("H", "HHL4s", 4)
    entry_size = struct.calcsize(endian + entry_fmt)
    if offset < 0 or offset + struct.calcsize(count_fmt) > len(data):
        return entries
    (count,) = struct.unpack_from(endian + count_fmt, data, offset)
    pos = offset + struct.calcsize(count_fmt)
    for _ in range(count):
        if pos + entry_size > len(data):
            break
        tag, typ, n, inline = struct.unpack_from(endian + entry_fmt, data, pos)
        pos += entry_size
        if typ not in TYPES:
            continue
        size = n * TYPES[typ][0]
        if size > inline_size:
            (at,) = struct.unpack(endian + ("Q" if big else "L"), inline)
            raw = data[at : at + size]
            if len(raw) != size:
                if every_entry:
                    continue
                break
        else:
            raw = inline[:size]
        if not raw or (every_entry and tag in entries):
            continue
        entries[tag] = (typ, raw)
    return entries


def _rational(num: int, den: int):
    return float("nan") if den == 0 else Fraction(num, den)


def tag_value(entries: dict[int, tuple[int, bytes]], tag: int, endian: str):
    """The tag's value as Pillow's tag_v2 gives it (see the module
    docstring), or None when the directory lacks it."""
    if tag not in entries:
        return None
    typ, raw = entries[tag]
    size, code = TYPES[typ]
    if typ == 2:
        return (raw[:-1] if raw.endswith(b"\x00") else raw).decode("latin-1", "replace")
    if code is None:
        return raw
    flat = struct.unpack(f"{endian}{len(raw) // struct.calcsize(endian + code)}{code}", raw)
    values = (
        tuple(_rational(a, b) for a, b in zip(flat[::2], flat[1::2]))
        if typ in (5, 10) else flat
    )
    if len(values) == 1 or tag in _SINGLE:
        return values[0]
    return values


def focal_length_35mm(data: bytes, endian: str, ifd0: int, big: bool = False) -> int | None:
    """FocalLengthIn35mmFilm from IFD0, else from the Exif sub-IFD
    (cybervision_tpu/images.py:98-106's getexif().get, then
    get_ifd(0x8769).get), through int() as the JAX package takes it.
    Raises on a value int() refuses; None when neither directory has it.
    In a BigTIFF both directories are BigTIFF's, as Pillow reads them."""
    entries = read_ifd(data, ifd0, endian, big)
    focal = tag_value(entries, FOCAL_LENGTH_35MM, endian)
    if focal is None:
        sub = tag_value(entries, EXIF_IFD, endian)
        if isinstance(sub, int):
            focal = tag_value(read_ifd(data, sub, endian, big), FOCAL_LENGTH_35MM, endian)
    return None if focal is None else int(focal)


def exif_block_focal_length(block: bytes) -> int | None:
    """focal_length_35mm of an EXIF block as JPEG APP1 and PNG eXIf carry
    it: a TIFF header and its directories, after any "Exif\\0\\0"
    prefixes."""
    while block.startswith(b"Exif\x00\x00"):
        block = block[6:]
    if not block:
        return None
    endian, ifd0 = tiff_header(block)
    return focal_length_35mm(block, endian, ifd0)
