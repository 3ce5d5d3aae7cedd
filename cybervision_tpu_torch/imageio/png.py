"""PNG container: signature, chunks (IHDR, PLTE, IDAT, eXIf, the text
chunks tEXt, zTXt and iTXt, IEND), the zlib stream through the standard
library, rows unfiltered by the native library or by numpy.

Follows Pillow's reader where the JAX package depends on it: chunks before
the first IDAT must carry a good CRC; the image data is the run of
consecutive IDAT chunks; chunks after it are read without a CRC check up
to IEND or the first broken chunk; tRNS is ignored (Pillow's conversions
to "L" and "RGB" do not use it); the EXIF block is an eXIf chunk's
payload or, as Pillow's getexif() falls back to it, the hex profile of a
"Raw profile type exif" text chunk (ImageMagick's way to carry a photo's
EXIF): the chunks after the image data count only when the rows decode,
since Pillow reads them there. Text chunks are read as
PngImagePlugin.PngStream reads them (latin-1 tEXt, zTXt and compressed
iTXt inflated up to MAX_TEXT_CHUNK, the MAX_TEXT_MEMORY total, the last
chunk of a keyword winning), with the errors that make Pillow's open or
load fail. Modes, as PngImagePlugin._MODES opens them: "1"
for 1-bit gray, "L" for 2/4/8-bit gray (2 and 4 bits scaled up), "LA",
"RGB", "RGBA", "P" at 1, 2, 4 and 8 bits, "I;16" for 16-bit gray, and
the high bytes of 16-bit LA, RGB and RGBA (as Pillow unpacks them).
Adam7-interlaced files are read pass by pass.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    TruncatedImageError,
)

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# PngImagePlugin's limits on text chunks: one inflated chunk (ImageFile's
# SAFEBLOCK) and all text together.
MAX_TEXT_CHUNK = 1024 * 1024
MAX_TEXT_MEMORY = 64 * MAX_TEXT_CHUNK
# The info keys getexif() reads: an EXIF block, and the hex profile it
# falls back to.
EXIF_KEYS = ("exif", "Raw profile type exif")

# colour type -> (samples per pixel, mode at 8 bits)
_COLOR_TYPES = {0: (1, "L"), 2: (3, "RGB"), 3: (1, "P"), 4: (2, "LA"), 6: (4, "RGBA")}


@dataclasses.dataclass
class PngFile:
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int
    palette: bytes | None
    idat: bytes
    # Pillow's info["exif"] and info["Raw profile type exif"] as the chunks
    # before the image data leave them, and what the chunks after it set:
    # the JAX package's Pillow reads those only when every row decodes.
    info: dict
    late_info: dict
    # A chunk after the image data that runs past the file's end: Pillow
    # raises once the rows are decoded.
    tail_error: str | None

    @property
    def mode(self) -> str:
        if self.bit_depth == 16 and self.color_type == 0:
            return "I;16"
        return _COLOR_TYPES[self.color_type][1]


def parse(data: bytes) -> PngFile:
    """The container of a PNG file, without inflating its image data."""
    if not data.startswith(SIGNATURE):
        raise CorruptImageError("not a PNG file")
    pos = len(SIGNATURE)
    head = None
    palette = tail_error = None
    info: dict = {}
    late_info: dict = {}
    text_memory = 0
    idat: list[bytes] = []
    seen_idat = in_idat = False
    while True:
        if pos + 8 > len(data):
            if seen_idat:
                break
            raise TruncatedImageError("PNG ends before its image data")
        length, cid = struct.unpack_from(">I4s", data, pos)
        if not cid.isalpha():
            if seen_idat:
                break
            raise CorruptImageError(f"broken PNG chunk {cid!r}")
        if cid == b"IEND" and seen_idat:
            break  # Pillow stops there, without reading its body
        body = data[pos + 8 : pos + 8 + length]
        if len(body) < length:
            if seen_idat and not in_idat:
                tail_error = f"PNG chunk {cid!r} after the image data is truncated"
                break
            raise TruncatedImageError(f"PNG chunk {cid!r} is truncated")
        if not seen_idat and cid != b"IDAT":
            crc = data[pos + 8 + length : pos + 12 + length]
            if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(cid + body):
                raise CorruptImageError(f"bad CRC in PNG chunk {cid!r}")
        pos += 12 + length
        if cid == b"IEND":
            break
        if cid == b"IDAT":
            if in_idat or not seen_idat:
                idat.append(body)
                seen_idat = in_idat = True
            continue  # a later run of IDATs is no image data
        in_idat = False
        if cid == b"IHDR":
            if length < 13:
                raise CorruptImageError("truncated IHDR chunk")
            head = struct.unpack(">IIBBBBB", body[:13])
        elif cid == b"PLTE":
            palette = body
        elif cid == b"eXIf":
            (late_info if seen_idat else info)["exif"] = b"Exif\x00\x00" + body
        elif cid in (b"tEXt", b"zTXt", b"iTXt"):
            try:
                key, value, size = _text(cid, body)
                if key in EXIF_KEYS:
                    (late_info if seen_idat else info)[key] = value
                text_memory += size
                if text_memory > MAX_TEXT_MEMORY:
                    raise ValueError(f"too much memory used in PNG text chunks: {text_memory}")
            except ValueError as err:
                if not seen_idat:
                    raise CorruptImageError(str(err)) from err
                tail_error = str(err)  # Pillow's load raises once the rows are decoded
                break
    if head is None or not idat:
        raise CorruptImageError("PNG without IHDR or image data")
    width, height, depth, color_type, _, filter_method, interlace = head
    if filter_method:
        raise CorruptImageError("unknown PNG filter category")
    return PngFile(width, height, depth, color_type, interlace, palette,
                   b"".join(idat), info, late_info, tail_error)


def _inflate_text(data: bytes) -> bytes:
    """PngImagePlugin._safe_zlib_decompress: ValueError past
    MAX_TEXT_CHUNK, zlib.error on a broken stream."""
    inflate = zlib.decompressobj()
    plain = inflate.decompress(data, MAX_TEXT_CHUNK)
    if inflate.unconsumed_tail:
        raise ValueError("a PNG text chunk inflates past MAX_TEXT_CHUNK")
    return plain


def _text(cid: bytes, body: bytes) -> tuple[str | None, object, int]:
    """(keyword, the value Pillow puts in info, its length in the text
    memory) of a tEXt, zTXt or iTXt chunk, keyword None where Pillow sets
    nothing; ValueError where Pillow's chunk handler raises."""
    key, sep, value = body.partition(b"\0")
    if cid == b"tEXt":
        if not key:
            return None, None, 0
        text = value.decode("latin-1", "replace")
        return key.decode("latin-1"), value if key == b"exif" else text, len(text)
    if cid == b"zTXt":
        if value and value[0] != 0:
            raise ValueError(f"unknown compression method {value[0]} in a PNG zTXt chunk")
        try:
            value = _inflate_text(value[1:])
        except zlib.error:
            value = b""
        if not key:
            return None, None, 0
        text = value.decode("latin-1", "replace")
        return key.decode("latin-1"), text, len(text)
    # iTXt: keyword, compression flag and method, language, translated
    # keyword, text.
    if not sep or len(value) < 2:
        return None, None, 0
    flag, method, rest = value[0], value[1], value[2:]
    parts = rest.split(b"\0", 2)
    if len(parts) < 3:
        return None, None, 0
    lang, translated, value = parts
    if flag:
        if method:
            return None, None, 0
        try:
            value = _inflate_text(value)
        except zlib.error:
            return None, None, 0
    try:
        lang.decode("utf-8"), translated.decode("utf-8")
        text = value.decode("utf-8")
    except UnicodeError:
        return None, None, 0
    return key.decode("latin-1"), text, len(text)


def exif_block(png: PngFile, decode) -> bytes | str | None:
    """The EXIF data Pillow's getexif() loads for the file: info["exif"],
    else the "Raw profile type exif" text's hex profile (lines from the
    fourth on), else None. Without an EXIF block before the image data
    getexif() first decodes every row (`decode`, which raises where they
    fail), reading the chunks after them; decode is called only where
    that can change the answer. bytes.fromhex raises on a bad profile,
    as in getexif()."""
    info = png.info
    if "exif" not in info:
        if not info and not png.late_info:
            return None
        decode()
        info = {**info, **png.late_info}
    block = info.get("exif")
    if block is None and "Raw profile type exif" in info:
        block = bytes.fromhex("".join(info["Raw profile type exif"].split("\n")[3:]))
    return block


def _unfilter_numpy(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of (filter byte + row bytes) -> row bytes without the native
    library: None, Sub and Up in numpy, Average and Paeth a loop over the
    bytes of a row."""
    h, n = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, n), np.uint8)
    prev = np.zeros(n, np.int32)
    for y in range(h):
        ftype = int(raw[y, 0])
        src = raw[y, 1:].astype(np.int32)
        if ftype == 0:
            row = src
        elif ftype == 2:
            row = (src + prev) & 0xFF
        elif ftype == 1:
            row = src.copy()
            for k in range(bpp):
                row[k::bpp] = np.cumsum(src[k::bpp]) & 0xFF
        elif ftype in (3, 4):
            cur, up = src.tolist(), prev.tolist()
            for x in range(n):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    cur[x] = (cur[x] + (a if pa <= pb and pa <= pc else (b if pb <= pc else c))) & 0xFF
            row = np.array(cur, np.int32)
        else:
            raise CorruptImageError(f"PNG filter type {ftype}")
        out[y] = row
        prev = row
    return out


# Adam7's passes: (first column, first row, column step, row step).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
# Bit depths each colour type allows.
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _unpack(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """(h, row_bytes) unfiltered bytes -> (h, width, channels) samples:
    uint8, or uint16 at 16 bits; 1/2/4-bit samples MSB first."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, -1)[:, : width * channels].reshape(
            h, width, channels).astype(np.uint16)
    if depth == 8:
        return rows[:, : width * channels].reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, : width * depth].reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :, None]


def decode(png: PngFile, native) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette) of the image: pixels (H, W) or (H, W, C)
    uint8, or (H, W) uint16 for "I;16"; palette (256, 3) uint8 for "P".
    1-bit gray is mode "1" stored as 0 and 255, 2- and 4-bit gray "L"
    scaled to 8 bits (Pillow's "L;2" and "L;4" raw modes), 1/2/4-bit
    palette indices "P". Adam7 files decode each pass's reduced image,
    filtered on its own, into its pixels of the plane. `native` is the
    loaded native library, or None for the numpy path."""
    if png.color_type not in _COLOR_TYPES:
        raise CorruptImageError(f"PNG colour type {png.color_type}")
    depth = png.bit_depth
    if depth not in _DEPTHS[png.color_type]:
        raise CorruptImageError(f"PNG bit depth {depth} with colour type {png.color_type}")
    channels = _COLOR_TYPES[png.color_type][0]
    bpp = max(1, channels * depth // 8)
    h, w = png.height, png.width
    passes = []
    for x0, y0, dx, dy in (_ADAM7 if png.interlace else ((0, 0, 1, 1),)):
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw > 0 and ph > 0:  # an empty pass has no filter bytes
            passes.append((x0, y0, dx, dy, pw, ph, (pw * channels * depth + 7) // 8))
    need = sum(ph * (rb + 1) for *_, ph, rb in passes)
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(png.idat, need)
    except zlib.error as err:
        raise CorruptImageError(f"PNG image data: {err}") from err
    if len(raw) < need:
        raise TruncatedImageError("PNG image data is truncated")
    raw = np.frombuffer(raw, np.uint8)
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy, pw, ph, rb in passes:
        rows = raw[at : at + ph * (rb + 1)].reshape(ph, rb + 1)
        at += ph * (rb + 1)
        if native is not None:
            plain = np.empty((ph, rb), np.uint8)
            if native.png_unfilter(rows, ph, rb, bpp, plain) < 0:
                raise CorruptImageError("PNG filter type above 4")
        else:
            plain = _unfilter_numpy(rows, bpp)
        out[y0::dy, x0::dx] = _unpack(plain, pw, channels, depth)
    if png.tail_error:
        raise TruncatedImageError(png.tail_error)
    mode = png.mode
    if depth == 16 and png.color_type != 0:
        out = (out >> 8).astype(np.uint8)  # the high bytes
    elif depth < 8 and png.color_type == 0:
        mode = "1" if depth == 1 else "L"
        out *= 255 // ((1 << depth) - 1)
    palette = None
    if png.color_type == 3:
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(png.palette or b"", np.uint8)
        entries = entries[: len(entries) // 3 * 3].reshape(-1, 3)[:256]
        palette[: len(entries)] = entries
    if channels == 1:
        out = out[:, :, 0]
    return mode, np.ascontiguousarray(out), palette
