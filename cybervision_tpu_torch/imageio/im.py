"""LabEye IFUNC image memory (IM), PIL's own interchange format, as
Pillow's ImImagePlugin opens it: "key: value" header lines (each at most
100 bytes, one of them a key Pillow knows, "\\r" between them skipped) up
to a NUL or ^Z, then up to the ^Z the data follows; "Image type" maps
through Pillow's OPEN table to a mode and raw mode (a value not in it is
the mode itself, read with raw mode "L"; of those only "L" and "P"
load), "Image size (x*y)" gives the size (512x512 when absent). A "Lut"
key reads a 768-byte table, planar R, G, B: a gray table leaves the image
as it is, any other makes "L" and "P" images "P" (raw mode "P", 8 bits a
pixel whatever the type said) and "LA" and "PA" images "PA". A "P" image
without one has an all-black palette.

Only the first frame is read. Rows are bottom-up, unpadded; the raw modes
are Pillow's unpackers: "1" (MSB first, set bits white), "P;2" and "P;4"
(MSB first), line-interleaved planes ("RGB;L", "RGBA;L", "RGBX;L",
"CMYK;L", "YCbCr;L", "LA;L", "PA;L"), interleaved "RGB", little-endian
16 and 32-bit integers ("I;16", "I;16L", "I;32", "I;32S"), big-endian
"I;16B", the integers "F;8", "F;8S", "F;16", "F;16S" and "F;32" (unsigned)
to float32, and "F;32F". The "L*n" float types of other widths go through Pillow's
bit decoder (imagedecode.cpp's im_bits; without the native library such a
file raises NativeDecoderError), and the old "RGB3"/"RYB3" types are three
planes, green, red and blue. "RLB"/"RYB" and "PA" without a colour "Lut"
have no unpacker in Pillow, so it cannot load them, nor can the port. IM
carries no metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    TruncatedImageError,
    bomb_check,
    native_missing,
)

COMMENT, FRAMES, LUT, MODE = "Comment", "File size (no of images)", "Lut", "Image type"
SCALE, SIZE = "Scale (x,y)", "Image size (x*y)"
TAGS = (COMMENT, "Date", "Digitalization equipment", FRAMES, LUT, "Name", SCALE, SIZE, MODE)

# ImImagePlugin.OPEN: "Image type" value -> (mode, raw mode).
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
    "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ["8", "8S", "16", "16S", "32", "32F"]:
    OPEN[f"L {_i} image"] = ("F", f"F;{_i}")
    OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ["16", "16L", "16B"]:
    OPEN[f"L {_i} image"] = (f"I;{_i}", f"I;{_i}")
    OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

# (mode, raw mode) -> (bits a pixel, numpy sample type or None for the
# packed and planar layouts) of Pillow's unpackers that these modes reach.
_UNPACK = {
    ("1", "1"): (1, None), ("L", "L"): (8, "u1"), ("P", "L"): (8, "u1"), ("P", "P"): (8, "u1"),
    ("P", "P;2"): (2, None), ("P", "P;4"): (4, None), ("RGB", "RGB"): (24, None),
    ("RGB", "RGB;L"): (24, None), ("RGB", "RGBX;L"): (32, None), ("RGBA", "RGBA;L"): (32, None),
    ("CMYK", "CMYK;L"): (32, None), ("YCbCr", "YCbCr;L"): (24, None),
    ("LA", "LA;L"): (16, None), ("PA", "PA;L"): (16, None),
    ("I", "I;32"): (32, "<i4"), ("I", "I;32S"): (32, "<i4"),
    ("I;16", "I;16"): (16, "<u2"), ("I;16L", "I;16L"): (16, "<u2"),
    ("I;16B", "I;16B"): (16, ">u2"),
    ("F", "F;8"): (8, "u1"), ("F", "F;8S"): (8, "i1"), ("F", "F;16"): (16, "<u2"),
    ("F", "F;16S"): (16, "<i2"), ("F", "F;32"): (32, "<u4"), ("F", "F;32F"): (32, "<f4"),
}

_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


def _number(s: str) -> float:
    try:
        return int(s)
    except ValueError:
        return float(s)


@dataclasses.dataclass
class ImFile:
    data: bytes
    size: tuple
    mode: str
    rawmode: str
    offset: int
    palette: np.ndarray | None  # (256, 3) uint8, for "P" and "PA"


def parse(data: bytes) -> ImFile:
    """The header, or the error Pillow's open raises (NotThisFormat where
    it fails and Pillow tries the next plugin)."""
    if b"\n" not in data[:100]:
        raise NotThisFormat("not an IM file")
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode, known, pos = "L", 0, 0
    while True:
        s = data[pos : pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            raise NotThisFormat("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _LINE.match(s)
        if not m:
            raise NotThisFormat("syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            try:
                v = tuple(map(_number, v.replace("*", ",").split(",")))
            except ValueError as err:
                raise CorruptImageError(f"IM header {k}: {v!r} is not a number") from err
            v = v[0] if len(v) == 1 else v
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        info[k] = v
        known += k in TAGS
    if not known:
        raise NotThisFormat("not an IM file")
    size, mode = info[SIZE], info[MODE]
    while s and not s.startswith(b"\x1a"):
        s = data[pos : pos + 1]
        pos += len(s)
    if not s:
        raise NotThisFormat("IM file truncated before its data")
    palette = None
    if LUT in info:
        table = data[pos : pos + 768]
        pos += len(table)
        # Pillow's test, index by index (a short table fails it as an
        # IndexError, where its open passes the file on); whether a gray
        # table is linear only sets a lut Pillow never applies.
        gray = True
        for i in range(256):
            try:
                gray &= table[i] == table[i + 256] and table[i + 256] == table[i + 512]
            except IndexError as err:
                raise NotThisFormat("IM Lut cut short") from err
        if mode in ("L", "LA", "P", "PA") and not gray:
            mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            n = len(table) // 3
            palette = np.zeros((256, 3), np.uint8)
            palette[:n] = np.frombuffer(table, np.uint8, 3 * n).reshape(3, n).T
    if mode in ("P", "PA") and palette is None:
        palette = np.zeros((256, 3), np.uint8)
    if not mode or not isinstance(size, tuple) or size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("IM image without a mode or pixels")
    bomb_check(size[:2], "IM image")
    return ImFile(data, size, mode, rawmode, pos, palette)


def decode(f: ImFile, native) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette) as imageio.ImageFile.decode gives them."""
    if len(f.size) != 2 or not all(isinstance(v, int) for v in f.size):
        raise CorruptImageError(f"IM image size {f.size}, which Pillow cannot load")
    w, h = f.size
    src = f.data[f.offset :]
    if f.rawmode.startswith("F;") and f.rawmode[2:].isdigit() \
            and int(f.rawmode[2:]) not in (8, 16, 32):
        if f.mode != "F":
            raise CorruptImageError(f"IM mode {f.mode} from the bit decoder")
        if native is None:
            raise native_missing(f"IM {f.rawmode[2:]}-bit float samples")
        return "F", native.im_bits(src, int(f.rawmode[2:]), w, h), None
    if f.rawmode in ("RGB;T", "RYB;T"):
        if len(src) < 3 * w * h:
            raise TruncatedImageError("the IM file ends before its planes")
        g, r, b = np.frombuffer(src, np.uint8, 3 * w * h).reshape(3, h, w)[:, ::-1]
        return "RGB", np.ascontiguousarray(np.stack([r, g, b], axis=2)), None
    if (f.mode, f.rawmode) not in _UNPACK:
        raise CorruptImageError(f"IM mode {f.mode} with raw mode {f.rawmode}, which Pillow"
                                " cannot load")
    bits, dtype = _UNPACK[(f.mode, f.rawmode)]
    row_bytes = (w * bits + 7) // 8
    if len(src) < row_bytes * h:
        raise TruncatedImageError("the IM file ends before its pixels")
    rows = np.frombuffer(src, np.uint8, row_bytes * h).reshape(h, row_bytes)[::-1]
    if dtype is not None:
        px = rows.view(dtype).reshape(h, w)
        if f.mode == "F":
            px = px.astype(np.float32)
        elif f.mode != "I":
            px = px.astype(np.uint16 if f.mode.startswith("I;16") else np.uint8)
        return f.mode, np.ascontiguousarray(px), f.palette
    if bits < 8:
        per = 8 // bits
        fields = np.stack([(rows >> (8 - bits * (k + 1))) & ((1 << bits) - 1)
                           for k in range(per)], axis=2).reshape(h, -1)[:, :w]
        if f.mode == "1":
            return "1", np.ascontiguousarray(fields * np.uint8(255)), None
        return "P", np.ascontiguousarray(fields), f.palette
    if f.rawmode == "RGB":
        return "RGB", np.ascontiguousarray(rows.reshape(h, w, 3)), None
    # Line-interleaved: each row holds its planes one after another.
    px = rows.reshape(h, bits // 8, w).transpose(0, 2, 1)
    if f.rawmode == "RGBX;L":
        px = px[:, :, :3]
    return f.mode, np.ascontiguousarray(px), f.palette
