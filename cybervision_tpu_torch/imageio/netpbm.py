"""Netpbm files as Pillow's PpmImagePlugin opens them: P1-P6, Pf and the
plugin's own P0CMYK, PyP, PyRGBA and PyCMYK.

The header is tokenised as the plugin does: a magic of up to six bytes
ending at whitespace, then tokens of at most ten bytes, a "#" dropping
the rest of its line even inside a token, every token read with int()
(or float() for Pf's scale). Modes: P1 and P4 "1"; P2 and P5 "L", or "I"
past a maxval of 255; P3 and P6 "RGB"; Pf "F", little-endian for a
negative scale, rows bottom-up. Samples at a maxval other than 255 are
rescaled to 255 ("I": 65535) with round(v / maxval * max), clipped, as
the plugin's "ppm" decoder does; a binary gray file at maxval 65535 is
read as 16-bit samples without rescaling. Plain files (P1-P3) follow
the plugin's "ppm_plain" decoder block by block (comments, tokens split
across its 1 MiB blocks, the checks on every token). Pillow opens
neither PF (colour PFM) nor P7 (PAM); nor does the port. Netpbm carries
no metadata the readers use.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    TruncatedImageError,
    bomb_check,
)

_WHITESPACE = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
          b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"L": 1, "I": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
_BLOCK = 1024 * 1024  # ImageFile.SAFEBLOCK: the plain decoder's reads
_MAX_TOKEN = 10


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[:1] == b"P" and prefix[1] in b"0123456fy"


@dataclasses.dataclass
class NetpbmFile:
    data: bytes
    magic: bytes
    mode: str
    size: tuple[int, int]
    maxval: int  # 0 for "1" and "F"
    little: bool  # Pf's byte order
    offset: int  # of the pixel data


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += len(out)
        return out


def _token(fp: _Reader) -> bytes:
    """PpmImageFile._read_token."""
    token = b""
    while len(token) <= _MAX_TOKEN:
        c = fp.read(1)
        if not c:
            break
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while fp.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise TruncatedImageError("Netpbm header ends before its fields")
    if len(token) > _MAX_TOKEN:
        raise CorruptImageError(f"Netpbm header token too long: {token!r}")
    return token


def _number(token: bytes, kind=int):
    try:
        return kind(token)
    except ValueError as err:
        raise CorruptImageError(f"Netpbm header field {token!r} is not a number") from err


def parse(data: bytes) -> NetpbmFile:
    """The header, or the error Pillow's open raises (NotThisFormat where
    it tries the next plugin)."""
    fp = _Reader(data)
    magic = b""
    for _ in range(6):
        c = fp.read(1)
        if not c or c in _WHITESPACE:
            break
        magic += c
    if magic not in _MODES:
        raise NotThisFormat(f"not a Netpbm magic: {magic!r}")
    mode = _MODES[magic]
    size = (_number(_token(fp)), _number(_token(fp)))
    maxval, little = 0, False
    if mode == "F":
        scale = _number(_token(fp), float)
        if scale == 0.0 or not math.isfinite(scale):
            raise CorruptImageError("PFM scale must be finite and non-zero")
        little = scale < 0
    elif mode != "1":
        maxval = _number(_token(fp))
        if not 0 < maxval < 65536:
            raise CorruptImageError(f"Netpbm maxval {maxval} is not in 1-65535")
        if maxval > 255 and mode == "L":
            mode = "I"
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("Netpbm image without pixels")
    bomb_check(size, "Netpbm image")
    return NetpbmFile(data, magic, mode, size, maxval, little, fp.pos)


class _Blocks:
    """The plain decoder's reads of the data after the header."""

    def __init__(self, data: bytes):
        self.fp = _Reader(data)
        self.comment_spans = False

    def read(self) -> bytes:
        return self.fp.read(_BLOCK)

    def drop_comments(self, block: bytes) -> bytes:
        """PpmPlainDecoder._ignore_comments."""
        if self.comment_spans:
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1 :]
                    break
                block = self.read()
        self.comment_spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1 :]
            else:
                block = block[:start]
                self.comment_spans = True
                break
        return block


def _comment_end(block: bytes, start: int = 0) -> int:
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


def _plain_bits(data: bytes, total: int) -> np.ndarray:
    """PpmPlainDecoder._decode_bitonal: every byte that is not whitespace
    is one pixel, "1" black; each block's bytes must all be 0 or 1."""
    blocks, out = _Blocks(data), b""
    while len(out) != total:
        block = blocks.read()
        if not block:
            break
        tokens = b"".join(blocks.drop_comments(block).split())
        if tokens.strip(b"01"):
            raise CorruptImageError("a plain PBM token that is not 0 or 1")
        out = (out + tokens)[:total]
    if len(out) < total:
        raise TruncatedImageError("the plain PBM ends before its pixels")
    return np.where(np.frombuffer(out, np.uint8) == ord("0"), 255, 0).astype(np.uint8)


def _plain_values(data: bytes, total: int, maxval: int) -> np.ndarray:
    """PpmPlainDecoder._decode_blocks: decimal samples, each at most ten
    bytes, 0 to maxval; (total,) int64 of the samples read."""
    blocks, values, half = _Blocks(data), [], b""
    while len(values) != total:
        block = blocks.read()
        if not block:
            if not half:
                break
            block = b" "
        block = blocks.drop_comments(block)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > _MAX_TOKEN:
                raise CorruptImageError(f"plain Netpbm token too long: {half[:11]!r}")
        take = tokens[: total - len(values)]
        if any(len(t) > _MAX_TOKEN for t in take):
            raise CorruptImageError("plain Netpbm token too long")
        try:
            values += map(int, take)
        except ValueError as err:
            raise CorruptImageError(f"plain Netpbm sample: {err}") from err
    if len(values) < total:
        raise TruncatedImageError("the plain Netpbm file ends before its samples")
    v = np.array(values, np.int64)
    if len(v) and (v.min() < 0 or v.max() > maxval):
        raise CorruptImageError(f"a plain Netpbm sample outside 0-{maxval}")
    return v


def _rescale(v: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """round(v / maxval * out_max), clipped to out_max (half to even, in
    float64, as Python's round)."""
    return np.minimum(np.rint(v / maxval * out_max), out_max)


def decode(f: NetpbmFile, native=None) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette) as imageio.ImageFile.decode gives them: "1"
    as 0 / 255 and "L" as (H, W) uint8, "I" (H, W) int32, "F" (H, W)
    float32, "RGB", "RGBA" and "CMYK" (H, W, C) uint8, "P" with Pillow's
    palette of a "P" image that has none (all black)."""
    w, h = f.size
    raw = f.data[f.offset :]
    mode = f.mode
    palette = np.zeros((256, 3), np.uint8) if mode == "P" else None
    if mode == "1":
        if f.magic == b"P1":
            px = _plain_bits(raw, w * h)
        else:
            stride = (w + 7) // 8
            if len(raw) < stride * h:
                raise TruncatedImageError("the PBM ends before its pixels")
            rows = np.frombuffer(raw, np.uint8, stride * h).reshape(h, stride)
            px = np.where(np.unpackbits(rows, axis=1)[:, :w], 0, 255).astype(np.uint8)
        return mode, px.reshape(h, w), None
    if mode == "F":
        if len(raw) < 4 * w * h:
            raise TruncatedImageError("the PFM ends before its pixels")
        px = np.frombuffer(raw, "<f4" if f.little else ">f4", w * h).reshape(h, w)
        return mode, np.ascontiguousarray(px[::-1]).astype(np.float32), None
    bands = _BANDS[mode]
    total = w * h * bands
    out_max = 65535 if mode == "I" else 255
    if f.magic in (b"P2", b"P3"):
        v = _rescale(_plain_values(raw, total, f.maxval), f.maxval, out_max)
    elif f.maxval == 255 or (f.maxval == 65535 and mode == "I"):
        nbytes = 1 if f.maxval == 255 else 2
        if len(raw) < nbytes * total:
            raise TruncatedImageError("the Netpbm file ends before its pixels")
        v = np.frombuffer(raw, np.uint8 if nbytes == 1 else ">u2", total)
    else:
        nbytes = 1 if f.maxval < 256 else 2
        if len(raw) < nbytes * total:
            raise TruncatedImageError("the Netpbm file ends before its pixels")
        v = _rescale(np.frombuffer(raw, np.uint8 if nbytes == 1 else ">u2", total), f.maxval,
                     out_max)
    px = v.astype(np.int32 if mode == "I" else np.uint8)
    return mode, px.reshape((h, w) if bands == 1 else (h, w, bands)), palette
