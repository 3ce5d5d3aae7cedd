"""WebP container, as Pillow's WebPImagePlugin opens and loads a file:
through libwebp's WebPAnimDecoder, for a still image as for an animation.
Opening runs libwebp's WebPGetFeatures on the whole file (the RIFF
header, a VP8X chunk of exactly 10 bytes, the chunks before the image,
the VP8 / VP8L frame header) and its demuxer (every chunk's size within
the RIFF size, no cut file, the VP8X flags and canvas, at most one image
in a still file, ANIM before the ANMF frames, each frame's ALPH before
its VP8, frames within the canvas), then Pillow's decompression-bomb
check on the canvas; a file any of them refuses raises here.
The mode is Pillow's: "RGBA" where WebPGetFeatures reports alpha (the
VP8X flag, a VP8L header's alpha hint, an ALPH chunk), else "RGB". The
EXIF chunk (kept only where the VP8X flag says so) gives the focal
length.

Loading decodes the first frame as WebPAnimDecoder does: its ALPH (when
the VP8X alpha flag keeps it) and VP8, or its VP8L, into a canvas of
zeros at the frame's offset. The bitstreams decode in the native library
(webpdecode.cpp); without it a WebP raises NativeDecoderError.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    TruncatedImageError,
    UnsupportedImageError,
    bomb_check,
    native_missing,
)

FIRST_CHUNKS = (b"VP8 ", b"VP8L", b"VP8X")
_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_AREA = 1 << 32
_ALPHA, _ANIMATION, _ICCP, _EXIF, _XMP = 0x10, 0x02, 0x20, 0x08, 0x04
_VALID_FLAGS = _ALPHA | _ANIMATION | _ICCP | _EXIF | _XMP
# libwebp's VP8StatusCode values the parsers return.
_OK, _ERROR, _UNSUPPORTED, _SHORT = 0, 3, 4, 7


def _le32(b: bytes, o: int) -> int:
    return struct.unpack_from("<I", b, o)[0]


def _le24(b: bytes, o: int) -> int:
    return b[o] | b[o + 1] << 8 | b[o + 2] << 16


def _vp8_info(data: bytes, chunk_size: int) -> tuple[int, int] | None:
    """libwebp's VP8GetInfo: a key frame's (width, height), or None."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        return None
    bits = data[0] | data[1] << 8 | data[2] << 16
    w, h = (data[6] | data[7] << 8) & 0x3FFF, (data[8] | data[9] << 8) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= chunk_size:
        return None
    return None if w == 0 or h == 0 else (w, h)


def _vp8l_info(data: bytes) -> tuple[int, int, bool] | None:
    """libwebp's VP8LGetInfo: (width, height, alpha hint), or None."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5:
        return None
    v = _le32(data, 1)
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool((v >> 28) & 1)


@dataclasses.dataclass
class _Headers:
    """What libwebp's ParseHeadersInternal reports."""

    width: int = 0
    height: int = 0
    has_alpha: bool = False
    animation: bool = False
    lossless: bool = False
    alpha: bytes | None = None  # an ALPH chunk's payload
    offset: int = 0  # of the VP8 / VP8L payload


def _optional_chunks(data: bytes, pos: int, riff_size: int, h: _Headers) -> tuple[int, int]:
    """libwebp's ParseOptionalChunks: (status, position of the VP8 / VP8L
    chunk), the last ALPH payload kept."""
    total = 4 + 8 + 10
    while True:
        if len(data) - pos < 8:
            return _SHORT, pos
        size = _le32(data, pos + 4)
        if size > _MAX_PAYLOAD:
            return _ERROR, pos
        disk = (8 + size + 1) & ~1
        total += disk
        if riff_size > 0 and total > riff_size:
            return _ERROR, pos
        if data[pos : pos + 4] in (b"VP8 ", b"VP8L"):
            return _OK, pos
        if len(data) - pos < disk:
            return _SHORT, pos
        if data[pos : pos + 4] == b"ALPH":
            h.alpha = data[pos + 8 : pos + 8 + size]
        pos += disk


def _headers(data: bytes, decoding: bool = False) -> tuple[int, _Headers]:
    """libwebp's ParseHeadersInternal on `data`: as WebPGetFeatures runs it,
    or, with `decoding`, as WebPDecode's WebPParseHeaders does (all data
    present, an animation unsupported)."""
    h = _Headers()
    if len(data) < 12:
        return _SHORT, h
    pos, riff_size = 0, 0
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            return _ERROR, h
        size = _le32(data, 4)
        if size < 12 or size > _MAX_PAYLOAD:
            return _ERROR, h
        if decoding and size > len(data) - 8:
            return _SHORT, h
        riff_size, pos = size, 12
    if len(data) - pos < 8:
        return _SHORT, h
    found_vp8x, flags, canvas = False, 0, (0, 0)
    if data[pos : pos + 4] == b"VP8X":
        if _le32(data, pos + 4) != 10:
            return _ERROR, h
        if len(data) - pos < 18:
            return _SHORT, h
        flags = _le32(data, pos + 8)
        canvas = (1 + _le24(data, pos + 12), 1 + _le24(data, pos + 15))
        if canvas[0] * canvas[1] >= _MAX_AREA:
            return _ERROR, h
        pos += 18
        found_vp8x = True
    if not riff_size and found_vp8x:
        return _ERROR, h
    h.has_alpha, h.animation = bool(flags & _ALPHA), bool(flags & _ANIMATION)
    h.width, h.height = canvas

    def done(status: int) -> tuple[int, _Headers]:
        if status == _OK or (status == _SHORT and found_vp8x and not decoding):
            h.has_alpha |= h.alpha is not None
            if decoding and h.animation:
                return _UNSUPPORTED, h
            return _OK, h
        return status, h

    if found_vp8x and h.animation and not decoding:
        return done(_OK)
    if len(data) - pos < 4:
        return done(_SHORT)
    if (riff_size and found_vp8x) or (not riff_size and not found_vp8x
                                      and data[pos : pos + 4] == b"ALPH"):
        status, pos = _optional_chunks(data, pos, riff_size, h)
        if status != _OK:
            return done(status)
    # ParseVP8Header
    if len(data) - pos < 8:
        return done(_SHORT)
    tag = data[pos : pos + 4]
    if tag in (b"VP8 ", b"VP8L"):
        size = _le32(data, pos + 4)
        if riff_size >= 12 and size > riff_size - 12:
            return _ERROR, h
        if decoding and size > len(data) - pos - 8:
            return done(_SHORT)
        compressed, pos, h.lossless = size, pos + 8, tag == b"VP8L"
    else:
        compressed = len(data) - pos
        h.lossless = _vp8l_info(data[pos:]) is not None
    if compressed > _MAX_PAYLOAD:
        return _ERROR, h
    if not h.lossless:
        if len(data) - pos < 10:
            return done(_SHORT)
        info = _vp8_info(data[pos:], compressed)
        if info is None:
            return _ERROR, h
        size2 = info
    else:
        if len(data) - pos < 5:
            return done(_SHORT)
        info = _vp8l_info(data[pos:])
        if info is None:
            return _ERROR, h
        size2, h.has_alpha = info[:2], info[2]
    if found_vp8x and size2 != canvas:
        return _ERROR, h
    h.width, h.height = size2
    h.offset = pos
    return done(_OK)


@dataclasses.dataclass
class _Frame:
    num: int = 0
    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0
    image: tuple[int, int] | None = None  # (offset, size) of the VP8 / VP8L chunk
    alpha: tuple[int, int] | None = None  # (offset, size) of the ALPH chunk
    complete: bool = False


class _Refused(Exception):
    """libwebp's demuxer refused the file."""


class _Demux:
    """libwebp's WebPDemux (no partial data) over a RIFF file: frames,
    canvas, flags and the stored chunks."""

    def __init__(self, data: bytes):
        if len(data) < 20:
            raise _Refused("shorter than a RIFF header and a chunk")
        riff_size = _le32(data, 4)
        if data[:4] != b"RIFF" or data[8:12] != b"WEBP" or riff_size < 8 \
                or riff_size > _MAX_PAYLOAD:
            raise _Refused("not a WebP RIFF header")
        self.data, self.riff_end = data, riff_size + 8
        if len(data) < self.riff_end:
            raise _Refused("the file ends before its RIFF size")
        self.pos, self.flags, self.ext = 12, 0, False
        self.canvas, self.frames, self.chunks = (0, 0), [], []
        self.num_frames, self.done = 0, False
        kind = data[12:16]
        if kind in (b"VP8 ", b"VP8L"):
            status = self._single_image()
            valid = self._valid_simple
        elif kind == b"VP8X":
            status = self._vp8x()
            valid = self._valid_extended
        else:
            raise _Refused("the first chunk is not VP8, VP8L or VP8X")
        if status == _OK:
            self.done = True
        if status != _OK or not valid():
            raise _Refused("the demuxer refuses the chunks")

    def _left(self) -> int:
        return self.riff_end - self.pos

    def _store_frame(self, num: int, min_size: int, frame: _Frame) -> int:
        if self._left() < 8 or self._left() < min_size:
            return _SHORT
        alpha_chunks = image_chunks = 0
        while True:
            start = self.pos
            tag, size = self.data[start : start + 4], _le32(self.data, start + 4)
            if size > _MAX_PAYLOAD:
                return _ERROR
            padded = size + (size & 1)
            if padded > self.riff_end - start - 8:
                return _ERROR
            if tag == b"VP8L" and alpha_chunks:
                return _ERROR  # VP8L carries its own alpha
            if tag == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha, frame.num = (start, 8 + padded), num
                self.pos = start + 8 + padded
            elif tag in (b"VP8 ", b"VP8L") and image_chunks == 0:
                status, h = _headers(self.data[start : start + 8 + padded])
                if status != _OK:
                    return _ERROR
                image_chunks = 1
                frame.image, frame.num, frame.complete = (start, 8 + padded), num, True
                frame.width, frame.height = h.width, h.height
                self.pos = start + 8 + padded
            else:
                return _OK  # the frame ends before this chunk
            if self.pos == self.riff_end:
                return _OK
            if self._left() < 8:
                return _SHORT

    def _add(self, frame: _Frame) -> bool:
        if self.frames and not self.frames[-1].complete:
            return False
        self.frames.append(frame)
        return True

    def _single_image(self) -> int:
        if self.frames or self._left() < 8:
            return _ERROR
        frame = _Frame()
        status = self._store_frame(1, 0, frame)
        if status != _ERROR:
            if not self.flags & _ALPHA and frame.alpha is not None:
                frame.alpha = None  # dropped where the VP8X flag is clear
            if not self.ext and frame.width > 0 and frame.height > 0:
                self.canvas = (frame.width, frame.height)
            if not self._add(frame):
                return _ERROR
            self.num_frames = 1
        return status

    def _vp8x(self) -> int:
        self.ext = True
        size = _le32(self.data, self.pos + 4)
        if size > _MAX_PAYLOAD or size < 10:
            return _ERROR
        size += size & 1
        self.pos += 8
        if size > self._left():
            return _ERROR
        self.flags = self.data[self.pos]
        self.canvas = (1 + _le24(self.data, self.pos + 4), 1 + _le24(self.data, self.pos + 7))
        if self.canvas[0] * self.canvas[1] >= _MAX_AREA:
            return _ERROR
        self.pos += size
        if self._left() < 8:
            return _ERROR
        return self._vp8x_chunks()

    def _vp8x_chunks(self) -> int:
        animation = bool(self.flags & _ANIMATION)
        anim_chunks = 0
        status = _OK
        while status == _OK:
            start = self.pos
            tag, size = self.data[start : start + 4], _le32(self.data, start + 4)
            if size > _MAX_PAYLOAD:
                return _ERROR
            padded = size + (size & 1)
            self.pos += 8
            if padded > self._left():
                return _ERROR
            if tag == b"VP8X":
                return _ERROR
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or animation:
                    return _ERROR
                self.pos = start
                status = self._single_image()
            elif tag == b"ANIM" and padded < 6:
                return _ERROR
            elif tag == b"ANIM" and anim_chunks == 0:
                anim_chunks = 1
                self.pos += padded
            elif tag == b"ANMF":
                if anim_chunks == 0:
                    return _ERROR
                status = self._anmf(padded)
            else:
                flag = {b"ICCP": _ICCP, b"EXIF": _EXIF, b"XMP ": _XMP}.get(tag)
                if tag != b"ANIM" and (flag is None or self.flags & flag):
                    self.chunks.append((tag, start + 8, size))
                self.pos += padded
            if self.pos == self.riff_end:
                break
            if self._left() < 8:
                status = _SHORT
        return status

    def _anmf(self, padded: int) -> int:
        if padded < 16 or self._left() < 16:
            return _ERROR
        d, p = self.data, self.pos
        frame = _Frame(x=2 * _le24(d, p), y=2 * _le24(d, p + 3))
        if (1 + _le24(d, p + 6)) * (1 + _le24(d, p + 9)) >= _MAX_AREA:
            return _ERROR
        self.pos = start = p + 16
        status = self._store_frame(self.num_frames + 1, padded - 16, frame)
        if status != _ERROR and self.pos - start > padded - 16:
            status = _ERROR
        if status != _ERROR and self.flags & _ANIMATION and frame.num > 0:
            if not self._add(frame):
                return _ERROR
            self.num_frames += 1
        return status

    def _valid_simple(self) -> bool:
        return (self.canvas[0] > 0 and self.canvas[1] > 0 and bool(self.frames)
                and self.frames[0].width > 0 and self.frames[0].height > 0)

    def _valid_extended(self) -> bool:
        animation = bool(self.flags & _ANIMATION)
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames \
                or self.flags & ~_VALID_FLAGS:
            return False
        for k, f in enumerate(self.frames):
            if not animation and f.num > 1:
                return False
            if f.complete:
                if f.alpha is None and f.image is None:
                    return False
                if f.alpha is not None and f.alpha[0] > f.image[0]:
                    return False
                if f.width <= 0 or f.height <= 0:
                    return False
            else:
                if self.done:
                    return False
                if f.alpha is not None and f.image is not None and f.alpha[0] > f.image[0]:
                    return False
                if k + 1 < len(self.frames):
                    return False
            if f.width > 0 and f.height > 0:
                if animation:
                    if f.x + f.width > self.canvas[0] or f.y + f.height > self.canvas[1]:
                        return False
                elif (f.x, f.y, f.width, f.height) != (0, 0) + self.canvas:
                    return False
        return True

    def chunk(self, tag: bytes) -> bytes | None:
        for t, offset, size in self.chunks:
            if t == tag:
                return self.data[offset : offset + size]
        return None


@dataclasses.dataclass
class WebPFile:
    data: bytes
    size: tuple[int, int]  # the canvas (width, height)
    mode: str  # "RGB" or "RGBA"
    exif: bytes | None
    frame: _Frame  # the first


def parse(data: bytes) -> WebPFile:
    """The container as Pillow's open reads it, or the error it raises."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP" or data[12:16] not in FIRST_CHUNKS:
        raise CorruptImageError("not a WebP file")
    status, h = _headers(data)
    if status != _OK:
        kind = TruncatedImageError if status == _SHORT else CorruptImageError
        raise kind("libwebp's WebPGetFeatures refuses the file")
    try:
        demux = _Demux(data)
    except _Refused as err:
        if len(data) < 20 or len(data) < _le32(data, 4) + 8:
            raise TruncatedImageError(f"WebP: {err}") from None
        raise CorruptImageError(f"WebP: {err}") from None
    bomb_check(demux.canvas, "WebP canvas")
    exif = demux.chunk(b"EXIF")
    return WebPFile(data, demux.canvas, "RGBA" if h.has_alpha else "RGB", exif or None,
                    demux.frames[0])


def decode_rgba(w: WebPFile, native) -> np.ndarray:
    """(H, W, 4) uint8: the first frame on the canvas, as WebPAnimDecoder
    composes it (MODE_RGBA)."""
    if native is None:
        raise native_missing("WebP")
    f = w.frame
    start = f.alpha[0] if f.alpha is not None else f.image[0]
    fragment = w.data[start : f.image[0] + f.image[1]]
    status, h = _headers(fragment, decoding=True)
    if status != _OK:
        kind = {_SHORT: TruncatedImageError, _UNSUPPORTED: UnsupportedImageError}
        raise kind.get(status, CorruptImageError)("libwebp refuses the frame's headers")
    payload = fragment[h.offset :]
    if h.lossless:
        argb = native.webp_vp8l_decode(payload, h.width, h.height)
        rgba = argb.view(np.uint8).reshape(h.height, h.width, 4)[:, :, [2, 1, 0, 3]]
    else:
        rgba = np.empty((h.height, h.width, 4), np.uint8)
        rgba[:, :, :3] = native.webp_vp8_decode(payload, h.width, h.height)
        rgba[:, :, 3] = 255 if h.alpha is None else native.webp_alph_decode(
            h.alpha, h.width, h.height)
    canvas = np.zeros((w.size[1], w.size[0], 4), np.uint8)
    canvas[f.y : f.y + h.height, f.x : f.x + h.width] = rgba
    return canvas


def decode(w: WebPFile, native) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette) as imageio.ImageFile.decode gives them."""
    rgba = decode_rgba(w, native)
    return w.mode, rgba if w.mode == "RGBA" else np.ascontiguousarray(rgba[:, :, :3]), None
