"""The port's GIF and WebP readers (imageio/gif.py, imageio/webp.py and
the native library's gif_lzw and webpdecode.cpp) against the JAX
package's, which reads through Pillow 12.1 (GifImagePlugin, and libwebp's
WebPAnimDecoder behind WebPImagePlugin): for every file the same
read_metadata, the same SourceImage.load gray plane and metadata and the
same colour plane (load_rgb_plane against SourceImage.load_rgb), bit for
bit, and where the file has alpha the same RGBA as Pillow's; where
Pillow refuses a file the port raises an ImageError.

Files are made at test time from numpy seeds: written by Pillow (with
its libwebp), or, for what Pillow does not write (GIF minimum code sizes,
local tables, frames off the screen, a full LZW table without a clear
code, raw or filtered ALPH chunks, the simple loop filter, animations
whose first frame sits at an offset), by the writers here, with Pillow as
the reader of record.
"""

import io
import os
import re
import struct

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

import chip_smoke
from cybervision_tpu import images as jimages
from cybervision_tpu.config import MeshMode as JMeshMode
from cybervision_tpu.reconstruction import reconstruct as jax_reconstruct
from cybervision_tpu_torch import cli, imageio
from cybervision_tpu_torch import images as timages
from cybervision_tpu_torch.errors import ImageError
from cybervision_tpu_torch.imageio import webp as twebp
from cybervision_tpu_torch.reconstruction import Reconstruction

from .test_pipeline import _fast_cfg, _sem_pair
from .test_torch_images import _exif_bytes, _jax_load, _meta, _texture
from .test_torch_pipeline import _port_fast_cfg

torch.set_num_threads(2)

NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "cybervision_tpu_torch", "native", "webpdecode.cpp")


def _pillow_rgba(path):
    """Pillow's RGBA of a file whose mode is RGBA, else None."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA")) if im.mode == "RGBA" else None


def _assert_same(path, pillow_reads=None):
    """The port reads `path` as the JAX package does (module docstring).
    pillow_reads: whether Pillow must read the file (None: either)."""
    assert _meta(timages.read_metadata(path)) == _meta(jimages.read_metadata(path))
    ref = _jax_load(path)
    if pillow_reads is not None:
        assert isinstance(ref, Exception) != pillow_reads, ref
    if isinstance(ref, Exception):
        with pytest.raises(ImageError):
            timages.SourceImage.load(path).load_rgb_plane()
        return
    src_j, rgb_j = ref
    src_t = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src_t.img, src_j.img)
    assert (src_t.scale, src_t.tilt_angle, src_t.focal_length_35mm) == (
        src_j.scale, src_j.tilt_angle, src_j.focal_length_35mm)
    np.testing.assert_array_equal(src_t.load_rgb_plane(), rgb_j)
    rgba = _pillow_rgba(path)
    if rgba is not None:
        f = imageio.open_image(path)
        assert f.format == "WebP" and f.parsed.mode == "RGBA"
        np.testing.assert_array_equal(twebp.decode_rgba(f.parsed, imageio._native()), rgba)


# -- GIF writers --------------------------------------------------------------


def _frame(x, y, idx, min_size=8, table=None, interlace=False, deferred=False, data=None):
    """An image descriptor with its optional local table and LZW data."""
    h, w = idx.shape
    flags = 0x40 if interlace else 0
    out = b","
    tbl = b""
    if table is not None:
        n = len(table) // 3
        bits = max(n - 1, 1).bit_length()
        flags |= 0x80 | (bits - 1)
        tbl = table + b"\0" * (3 * (1 << bits) - len(table))
    rows = idx[chip_smoke.interlaced_rows(h)] if interlace else idx
    lzw = data if data is not None else chip_smoke.gif_lzw(rows, min_size, deferred)
    return out + struct.pack("<HHHHB", x, y, w, h, flags) + tbl + bytes([min_size]) + lzw


def _gif(path, screen, blocks, table=None):
    """A GIF89a: the logical screen (w, h), an optional global table (bytes
    of RGB triples, padded to a power of two) and the blocks, then ';'."""
    flags, tbl = 0, b""
    if table is not None:
        n = len(table) // 3
        bits = max(n - 1, 1).bit_length()
        flags = 0x80 | (bits - 1)
        tbl = table + b"\0" * (3 * (1 << bits) - len(table))
    with open(path, "wb") as fh:
        fh.write(b"GIF89a" + struct.pack("<HHBBB", *screen, flags, 0, 0) + tbl
                 + b"".join(blocks) + b";")


def _gce(transparency=None):
    return b"!\xf9\x04" + bytes([1 if transparency is not None else 0, 0, 0,
                                 transparency or 0]) + b"\0"


def _colours(rng, n):
    return rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes()


def _gif_pillow(path, rng, mode="RGB", size=(37, 29), **kw):
    h, w = size
    px = _texture(rng, h, w, 3)
    im = Image.fromarray(px)
    im = im.convert("L") if mode == "L" else im.convert("P")
    im.save(path, "GIF", **kw)


def _gif_animated(path, rng):
    frames = [Image.fromarray(_texture(rng, 31, 23, 3)).convert("P") for _ in range(3)]
    frames[0].save(path, "GIF", save_all=True, append_images=frames[1:], duration=50, loop=0)


def _gif_min_size(path, rng, bits, deferred=False, size=(40, 51)):
    n = min(1 << bits, 256)
    idx = rng.randint(0, n, size).astype(np.uint8)
    _gif(path, size[::-1], [_frame(0, 0, idx, bits, deferred=deferred)],
         table=_colours(rng, n))


def _gif_local(path, rng, identity=False):
    idx = rng.randint(0, 16, (21, 34)).astype(np.uint8)
    local = (np.repeat(np.arange(16, dtype=np.uint8), 3).tobytes() if identity
             else _colours(rng, 16))
    _gif(path, (34, 21), [_frame(0, 0, idx, 4, table=local)], table=_colours(rng, 16))


def _gif_small_frame(path, rng, transparency=None, past=False):
    idx = rng.randint(0, 8, (7, 5)).astype(np.uint8)
    x, y = (22, 20) if past else (3, 2)
    _gif(path, (25, 24), [_gce(transparency), _frame(x, y, idx, 3)], table=_colours(rng, 8))


def _gif_extensions(path, rng):
    idx = rng.randint(0, 4, (9, 11)).astype(np.uint8)
    comment = b"!\xfe\x05hello\x03abc\0"
    netscape = b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\0"
    text = b"!\x01\x0c" + bytes(12) + b"\x02hi\0"
    stray = b"\x00\x07"  # bytes between blocks, skipped one at a time
    _gif(path, (11, 9), [comment, netscape, text, stray, _gce(2), _frame(0, 0, idx, 2)],
         table=_colours(rng, 4))


def _gif_no_width(path, rng):
    """A frame of width 0 at x 0: Pillow decodes its data over the whole
    screen."""
    idx = rng.randint(0, 8, (14, 19)).astype(np.uint8)
    block = _frame(0, 0, idx, 3)
    block = block[:5] + struct.pack("<H", 0) + block[7:]
    _gif(path, (19, 14), [block], table=_colours(rng, 8))


def _gif_past_table(path, rng):
    idx = rng.randint(0, 4, (13, 17)).astype(np.uint8)
    _gif(path, (17, 13), [_frame(0, 0, idx, 2)], table=_colours(rng, 2))


def _gif_corrupt(path, rng, kind):
    idx = rng.randint(0, 256, (12, 10)).astype(np.uint8)
    if kind == "early end code":
        data = chip_smoke.gif_lzw(idx[:5], 8)
    elif kind == "code past the table":
        # 9-bit codes: a clear code, a literal, then 300 before 258 is defined.
        packed = (256 | 5 << 9 | 300 << 18).to_bytes(4, "little")
        data = bytes([4]) + packed + b"\0"
    elif kind == "no image data":
        data = b"\0"
    _gif(path, (10, 12), [_frame(0, 0, idx, 8, data=data)], table=_colours(rng, 256))


def _gif_code_size(path, rng, bits, literals=256):
    idx = rng.randint(0, literals, (15, 16))
    data = chip_smoke.gif_lzw(idx, min(bits, 11)) if bits <= 12 else b"\x01\x00\0"
    block = _frame(0, 0, idx, bits, data=data)
    _gif(path, (16, 15), [block], table=_colours(rng, 256))


GIF_CASES = {
    "gif gray": lambda p, r: _gif_pillow(p, r, "L"),
    "gif colour": lambda p, r: _gif_pillow(p, r, interlace=False),
    "gif colour interlaced": lambda p, r: _gif_pillow(p, r, size=(40, 33), interlace=True),
    "gif transparency": lambda p, r: _gif_pillow(p, r, transparency=3),
    "gif animated, first frame": _gif_animated,
    "gif local table": _gif_local,
    "gif local identity table": lambda p, r: _gif_local(p, r, identity=True),
    "gif frame inside the screen": _gif_small_frame,
    "gif frame inside the screen, transparency": lambda p, r: _gif_small_frame(p, r, 5),
    "gif frame past the screen": lambda p, r: _gif_small_frame(p, r, past=True),
    **{f"gif min code size {b}": (lambda b: lambda p, r: _gif_min_size(p, r, b))(b)
       for b in range(2, 9)},
    "gif full table, deferred clear": lambda p, r: _gif_min_size(p, r, 8, True, (150, 200)),
    "gif full table, min code size 2": lambda p, r: _gif_min_size(p, r, 2, True, (120, 150)),
    "gif min code size 10": lambda p, r: _gif_code_size(p, r, 10),
    "gif min code size 10, literals past 255": lambda p, r: _gif_code_size(p, r, 10, 1024),
    "gif 1x1": lambda p, r: _gif_pillow(p, r, size=(1, 1)),
    "gif 1x61": lambda p, r: _gif_pillow(p, r, size=(1, 61)),
    "gif 45x1": lambda p, r: _gif_pillow(p, r, size=(45, 1)),
    "gif extensions": _gif_extensions,
    "gif indices past the table": _gif_past_table,
    "gif frame of no width at x 0": _gif_no_width,
}
GIF_REFUSED = {
    "gif early end code": lambda p, r: _gif_corrupt(p, r, "early end code"),
    "gif code past the table": lambda p, r: _gif_corrupt(p, r, "code past the table"),
    "gif without image data": lambda p, r: _gif_corrupt(p, r, "no image data"),
    "gif min code size 13": lambda p, r: _gif_code_size(p, r, 13),
    "gif without an image": lambda p, r: _gif(p, (4, 4), [], table=_colours(r, 2)),
}


# -- WebP writers -------------------------------------------------------------


def _riff(chunks: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    """(tag, payload) of a RIFF WebP's chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, size = data[pos : pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((tag, data[pos + 8 : pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + struct.pack("<I", w - 1)[:3]
                  + struct.pack("<I", h - 1)[:3])


def _webp_bytes(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _webp(path, rng, size=(41, 57), channels=3, **kw):
    h, w = size
    with open(path, "wb") as fh:
        fh.write(_webp_bytes(_texture(rng, h, w, channels), **kw))


def _webp_content(path, rng, kind):
    h, w = 33, 47
    if kind == "gray":
        arr = np.repeat(_texture(rng, h, w)[:, :, None], 3, axis=2)
    else:  # saturated primaries and edges
        arr = (rng.randint(0, 2, (h, w, 3)) * 255).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(_webp_bytes(arr, quality=60))


def _webp_alpha(path, rng, **kw):
    arr = _texture(rng, 43, 38, 4)
    arr[:, :, 3] = rng.randint(0, 256, (43, 38))
    arr[:9, :7, 3] = 0
    with open(path, "wb") as fh:
        fh.write(_webp_bytes(arr, **kw))


def _filter_alpha(alpha: np.ndarray, filt: int) -> np.ndarray:
    """libwebp's alpha filters (filters.c): residuals of the predictions
    the decoder's unfilter adds back."""
    a = alpha.astype(np.int32)
    pred = np.zeros_like(a)
    if filt == 1:
        pred[:, 1:] = a[:, :-1]
        pred[1:, 0] = a[:-1, 0]
    elif filt == 2:
        pred[0, 1:] = a[0, :-1]
        pred[1:] = a[:-1]
    elif filt == 3:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 255).astype(np.uint8)


def _webp_alph(path, rng, filt, compressed):
    """A lossy VP8X file whose ALPH chunk is rewritten: raw or VP8L
    (a lossless encode of the filtered alpha as green, its 5-byte header
    dropped), with filter `filt`."""
    h, w = 29, 35
    arr = _texture(rng, h, w, 4)
    alpha = np.clip(_texture(rng, h, w).astype(np.int32) + 40, 0, 255).astype(np.uint8)
    arr[:, :, 3] = alpha
    chunks = _chunks(_webp_bytes(arr, quality=70))
    res = _filter_alpha(alpha, filt)
    if compressed:
        green = np.zeros((h, w, 3), np.uint8)
        green[:, :, 1] = res
        stream = _chunks(_webp_bytes(green, lossless=True))[0][1][5:]
        body = bytes([filt << 2 | 1]) + stream
    else:
        body = bytes([filt << 2]) + res.tobytes()
    out = b"".join(_chunk(t, body if t == b"ALPH" else p) for t, p in chunks)
    with open(path, "wb") as fh:
        fh.write(_riff(out))


def _webp_alpha_flag_clear(path, rng):
    chunks = _chunks(_webp_bytes(_texture(rng, 30, 20, 4), quality=70))
    out = b"".join(_chunk(t, bytes([p[0] & ~0x10]) + p[1:] if t == b"VP8X" else p)
                   for t, p in chunks)
    with open(path, "wb") as fh:
        fh.write(_riff(out))


def _webp_animated(path, rng, frame_kw, alpha_flag=True):
    """An animation written here: a 64x48 canvas, ANIM, and two ANMF
    frames made of a still file's image chunks, the first at (6, 10)."""
    frames = []
    for (x, y), (h, w) in (((6, 10), (30, 21)), ((0, 0), (40, 60))):
        arr = _texture(rng, h, w, 4)
        arr[:, :, 3] = rng.randint(1, 256, (h, w))
        chunks = _chunks(_webp_bytes(arr, **frame_kw))
        data = b"".join(_chunk(t, p) for t, p in chunks if t in (b"ALPH", b"VP8 ", b"VP8L"))
        frames.append(_chunk(b"ANMF", struct.pack("<I", x // 2)[:3] + struct.pack("<I", y // 2)[:3]
                             + struct.pack("<I", w - 1)[:3] + struct.pack("<I", h - 1)[:3]
                             + struct.pack("<I", 100)[:3] + b"\0" + data))
    flags = 0x02 | (0x10 if alpha_flag else 0)
    body = _vp8x(flags, 64, 48) + _chunk(b"ANIM", struct.pack("<IH", 0xFF204060, 0))
    with open(path, "wb") as fh:
        fh.write(_riff(body + b"".join(frames)))


def _webp_pillow_animation(path, rng):
    frames = [Image.fromarray(_texture(rng, 26, 31, 3)) for _ in range(3)]
    frames[0].save(path, "WEBP", save_all=True, append_images=frames[1:], duration=40)


def _webp_palette(path, rng, colours, size=(37, 43)):
    lut = rng.randint(0, 256, (colours, 3)).astype(np.uint8)
    idx = rng.randint(0, colours, size)
    with open(path, "wb") as fh:
        fh.write(_webp_bytes(lut[idx], lossless=True))


def _webp_trailing(path, rng):
    with open(path, "wb") as fh:
        fh.write(_webp_bytes(_texture(rng, 20, 20, 3)) + b"trailing bytes")


WEBP_CASES = {
    **{f"webp lossy q{q} method {m}": (lambda q, m: lambda p, r: _webp(p, r, quality=q, method=m))(
        q, m) for q in (0, 50, 75, 100) for m in (0, 6)},
    **{f"webp lossy {h}x{w}": (lambda h, w: lambda p, r: _webp(p, r, (h, w)))(h, w)
       for h, w in ((1, 1), (1, 37), (37, 1), (17, 33), (257, 513))},
    "webp lossy gray": lambda p, r: _webp_content(p, r, "gray"),
    "webp lossy saturated": lambda p, r: _webp_content(p, r, "saturated"),
    "webp lossy exif ifd0": lambda p, r: _webp(p, r, exif=_exif_bytes({41989: 35})),
    "webp lossy exif sub-ifd": lambda p, r: _webp(p, r, exif=_exif_bytes(sub={41989: 43})),
    "webp lossy iccp and xmp": lambda p, r: _webp(p, r, icc_profile=b"icc!" * 33,
                                                   xmp=b"<x:xmpmeta>focal</x:xmpmeta>"),
    **{f"webp alpha quality {q} method {m}": (
        lambda q, m: lambda p, r: _webp_alpha(p, r, alpha_quality=q, method=m))(q, m)
       for q, m in ((100, 0), (100, 4), (100, 6), (50, 4), (0, 6))},
    **{f"webp alph {'compressed' if c else 'raw'} filter {f}": (
        lambda f, c: lambda p, r: _webp_alph(p, r, f, c))(f, c) for f in range(4) for c in (0, 1)},
    "webp alph with the vp8x flag clear": _webp_alpha_flag_clear,
    **{f"webp lossless method {m}": (lambda m: lambda p, r: _webp(p, r, lossless=True, method=m))(m)
       for m in range(7)},
    "webp lossless rgba exact": lambda p, r: _webp(p, r, channels=4, lossless=True, exact=True),
    "webp lossless rgba": lambda p, r: _webp(p, r, channels=4, lossless=True),
    **{f"webp lossless palette {n}": (lambda n: lambda p, r: _webp_palette(p, r, n))(n)
       for n in (2, 4, 16, 256)},
    "webp lossless 1x1": lambda p, r: _webp(p, r, (1, 1), lossless=True),
    "webp lossless 1x16383": lambda p, r: _webp(p, r, (1, 16383), lossless=True),
    "webp lossless exif": lambda p, r: _webp(p, r, lossless=True,
                                             exif=_exif_bytes(sub={41989: 28})),
    "webp animated, lossless first frame at an offset": lambda p, r: _webp_animated(
        p, r, {"lossless": True}),
    "webp animated, lossy alpha first frame at an offset": lambda p, r: _webp_animated(
        p, r, {"quality": 60}),
    "webp animated without the alpha flag": lambda p, r: _webp_animated(
        p, r, {"quality": 60}, alpha_flag=False),
    "webp animated by pillow": _webp_pillow_animation,
    "webp trailing bytes": _webp_trailing,
}


@pytest.mark.parametrize("name", sorted(GIF_CASES) + sorted(WEBP_CASES))
def test_readers_match_jax(tmp_path, name):
    cases = {**GIF_CASES, **WEBP_CASES}
    ext = "gif" if name.startswith("gif") else "webp"
    path = str(tmp_path / f"case.{ext}")
    cases[name](path, np.random.RandomState(sorted(cases).index(name)))
    _assert_same(path, pillow_reads=True)


@pytest.mark.parametrize("name", sorted(GIF_REFUSED))
def test_gifs_pillow_refuses_are_refused(tmp_path, name):
    path = str(tmp_path / "case.gif")
    GIF_REFUSED[name](path, np.random.RandomState(3))
    _assert_same(path, pillow_reads=False)


def test_gif_end_code_past_64k_reads_on(tmp_path):
    """Pillow feeds GifDecode 64 KiB at a time: an end code before the
    last pixel pauses the decoder, and the next 64 KiB (here the frame's
    data, coded again) go on filling the image."""
    rng = np.random.RandomState(9)
    idx = rng.randint(0, 256, (300, 400)).astype(np.uint8)
    first = chip_smoke.gif_lzw(idx[:100], 8)[:-1]  # its end code, no terminator
    rest = chip_smoke.gif_lzw(idx[100:], 8)
    assert len(first) < 65536 < len(first) + len(rest)
    path = str(tmp_path / "paused.gif")
    _gif(path, (400, 300), [_frame(0, 0, idx, 8, data=first + rest)], table=_colours(rng, 256))
    _assert_same(path)


# -- VP8's simple loop filter: partition 0 decoded and re-encoded ------------


class _BoolDecoder:
    """RFC 6386's boolean decoder (section 7.3), keeping every (bit, prob)."""

    def __init__(self, data: bytes):
        self.data = data + b"\0" * 4
        self.value = (self.data[0] << 8) | self.data[1]
        self.pos, self.range, self.count = 2, 255, 0
        self.trace = []

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            b, self.range, self.value = 1, self.range - split, self.value - (split << 8)
        else:
            b, self.range = 0, split
        while self.range < 128:
            self.value, self.range, self.count = self.value << 1, self.range << 1, self.count + 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
        self.trace.append([b, prob])
        return b

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.bits(n)
        return -v if self.bit(128) else v


class _BoolEncoder:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def put(self, b: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if b:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                i = len(self.out) - 1
                while self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if self.count == 0:
                self.out.append(self.bottom >> 24)
                self.bottom &= 0xFFFFFF
                self.count = 8

    def finish(self) -> bytes:
        for _ in range(32):
            self.put(0, 128)
        return bytes(self.out)


def _cpp_table(name: str) -> list[int]:
    with open(NATIVE) as fh:
        src = fh.read()
    body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
    return [int(v) for v in re.findall(r"\d+", body)]


def _first_partition(d: _BoolDecoder, mb_w: int, mb_h: int) -> dict:
    """Parse a key frame's first partition (header and intra modes) as
    libwebp does: the trace index of the filter-type bit and of the
    partition count, the filter level, the coefficient probabilities and
    each macroblock's (skip, 4x4) flags."""
    update, bmodes = _cpp_table("kCoeffsUpdateProba"), _cpp_table("kBModesProba")
    proba0 = _cpp_table("kCoeffsProba0")
    assert len(update) == len(proba0) == 1056 and len(bmodes) == 900
    out = {}
    d.bits(2)  # colour space, clamping type
    update_map, seg = 0, [255] * 3
    if d.bit(128):
        update_map = d.bit(128)
        if d.bit(128):
            d.bit(128)
            for n in (7, 7, 7, 7, 6, 6, 6, 6):
                if d.bit(128):
                    d.signed(n)
        if update_map:
            seg = [d.bits(8) if d.bit(128) else 255 for _ in range(3)]
    out["simple_at"] = len(d.trace)
    d.bit(128)
    out["level"] = d.bits(6)
    d.bits(3)
    if d.bit(128) and d.bit(128):
        for _ in range(8):
            if d.bit(128):
                d.signed(6)
    out["parts_at"] = len(d.trace)
    d.bits(2)
    d.bits(7)
    for _ in range(5):
        if d.bit(128):
            d.signed(4)
    d.bit(128)
    probas = [d.bits(8) if d.bit(p) else v for p, v in zip(update, proba0)]
    out["probas"] = np.array(probas).reshape(4, 8, 3, 11).tolist()
    skip_p = d.bits(8) if d.bit(128) else None
    top, mbs = [0] * (4 * mb_w), []
    for _ in range(mb_h):
        left, row = [0] * 4, []
        for mb_x in range(mb_w):
            if update_map:
                d.bit(seg[2]) if d.bit(seg[0]) else d.bit(seg[1])
            skip = d.bit(skip_p) if skip_p is not None else 0
            i4x4 = not d.bit(145)
            if i4x4:
                for y in range(4):
                    mode = left[y]
                    for x in range(4):
                        p = bmodes[(top[4 * mb_x + x] * 10 + mode) * 9:][:9]
                        if not d.bit(p[0]):
                            mode = 0
                        elif not d.bit(p[1]):
                            mode = 1
                        elif not d.bit(p[2]):
                            mode = 2
                        elif not d.bit(p[3]):
                            mode = 3 if not d.bit(p[4]) else (4 if not d.bit(p[5]) else 5)
                        else:
                            mode = (6 if not d.bit(p[6]) else 7 if not d.bit(p[7])
                                    else 8 if not d.bit(p[8]) else 9)
                        top[4 * mb_x + x] = mode
                    left[y] = mode
            else:
                mode = ((1 if d.bit(128) else 3) if d.bit(156) else (2 if d.bit(163) else 0))
                top[4 * mb_x : 4 * mb_x + 4] = [mode] * 4
                left = [mode] * 4
            if d.bit(142) and d.bit(114):
                d.bit(183)
            row.append((skip, i4x4))
        mbs.append(row)
    out["mbs"] = mbs
    return out


_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))


def _coeffs(d: _BoolDecoder, bands, ctx: int, n: int) -> int:
    """libwebp's GetCoeffs, values discarded: the position after the last
    non-zero coefficient."""
    p = bands[_BANDS[n]][ctx]
    while n < 16:
        if not d.bit(p[0]):
            return n
        while not d.bit(p[1]):
            n += 1
            p = bands[_BANDS[n]][0]
            if n == 16:
                return 16
        nxt = bands[_BANDS[n + 1]]
        if not d.bit(p[2]):
            p = nxt[1]
        else:
            if not d.bit(p[3]):
                if d.bit(p[4]):
                    d.bit(p[5])
            elif not d.bit(p[6]):
                if not d.bit(p[7]):
                    d.bit(159)
                else:
                    d.bit(165)
                    d.bit(145)
            else:
                b1 = d.bit(p[8])
                b0 = d.bit(p[9 + b1])
                for prob in _CAT3456[2 * b1 + b0]:
                    d.bit(prob)
            p = nxt[2]
        d.bit(128)  # the sign
        n += 1
    return 16


def _token_rows(d: _BoolDecoder, head: dict) -> list[list]:
    """Parse the tokens of every macroblock (libwebp's ParseResiduals and
    its non-zero contexts); the (bit, prob) trace of each macroblock row."""
    probas, mbs = head["probas"], head["mbs"]
    mb_w = len(mbs[0])
    top_nz, top_dc, rows = [0] * mb_w, [0] * mb_w, []
    for row in mbs:
        start, left_nz, left_dc = len(d.trace), 0, 0
        for x, (skip, i4x4) in enumerate(row):
            if skip:
                left_nz = top_nz[x] = 0
                if not i4x4:
                    left_dc = top_dc[x] = 0
                continue
            if not i4x4:
                nz = _coeffs(d, probas[1], top_dc[x] + left_dc, 0)
                top_dc[x] = left_dc = int(nz > 0)
                first, ac = 1, probas[0]
            else:
                first, ac = 0, probas[3]
            tnz, lnz = top_nz[x] & 0x0F, left_nz & 0x0F
            for _ in range(4):
                lb = lnz & 1
                for _ in range(4):
                    lb = int(_coeffs(d, ac, lb + (tnz & 1), first) > first)
                    tnz = (tnz >> 1) | (lb << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (lb << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz, lnz = top_nz[x] >> (4 + ch), left_nz >> (4 + ch)
                for _ in range(2):
                    lb = lnz & 1
                    for _ in range(2):
                        lb = int(_coeffs(d, probas[2], lb + (tnz & 1), 0) > 0)
                        tnz = (tnz >> 1) | (lb << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (lb << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            top_nz[x], left_nz = out_t & 0xFF, out_l & 0xFF
        rows.append(d.trace[start:])
    return rows


def _encode(trace) -> bytes:
    enc = _BoolEncoder()
    for b, p in trace:
        enc.put(b, p)
    return enc.finish()


def _rewrite_vp8(data: bytes, simple: bool = False, partitions: int = 1) -> bytes:
    """The lossy WebP `data` (one token partition) rewritten: its frame
    header's filter type set to the simple filter, or its tokens split
    into `partitions` partitions by macroblock row; the first partition
    re-encoded, every other bit kept."""
    (tag, vp8), = [c for c in _chunks(data) if c[0] == b"VP8 "]
    bits = vp8[0] | vp8[1] << 8 | vp8[2] << 16
    size = bits >> 5
    w, h = struct.unpack_from("<HH", vp8, 6)
    d = _BoolDecoder(vp8[10 : 10 + size])
    head = _first_partition(d, ((w & 0x3FFF) + 15) // 16, ((h & 0x3FFF) + 15) // 16)
    trace = d.trace
    assert trace[head["parts_at"]][0] == trace[head["parts_at"] + 1][0] == 0
    tokens = vp8[10 + size :]
    if simple:
        assert head["level"] > 0 and trace[head["simple_at"]][0] == 0
        trace[head["simple_at"]][0] = 1
    if partitions > 1:
        k = partitions.bit_length() - 1
        trace[head["parts_at"]][0], trace[head["parts_at"] + 1][0] = k >> 1, k & 1
        rows = _token_rows(_BoolDecoder(tokens), head)
        parts = [_encode([t for r in rows[i::partitions] for t in r]) for i in range(partitions)]
        tokens = b"".join(struct.pack("<I", len(p))[:3] for p in parts[:-1]) + b"".join(parts)
    part0 = _encode(trace)
    out = struct.pack("<I", (bits & 0x1F) | len(part0) << 5)[:3] + vp8[3:10] + part0 + tokens
    return _riff(_chunk(b"VP8 ", out))


def test_simple_loop_filter_matches_pillow(tmp_path):
    """Pillow's encoder writes the normal loop filter only; this file's
    first partition is re-encoded with the simple one (filter type bit
    set), which Pillow decodes: the port gives its planes, which differ
    from the normal-filter file's."""
    rng = np.random.RandomState(21)
    data = _webp_bytes(_texture(rng, 70, 90, 3), quality=30)
    path, normal = str(tmp_path / "simple.webp"), str(tmp_path / "normal.webp")
    with open(path, "wb") as fh:
        fh.write(_rewrite_vp8(data, simple=True))
    with open(normal, "wb") as fh:
        fh.write(data)
    _assert_same(path, pillow_reads=True)
    with Image.open(path) as a, Image.open(normal) as b:
        assert not np.array_equal(np.asarray(a.convert("RGB")), np.asarray(b.convert("RGB")))


@pytest.mark.parametrize("partitions", [2, 4, 8])
def test_token_partitions_match_pillow(tmp_path, partitions):
    """Pillow's encoder writes one token partition; this file's tokens
    are split into 2, 4 or 8 by macroblock row (the frame header's
    partition count re-encoded): Pillow decodes it to the one-partition
    file's planes, and the port gives the same."""
    rng = np.random.RandomState(22)
    data = _webp_bytes(_texture(rng, 150, 70, 3), quality=60)
    path, single = str(tmp_path / "parts.webp"), str(tmp_path / "single.webp")
    with open(path, "wb") as fh:
        fh.write(_rewrite_vp8(data, partitions=partitions))
    with open(single, "wb") as fh:
        fh.write(data)
    with Image.open(path) as a, Image.open(single) as b:
        np.testing.assert_array_equal(np.asarray(a.convert("RGB")), np.asarray(b.convert("RGB")))
    _assert_same(path, pillow_reads=True)


# -- refusals: truncations and byte flips --------------------------------------


def _base_file(kind: str) -> bytes:
    rng = np.random.RandomState(31)
    if kind == "gif":
        buf = io.BytesIO()
        Image.fromarray(_texture(rng, 40, 50, 3)).convert("P").save(buf, "GIF")
        return buf.getvalue()
    if kind == "lossy":
        return _webp_bytes(_texture(rng, 40, 50, 3), quality=60, exif=_exif_bytes({41989: 50}))
    if kind == "lossless":
        return _webp_bytes(_texture(rng, 40, 50, 4), lossless=True)
    arr = _texture(rng, 40, 50, 4)
    arr[:, :, 3] = rng.randint(0, 256, (40, 50))
    return _webp_bytes(arr, quality=60)


KINDS = ("gif", "lossy", "lossless", "lossy alpha")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sixteenths", range(1, 16))
def test_truncated_files_match_pillow(tmp_path, kind, sixteenths):
    data = _base_file(kind)
    path = str(tmp_path / ("cut.gif" if kind == "gif" else "cut.webp"))
    with open(path, "wb") as fh:
        fh.write(data[: len(data) * sixteenths // 16])
    _assert_same(path, pillow_reads=False)


@pytest.mark.parametrize("kind", KINDS)
@settings(max_examples=60, derandomize=True, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(flips=st.lists(st.tuples(st.floats(0, 1, exclude_max=True), st.integers(0, 255)),
                      min_size=1, max_size=3))
def test_byte_flips_match_pillow(tmp_path, kind, flips):
    """A few bytes of a file replaced anywhere: where Pillow reads it the
    port gives its planes, where Pillow refuses it the port raises an
    ImageError; read_metadata equal either way."""
    data = bytearray(_base_file(kind))
    for where, value in flips:
        data[int(where * len(data))] = value
    path = str(tmp_path / ("flip.gif" if kind == "gif" else "flip.webp"))
    with open(path, "wb") as fh:
        fh.write(bytes(data))
    _assert_same(path)


def test_webp_needs_the_native_library(tmp_path, monkeypatch):
    from cybervision_tpu_torch import native
    from cybervision_tpu_torch.imageio import NativeDecoderError

    rng = np.random.RandomState(2)
    for ext, build in (("gif", lambda p: _gif_pillow(p, rng)), ("webp", lambda p: _webp(p, rng))):
        path = str(tmp_path / f"n.{ext}")
        build(path)
        monkeypatch.setattr(native, "load", lambda: (_ for _ in ()).throw(ImportError("no")))
        with pytest.raises(NativeDecoderError, match="C\\+\\+ compiler"):
            timages.SourceImage.load(path)
        monkeypatch.undo()


# -- the CLI from GIF and WebP files -----------------------------------------


@pytest.mark.parametrize("fmt", ["gif", "webp"])
def test_cli_cpu_ply_from_gif_and_webp_matches_jax_planes(tmp_path, monkeypatch, fmt):
    """tests/test_pipeline.py's 160x160 SEM pair as gray GIFs (written by
    Pillow) or lossy WebPs -> PLY through the port's cli.main with
    every import of Pillow blocked: the file equals the port's run on the
    planes the JAX package reads from the same files, and the JAX CLI's
    PLY has the same vertex count."""
    import sys

    img1, img2, _ = _sem_pair(np.random.RandomState(7))
    paths = []
    for k, img in enumerate((img1, img2)):
        paths.append(str(tmp_path / f"sem{k}.{fmt}"))
        if fmt == "gif":
            Image.fromarray(img).save(paths[-1], "GIF")
        else:
            Image.fromarray(np.stack([img, img, img], axis=-1)).save(paths[-1], "WEBP",
                                                                        quality=90)
    mem = []
    for p in paths:
        src = jimages.SourceImage.load(p)
        t = timages.SourceImage(src.img)
        rgb = jimages.SourceImage.load_rgb(p)
        t.load_rgb_plane = lambda rgb=rgb: np.array(rgb)
        mem.append(t)
    out, ref = str(tmp_path / "port.ply"), str(tmp_path / "mem.ply")
    argv = ["--mode=cpu", "--projection=parallel", "--mesh=vertex-colors", *paths]
    monkeypatch.setattr(cli, "ReconstructionConfig", _port_fast_cfg)
    cfg = cli.parse_args([*argv, ref])[0]
    Reconstruction(["a", "b"], ref, cfg, quiet=True, images=mem).run()
    out_j = str(tmp_path / "jax.ply")
    jax_reconstruct(paths, out_j, _fast_cfg(mesh=JMeshMode.VERTEX_COLORS), quiet=True)
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)  # any import of Pillow now raises
    assert cli.main([*argv, out]) == 0
    with open(out, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    with open(out_j, "rb") as fh:
        head = fh.read(400).split(b"end_header")[0]
    with open(out, "rb") as fh:
        assert fh.read(400).split(b"end_header")[0] == head


def test_corrupt_coefficients_take_libwebps_simd_transform(tmp_path):
    """A byte of a lossy file changed so that a block's coefficients
    overflow 16 bits: x86-64 libwebp runs its full inverse transform in
    wrapping 16-bit lanes (Transform_SSE2), which then departs from its C
    transform; the port follows the SIMD one (webpdecode.cpp's
    transform_simd) and gives Pillow's planes."""
    rng = np.random.RandomState(166)
    data = bytearray(_webp_bytes(_texture(rng, 32, 32, 3), quality=int(rng.randint(0, 100))))
    for _ in range(10):
        at, value = int(rng.randint(30, len(data))), int(rng.randint(256))
    data[at] = value
    path = str(tmp_path / "overflow.webp")
    with open(path, "wb") as fh:
        fh.write(bytes(data))
    _assert_same(path, pillow_reads=True)
