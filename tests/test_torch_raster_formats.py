"""The port's readers of the raster formats Pillow opens beyond PNG, TIFF,
JPEG, BMP, GIF and WebP (imageio/netpbm.py, spider.py, tga.py, sgi.py,
pcx.py, qoi.py, TIFF's LA, PA and CMYK keys, and the native library's
tga_rle, sgi_rle, pcx_rle and qoi_decode) against the JAX package's,
which reads through Pillow 12.1: for every file the same read_metadata,
the same SourceImage.load gray plane and metadata and the same colour
plane (load_rgb_plane against SourceImage.load_rgb), bit for bit; where
Pillow refuses a file the port raises an ImageError; where Pillow
misreads a valid file the port reads it as a twin Pillow reads.

Files are made at test time from numpy seeds: written by Pillow, or, for
what Pillow does not write (plain Netpbm with comments, other maxvals,
big-endian PFM, colour-mapped, top-down and mirrored TGA with an ID
field, SGI RLE, PCX bit planes, SPIDER stacks, CMYK TIFF with extra or
16-bit samples), by the writers here, with Pillow as the reader of
record.
"""

import io
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from cybervision_tpu import images as jimages
from cybervision_tpu.config import MeshMode as JMeshMode
from cybervision_tpu.reconstruction import reconstruct as jax_reconstruct
from cybervision_tpu_torch import cli, imageio, native
from cybervision_tpu_torch import images as timages
from cybervision_tpu_torch.errors import ImageError
from cybervision_tpu_torch.imageio import NativeDecoderError, UnsupportedImageError

from .test_pipeline import _fast_cfg, _sem_pair
from .test_torch_images import _exif_bytes, _jax_load, _meta, _texture, _tiff_file
from .test_torch_pipeline import SAME_F_DEPTH_BUDGET, _port_fast_cfg, _read_ply

torch.set_num_threads(2)


def _assert_same(path):
    """The port reads `path` as the JAX package does (module docstring);
    Pillow must read it."""
    assert _meta(timages.read_metadata(path)) == _meta(jimages.read_metadata(path))
    ref = _jax_load(path)
    assert not isinstance(ref, Exception), ref
    src_j, rgb_j = ref
    src_t = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src_t.img, src_j.img)
    assert (src_t.scale, src_t.tilt_angle, src_t.focal_length_35mm) == (
        src_j.scale, src_j.tilt_angle, src_j.focal_length_35mm)
    rgb_t = src_t.load_rgb_plane()
    assert rgb_t.dtype == np.uint8 and rgb_t.flags.c_contiguous
    np.testing.assert_array_equal(rgb_t, rgb_j)


def _write(path, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)


def _pillow(mode, px):
    """A Pillow image of `mode` from (h, w[, c]) samples."""
    if mode in ("P", "PA"):
        im = Image.fromarray(px[:, :, 0] if px.ndim == 3 else px).convert("P")
        im.putpalette([int(v) for v in np.random.RandomState(px.size % 97).randint(0, 256, 768)])
        if mode == "PA":
            im = im.convert("PA")
            im.putalpha(Image.fromarray(px[:, :, 1]))
        return im
    if mode == "1":
        return Image.fromarray(px > 127)
    if mode == "I;16":
        return Image.fromarray(px.astype(np.uint16) * 257 + 3)
    if mode == "F":
        return Image.fromarray(px.astype(np.float32) * 1.3 - 20.5)
    return Image.fromarray(px).convert(mode)


def _saved(fmt, mode, channels=None, size=(13, 17), **save):
    def build(path, rng):
        px = _texture(rng, *size, channels)
        _pillow(mode, px).save(path, fmt, **save)
    return build


# -- Netpbm --------------------------------------------------------------------


def _pnm(magic: bytes, fields, body: bytes, seps=(b"\n", b" ", b"\n")) -> bytes:
    head = magic
    for k, f in enumerate(fields):
        head += seps[k % len(seps)] + f
    return head + b"\n" + body


def _plain(values, rng, per_line=7) -> bytes:
    """Decimal samples with comments and runs of whitespace between them."""
    out = b""
    for k, v in enumerate(values):
        out += str(int(v)).encode() + (b"\n" if k % per_line == per_line - 1 else b" ")
        if rng.rand() < 0.05:
            out += b"# a comment\r\n"
    return out


def _netpbm(kind):
    def build(path, rng):
        h, w = 11, 14
        if kind == "P1 plain, comments":
            bits = rng.randint(0, 2, (h, w))
            body = b"\n".join(b"".join(b"%d" % v for v in row) + b"# row\n" for row in bits)
            _write(path, _pnm(b"P1", [b"%d" % w, b"# size\n%d" % h], body))
        elif kind.startswith("P2"):
            maxval = int(kind.split("maxval ")[1].split(",")[0])
            vals = rng.randint(0, maxval + 1, h * w)
            _write(path, _pnm(b"P2", [b"%d" % w, b"%d" % h, b"%d" % maxval], _plain(vals, rng),
                              seps=(b"\n# made by hand\n", b"\t", b"  ")))
        elif kind.startswith("P3"):
            maxval = int(kind.split("maxval ")[1].split(",")[0])
            vals = rng.randint(0, maxval + 1, h * w * 3)
            _write(path, _pnm(b"P3", [b"%d" % w, b"%d" % h, b"%d" % maxval], _plain(vals, rng)))
        elif kind == "P5 header tokens split by a comment":
            vals = _texture(rng, h, w)
            _write(path, b"P5 1#x\n4 +11 2#\r55\n" + vals.tobytes())
        elif kind.startswith(("P5", "P6")):
            maxval = int(kind.split("maxval ")[1].split(",")[0])
            bands = 1 if kind.startswith("P5") else 3
            if "8-bit values" in kind:
                vals = _texture(rng, h, w).astype(">u2")
            else:
                vals = rng.randint(0, maxval + 1, h * w * bands).astype(
                    ">u2" if maxval > 255 else np.uint8)
            _write(path, _pnm(kind[:2].encode(), [b"%d" % w, b"%d" % h, b"%d" % maxval],
                              vals.tobytes()))
        elif kind.startswith("Pf"):
            big = "big-endian" in kind
            px = (_texture(rng, h, w).astype(np.float32) * 1.2 - 10.25).astype(np.float32)
            px[2, 3], px[4, 5], px[6, 7] = np.nan, np.inf, -np.inf
            _write(path, _pnm(b"Pf", [b"%d" % w, b"%d" % h, b"1.0" if big else b"-0.5"],
                              px[::-1].astype(">f4" if big else "<f4").tobytes()))
        else:  # Pillow's own magics
            magic = kind.split()[0].encode()
            bands = {b"P0CMYK": 4, b"PyRGBA": 4, b"PyCMYK": 4, b"PyP": 1}[magic]
            maxval = 255 if "255" in kind else 100
            vals = rng.randint(0, maxval + 1, h * w * bands).astype(np.uint8)
            _write(path, _pnm(magic, [b"%d" % w, b"%d" % h, b"%d" % maxval], vals.tobytes()))
    return build


# -- SPIDER -------------------------------------------------------------------


def _spider_bytes(img: np.ndarray, endian: str, stack: bool = False) -> bytes:
    """A SPIDER 2D image (iform 1) of float32 `img` behind a header of
    whole records (labrec records of lenbyt bytes, at least 1024 bytes);
    with `stack`, a stack's header (istack 2) and then its first image's
    header before the pixels."""
    h, w = img.shape
    lenbyt = max(256, 4 * w)
    labrec = -(-1024 // lenbyt)
    fields = np.zeros(lenbyt * labrec // 4, np.float64)
    fields[[0, 1, 4, 11, 12, 21, 22]] = (1, h, 1, w, labrec, labrec * lenbyt, lenbyt)
    head = fields.copy()
    if stack:
        head[[23, 25]] = (2, 1)  # istack, maxim
    out = head.astype(endian + "f4").tobytes()
    if stack:
        image = fields.copy()
        image[26] = 1  # imgnum
        out += image.astype(endian + "f4").tobytes()
    return out + img.astype(endian + "f4").tobytes()


def _spider(endian, stack=False):
    def build(path, rng):
        img = _texture(rng, 12, 19).astype(np.float32) + rng.uniform(0, 0.99, (12, 19)).astype(
            np.float32) - 3.0
        _write(path, _spider_bytes(img, endian, stack))
    return build


# -- TGA ----------------------------------------------------------------------


def _tga_rle(raw: bytes, depth: int, row_px: int, rng) -> bytes:
    """Pixels (depth bytes each) as TGA RLE packets: runs within a row,
    literals across rows."""
    out, n, i = b"", len(raw) // depth, 0
    px = [raw[k * depth : (k + 1) * depth] for k in range(n)]
    while i < n:
        k = 1
        while i + k < n and k < 128 and px[i + k] == px[i] and (i + k) % row_px:
            k += 1
        if k > 1:
            out += bytes([0x80 | (k - 1)]) + px[i]
        else:
            k = min(int(rng.randint(1, 40)), n - i)
            out += bytes([k - 1]) + b"".join(px[i : i + k])
        i += k
    return out


def _tga_file(image_type, depth, rows: bytes, size, rng, cmap=None, id_field=b"", flags=0):
    """A TGA of `rows` (the file's order); cmap = (first index, entry
    bits, entries bytes)."""
    w, h = size
    start, bits, entries = cmap or (0, 0, b"")
    count = len(entries) // max(1, (bits + 7) // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), int(cmap is not None), image_type, start,
                       count, bits, 0, 0, w, h, depth, flags)
    data = rows if image_type < 8 else _tga_rle(rows, max(depth // 8, 1), w, rng)
    return head + id_field + entries + data


def _tga(kind):
    def build(path, rng):
        w, h = 15, 9
        idx = (_texture(rng, h, w) // 4).astype(np.uint8)  # 64 colours: repeats for runs
        rle = 8 if "RLE" in kind else 0
        flags = 0x20 if "top-down" in kind else 0
        flags |= 0x10 if "mirrored" in kind else 0
        id_field = b"cybervision" if "ID field" in kind else b""
        if kind.startswith("colour-mapped"):
            bits = 16 if "16-bit" in kind else 24
            start = 5 if "first index" in kind else 0
            entries = rng.randint(0, 256, (64 - start) * bits // 8).astype(np.uint8).tobytes()
            data = _tga_file(1 | rle, 8, idx.tobytes(), (w, h), rng, (start, bits, entries),
                             id_field, flags)
        elif kind.startswith("gray with a colour map"):
            entries = rng.randint(0, 256, 64 * 3).astype(np.uint8).tobytes()
            data = _tga_file(3 | rle, 8, idx.tobytes(), (w, h), rng, (0, 24, entries), id_field,
                             flags)
        elif kind.startswith("gray-alpha with a colour map"):
            la = np.stack([idx, _texture(rng, h, w)], axis=-1)
            entries = rng.randint(0, 256, 64 * 3).astype(np.uint8).tobytes()
            data = _tga_file(3 | rle, 16, la.tobytes(), (w, h), rng, (0, 24, entries), flags=flags)
        elif kind.startswith("16-bit"):
            px = rng.randint(0, 65536, (h, w)).astype("<u2")
            px[:, ::3] = px[:, :1]  # runs
            data = _tga_file(2 | rle, 16, px.tobytes(), (w, h), rng, id_field=id_field, flags=flags)
        elif kind.startswith("1-bit"):
            rows = np.packbits(rng.randint(0, 2, (h, w)).astype(np.uint8), axis=1)
            data = _tga_file(3, 1, rows.tobytes(), (w, h), rng, flags=flags)
        else:  # BGR(A)
            depth = 32 if "32" in kind else 24
            px = (_texture(rng, h, w, depth // 8) // 8 * 8).astype(np.uint8)
            data = _tga_file(2 | rle, depth, px.tobytes(), (w, h), rng, id_field=id_field,
                             flags=flags)
        _write(path, data)
    return build


# -- SGI ----------------------------------------------------------------------


def _sgi_rle_row(vals, bpc: int, rng) -> bytes:
    out, i, n = b"", 0, len(vals)
    while i < n:
        k = 1
        while i + k < n and k < 127 and vals[i + k] == vals[i]:
            k += 1
        if k > 1:
            out += (b"\0" if bpc == 2 else b"") + bytes([k]) + int(vals[i]).to_bytes(bpc, "big")
        else:
            k = min(int(rng.randint(1, 20)), n - i)
            out += (b"\0" if bpc == 2 else b"") + bytes([0x80 | k])
            out += b"".join(int(v).to_bytes(bpc, "big") for v in vals[i : i + k])
        i += k
    return out + b"\0" * bpc


def _sgi_file(planes: np.ndarray, bpc: int, rng, rle=True, dim=None, short_row=None) -> bytes:
    """An SGI of (z, h, w) samples (the file's order: bottom row first),
    RLE rows (one of them cut short when `short_row` = (z, row)) or
    uncompressed planes."""
    z, h, w = planes.shape
    dim = dim or (3 if z > 1 else 2)
    head = struct.pack(">hBBHHHH", 474, int(rle), bpc, dim, w, h, z).ljust(512, b"\0")
    if not rle:
        return head + planes.astype(">u2" if bpc == 2 else np.uint8).tobytes()
    rows, starts, lengths = b"", [], []
    base = 512 + 8 * z * h
    for c in range(z):
        for y in range(h):
            vals = planes[c, y][: w // 2] if short_row == (c, y) else planes[c, y]
            r = _sgi_rle_row(vals, bpc, rng)
            starts.append(base + len(rows))
            lengths.append(len(r) // bpc)
            rows += r
    tables = struct.pack(f">{z * h}I", *starts) + struct.pack(f">{z * h}I", *lengths)
    return head + tables + rows


def _sgi(kind):
    def build(path, rng):
        z = {"L": 1, "RGB": 3, "RGBA": 4}[kind.split()[0]]
        bpc = 2 if "16-bit" in kind else 1
        planes = (_texture(rng, 9, 13, z) // 8 * 8).astype(np.int64).transpose(2, 0, 1)
        if bpc == 2:
            planes = planes * 257 + rng.randint(0, 256, planes.shape)
        _write(path, _sgi_file(planes, bpc, rng, rle="RLE" in kind,
                               dim=1 if "dimension 1" in kind else None,
                               short_row=(0, 3) if "short row" in kind else None))
    return build


# -- PCX ----------------------------------------------------------------------


def _pcx_rle(line: bytes) -> bytes:
    out, i = b"", 0
    while i < len(line):
        k = 1
        while i + k < len(line) and line[i + k] == line[i] and k < 63:
            k += 1
        out += bytes([0xC0 | k, line[i]]) if k > 1 or line[i] >= 0xC0 else line[i : i + 1]
        i += k
    return out


def _pcx_file(bits, planes, lines: np.ndarray, w, stride, version=5, pal16=b"", tail=b"",
              origin=(0, 0)) -> bytes:
    """A PCX of (h, planes * stride) uint8 lines, run-length coded line by
    line."""
    h = len(lines)
    x0, y0 = origin
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0, x0 + w - 1, y0 + h - 1, 72, 72)
    head += pal16.ljust(48, b"\0") + bytes([0, planes]) + struct.pack("<HH", stride, 1)
    return head.ljust(128, b"\0") + b"".join(_pcx_rle(row.tobytes()) for row in lines) + tail


def _pcx(kind):
    def build(path, rng):
        h, w = 7, 22
        pal16 = rng.randint(0, 256, 48).astype(np.uint8).tobytes()
        if kind.startswith("1-bit"):
            planes = int(kind.split("x ")[1].split(" ")[0])
            stride = (w + 7) // 8
            stride += stride % 2
            lines = rng.randint(0, 256, (h, planes * stride)).astype(np.uint8)
            _write(path, _pcx_file(1, planes, lines, w, stride, pal16=pal16,
                                   origin=(3, 2) if "origin" in kind else (0, 0)))
        else:
            px = _texture(rng, h, w, 3)
            if kind.startswith("8-bit gray"):
                ramp = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
                tail = b"\x0c" + ramp if "gray palette" in kind else b""
                lines = px[:, :, 0]
                data = _pcx_file(8, 1, lines, w, w, tail=tail)
                if not tail:
                    data += bytes(769)  # Pillow seeks 769 bytes back from the end
            else:
                lines = np.ascontiguousarray(px.transpose(0, 2, 1)).reshape(h, 3 * w)
                data = _pcx_file(8, 3, lines, w, w)
            _write(path, data)
    return build


# -- QOI ----------------------------------------------------------------------


def _qoi_ops(path, rng):
    """A QOI op stream of every op, an INDEX of a slot never written first
    (alpha 0 then carried by DIFF and LUMA), 4 channels declared 3."""
    w, h = 9, 7
    ops = bytes([0x05])  # INDEX of an empty slot: (0, 0, 0, 0)
    for _ in range(w * h):
        r = rng.rand()
        if r < 0.2:
            ops += bytes([0xFE]) + rng.randint(0, 256, 3).astype(np.uint8).tobytes()
        elif r < 0.3:
            ops += bytes([0xFF]) + rng.randint(0, 256, 4).astype(np.uint8).tobytes()
        elif r < 0.5:
            ops += bytes([rng.randint(0, 64)])
        elif r < 0.7:
            ops += bytes([0x40 | rng.randint(0, 64)])
        elif r < 0.85:
            ops += bytes([0x80 | rng.randint(0, 64), rng.randint(0, 256)])
        else:
            ops += bytes([0xC0 | rng.randint(0, 62)])
    _write(path, b"qoif" + struct.pack(">II", w, h) + bytes([3, 0]) + ops + bytes(7) + b"\1")


# -- LA, PA and CMYK TIFF -------------------------------------------------------


def _tiff_kind(kind):
    def build(path, rng):
        h, w = 19, 23
        endian = ">" if "(MM)" in kind else "<"
        layout = {"compression": 5 if "LZW" in kind else 8 if "deflate" in kind else 1,
                  "planar": "planar" in kind, "tile": (16, 16) if "tiled" in kind else None,
                  "endian": endian}
        if kind.startswith("LA"):
            _tiff_file(path, _texture(rng, h, w, 2), photometric=1, extra=(2,), **layout)
        elif kind.startswith(("PA", "PX")):
            cmap = [int(v) for v in rng.randint(0, 65536, 768)]
            _tiff_file(path, _texture(rng, h, w, 2), photometric=3,
                       extra=(2,) if kind.startswith("PA") else (0,),
                       extra_tags=[(320, 3, cmap)], **layout)
        else:
            extras = kind.count("X")
            px = _texture(rng, h, w, 4 + extras)
            if "16-bit" in kind:
                px = px.astype(np.uint16) * 257 + rng.randint(0, 256, px.shape).astype(np.uint16)
            _tiff_file(path, px, photometric=5, extra=(0,) * extras or None, **layout)
    return build


CASES = {
    # Netpbm, written by Pillow
    "pgm L": ("pgm", _saved("PPM", "L")),
    "pgm I;16 (maxval 65535)": ("pgm", _saved("PPM", "I;16")),
    "ppm RGB": ("ppm", _saved("PPM", "RGB", 3)),
    "pbm 1": ("pbm", _saved("PPM", "1")),
    "pfm F": ("pfm", _saved("PPM", "F")),
    # Netpbm, by hand
    "pbm P1 plain, comments": ("pbm", _netpbm("P1 plain, comments")),
    "pgm P2 plain maxval 255, comments": ("pgm", _netpbm("P2 maxval 255, comments")),
    "pgm P2 plain maxval 1000": ("pgm", _netpbm("P2 maxval 1000,")),
    "ppm P3 plain maxval 100, comments": ("ppm", _netpbm("P3 maxval 100, comments")),
    "ppm P3 plain maxval 65535": ("ppm", _netpbm("P3 maxval 65535,")),
    "pgm P5 maxval 100": ("pgm", _netpbm("P5 maxval 100,")),
    "pgm P5 maxval 1000": ("pgm", _netpbm("P5 maxval 1000,")),
    "pgm P5 maxval 65535, 8-bit values": ("pgm", _netpbm("P5 maxval 65535, 8-bit values")),
    "ppm P6 maxval 1000": ("ppm", _netpbm("P6 maxval 1000,")),
    "ppm P6 maxval 65535": ("ppm", _netpbm("P6 maxval 65535,")),
    "pfm big-endian": ("pfm", _netpbm("Pf big-endian")),
    "pfm little-endian, NaN and infinities": ("pfm", _netpbm("Pf little-endian")),
    "pgm header tokens split by a comment": ("pgm", _netpbm("P5 header tokens split by a comment")),
    "pnm P0CMYK maxval 255": ("pnm", _netpbm("P0CMYK 255")),
    "pnm PyRGBA maxval 100": ("pnm", _netpbm("PyRGBA 100")),
    "pnm PyP maxval 255": ("pnm", _netpbm("PyP 255")),
    # SPIDER
    "spider written by Pillow": ("spi", _saved("SPIDER", "F")),
    "spider big-endian": ("spi", _spider(">")),
    "spider little-endian": ("spi", _spider("<")),
    "spider stack, first image (MM)": ("spi", _spider(">", stack=True)),
    "spider stack, first image": ("spi", _spider("<", stack=True)),
    # TGA, written by Pillow
    **{f"tga {mode}{' RLE' * rle}{' top-down' * top}": (
        "tga", _saved("TGA", mode, {"LA": 2, "RGB": 3, "RGBA": 4}.get(mode), rle=rle,
                      orientation=1 if top else -1))
       for mode in ("L", "LA", "P", "RGB", "RGBA") for rle in (False, True)
       for top in (False, True) if not (top and mode in ("LA", "RGBA"))},
    "tga 1": ("tga", _saved("TGA", "1")),
    # TGA, by hand
    "tga colour-mapped 16-bit entries": ("tga", _tga("colour-mapped 16-bit")),
    "tga colour-mapped 16-bit entries RLE, first index, ID field": (
        "tga", _tga("colour-mapped 16-bit RLE first index ID field")),
    "tga colour-mapped 24-bit entries, first index, top-down": (
        "tga", _tga("colour-mapped 24-bit first index top-down")),
    "tga colour-mapped RLE, mirrored": ("tga", _tga("colour-mapped 24-bit RLE mirrored")),
    "tga gray with a colour map": ("tga", _tga("gray with a colour map")),
    "tga gray with a colour map RLE, top-down": (
        "tga", _tga("gray with a colour map RLE top-down")),
    "tga gray-alpha with a colour map": ("tga", _tga("gray-alpha with a colour map")),
    "tga 16-bit 5-5-5, ID field": ("tga", _tga("16-bit ID field")),
    "tga 16-bit 5-5-5 RLE, top-down, mirrored": ("tga", _tga("16-bit RLE top-down mirrored")),
    "tga 1-bit, mirrored": ("tga", _tga("1-bit mirrored")),
    "tga BGR RLE, ID field": ("tga", _tga("BGR RLE ID field")),
    "tga BGRA 32 RLE, top-down": ("tga", _tga("BGRA 32 RLE top-down")),
    # SGI
    "sgi L": ("sgi", _saved("SGI", "L")),
    "sgi RGB": ("sgi", _saved("SGI", "RGB", 3)),
    "sgi RGBA": ("sgi", _saved("SGI", "RGBA", 4)),
    "sgi L 16-bit (Pillow, bpc 2)": ("sgi", _saved("SGI", "L", bpc=2)),
    "sgi RGB 16-bit (Pillow, bpc 2)": ("sgi", _saved("SGI", "RGB", 3, bpc=2)),
    "sgi L RLE": ("sgi", _sgi("L RLE")),
    "sgi L RLE, dimension 1": ("sgi", _sgi("L RLE dimension 1")),
    "sgi RGB RLE": ("sgi", _sgi("RGB RLE")),
    "sgi RGBA RLE, a short row": ("sgi", _sgi("RGBA RLE short row")),
    "sgi L RLE 16-bit": ("sgi", _sgi("L RLE 16-bit")),
    "sgi RGBA RLE 16-bit": ("sgi", _sgi("RGBA RLE 16-bit")),
    "sgi RGB 16-bit uncompressed": ("sgi", _sgi("RGB 16-bit")),
    # PCX
    "pcx 1 (Pillow)": ("pcx", _saved("PCX", "1", size=(9, 30))),
    "pcx L (Pillow)": ("pcx", _saved("PCX", "L")),
    "pcx P (Pillow)": ("pcx", _saved("PCX", "P")),
    "pcx RGB (Pillow)": ("pcx", _saved("PCX", "RGB", 3, size=(9, 20))),
    "pcx 1-bit x 1 plane": ("pcx", _pcx("1-bit x 1 plane")),
    "pcx 1-bit x 2 planes": ("pcx", _pcx("1-bit x 2 planes")),
    "pcx 1-bit x 4 planes, origin": ("pcx", _pcx("1-bit x 4 planes origin")),
    "pcx 8-bit gray palette": ("pcx", _pcx("8-bit gray palette")),
    "pcx 8-bit gray, no palette": ("pcx", _pcx("8-bit gray")),
    "pcx 8-bit x 3 planes": ("pcx", _pcx("RGB")),
    # QOI
    "qoi RGB": ("qoi", _saved("QOI", "RGB", 3)),
    "qoi RGBA": ("qoi", _saved("QOI", "RGBA", 4)),
    "qoi every op, an empty index slot": ("qoi", _qoi_ops),
    # TIFF
    "tif LA (Pillow)": ("tif", _saved("TIFF", "LA", 2)),
    "tif PA (Pillow)": ("tif", _saved("TIFF", "PA", 2)),
    "tif CMYK (Pillow)": ("tif", _saved("TIFF", "CMYK", 4)),
    "tif CMYK LZW (Pillow)": ("tif", _saved("TIFF", "CMYK", 4, compression="tiff_lzw")),
    "tif LA (MM)": ("tif", _tiff_kind("LA (MM)")),
    "tif LA LZW planar": ("tif", _tiff_kind("LA LZW planar")),
    "tif PA deflate tiled": ("tif", _tiff_kind("PA deflate tiled")),
    "tif PA LZW planar": ("tif", _tiff_kind("PA LZW planar")),
    "tif PX (palette + extra sample)": ("tif", _tiff_kind("PX")),
    "tif CMYK deflate planar (MM)": ("tif", _tiff_kind("CMYK deflate planar (MM)")),
    "tif CMYKX": ("tif", _tiff_kind("CMYKX")),
    "tif CMYKXX LZW tiled": ("tif", _tiff_kind("CMYKXX LZW tiled")),
    "tif CMYK 16-bit": ("tif", _tiff_kind("CMYK 16-bit")),
    "tif CMYK 16-bit (MM) LZW": ("tif", _tiff_kind("CMYK 16-bit (MM) LZW")),
}


def _write_case(tmp_path, name: str) -> str:
    ext, build = CASES[name]
    path = str(tmp_path / f"case.{ext}")
    build(path, np.random.RandomState(sorted(CASES).index(name)))
    return path


@pytest.mark.parametrize("name", sorted(CASES))
def test_raster_formats_match_jax(tmp_path, name):
    _assert_same(_write_case(tmp_path, name))


def test_plain_netpbm_across_read_blocks(tmp_path):
    """A plain PGM past Pillow's 1 MiB read blocks, with a comment across
    the first block's end: the plain decoder's stitching of comments and
    split samples (PpmPlainDecoder) gives the same plane."""
    rng = np.random.RandomState(21)
    h, w = 300, 1000
    header = b"P2\n%d %d\n999\n" % (w, h)
    body = b" ".join(b"%d" % v for v in rng.randint(0, 1000, h * w))
    cut = 1024 * 1024 - 4  # the comment starts in the first block, ends in the second
    body = body[:cut] + b" # a comment across the block's end\n" + body[cut:]
    path = str(tmp_path / "big.pgm")
    _write(path, header + body + b"\n")
    assert len(body) > 1024 * 1024
    _assert_same(path)


def test_two_frame_mpo_reads_its_first_frame_and_focal_length(tmp_path):
    """MPO, the stereo cameras' format, which Pillow opens as a JPEG with
    more frames: a two-frame file with EXIF 41989 = 43 reads as the JAX
    package reads it (the first frame, the focal length)."""
    rng = np.random.RandomState(22)
    a, b = (Image.fromarray(_texture(rng, 32, 40, 3)) for _ in range(2))
    path = str(tmp_path / "pair.mpo")
    a.save(path, "MPO", save_all=True, append_images=[b], exif=_exif_bytes(sub={41989: 43}))
    with Image.open(path) as im:
        assert im.format == "MPO" and im.n_frames == 2
    _assert_same(path)
    assert timages.read_metadata(path).focal_length_35mm == 43


# -- what Pillow refuses, or misreads -------------------------------------------


def _refused(kind, path, rng):
    """A file of a kind Pillow 12.1 does not read."""
    idx = (_texture(rng, 6, 9) // 8).astype(np.uint8)
    if kind.startswith("tga"):
        bits = {"tga 15-bit colour map": 15, "tga 32-bit colour map": 32}.get(kind, 24)
        n = 40 if "past 256" not in kind else 60
        entries = bytes(n * ((bits + 7) // 8))
        if kind == "tga 1-bit RLE":
            head = struct.pack("<BBBHHBHHHHBB", 0, 0, 11, 0, 0, 0, 0, 0, 8, 2, 1, 0)
            data = head + b"\x81\xff" * 4
        elif kind == "tga RGB with a colour map":
            data = _tga_file(2, 24, _texture(rng, 6, 9, 3).tobytes(), (9, 6), rng, (0, 24, entries))
        else:
            data = _tga_file(1, 8, idx.tobytes(), (9, 6), rng, (200 if "past 256" in kind else 0,
                                                                 bits, entries))
    elif kind.startswith("pcx"):
        bits, planes = {"pcx 2 bits x 1 plane": (2, 1), "pcx 4 bits x 1 plane": (4, 1),
                        "pcx 8 bits x 4 planes": (8, 4)}.get(kind, (8, 1))
        stride = (9 * bits + 7) // 8
        stride += stride % 2
        lines = rng.randint(0, 256, (6, planes * stride)).astype(np.uint8)
        data = _pcx_file(bits, planes, lines, 9, stride)  # shorter than 769 bytes
    elif kind == "pam (P7)":
        data = b"P7\nWIDTH 9\nHEIGHT 6\nDEPTH 1\nMAXVAL 255\nTUPLTYPE GRAYSCALE\nENDHDR\n"
        data += idx.tobytes()
    elif kind == "pfm colour (PF)":
        data = b"PF\n9 6\n-1.0\n" + np.zeros(162, "<f4").tobytes()
    elif kind == "pgm maxval 0":
        data = b"P5 9 6 0\n" + idx.tobytes()
    elif kind == "sgi dimension 3, 2 channels":
        data = _sgi_file(np.zeros((2, 6, 9), np.int64), 1, rng, rle=False)
    elif kind == "spider image inside a stack":
        data = bytearray(_spider_bytes(np.zeros((6, 9), np.float32), "<"))
        data[26 * 4 : 27 * 4] = struct.pack("<f", 1.0)  # imgnum without the stack's header
        data = bytes(data)
    elif kind == "tif LA min-is-white":
        _tiff_file(path, _texture(rng, 6, 9, 2), photometric=0, extra=(2,))
        return
    else:  # "tif CMYK with alpha"
        _tiff_file(path, _texture(rng, 6, 9, 5), photometric=5, extra=(2,))
        return
    _write(path, data)


REFUSED = ["tga 15-bit colour map", "tga 32-bit colour map", "tga colour map past 256 entries",
           "tga RGB with a colour map", "tga 1-bit RLE", "pcx 2 bits x 1 plane",
           "pcx 4 bits x 1 plane", "pcx 8 bits x 4 planes", "pcx 8-bit under 769 bytes",
           "pam (P7)", "pfm colour (PF)", "pgm maxval 0", "sgi dimension 3, 2 channels",
           "spider image inside a stack", "tif LA min-is-white", "tif CMYK with alpha"]


@pytest.mark.parametrize("kind", REFUSED)
def test_kinds_pillow_refuses_are_refused(tmp_path, kind):
    """Layouts Pillow 12.1 does not read (no entry in its plugin's mode
    table, a palette raw mode it lacks, a seek before the file's start,
    a stack image opened alone): the JAX package's load raises, and so
    does the port's, with an ImageError the CLI reports as a failed run."""
    path = str(tmp_path / "refused.bin")
    _refused(kind, path, np.random.RandomState(REFUSED.index(kind)))
    assert isinstance(_jax_load(path), Exception)
    with pytest.raises(ImageError):
        timages.SourceImage.load(path).load_rgb_plane()


def _misread(kind, path, twin, rng):
    """A valid file Pillow 12.1 misreads or cannot load, and its twin of
    the same pixels in a layout Pillow reads."""
    if kind.startswith("pcx"):
        w = 3 if "3 pixels" in kind else 6
        px = _texture(rng, 5, w, 3)
        if "RGB" in kind:
            pad = lambda p: np.pad(p, ((0, 0), (0, 0), (0, 1)))  # noqa: E731
            lines = pad(px.transpose(0, 2, 1)).reshape(5, -1)
            _write(path, _pcx_file(8, 3, lines, w, w + 1))
            _write(twin, _pcx_file(8, 3, px.transpose(0, 2, 1).reshape(5, -1), w, w))
        else:  # BytesPerLine past the even-rounded row
            tail = b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
            _write(path, _pcx_file(8, 1, np.pad(px[:, :, 0], ((0, 0), (0, 4))), w, w + 4,
                                   tail=tail))
            _write(twin, _pcx_file(8, 1, px[:, :, 0], w, w, tail=tail))
        return
    photometric, extra, spp = {"tif LA": (1, (2,), 2), "tif PA": (3, (2,), 2),
                               "tif PX": (3, (0,), 2), "tif CMYKX": (5, (0,), 5),
                               "tif CMYK": (5, None, 4)}[kind.split(" planar")[0]]
    px = _texture(rng, 13, 11, spp)
    if "16-bit" in kind:
        px = px.astype(np.uint16) * 257 + 7
    tags = [(320, 3, [int(v) for v in rng.randint(0, 65536, 768)])] if photometric == 3 else []
    compression = 5 if "LZW" in kind else 1
    _tiff_file(path, px, photometric=photometric, extra=extra, planar=True,
               compression=compression, extra_tags=tags)
    _tiff_file(twin, px, photometric=photometric, extra=extra, extra_tags=tags)


MISREAD = ["pcx RGB 3 pixels wide, BytesPerLine 4", "pcx L, BytesPerLine past the row",
           "tif LA planar", "tif PA planar", "tif PX planar LZW", "tif CMYKX planar",
           "tif CMYKX planar LZW", "tif CMYK planar 16-bit"]


@pytest.mark.parametrize("kind", MISREAD)
def test_files_pillow_misreads_decode_as_their_twins(tmp_path, kind):
    """Where Pillow 12.1 misreads a valid file (it ignores a PCX's
    BytesPerLine past its own even count and leaves the planes of a 1- or
    3-pixel-wide 8 x 3 row unmoved; it reads planar TIFF with extra
    samples, and uncompressed planar 16-bit CMYK, a plane at a time in
    the wrong raw mode), the port reads the file as the specification
    says: as Pillow reads its twin."""
    path, twin = str(tmp_path / "misread.bin"), str(tmp_path / "twin.bin")
    _misread(kind, path, twin, np.random.RandomState(MISREAD.index(kind) + 50))
    twin_src, twin_rgb = _jax_load(twin)
    ref = _jax_load(path)
    if not isinstance(ref, Exception):
        assert not np.array_equal(ref[1], twin_rgb)  # Pillow's reading is not the image
    src = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src.img, twin_src.img)
    np.testing.assert_array_equal(src.load_rgb_plane(), twin_rgb)


# -- Pillow's plugin order --------------------------------------------------------


def _order_case(kind, path, rng):
    idx = _texture(rng, 6, 9)
    tga = _tga_file(3, 8, idx.tobytes(), (9, 6), rng)
    if kind == "tga behind the CUR magic":
        # 00 00 02 00: CUR's magic, but a cursor directory of no entries,
        # so Pillow's CUR plugin passes the file on to TGA.
        data = _tga_file(2, 24, _texture(rng, 6, 9, 3).tobytes(), (9, 6), rng)
        assert data.startswith(b"\0\0\2\0")
    elif kind == "tga after SPIDER's checks":
        data = tga
    elif kind == "spider before tga":
        data = _spider_bytes(idx.astype(np.float32), "<")
    else:  # an IM header in front of a TGA's bytes
        data = b"Image type: L\r\nImage size (x*y): 9*6\r\n" + b"\0" * 400 + b"\x1a" + idx.tobytes()
    _write(path, data)


def test_identify_walks_pillows_plugin_order():
    """imageio.identify tries the plugins in the order Pillow 12.1's
    Image.open tries them in a process that has imported no plugin
    itself, as the JAX package's CLI (preinit's five first, then init's):
    every one of them. (A process that imports a plugin module first, as
    this test file's imports do, registers that plugin earlier.)"""
    import subprocess

    order = subprocess.run(
        [sys.executable, "-c", "from PIL import Image; Image.preinit(); Image.init();"
         " print(' '.join(Image.ID))"], capture_output=True, text=True, check=True).stdout.split()
    assert [name for name, _, _ in imageio._PLUGINS] == order


@pytest.mark.parametrize("kind", ["tga behind the CUR magic", "tga after SPIDER's checks",
                                  "spider before tga", "im before tga"])
def test_files_reach_the_plugin_pillow_picks(tmp_path, kind):
    """TGA and SPIDER have no magic: Pillow gives a file to the first
    plugin in its order whose checks it passes. The port follows that
    order: a TGA starting with CUR's magic (no cursor entries) is a TGA,
    a SPIDER header is SPIDER's, and an IM header before TGA-like bytes
    is IM's (read by imageio/im.py, or refused by name while the readers
    did not take IM)."""
    path = str(tmp_path / "order.bin")
    _order_case(kind, path, np.random.RandomState(30))
    with Image.open(path) as im:
        pillow_format = im.format
    f = None
    try:
        f = imageio.open_image(path)
    except UnsupportedImageError as err:
        assert pillow_format == "IM" and "IM (LabEye IFUNC) is not supported yet" in str(err)
        return
    assert f.format == pillow_format
    _assert_same(path)


# -- without the native library --------------------------------------------------


def test_rle_formats_without_native_name_the_compiler(tmp_path, monkeypatch):
    """No fallback: without the native library an RLE TGA or SGI, a PCX
    and a QOI raise an error that says what is missing; the uncompressed
    TGA, SGI, Netpbm and SPIDER files still read through numpy."""
    native_only = ["tga colour-mapped RLE, mirrored", "sgi L RLE", "pcx P (Pillow)", "qoi RGB"]
    numpy_paths = ["tga RGB", "sgi RGB", "pgm P5 maxval 1000", "pbm P1 plain, comments",
                   "spider big-endian", "tga colour-mapped 24-bit entries, first index, top-down"]
    paths = {}
    for k, name in enumerate(native_only + numpy_paths):
        (tmp_path / str(k)).mkdir()
        paths[name] = _write_case(tmp_path / str(k), name)
    planes = {n: timages.SourceImage.load(paths[n]).img for n in numpy_paths}

    def refuse():
        raise ImportError("no native library")

    monkeypatch.setattr(native, "load", refuse)
    for name in native_only:
        with pytest.raises(NativeDecoderError, match="C\\+\\+ compiler"):
            timages.SourceImage.load(paths[name])
    for name in numpy_paths:
        np.testing.assert_array_equal(timages.SourceImage.load(paths[name]).img, planes[name])


# -- the CLI from PGM files -----------------------------------------------------


def test_cli_cpu_pgm_pair_ply_matches_jax_without_pillow(tmp_path, monkeypatch):
    """tests/test_pipeline.py's 160x160 SEM pair as PGMs, one 8-bit
    written by Pillow and one of 16-bit samples (maxval 65535, the gray
    values unscaled) -> PLY through the port's cli.main with every import
    of Pillow blocked: the JAX CLI's PLY (as
    tests/test_torch_pipeline.py's BMP test holds it)."""
    img1, img2, _ = _sem_pair(np.random.RandomState(7))
    pgms = [str(tmp_path / "sem0.pgm"), str(tmp_path / "sem1.pgm")]
    Image.fromarray(img1).save(pgms[0])
    _write(pgms[1], b"P5\n160 160\n65535\n" + img2.astype(">u2").tobytes())
    for p, img in zip(pgms, (img1, img2)):
        np.testing.assert_array_equal(timages.SourceImage.load(p).img, img)
    out_j, out_t = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jax_reconstruct(pgms, out_j, _fast_cfg(mesh=JMeshMode.VERTEX_COLORS), quiet=True)
    monkeypatch.setattr(cli, "ReconstructionConfig", _port_fast_cfg)
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)  # any import of Pillow now raises
    rc = cli.main(["--mode=cpu", "--projection=parallel", "--mesh=vertex-colors", *pgms, out_t])
    assert rc == 0
    nv_j, nf_j, cells_j = _read_ply(out_j)
    nv_t, nf_t, cells_t = _read_ply(out_t)
    assert nv_j > 3000 and (nv_t, nf_t) == (nv_j, nf_j)
    assert cells_t.keys() == cells_j.keys()
    zj = np.array([cells_j[k] for k in cells_j])
    zt = np.array([cells_t[k] for k in cells_j])
    assert np.abs(zt - zj).mean() / (zj.max() - zj.min()) < SAME_F_DEPTH_BUDGET


def test_in_memory_round_trip_of_the_writers_here():
    """The test's own TGA RLE and SGI RLE writers decode (through Pillow)
    to the pixels they were given, so a case that passes holds the port
    to a file of known content."""
    rng = np.random.RandomState(23)
    px = (_texture(rng, 8, 11, 3) // 16 * 16).astype(np.uint8)
    data = _tga_file(10, 24, px[:, :, ::-1].tobytes(), (11, 8), rng, flags=0x20)
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im), px)
    planes = (_texture(rng, 5, 7, 3) // 16 * 16).astype(np.int64).transpose(2, 0, 1)
    with Image.open(io.BytesIO(_sgi_file(planes, 1, rng))) as im:
        np.testing.assert_array_equal(np.asarray(im), planes.transpose(1, 2, 0)[::-1])


def test_phase8k_raster_files_decode_to_the_committed_hashes(tmp_path):
    """chip_smoke.raster_files' pairs (phase 3's 1024x1024 SEM pair as
    16-bit PGMs, SPIDER files and CMYK TIFFs, BASELINE #3's views as RLE
    TGAs): Pillow's L and RGB planes have the SHA-256 committed for phase
    8 (k) (torch_formats_sha256.json, "raster"), and so do the port's,
    read with every import of Pillow blocked; the TGAs hold both kinds of
    RLE packet."""
    import hashlib
    import json

    import chip_smoke

    with open(chip_smoke.FORMATS_SHA256) as fh:
        committed = json.load(fh)["raster"]
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    files = chip_smoke.raster_files(str(tmp_path), img1, img2)
    paths = [p for ps in files.values() for p in ps]
    assert sorted(committed) == sorted(p.split("/")[-1] for p in paths)
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa: E731
    for path in paths:
        want = committed[path.split("/")[-1]]
        with Image.open(path) as im:
            assert sha(np.asarray(im.convert("L"))) == want["l"], path
            assert sha(np.asarray(im.convert("RGB"))) == want["rgb"], path
    with chip_smoke._NoPillow():
        for path in paths:
            src = timages.SourceImage.load(path)
            want = committed[path.split("/")[-1]]
            assert (sha(src.img), sha(src.load_rgb_plane())) == (want["l"], want["rgb"]), path
        assert not any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    for path in files["tga"]:
        data = open(path, "rb").read()
        kinds, at, pixels = {True: 0, False: 0}, 18, 0
        while pixels < 320 * 256:
            n = (data[at] & 0x7F) + 1
            kinds[bool(data[at] & 0x80)] += 1
            at += 1 + 3 * (1 if data[at] & 0x80 else n)
            pixels += n
        assert at == len(data) and kinds[True] > 0 and kinds[False] > 0
