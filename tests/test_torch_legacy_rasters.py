"""The port's readers of IM, MSP, XBM, XPM and Sun raster files
(imageio/im.py, msp.py, xbm.py, xpm.py, sun.py and the native library's
sun_rle, msp_rle and im_bits) against the JAX package's, which reads
through Pillow 12.1: for every file the same read_metadata, the same
SourceImage.load gray plane and metadata and the same colour plane, bit
for bit; where Pillow refuses a file the port raises an ImageError.

Files are made at test time from numpy seeds: written by Pillow (IM in
every mode it saves, MSP version 1, XBM) or, for what Pillow does not
write (every IM type of its OPEN table it cannot save, MSP version 2,
XPM, Sun rasters of every depth and file type), by chip_smoke.py's
writers and the variants here, with Pillow as the reader of record.
"""

import io
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from cybervision_tpu import images as jimages
from cybervision_tpu_torch import cli, imageio, native
from cybervision_tpu_torch import config as tcfg
from cybervision_tpu_torch import images as timages
from cybervision_tpu_torch.errors import ImageError
from cybervision_tpu_torch.imageio import NativeDecoderError, convert
from cybervision_tpu_torch.reconstruction import reconstruct as treconstruct

from .test_pipeline import _sem_pair
from .test_torch_images import _jax_load, _meta, _texture
from .test_torch_pipeline import _port_fast_cfg, _read_ply
from .test_torch_raster_formats import _assert_same, _write

torch.set_num_threads(2)

_sun, _im, _msp, _xbm, _xpm = (chip_smoke.sun_raster, chip_smoke.im_file, chip_smoke.msp_file,
                               chip_smoke.xbm_file, chip_smoke.xpm_file)


def _bits(rng, h, w):
    return _texture(rng, h, w) > 128


# -- Sun raster ----------------------------------------------------------------------


def _sun_case(depth, file_type=1, cmap=0, w=13, h=9, flat=False):
    """A Sun raster of a seeded texture; cmap: entries of a colour map;
    flat: runs of equal bytes (and of 0x80) for the byte encoding."""
    def build(path, rng):
        if depth == 1:
            px = _bits(rng, h, w)
        elif depth in (4, 8):
            px = _texture(rng, h, w) >> (8 - depth)
            if flat:
                px[:, : w // 2] = px[0, 0]
                px[1, :] = 0x80 if depth == 8 else 8
        else:
            px = _texture(rng, h, w, 3)
            if flat:
                px[: h // 2] = px[0, 0]
        colours = rng.randint(0, 256, (cmap, 3)).astype(np.uint8) if cmap else None
        _write(path, _sun(px, depth, file_type, colours))
    return build


def _sun_without_last_padding(path, rng):
    data = _sun(_texture(rng, 5, 7), 8, 1)  # rows of 7 bytes padded to 8
    _write(path, data[:-1])


def _sun_short_map(path, rng):
    """An 8-bit raster whose colour map is 7 bytes: 2 entries (the reds,
    greens and blues of 2), the other indices black."""
    data = bytearray(_sun(_texture(rng, 6, 8) // 64, 8, 1, np.zeros((2, 3), np.uint8)))
    data[28:32] = struct.pack(">I", 7)
    _write(path, bytes(data[:32]) + rng.bytes(7) + bytes(data[38:]))


# -- MSP --------------------------------------------------------------------------


def _msp_pillow(path, rng):
    Image.fromarray(_bits(rng, 11, 29)).save(path, "MSP")


def _msp_rows(rows: list[bytes], w: int) -> bytes:
    """A version 2 MSP of the given coded rows."""
    words = [*struct.unpack("<2H", b"LinS"), w, len(rows), 1, 1, 1, 1, w, len(rows), 0, 0, 0,
             0, 0, 0]
    for k in range(12):
        words[12] ^= words[k]
    return struct.pack("<16H", *words) + struct.pack(f"<{len(rows)}H", *map(len, rows)) \
        + b"".join(rows)


def _msp_case(kind):
    def build(path, rng):
        w = 21  # 3 bytes a row
        if kind == "blank rows":
            rows = [b"\x00\x03\x0f", b"", b"\x03\xaa\x55\x01", b""]
        elif kind == "rows of uneven length":  # one stream: rows flow into the next
            rows = [b"\x02\x81\x42", b"\x00\x05\x3c", b"\x01\x99", b"\x04\x12\x34\x56\x78"]
        elif kind == "literal cut by its row":
            rows = [b"\x05\x11\x22\x33", b"\x00\x03\xf0", b"\x00\x06\x0f"]
        else:  # "longer than the image"
            rows = [b"\x00\x09\xa5", b"\x00\x09\x5a", b"\x02\xff\x00"]
        _write(path, _msp_rows(rows, w))
    return build


# -- XBM --------------------------------------------------------------------------


def _xbm_pillow(hotspot=None):
    def build(path, rng):
        im = Image.fromarray(_bits(rng, 10, 19))
        im.save(path, "XBM", **({"hotspot": hotspot} if hotspot else {}))
    return build


def _xbm_hand(kind):
    def build(path, rng):
        bits = _bits(rng, 7, 12)
        data = _xbm(bits, "hand_made")
        if kind == "upper-case hex, other separators":
            head, brace, body = data.partition(b"{")
            data = head + brace + body.replace(b", ", b"\t,").upper().replace(b"0X", b"0x")
        elif kind == "digits that are no hex":
            data = data.replace(b"0x0", b"0xg").replace(b"0xf", b"0x?")
        else:  # "an x in a comment after the bits' name"
            data = data.replace(b"[] = {", b"[] = { /* xz */")
        _write(path, data)
    return build


# -- XPM --------------------------------------------------------------------------


def _xpm_case(n, cpp, kind=""):
    def build(path, rng):
        h, w = 9, 31
        colours = rng.randint(0, 256, (n, 3)).astype(np.uint8)
        idx = np.arange(h * w).reshape(h, w) % n if n > 64 else rng.randint(0, n, (h, w))
        data = _xpm(idx, colours, cpp)
        if kind == "None colour unused":
            data = data.replace(b'",\n/* pixels */', b'",\n"@' + b"@" * (cpp - 1)
                                + b' c None",\n/* pixels */')
            data = data.replace(b'"%d %d %d' % (w, h, n), b'"%d %d %d' % (w, h, n + 1))
        elif kind == "48-bit colours and symbolic keys":
            lines = data.split(b"\n")
            for k in range(3, 3 + n):
                key = lines[k][1 : 1 + cpp]
                lines[k] = b'"' + key + b' s sym%d c #1234%s",' % (k, lines[k][-8:-2])
            data = b"\n".join(lines)
        elif kind == "rows of uneven length":
            lines = data.split(b"\n")
            lines[-4] = lines[-4][:-cpp - 2] + b'",'  # one key short: the rest shift
            lines.insert(-2, b'"' + lines[-3][1 : 1 + cpp] * 7 + b'"')
            data = b"\n".join(lines)
        elif kind == "comments between rows":
            head, mark, rows = data.partition(b"/* pixels */")
            data = head + mark + rows.replace(b'",\n"', b'", /* a row */\n/* note */\n"')
        _write(path, data)
    return build


# -- IM ---------------------------------------------------------------------------


def _im_pillow(mode):
    def build(path, rng):
        h, w = 7, 11
        if mode == "1":
            im = Image.fromarray(_bits(rng, h, w))
        elif mode == "I":
            im = Image.fromarray(rng.randint(-400, 700, (h, w)).astype(np.int32))
        elif mode.startswith("I;16"):
            im = Image.fromarray(rng.randint(0, 1000, (h, w)).astype(np.uint16))
            im = im if mode == "I;16" else im.convert(mode)
        elif mode == "F":
            im = Image.fromarray((rng.randn(h, w) * 200).astype(np.float32))
        elif mode in ("P", "PA"):
            im = Image.fromarray(_texture(rng, h, w, 3)).convert("P", palette=Image.ADAPTIVE,
                                                                 colors=40)
            if mode == "PA":
                im = im.convert("PA")
                im.putalpha(Image.fromarray(_texture(rng, h, w)))
        else:
            im = Image.fromarray(_texture(rng, h, w, 4)).convert(mode)
        im.save(path, "IM")
    return build


_IM_BITS = {"0 1": 1, "L 1": 1, "B1": 1, "B2": 2, "B4": 4, "X 24": 24, "RGB3": 24, "RYB3": 24,
            "L*32": 32, "L 32S": 32}


def _im_raw(image_type, lut=None, bits=None, extra=b"", frames=1):
    """An IM file of `image_type` over seeded raw rows."""
    def build(path, rng):
        h, w = 6, 9
        nbits = bits or _IM_BITS.get(image_type) or 8
        row = (w * nbits + 7) // 8
        data = rng.randint(0, 256, (frames * h * row + 5)).astype(np.uint8).tobytes()
        table = None
        if lut == "colour":
            table = rng.randint(0, 256, (256, 3)).astype(np.uint8)
        elif lut == "gray, not linear":
            table = np.repeat(rng.randint(0, 256, (256, 1)), 3, axis=1).astype(np.uint8)
        head = _im(np.zeros((h, w), np.uint8), image_type, table)
        if image_type in ("L", "P"):  # a mode, not a type of Pillow's table
            head = head.replace(b" image\r\n", b"\r\n", 1)
        _write(path, head[: len(head) - h * w] + data + extra)
    return build


def _im_header_variants(path, rng):
    """"\\n\\r" line ends (IFUNC's), a comment, a scale, a name, no image
    type (so "L"), then NULs and ^Z."""
    head = (b"Comment: made by hand\n\rName: v.im\n\rScale (x,y): 1.5,2\n\r"
            b"Image size (x*y): 9*4\n\r")
    _write(path, head.ljust(400, b"\0") + b"\x1a" + _texture(rng, 4, 9).tobytes())


def _im_typed(image_type, dtype, scale=1.0, shift=0.0):
    """An IM file of `image_type` over seeded samples of `dtype`."""
    def build(path, rng):
        px = (_texture(rng, 6, 9).astype(np.float64) * scale + shift).astype(dtype)
        _write(path, _im(px, image_type))
    return build


CASES = {
    **{f"sun {d}-bit raw": ("ras", _sun_case(d)) for d in (1, 4, 8, 24, 32)},
    **{f"sun {d}-bit byte-encoded": ("ras", _sun_case(d, 2, flat=True)) for d in (1, 4, 8, 24, 32)},
    **{f"sun 8-bit file type {t}": ("ras", _sun_case(8, t, w=12)) for t in (0, 4, 5)},
    "sun 24-bit RGB (type 3)": ("ras", _sun_case(24, 3)),
    "sun 32-bit RGBX (type 3)": ("ras", _sun_case(32, 3)),
    "sun 4-bit colour map of 10 entries": ("ras", _sun_case(4, cmap=10)),
    "sun 8-bit colour map": ("ras", _sun_case(8, cmap=256)),
    "sun 8-bit colour map byte-encoded": ("ras", _sun_case(8, 2, cmap=40, flat=True)),
    "sun 8-bit colour map of 7 bytes": ("ras", _sun_short_map),
    "sun 8-bit without the last row's padding": ("ras", _sun_without_last_padding),
    "sun 8-bit byte-encoded, odd width": ("ras", _sun_case(8, 2, w=7, flat=True)),
    "sun 24-bit byte-encoded, odd width": ("ras", _sun_case(24, 2, w=5, flat=True)),
    "msp v1 (Pillow)": ("msp", _msp_pillow),
    "msp v1, odd width": ("msp", lambda p, r: _write(p, _msp(_bits(r, 9, 13), 1))),
    "msp v2": ("msp", lambda p, r: _write(p, _msp(_bits(r, 12, 37), 2))),
    **{f"msp v2 {k}": ("msp", _msp_case(k)) for k in (
        "blank rows", "rows of uneven length", "literal cut by its row", "longer than the image")},
    "xbm (Pillow)": ("xbm", _xbm_pillow()),
    "xbm with a hot spot (Pillow)": ("xbm", _xbm_pillow((3, 4))),
    **{f"xbm {k}": ("xbm", _xbm_hand(k)) for k in (
        "upper-case hex, other separators", "digits that are no hex",
        "an x in a comment after the bits' name")},
    "xpm 2 colours": ("xpm", _xpm_case(2, 1)),
    "xpm 256 colours (P)": ("xpm", _xpm_case(256, 2)),
    "xpm 257 colours (RGB)": ("xpm", _xpm_case(257, 2)),
    "xpm 279 colours, 3 characters": ("xpm", _xpm_case(279, 3)),
    "xpm None colour unused": ("xpm", _xpm_case(5, 1, "None colour unused")),
    "xpm 48-bit colours and symbolic keys": ("xpm", _xpm_case(6, 1, "48-bit colours and symbolic keys")),
    "xpm rows of uneven length": ("xpm", _xpm_case(7, 2, "rows of uneven length")),
    "xpm comments between rows": ("xpm", _xpm_case(4, 1, "comments between rows")),
    **{f"im {m} (Pillow)": ("im", _im_pillow(m)) for m in (
        "1", "L", "LA", "P", "PA", "I", "I;16", "I;16L", "I;16B", "F", "RGB", "RGBA", "RGBX",
        "CMYK", "YCbCr")},
    **{f"im {t}": ("im", _im_raw(t)) for t in ("0 1", "L 1", "B1", "Grayscale", "X 24", "RGB3",
                                               "RYB3", "L 8", "L 8S", "L*32", "L 32S")},
    "im B2, no Lut (black)": ("im", _im_raw("B2")),
    "im B4, gray Lut": ("im", _im_raw("B4", "gray, not linear")),
    "im B4, colour Lut (8 bits a pixel)": ("im", _im_raw("B4", "colour", bits=8)),
    "im L 32 S": ("im", _im_typed("L 32 S", "<i4", 3.0, -200.0)),
    "im L 32 F (unsigned)": ("im", _im_typed("L 32 F", "<u4", 1e7)),
    "im L 16 (I;16)": ("im", _im_typed("L 16", "<u2", 2.0)),
    "im L 16S": ("im", _im_typed("L 16S", "<i2", 2.0, -100.0)),
    "im L 32F": ("im", _im_typed("L 32F", "<f4", 1.37, -20.25)),
    "im L*16 (float)": ("im", _im_typed("L*16", "<u2", 1.5)),
    "im L 16L": ("im", _im_typed("L 16L", "<u2", 3.0)),
    "im L 16B": ("im", _im_typed("L 16B", ">u2", 3.0)),
    **{f"im L*{n} (bit decoder)": ("im", _im_raw(f"L*{n}", bits=n)) for n in (3, 12, 27, 31)},
    "im type L, not in the table": ("im", _im_raw("L")),
    "im type P, no Lut (black)": ("im", _im_raw("P")),
    "im Greyscale, gray Lut (ignored)": ("im", _im_raw("Greyscale", "gray, not linear")),
    "im Greyscale, colour Lut (P)": ("im", _im_raw("Greyscale", "colour")),
    "im LA, colour Lut (PA)": ("im", _im_raw("LA", "colour", bits=16)),
    "im PA, colour Lut": ("im", _im_raw("PA", "colour", bits=16)),
    "im RGB, Lut (ignored)": ("im", _im_raw("RGB", "colour", bits=24)),
    "im two frames, the first read": ("im", _im_raw("Greyscale", frames=2)),
    "im header of IFUNC line ends, no type": ("im", _im_header_variants),
}


def _write_case(tmp_path, name: str) -> str:
    ext, build = CASES[name]
    path = str(tmp_path / f"case.{ext}")
    build(path, np.random.RandomState(sorted(CASES).index(name)))
    return path


@pytest.mark.parametrize("name", sorted(CASES))
def test_legacy_rasters_match_jax(tmp_path, name):
    _assert_same(_write_case(tmp_path, name))


def test_identify_gives_each_to_pillows_plugin(tmp_path):
    """Each new reader takes the files Pillow's plugin of its name takes."""
    for name in ("sun 8-bit raw", "msp v2", "xbm (Pillow)", "xpm 2 colours", "im L (Pillow)",
                 "im header of IFUNC line ends, no type"):
        path = _write_case(tmp_path, name)
        with Image.open(path) as im:
            assert imageio.open_image(path).format == im.format, name


def test_ycbcr_to_rgb_is_pillows_fixed_point():
    """convert.py's YCbCr -> RGB (ConvertYCbCr.c's tables) equals
    Pillow's for every Cb and Cr at eight Y, and its "L" is Y."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 1, 37, 100, 128, 180, 254, 255):
        px = np.stack([np.full_like(cb, y), cb, cr], axis=2).astype(np.uint8)
        im = Image.fromarray(px, "YCbCr")
        np.testing.assert_array_equal(convert.to_rgb("YCbCr", px, None), np.asarray(im.convert("RGB")))
        np.testing.assert_array_equal(convert.to_l("YCbCr", px, None), np.asarray(im.convert("L")))


# -- what Pillow refuses ----------------------------------------------------------------


def _refused(kind, path, rng):
    px = _texture(rng, 6, 9)
    if kind == "sun 1-bit with a colour map":
        data = _sun(px > 128, 1, 1, np.zeros((2, 3), np.uint8))
    elif kind == "sun 24-bit with a colour map":
        data = _sun(_texture(rng, 6, 9, 3), 24, 1, np.zeros((2, 3), np.uint8))
    elif kind == "sun raw cut short":
        data = _sun(px, 8, 1)[:-12]
    elif kind == "sun byte-encoded cut short":
        data = _sun(px, 8, 2)[:-3]
    elif kind == "sun colour map of type 2":
        data = bytearray(_sun(px, 8, 1, np.zeros((4, 3), np.uint8)))
        data[24:28] = struct.pack(">I", 2)
    elif kind == "sun depth 16":
        data = bytearray(_sun(px, 8, 1))
        data[12:16] = struct.pack(">I", 16)
    elif kind == "sun file type 6":
        data = bytearray(_sun(px, 8, 1))
        data[20:24] = struct.pack(">I", 6)
    elif kind == "msp bad checksum":
        data = bytearray(_msp(px > 128, 1))
        data[24] ^= 1
    elif kind == "msp v1 cut short":
        data = _msp(px > 128, 1)[:-2]
    elif kind == "msp v2 row map cut short":
        data = _msp(px > 128, 2)[:38]
    elif kind == "msp v2 row past the file":
        data = _msp(px > 128, 2)[:-1]
    elif kind == "msp v2 run cut by its row":
        data = _msp_rows([b"\x00\x02\xff", b"\x00\x02"], 16)
    elif kind == "msp v2 short of the image":
        data = _msp_rows([b"\x00\x02\xff", b"\x01\x0f"], 16)
    elif kind == "xbm cut short":
        data = _xbm(px > 128)[:-20]
    elif kind == "xpm colour by name":
        data = _xpm(px % 3, np.zeros((3, 3), np.uint8), 1).replace(b"c #000000", b"c red", 1)
    elif kind == "xpm pixel of the None colour":
        data = _xpm(px % 3, np.zeros((3, 3), np.uint8), 1).replace(b"c #000000", b"c None", 1)
    elif kind == "xpm cut short":
        data = _xpm(px % 3, np.zeros((3, 3), np.uint8), 1)[:-40]
    elif kind == "xpm colour of bad hex":
        data = _xpm(px % 3, np.zeros((3, 3), np.uint8), 1).replace(b"#000000", b"#00zz00", 1)
    elif kind == "xpm colour line without c":
        data = _xpm(px % 3, np.zeros((3, 3), np.uint8), 1).replace(b" c #", b" m #", 1)
    elif kind == "im RLB":
        data = _im(_texture(rng, 6, 9, 3), "RLB")
    elif kind == "im PA without a colour Lut":
        data = _im(_texture(rng, 6, 9, 2), "PA")
    elif kind == "im type of no Pillow mode":
        data = _im(px, "Greyscale").replace(b"Greyscale image", b"Colour image", 1)
    elif kind == "im size of floats":
        data = _im(px, "Greyscale").replace(b"9*6", b"9.0*6", 1)
    elif kind == "im size of three numbers":
        data = _im(px, "Greyscale").replace(b"9*6", b"9*6*1", 1)
    elif kind == "im cut short":
        data = _im(px, "Greyscale")[:-5]
    elif kind == "im L*12 rows cut short":  # each row starts at a new byte
        data = _im(np.zeros((6, 9), np.uint8), "L*12")[:512] + rng.bytes(81)
    else:  # "im Lut cut short"
        data = _im(px, "Greyscale", np.zeros((256, 3), np.uint8))[:512 + 300]
    _write(path, bytes(data))


REFUSED = ["sun 1-bit with a colour map", "sun 24-bit with a colour map", "sun raw cut short",
           "sun byte-encoded cut short", "sun colour map of type 2", "sun depth 16",
           "sun file type 6", "msp bad checksum", "msp v1 cut short", "msp v2 row map cut short",
           "msp v2 row past the file", "msp v2 run cut by its row", "msp v2 short of the image",
           "xbm cut short", "xpm colour by name", "xpm pixel of the None colour", "xpm cut short",
           "xpm colour of bad hex", "xpm colour line without c", "im RLB",
           "im PA without a colour Lut", "im type of no Pillow mode", "im size of floats",
           "im size of three numbers", "im cut short", "im L*12 rows cut short",
           "im Lut cut short"]


@pytest.mark.parametrize("kind", REFUSED)
def test_kinds_pillow_refuses_are_refused(tmp_path, kind):
    """Files Pillow 12.1 does not read (no unpacker for the mode, a map it
    cannot apply, a colour name it does not know, data short of the image,
    a header its plugin rejects): the JAX package's load raises, and so
    does the port's, with an ImageError the CLI reports as a failed run;
    the metadata agree."""
    path = str(tmp_path / "refused.bin")
    _refused(kind, path, np.random.RandomState(REFUSED.index(kind)))
    assert _meta(timages.read_metadata(path)) == _meta(jimages.read_metadata(path))
    assert isinstance(_jax_load(path), Exception)
    with pytest.raises(ImageError):
        timages.SourceImage.load(path).load_rgb_plane()


@pytest.mark.parametrize("kind", ["sun", "msp"])
def test_seeded_rle_damage_reads_where_pillow_reads(tmp_path, kind):
    """Bytes flipped, replaced or cut in byte-encoded Sun rasters (8 and
    24 bits, runs across rows, 0x80 escapes) and version 2 MSP files (row
    maps, runs and literals): the port reads what Pillow reads, the same
    pixels, and raises where it raises."""
    rng = np.random.RandomState(17 if kind == "sun" else 18)
    read = refused = 0
    for it in range(60):
        h, w = rng.randint(2, 14, 2)
        if kind == "sun":
            px = _texture(rng, h, w, 3) if it % 2 else _texture(rng, h, w) // 32 * 32
            px[: h // 2] = 0x80
            data = bytearray(_sun(px, 24 if it % 2 else 8, 2))
        else:
            data = bytearray(_msp(_bits(rng, h, 8 * w), 2))
        for _ in range(int(rng.randint(1, 4))):
            data[int(rng.randint(32, len(data)))] = int(rng.choice([0, 0x80, 0xFF, rng.randint(256)]))
        if it % 5 == 0:
            data = data[: int(rng.randint(33, len(data)))]
        path = str(tmp_path / f"d{it}.{kind}")
        _write(path, bytes(data))
        try:
            with Image.open(path) as im:
                ref = np.asarray(im.convert("L"))
        except (OSError, ValueError):
            ref = None
        if ref is None:
            refused += 1
            with pytest.raises(ImageError):
                timages.SourceImage.load(path)
        else:
            read += 1
            np.testing.assert_array_equal(timages.SourceImage.load(path).img, ref)
    assert read > 10 and refused > 10


# -- without the native library --------------------------------------------------------


def test_coded_kinds_without_native_name_the_compiler(tmp_path, monkeypatch):
    """No fallback: without the native library a byte-encoded Sun raster,
    a version 2 MSP and an IM of packed float samples raise an error that
    says what is missing; raw Sun rasters, version 1 MSP, XBM, XPM and raw
    IM files still read through numpy."""
    native_only = ["sun 8-bit byte-encoded", "msp v2", "im L*12 (bit decoder)"]
    numpy_paths = ["sun 24-bit raw", "msp v1 (Pillow)", "xbm (Pillow)", "xpm 257 colours (RGB)",
                   "im RGB (Pillow)", "im L 32F"]
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


# -- the CLI from Sun rasters ------------------------------------------------------------


def test_cli_cpu_sun_pair_ply_equals_the_in_memory_run_without_pillow(tmp_path, monkeypatch):
    """tests/test_pipeline.py's 160x160 SEM pair as byte-encoded 8-bit Sun
    rasters (ImageMagick's .ras) -> PLY through the port's cli.main with
    every import of Pillow blocked: byte-equal to the port's reconstruct
    on the arrays (tests/test_torch_pipeline.py holds that run to the JAX
    CLI's PLY), as chip_smoke.py's phase 8 (m) holds it on the card."""
    img1, img2, _ = _sem_pair(np.random.RandomState(7))
    paths = [str(tmp_path / "sem0.ras"), str(tmp_path / "sem1.ras")]
    for p, img in zip(paths, (img1, img2)):
        _write(p, _sun(img, 8, 2))
    cfg = dict(projection=tcfg.ProjectionMode.AFFINE, mesh=tcfg.MeshMode.VERTEX_COLORS,
               hardware=tcfg.HardwareMode.CPU)
    ref, out = str(tmp_path / "mem.ply"), str(tmp_path / "port.ply")
    treconstruct(["a", "b"], ref, _port_fast_cfg(**cfg), quiet=True,
                 images=[timages.SourceImage(img1), timages.SourceImage(img2)])
    monkeypatch.setattr(cli, "ReconstructionConfig", _port_fast_cfg)
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)  # any import of Pillow now raises
    rc = cli.main(["--mode=cpu", "--projection=parallel", "--mesh=vertex-colors", *paths, out])
    assert rc == 0
    nv, _, _ = _read_ply(out)
    assert nv > 3000
    with open(ref, "rb") as fa, open(out, "rb") as fb:
        assert fa.read() == fb.read()


# -- phase 8 (m)'s files ------------------------------------------------------------------


def test_writers_here_give_pillow_their_pixels():
    """chip_smoke.py's Sun raster, MSP, XBM, XPM and IM writers decode
    (through Pillow) to the pixels they were given, so a case that passes
    holds the port to a file of known content."""
    rng = np.random.RandomState(24)
    gray, rgb, bits = _texture(rng, 5, 11), _texture(rng, 5, 11, 3), _bits(rng, 5, 11)

    def pillow(data):
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im)

    for depth, ft in ((8, 1), (8, 2), (24, 1), (24, 3), (32, 2)):
        np.testing.assert_array_equal(pillow(_sun(gray if depth == 8 else rgb, depth, ft)),
                                      gray if depth == 8 else rgb)
    np.testing.assert_array_equal(pillow(_sun(bits, 1)), ~bits)
    for v in (1, 2):
        np.testing.assert_array_equal(pillow(_msp(bits, v)), bits)
    np.testing.assert_array_equal(pillow(_xbm(bits)), bits)
    idx = gray % 5
    with Image.open(io.BytesIO(_xpm(idx, rgb[0, :5], 2))) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), rgb[0, :5][idx])
    np.testing.assert_array_equal(pillow(_im(rgb, "RGB")), rgb)


def test_phase8m_files_decode_to_the_committed_hashes(tmp_path):
    """chip_smoke.legacy_files (phase 3's 1024x1024 SEM pair as
    byte-encoded Sun rasters, BASELINE #3's views as IM files, the
    decode-only MSP, XBM, XPM, Sun and IM files) and the committed damaged
    LZMA TIFF: Pillow's L and RGB planes have the SHA-256 committed for
    phase 8 (m) (torch_formats_sha256.json, "legacy", "lzma damaged"), and
    so do the port's, read with every import of Pillow blocked."""
    import hashlib
    import json
    import os

    with open(chip_smoke.FORMATS_SHA256) as fh:
        committed = json.load(fh)
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    files = chip_smoke.legacy_files(str(tmp_path), img1, img2)
    wanted = {p: committed["legacy"][os.path.basename(p)] for ps in files.values() for p in ps}
    assert sorted(committed["legacy"]) == sorted(os.path.basename(p) for p in wanted)
    wanted[chip_smoke.LZMA_DAMAGED_TIFF] = committed["lzma damaged"]
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa: E731
    for path, want in wanted.items():
        with Image.open(path) as im:
            assert (sha(np.asarray(im.convert("L"))), sha(np.asarray(im.convert("RGB")))) == (
                want["l"], want["rgb"]), path
    with chip_smoke._NoPillow():
        for path, want in wanted.items():
            src = timages.SourceImage.load(path)
            assert (sha(src.img), sha(src.load_rgb_plane())) == (want["l"], want["rgb"]), path
        assert not any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
