"""The port's AVIF reader (imageio/avif.py with the native library's AV1
key-frame decoder, native/av1*.cpp, and its YUV->RGB, avifrgb.cpp)
against Pillow 12.1 with libavif 1.3 (dav1d 1.5.1, libyuv 1909), which the
JAX package reads through: imageio's mode and pixels are Pillow's, bit
for bit; the JAX package's gray and colour planes and focal length are
the port's; where Pillow's open passes a file on the port's identify does
too, and where its load fails the port's decode fails; the tools no file
written here uses are refused by name.

The files are written by Pillow (aom 3.12.1) at test time from numpy
seeds, small: a sample of the seeded grid (modes, subsamplings, ranges,
qualities, speeds, tiles, natural and screen-like content), sequences,
and edits of its files for the damaged and refused kinds.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from cybervision_tpu import images as jimages
from cybervision_tpu_torch import images as timages
from cybervision_tpu_torch import imageio
from cybervision_tpu_torch.errors import ImageError

from .test_torch_images import _jax_load, _meta


def _natural(h, w, seed):
    """A smooth field with noise, as SEM images look."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(x / (7 + seed % 13)) * np.cos(y / (11 + seed % 7))
    base = base + rng.normal(0, 10, (h, w))
    img = np.stack([base, base * 0.8 + 30 * np.sin(y / 9.0), 255 - base * 0.9], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _screen(h, w, seed):
    """Few flat colours, hard edges and repeated glyph-like tiles: what
    aom's screen-content detection answers with palette and intra block
    copy."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (3, 3)).astype(np.uint8)
    tile = pal[rng.integers(0, 3, (12, 12))]
    img = np.full((h, w, 3), pal[0], np.uint8)
    for y in range(0, h, 16):
        for x in range(0, w, 15):
            img[y:y + 12, x:x + 12] = tile[:max(0, min(12, h - y)), :max(0, min(12, w - x))]
    img[h // 3:h // 3 + 5, : w // 2] = 20
    return img


def _avif(arr, mode, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "AVIF", **opts)
    return buf.getvalue()


def _pillow(data):
    """(mode, pixels) as Pillow opens and loads `data`; ("open", error) or
    ("load", error) where it fails."""
    try:
        im = Image.open(io.BytesIO(data))
    except Exception as err:  # noqa: BLE001 - Pillow's refusal is the result
        return "open", err
    try:
        im.load()
    except Exception as err:  # noqa: BLE001
        return "load", err
    return im.mode, np.asarray(im)


def _port(data):
    try:
        fmt, parsed = imageio.identify(data)
    except ImageError as err:
        return "open", err
    try:
        mode, px, _ = imageio.ImageFile(fmt, parsed).decode()
    except ImageError as err:
        return "load", err
    return mode, px


def _assert_as_pillow(data):
    ref, got = _pillow(data), _port(data)
    assert ref[0] == got[0], (ref, got)
    if ref[0] not in ("open", "load"):
        np.testing.assert_array_equal(got[1], ref[1])


# (content, h, w, mode, save options): a seeded sample of the grid of
# Pillow's options (modes, subsamplings, ranges, qualities, speeds,
# tiles, sizes, natural and screen-like content).
GRID = {
    "L 4:0:0 q75": ("natural", 31, 40, "L", {"subsampling": "4:0:0"}),
    "L 4:2:0 q0 speed 4": ("natural", 40, 31, "L", {"quality": 0, "speed": 4}),
    "RGB 4:2:0 limited": ("natural", 33, 64, "RGB", {"range": "limited"}),
    "RGB 4:2:2 q90 speed 5": ("natural", 17, 29, "RGB", {"subsampling": "4:2:2",
                                                           "quality": 90, "speed": 5}),
    "RGB 4:4:4 q100 lossless": ("natural", 24, 24, "RGB", {"subsampling": "4:4:4",
                                                             "quality": 100}),
    "RGB 4:0:0 limited": ("natural", 20, 20, "RGB", {"subsampling": "4:0:0",
                                                     "range": "limited"}),
    "RGBA 4:2:0 speed 8": ("natural", 25, 37, "RGBA", {"speed": 8}),
    "RGBA 4:0:0 limited": ("natural", 16, 48, "RGBA", {"subsampling": "4:0:0",
                                                       "range": "limited"}),
    "RGB 1x1": ("natural", 1, 1, "RGB", {}),
    "RGB 2x7 4:2:2": ("natural", 2, 7, "RGB", {"subsampling": "4:2:2"}),
    "RGB 2x2 tiles": ("natural", 128, 128, "RGB", {"tile_rows": 1, "tile_cols": 1,
                                                   "quality": 60}),
    "screen 4:4:4 speed 4": ("screen", 64, 100, "RGB", {"subsampling": "4:4:4", "speed": 4}),
    "screen 4:2:0 lossless": ("screen", 70, 90, "RGB", {"quality": 100, "speed": 6}),
    "screen 4:2:2 q30": ("screen", 66, 80, "RGB", {"subsampling": "4:2:2", "quality": 30,
                                                   "speed": 4}),
    "natural 300x200 q40 autotiled": ("natural", 200, 300, "RGB", {"quality": 40}),
}


def _grid_file(name, seed=0):
    content, h, w, mode, opts = GRID[name]
    img = (_natural if content == "natural" else _screen)(h, w, seed + len(name))
    if mode == "L":
        img = img[:, :, 0]
    elif mode == "RGBA":
        img = np.dstack([img, np.arange(h * w, dtype=np.uint32).reshape(h, w) % 251])
        img = img.astype(np.uint8)
    return _avif(img, mode, **opts)


@pytest.mark.parametrize("name", sorted(GRID))
def test_planes_equal_pillows(name):
    """Every file of the grid sample decodes to Pillow's mode and planes,
    bit for bit, and to its convert("L") and convert("RGB")."""
    data = _grid_file(name)
    mode, ref = _pillow(data)
    got_mode, got = _port(data)
    assert got_mode == mode
    np.testing.assert_array_equal(got, ref)
    im = Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(imageio.to_l(got_mode, got, None), np.asarray(im.convert("L")))
    np.testing.assert_array_equal(imageio.to_rgb(got_mode, got, None),
                                  np.asarray(im.convert("RGB")))


@pytest.mark.parametrize("mode", ["L", "RGBA"])
def test_sequence_gives_its_first_frame(mode):
    """An avis sequence (Pillow's save_all, read from its tracks, the
    alpha from its auxl track) gives the first frame, as Pillow's load
    does."""
    frames = []
    for k in range(3):
        img = _natural(24, 33, k)
        img = img[:, :, 0] if mode == "L" else np.dstack([img, np.full((24, 33), 60 * k + 20,
                                                                       np.uint8)])
        frames.append(Image.fromarray(img, mode))
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:], quality=70)
    assert buf.getvalue()[8:12] == b"avis"
    _assert_as_pillow(buf.getvalue())


def _focal_exif(orientation):
    exif = Image.Exif()
    if orientation:
        exif[0x0112] = orientation
    exif.get_ifd(0x8769)[41989] = 43
    return exif.tobytes()


@pytest.mark.parametrize("case", ["gray 4:0:0", "rgb orientation 6 focal 43", "rgba focal 43"])
def test_jax_loader_equals_ports(tmp_path, case):
    """The JAX package's SourceImage.load, load_rgb and read_metadata
    against the port's on the same AVIF file: equal gray and colour
    arrays and focal length. Pillow's save moves EXIF orientation 6 into
    irot, its open writes it back into the EXIF it reports, and the
    pixels stay unrotated."""
    img = _natural(48, 64, 9)
    if case == "gray 4:0:0":
        data = _avif(img[:, :, 0], "L", subsampling="4:0:0")
    elif case.startswith("rgb orientation"):
        data = _avif(img, "RGB", exif=_focal_exif(6))
        assert b"irot" in data
    else:
        data = _avif(np.dstack([img, img[:, :, 1]]), "RGBA", exif=_focal_exif(0))
    path = str(tmp_path / "v.avif")
    with open(path, "wb") as fh:
        fh.write(data)
    src_j, rgb_j = _jax_load(path)
    src_t = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src_t.img, src_j.img)
    np.testing.assert_array_equal(src_t.load_rgb_plane(), rgb_j)
    assert _meta(timages.read_metadata(path)) == _meta(jimages.read_metadata(path))
    assert src_t.focal_length_35mm == (None if case == "gray 4:0:0" else 43)
    assert src_t.img.shape == (48, 64)


def _cut_points(data):
    return range(0, len(data), 3)


def test_truncated_files_fail_where_pillows_do():
    """A file cut anywhere: Pillow's open passes it on (libavif: truncated
    data, the cut in the meta box or the Exif item) and the port's
    identify does too, or Pillow's load fails (the cut in the image's
    data) and the port's decode does too."""
    img = _natural(24, 40, 1)
    files = [_avif(img, "RGB", exif=_focal_exif(6)),
             _avif(np.dstack([img, img[:, :, 2]]), "RGBA", quality=60)]
    frames = [Image.fromarray(_natural(16, 24, k)) for k in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:])
    files.append(buf.getvalue())
    for data in files:
        for cut in _cut_points(data):
            _assert_as_pillow(data[:cut])


def _edit(data, at, new):
    return data[:at] + new + data[at + len(new):]


def _box(data, kind, nth=0):
    """The offset of the nth box `kind` (its size field)."""
    at = -1
    for _ in range(nth + 1):
        at = data.index(kind, at + 1)
    return at - 4


DAMAGE = {
    "ftyp without avif or avis": lambda d: _edit(d, 16, b"mif1miafMA1Bmif1"),
    "meta not opening with hdlr": lambda d: _edit(d, _box(d, b"hdlr") + 4, b"xdlr"),
    "hdlr handler vide": lambda d: _edit(d, _box(d, b"hdlr") + 16, b"vide"),
    "hdlr pre_defined set": lambda d: _edit(d, _box(d, b"hdlr") + 12, b"\x00\x00\x00\x07"),
    "hdlr version 1": lambda d: _edit(d, _box(d, b"hdlr") + 8, b"\x01"),
    "av1C marker cleared": lambda d: _edit(d, _box(d, b"av1C") + 8, b"\x01"),
    "pixi version 1": lambda d: _edit(d, _box(d, b"pixi") + 8, b"\x01"),
    "pixi 10-bit": lambda d: _edit(d, _box(d, b"pixi") + 13, b"\x0a\x0a\x0a"),
    "no ftyp first": lambda d: _edit(d, 4, b"free"),
    "meta box cut short": lambda d: d[:_box(d, b"meta") + 40],
    "image data past the end": lambda d: d[:-20],
    "item longer than the file": lambda d: _edit(d, _box(d, b"iloc") + 26,
                                                 struct.pack(">I", len(d) + 1)),
    "ispe past libavif's dimension limit": lambda d: _edit(d, _box(d, b"ispe") + 12,
                                                           struct.pack(">I", 32769)),
}


@pytest.mark.parametrize("kind", sorted(DAMAGE))
def test_damaged_files_as_pillow(kind):
    """Damaged files, as Pillow (libavif's parse) takes them: passed on,
    refused or read (ROADMAP.md Queue 3 lists the parse checks that are
    not followed yet, and why damage inside the AV1 payload, where
    dav1d's errors are not normative, is not held)."""
    img = _natural(24, 32, 4)
    data = DAMAGE[kind](_avif(img, "RGB", quality=70))
    _assert_as_pillow(data)


SEQUENCE_DAMAGE = {
    "no mdhd": lambda d: _edit(d, _box(d, b"mdhd") + 4, b"mdhx"),
    "mdhd timescale 0": lambda d: _edit(d, _box(d, b"mdhd") + 28, b"\0\0\0\0"),
    "stts version 1": lambda d: _edit(d, _box(d, b"stts") + 8, b"\x01"),
    "elst of two entries": lambda d: _edit(d, _box(d, b"elst") + 12, b"\0\0\0\x02"),
    "tkhd version 2": lambda d: _edit(d, _box(d, b"tkhd") + 8, b"\x02"),
    "track handler of another kind": lambda d: _edit(d, _box(d, b"hdlr", 1) + 16, b"zzzz"),
    "stss count past its box": lambda d: _edit(d, _box(d, b"stss") + 12, b"\0\0\x10\0"),
    "stsz size past the end": lambda d: _edit(d, _box(d, b"stsz") + 20, b"\0\x10\0\0"),
    "infe count off": lambda d: _edit(d, _box(d, b"iinf") + 12, b"\0\x05"),
}


@pytest.mark.parametrize("kind", sorted(SEQUENCE_DAMAGE))
def test_damaged_sequences_as_pillow(kind):
    """Damaged sequences (avis, read from their tracks), as Pillow takes
    them: libavif's track checks (edit list, sample table boxes, every
    sample within the file) pass the file on; a timescale of 0 fails
    Pillow's load, which divides by it."""
    frames = [Image.fromarray(_natural(16, 24, k)) for k in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:])
    _assert_as_pillow(SEQUENCE_DAMAGE[kind](buf.getvalue()))


def _seq_header_bits(data):
    """(bit offset in `data` of the reduced still-picture sequence header,
    width and height field sizes) of a Pillow AVIF's colour item."""
    at = data.index(b"\x12\x00\x0a") + 2  # temporal delimiter, then OBU_SEQUENCE_HEADER
    size = data[at + 1]  # a one-byte leb128 size
    bits = (at + 2) * 8
    byte = lambda i: data[(bits + i) // 8] >> (7 - (bits + i) % 8) & 1  # noqa: E731
    fwb = sum(byte(10 + k) << (3 - k) for k in range(4)) + 1
    fhb = sum(byte(14 + k) << (3 - k) for k in range(4)) + 1
    assert size > 4
    return bits, fwb, fhb


def _set_bit(data, bit):
    return _edit(data, bit // 8, bytes([data[bit // 8] | 0x80 >> (bit % 8)]))


def _frame_bits(data):
    at = data.index(b"\x32", data.index(b"\x12\x00\x0a") + 3)  # OBU_FRAME with a size
    return (at + 2) * 8


# Kinds this test once refused by name, read since: a file of each is
# read as Pillow reads it (a primary item retyped "grid" has no ImageGrid
# payload, so both fail to open it; libavif's parse fails on construction
# method 2, so both fail to open that too; the superres bits set in a
# stream coded without superres read on as dav1d reads them).
READ_SINCE = {
    "AV1 superres": lambda img: (lambda d: _set_bit(_set_bit(d, (lambda b, w, h: b + 21 + w + h)(
        *_seq_header_bits(d))), _frame_bits(d) + 2))(_avif(img, "RGB")),
    "AVIF item construction method 2": lambda img: _iloc_rewritten(_avif(img, "RGB"), 1, 2),
    "AV1 bit depth above 8": lambda img: (lambda d: _set_bit(d, (lambda b, w, h: b + 24 + w + h)(
        *_seq_header_bits(d))))(_avif(img, "RGB")),
    "AVIF premultiplied alpha": lambda img: _avif(np.dstack([img, img[:, :, 0]]), "RGBA",
                                                  alpha_premultiplied=True),
    "AV1 quantizer matrices": lambda img: _avif(img[:, :, 0], "L", subsampling="4:0:0",
                                                advanced={"enable-qm": "1", "qm-min": "2",
                                                          "qm-max": "9"}),
    "AVIF grid images": lambda img: (lambda d: _edit(d, d.index(b"av01Color"), b"grid"))(
        _avif(img, "RGB")),
    "AVIF matrix coefficients 1": lambda img: (lambda d: _edit(
        d, _box(d, b"colr") + 16, b"\x00\x01"))(_avif(img, "RGB")),
}


@pytest.mark.parametrize("tool", sorted(READ_SINCE))
def test_tools_refused_by_name(tool):
    """The tools and container kinds the reader once refused by name, "not
    supported yet" (READ_SINCE; none is refused now): a file of each is
    read, or refused, as Pillow takes it."""
    _assert_as_pillow(READ_SINCE[tool](_natural(16, 16, 5)))


def _iloc_rewritten(data, version, method=0):
    """Pillow's file with its version 0 iloc (4-byte offsets and lengths,
    no base offset) rewritten as `version` (1 or 2: 32-bit item ids and
    counts in 2) with every item's construction method `method`, each
    extent moved by the growth of the meta box."""
    meta = _box(data, b"meta")
    iloc = _box(data, b"iloc")
    size, = struct.unpack_from(">I", data, iloc)
    v, = data[iloc + 8:iloc + 9]
    assert v == 0
    sizes = data[iloc + 12:iloc + 14]
    count, = struct.unpack_from(">H", data, iloc + 14)
    p, entries = iloc + 16, []
    for _ in range(count):
        iid, dri, n = struct.unpack_from(">HHH", data, p)
        offsets = [struct.unpack_from(">II", data, p + 6 + 8 * k) for k in range(n)]
        entries.append((iid, offsets))
        p += 6 + 8 * n
    wide = ">I" if version == 2 else ">H"
    body = bytes([version, 0, 0, 0]) + sizes + struct.pack(wide, count)
    for iid, offsets in entries:
        body += struct.pack(wide, iid) + struct.pack(">HHH", method, 0, len(offsets))
        body += b"".join(struct.pack(">II", o, n) for o, n in offsets)
    new_iloc = struct.pack(">I", 8 + len(body)) + b"iloc" + body
    grow = len(new_iloc) - size
    out = bytearray(data[:iloc] + new_iloc + data[iloc + size:])
    struct.pack_into(">I", out, meta, struct.unpack_from(">I", data, meta)[0] + grow)
    # Every extent moves by the growth of the meta box.
    p = iloc + 8 + 4 + 2 + (4 if version == 2 else 2)
    for iid, offsets in entries:
        p += 10 if version == 2 else 8
        for o, n in offsets:
            struct.pack_into(">I", out, p, o + grow)
            p += 8
    return bytes(out)


def test_avif_reader_parses_iloc_versions_and_idat():
    """iloc versions 1 and 2 (32-bit item ids and counts) and construction
    method 1 (the data in idat) locate the same bytes as Pillow's version
    0 file does: the port reads the rewritten file to the same planes."""
    data = _avif(_natural(20, 20, 2), "RGB")
    ref = _pillow(data)
    out = _iloc_rewritten(data, 2)
    assert _port(_iloc_rewritten(data, 1))[0] == ref[0]
    got = _port(bytes(out))
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], ref[1])
