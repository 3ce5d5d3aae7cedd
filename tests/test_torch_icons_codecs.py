"""The port's readers of the files PR 16's slice took on, against the JAX
package's, which reads through Pillow 12.1 (libtiff 4.7.1, libzstd
1.5.7): EXIF in a PNG text chunk (imageio/png.py), LZMA and zstd TIFF
(imageio/tiff.py, the native library's zstd_strip), headerless BMP (DIB),
ICO and CUR (imageio/ico.py) and ICNS (imageio/icns.py, icns_rle). For
every file the same read_metadata, the same SourceImage.load gray plane
and metadata and the same colour plane, bit for bit; where Pillow refuses
a file the port raises an ImageError. The zstd frame decoder is held to
python-zstandard (the same libzstd) on seeded payloads.

Files are made at test time from numpy seeds: written by Pillow (ICO,
ICNS with PNG entries, DIB, LZMA and zstd strips), or, for what Pillow
does not write (text chunks after the image data, tiled LZMA and zstd,
ICO and CUR with hand-built BMP entries and AND masks, ICNS's RLE icons
and masks), by the writers here, with Pillow as the reader of record.
"""

import io
import lzma
import struct
import zlib

import numpy as np
import pytest
import torch
import zstandard
from PIL import Image, PngImagePlugin

import chip_smoke
from cybervision_tpu import images as jimages
from cybervision_tpu_torch import imageio, native
from cybervision_tpu_torch import images as timages
from cybervision_tpu_torch.errors import ImageError
from cybervision_tpu_torch.imageio import NativeDecoderError, UnsupportedImageError
from cybervision_tpu_torch.imageio import png as tpng

from .test_torch_images import (
    _bmp_file,
    _chunk,
    _exif_bytes,
    _jax_load,
    _meta,
    _texture,
    _tiff_file,
)

torch.set_num_threads(2)

FOCAL = 41989
# chip_smoke.py's writers of the icon containers (it builds its phase 8
# (l) icons with them).
_icon_dir, _icns_file = chip_smoke.icon_directory, chip_smoke.icns_file


def _assert_same(path):
    """The port reads `path` as the JAX package does; Pillow must read it."""
    assert _meta(timages.read_metadata(path)) == _meta(jimages.read_metadata(path))
    ref = _jax_load(path)
    assert not isinstance(ref, Exception), ref
    src_j, rgb_j = ref
    src_t = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src_t.img, src_j.img)
    assert (src_t.scale, src_t.tilt_angle, src_t.focal_length_35mm) == (
        src_j.scale, src_j.tilt_angle, src_j.focal_length_35mm)
    np.testing.assert_array_equal(src_t.load_rgb_plane(), rgb_j)


def _assert_both_refuse(path):
    """Pillow and the port both fail to load `path`; the metadata agree."""
    assert _meta(timages.read_metadata(path)) == _meta(jimages.read_metadata(path))
    assert isinstance(_jax_load(path), Exception)
    with pytest.raises(ImageError):
        timages.SourceImage.load(path).load_rgb_plane()


def _write(path, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)


# -- EXIF in a PNG text chunk ------------------------------------------------------


def _profile(block: bytes) -> str:
    """ImageMagick's "Raw profile type exif" text: a blank line, the
    name, the length, then the hex in lines of 72 digits."""
    digits = block.hex()
    lines = [digits[k : k + 72] for k in range(0, len(digits), 72)]
    return "\nexif\n" + f"{len(block):8d}\n" + "\n".join(lines) + "\n"


def _text_chunk(kind: str, key: str, text) -> bytes:
    value = text.encode("latin-1") if isinstance(text, str) else text
    if kind == "tEXt":
        return _chunk(b"tEXt", key.encode() + b"\0" + value)
    if kind == "zTXt":
        return _chunk(b"zTXt", key.encode() + b"\0\0" + zlib.compress(value))
    flag = kind == "iTXt compressed"
    body = zlib.compress(value) if flag else value
    return _chunk(b"iTXt", key.encode() + b"\0" + bytes([flag, 0]) + b"en\0\0" + body)


def _gray_png(rng, before=(), after=(), idat=None, size=(48, 64)) -> bytes:
    h, w = size
    px = _texture(rng, h, w)
    rows = b"".join(b"\0" + px[y].tobytes() for y in range(h))
    idat = zlib.compress(rows) if idat is None else idat
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + b"".join(before) + _chunk(b"IDAT", idat) + b"".join(after) + _chunk(b"IEND", b""))


def _raw_tiff_exif(focal=43) -> bytes:
    """An EXIF block without the "Exif\\0\\0" prefix: the TIFF header and
    IFD0 alone."""
    block = _exif_bytes(ifd0={FOCAL: focal})
    return block[6:] if block.startswith(b"Exif\0\0") else block


def _with_prefix() -> bytes:
    return b"Exif\0\0" + _raw_tiff_exif()


def _png_case(kind, place, prefix):
    def build(path, rng):
        chunk = _text_chunk(kind, "Raw profile type exif",
                            _profile(_with_prefix() if prefix else _raw_tiff_exif()))
        _write(path, _gray_png(rng, before=[chunk] if place == "before" else [],
                               after=[chunk] if place == "after" else []))
    return build


def _png_exif_beside(place):
    """An eXIf chunk (focal 28) beside a text profile (focal 43): Pillow's
    info["exif"] wins whenever it is set, before or after the image data."""
    def build(path, rng):
        exif = _chunk(b"eXIf", _raw_tiff_exif(28))
        text = _text_chunk("zTXt", "Raw profile type exif", _profile(_with_prefix()))
        before, after = ([exif, text], []) if place == "before" else ([text], [exif])
        _write(path, _gray_png(rng, before=before, after=after))
    return build


def _png_odd(kind):
    def build(path, rng):
        if kind == "bad hex":
            chunk = _text_chunk("tEXt", "Raw profile type exif", "\nexif\n  4\nzz0102\n")
            _write(path, _gray_png(rng, before=[chunk]))
        elif kind == "tEXt keyword exif":  # Pillow keeps its raw bytes as info["exif"]
            _write(path, _gray_png(rng, after=[_chunk(b"tEXt", b"exif\0" + _with_prefix())]))
        elif kind == "zTXt keyword exif":  # a str in info["exif"]: getexif() fails
            chunk = _text_chunk("zTXt", "exif", _profile(_with_prefix()))
            _write(path, _gray_png(rng, before=[chunk]))
        elif kind == "later chunk wins":
            first = _text_chunk("tEXt", "Raw profile type exif",
                                _profile(_exif_bytes(ifd0={FOCAL: 35})))
            _write(path, _gray_png(rng, before=[first], after=[
                _text_chunk("iTXt compressed", "Raw profile type exif", _profile(_with_prefix()))]))
        elif kind == "broken zTXt stream":  # Pillow keeps an empty text
            body = b"Raw profile type exif\0\0" + b"x\x9c\xff\xff"
            _write(path, _gray_png(rng, before=[_chunk(b"zTXt", body)]))
        elif kind == "iTXt not utf-8":  # Pillow drops the chunk
            chunk = _chunk(b"iTXt", b"Raw profile type exif\0\0\0en\0\0" + b"\xff" + _profile(
                _with_prefix()).encode())
            _write(path, _gray_png(rng, before=[chunk]))
        elif kind == "IEND of a bad length":  # Pillow stops at IEND without reading it
            data = _gray_png(rng, after=[_text_chunk("tEXt", "Raw profile type exif",
                                                     _profile(_with_prefix()))])
            _write(path, data[:-12] + struct.pack(">I", 99) + data[-8:])
        else:  # the sub-IFD: getexif().get_ifd(0x8769)
            block = _exif_bytes(sub={FOCAL: 50})
            _write(path, _gray_png(rng, after=[_text_chunk("tEXt", "Raw profile type exif",
                                                           _profile(block))]))
    return build


# -- LZMA and zstd TIFF -------------------------------------------------------------


def _pillow_tiff(mode, compression, predictor, size=(19, 23)):
    def build(path, rng):
        h, w = size
        if mode == "I;16":
            im = Image.fromarray((_texture(rng, h, w).astype(np.uint16) * 251 + 7))
        elif mode == "F":
            im = Image.fromarray(_texture(rng, h, w).astype(np.float32) * 1.7 - 40.25)
        else:
            im = Image.fromarray(_texture(rng, h, w, 3)).convert(mode)
        im.save(path, "TIFF", compression=compression, tiffinfo={317: predictor})
    return build


def _zstd(level=3, checksum=False, size=True):
    return lambda raw: zstandard.ZstdCompressor(
        level=level, write_checksum=checksum, write_content_size=size).compress(raw)


def _xz(raw: bytes) -> bytes:
    return lzma.compress(raw, format=lzma.FORMAT_XZ)


def _tiled_tiff(kind, compression, predictor, planar=False):
    def build(path, rng):
        px = {"L": lambda: _texture(rng, 37, 41),
              "RGB": lambda: _texture(rng, 37, 41, 3),
              "I;16": lambda: _texture(rng, 37, 41).astype(np.uint16) * 257,
              "F": lambda: _texture(rng, 37, 41).astype(np.float32) / 3 - 7}[kind]()
        codec = _xz if compression == 34925 else _zstd(level=1 + len(kind), checksum=True)
        _tiff_file(path, px, tile=(16, 16), planar=planar, compression=compression,
                   predictor=predictor, codec=codec)
    return build


# -- DIB, ICO, CUR -------------------------------------------------------------------


def _bmp_bytes(tmp, px, bits, **kw) -> bytes:
    """The bytes of a BMP from test_torch_images' writer, without its
    14-byte file header."""
    _bmp_file(tmp, px, bits, **kw)
    with open(tmp, "rb") as fh:
        return fh.read()[14:]


def _dib(kind):
    def build(path, rng):
        if kind.startswith("pillow "):
            mode = kind.split()[1]
            im = Image.fromarray(_texture(rng, 13, 17, 3)).convert(mode)
            im.save(path, "DIB")
            return
        pal = rng.randint(0, 256, (16, 3))
        px = {"4-bit": lambda: rng.randint(0, 16, (9, 11)),
              "16-bit 5-6-5": lambda: _texture(rng, 9, 11, 3),
              "32-bit V4 BGRA": lambda: _texture(rng, 9, 11, 4),
              "core 24-bit": lambda: _texture(rng, 9, 11, 3),
              "top-down 24-bit": lambda: _texture(rng, 9, 11, 3)}[kind]()
        kw = {"4-bit": dict(bits=4, palette=pal),
              "16-bit 5-6-5": dict(bits=16, compression=3, masks=(0xF800, 0x7E0, 0x1F, 0)),
              "32-bit V4 BGRA": dict(bits=32, header=108, compression=3,
                                     masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
              "core 24-bit": dict(bits=24, header=12),
              "top-down 24-bit": dict(bits=24, top_down=True)}[kind]
        _write(path, _bmp_bytes(path + ".bmp", px, **kw))
    return build


def _and_mask(rng, h, w) -> bytes:
    stride = (w + 31) // 32 * 4
    return rng.randint(0, 256, (h, stride)).astype(np.uint8).tobytes()


def _icon_bitmap(path, rng, bits, w, h) -> bytes:
    """A DIB of an ICO or CUR entry: its header's height doubled, the XOR
    bitmap, then (below 32 bits) the AND mask."""
    if bits <= 8:
        n = 1 << bits
        px, kw = rng.randint(0, n, (h, w)), dict(palette=rng.randint(0, 256, (n, 3)))
    else:
        px, kw = _texture(rng, h, w, 4 if bits == 32 else 3), {}
    dib = bytearray(_bmp_bytes(path + ".bmp", px, bits, **kw))
    struct.pack_into("<i", dib, 8, 2 * h)
    return bytes(dib) + (_and_mask(rng, h, w) if bits < 32 else b"")


def _ico(kind):
    def build(path, rng):
        if kind.startswith("pillow png"):
            im = Image.fromarray(_texture(rng, 32, 32, 4 if "RGBA" in kind else 3))
            im.save(path, "ICO", sizes=[(16, 16), (24, 24), (32, 32)])
        elif kind.startswith("pillow bmp"):
            mode = kind.split()[-1]
            im = Image.fromarray(_texture(rng, 24, 24, 4)).convert(mode)
            im.save(path, "ICO", sizes=[(16, 16), (24, 24)], bitmap_format="bmp")
        elif kind == "same size, lower depth first":
            big8 = _icon_bitmap(path, rng, 8, 12, 10)
            big24 = _icon_bitmap(path, rng, 24, 12, 10)
            small = _icon_bitmap(path, rng, 32, 6, 5)
            _write(path, _icon_dir(1, [(6, 5, 32, small), (12, 10, 24, big24), (12, 10, 8, big8)]))
        elif kind == "png beside bmp":
            buf = io.BytesIO()
            Image.fromarray(_texture(rng, 20, 20, 3)).convert("P").save(buf, "PNG")
            _write(path, _icon_dir(1, [(12, 12, 32, _icon_bitmap(path, rng, 32, 12, 12)),
                                       (20, 20, 8, buf.getvalue())]))
        else:
            bits = int(kind.split("-")[0])
            _write(path, _icon_dir(1, [(13, 7, bits, _icon_bitmap(path, rng, bits, 13, 7))]))
    return build


def _cur(kind):
    def build(path, rng):
        if kind == "32-bit at offset 22":
            _write(path, _icon_dir(2, [(9, 6, 32, _icon_bitmap(path, rng, 32, 9, 6))]))
        elif kind == "largest of three":
            _write(path, _icon_dir(2, [(8, 8, 8, _icon_bitmap(path, rng, 8, 8, 8)),
                                       (16, 12, 24, _icon_bitmap(path, rng, 24, 16, 12)),
                                       (20, 10, 4, _icon_bitmap(path, rng, 4, 20, 10))]))
        else:  # "bitmap offset 0": read right after the directory
            data = bytearray(_icon_dir(2, [(10, 9, 1, _icon_bitmap(path, rng, 1, 10, 9))]))
            struct.pack_into("<I", data, 18, 0)
            _write(path, bytes(data))
    return build


# -- ICNS ------------------------------------------------------------------------------


def _icns_rgb(kind_code, size, rng, rle=True):
    px = (_texture(rng, size, size, 3) // 8 * 8).astype(np.uint8)
    if rle:
        data = b"".join(chip_smoke.icns_rle_plane(px[:, :, k].tobytes()) for k in range(3))
    else:
        data = px.tobytes()
    return (kind_code, (b"\0\0\0\0" if kind_code == b"it32" else b"") + data)


def _icns(kind):
    def build(path, rng):
        if kind == "pillow png":
            im = Image.fromarray(_texture(rng, 16, 16, 4))
            im.save(path, "ICNS")
            return
        if kind == "it32 RLE + t8mk":
            entries = [_icns_rgb(b"it32", 128, rng), (b"t8mk", rng.bytes(128 * 128))]
        elif kind == "ih32 raw + h8mk":
            entries = [_icns_rgb(b"ih32", 48, rng, rle=False), (b"h8mk", rng.bytes(48 * 48))]
        elif kind == "il32 RLE, no mask":
            entries = [(b"is32", b"\x00" * 3), _icns_rgb(b"il32", 32, rng)]
        elif kind == "is32 + s8mk beside icp4 png":
            buf = io.BytesIO()
            Image.fromarray(_texture(rng, 16, 16, 3)).save(buf, "PNG")
            entries = [_icns_rgb(b"is32", 16, rng), (b"s8mk", rng.bytes(256)),
                       (b"icp4", buf.getvalue())]
        else:  # "ic07 png of 64x64": a smaller PNG in a 128 slot, as Pillow allows
            buf = io.BytesIO()
            Image.fromarray(_texture(rng, 64, 64, 3)).convert("L").save(buf, "PNG")
            entries = [(b"ic07", buf.getvalue()), _icns_rgb(b"is32", 16, rng)]
        _write(path, _icns_file(entries))
    return build


# The fault's cases: the profile in every chunk kind, before and after the
# image data, with and without the "Exif\0\0" prefix.
PROFILE_CASES = {
    f"png {kind} {place}{'' if prefix else ' no prefix'}": ("png", _png_case(kind, place, prefix))
    for kind in ("tEXt", "zTXt", "iTXt", "iTXt compressed")
    for place in ("before", "after") for prefix in (True, False)}
CASES = {
    **PROFILE_CASES,
    "png eXIf before, text profile": ("png", _png_exif_beside("before")),
    "png text profile, eXIf after": ("png", _png_exif_beside("after")),
    **{f"png {kind}": ("png", _png_odd(kind))
       for kind in ("bad hex", "tEXt keyword exif", "zTXt keyword exif", "later chunk wins",
                    "broken zTXt stream", "iTXt not utf-8", "sub-IFD profile",
                    "IEND of a bad length")},
    **{f"tif {mode} {codec} predictor {pred}": ("tif", _pillow_tiff(mode, codec, pred))
       for codec in ("lzma", "zstd")
       for mode, preds in (("L", (1, 2)), ("RGB", (1, 2)), ("I;16", (1, 2)), ("F", (1, 2, 3)),
                           ("P", (1,)), ("1", (1,)))
       for pred in preds},
    **{f"tif tiled {kind} {name} predictor {pred}{' planar' if planar else ''}":
       ("tif", _tiled_tiff(kind, comp, pred, planar))
       for name, comp in (("lzma", 34925), ("zstd", 50000))
       for kind, pred, planar in (("L", 2, False), ("RGB", 1, True), ("I;16", 2, False),
                                  ("F", 3, False))},
    **{f"dib {kind}": ("dib", _dib(kind))
       for kind in ("pillow 1", "pillow L", "pillow P", "pillow RGB", "4-bit", "16-bit 5-6-5",
                    "32-bit V4 BGRA", "core 24-bit", "top-down 24-bit")},
    **{f"ico {kind}": ("ico", _ico(kind))
       for kind in ("pillow png RGB", "pillow png RGBA", "pillow bmp RGB", "pillow bmp RGBA",
                    "pillow bmp P", "pillow bmp L", "pillow bmp 1", "1-bit", "4-bit", "8-bit",
                    "24-bit", "32-bit", "same size, lower depth first", "png beside bmp")},
    **{f"cur {kind}": ("cur", _cur(kind))
       for kind in ("32-bit at offset 22", "largest of three", "bitmap offset 0")},
    **{f"icns {kind}": ("icns", _icns(kind))
       for kind in ("pillow png", "it32 RLE + t8mk", "ih32 raw + h8mk", "il32 RLE, no mask",
                    "is32 + s8mk beside icp4 png", "ic07 png of 64x64")},
}


def _write_case(tmp_path, name: str) -> str:
    ext, build = CASES[name]
    path = str(tmp_path / f"case.{ext}")
    build(path, np.random.RandomState(sorted(CASES).index(name)))
    return path


@pytest.mark.parametrize("name", sorted(CASES))
def test_icons_and_codecs_match_jax(tmp_path, name):
    path = _write_case(tmp_path, name)
    _assert_same(path)


def test_png_text_profile_gives_the_focal_length(tmp_path):
    """The fault: a gray PNG whose only EXIF is an ImageMagick-style text
    profile (41989 = 43) gives 43 in both packages, in every chunk kind
    and place."""
    for name in PROFILE_CASES:
        path = _write_case(tmp_path, name)
        assert jimages.read_metadata(path).focal_length_35mm == 43, name
        assert timages.read_metadata(path).focal_length_35mm == 43, name


def _failing_png(kind, path, rng):
    profile = _text_chunk("zTXt", "Raw profile type exif", _profile(_with_prefix()))
    if kind == "late profile, rows cut":
        rows = zlib.compress(b"\0" * 10)
        _write(path, _gray_png(rng, after=[profile], idat=rows))
    elif kind == "early profile, rows cut":
        _write(path, _gray_png(rng, before=[profile], idat=zlib.compress(b"\0" * 10)))
    elif kind == "zTXt of an unknown method":
        chunk = _chunk(b"zTXt", b"Raw profile type exif\0\1" + zlib.compress(b"x"))
        _write(path, _gray_png(rng, before=[chunk]))
    else:  # "late zTXt of an unknown method": Pillow's load fails after the rows
        chunk = _chunk(b"zTXt", b"Comment\0\1" + zlib.compress(b"x"))
        _write(path, _gray_png(rng, after=[chunk]))


@pytest.mark.parametrize("kind", ["late profile, rows cut", "early profile, rows cut",
                                  "zTXt of an unknown method", "late zTXt of an unknown method"])
def test_png_text_where_pillow_fails(tmp_path, kind):
    """Where the rows do not decode, getexif() raises (its load() comes
    first) and the JAX package's metadata keep no focal length; a zTXt
    of an unknown method fails Pillow's open, or, after the image data,
    its load."""
    path = str(tmp_path / "t.png")
    _failing_png(kind, path, np.random.RandomState(3))
    _assert_both_refuse(path)
    assert timages.read_metadata(path).focal_length_35mm is None


@pytest.mark.parametrize("limit", ["MAX_TEXT_CHUNK", "MAX_TEXT_MEMORY"])
def test_png_text_limits_follow_pillow(tmp_path, monkeypatch, limit):
    """Pillow's limits on text (lowered here on both sides to keep the
    file small): a zTXt inflating past MAX_TEXT_CHUNK, and text past
    MAX_TEXT_MEMORY in all, fail the open."""
    monkeypatch.setattr(PngImagePlugin, limit, 4096)
    monkeypatch.setattr(tpng, limit, 4096)
    rng = np.random.RandomState(9)
    if limit == "MAX_TEXT_CHUNK":
        chunks = [_text_chunk("zTXt", "Comment", "a" * 5000)]
    else:
        chunks = [_text_chunk("tEXt", f"Note{k}", "b" * 1500) for k in range(3)]
    path = str(tmp_path / "t.png")
    _write(path, _gray_png(rng, before=chunks))
    _assert_both_refuse(path)
    _write(path, _gray_png(rng, before=chunks[:1] if limit == "MAX_TEXT_MEMORY" else [
        _text_chunk("zTXt", "Comment", "a" * 4000)]))
    _assert_same(path)


# -- the zstd frame decoder against python-zstandard --------------------------------


def _payload(kind, rng, n):
    if kind == "incompressible":
        return rng.bytes(n)
    if kind == "constant runs":
        values, runs = rng.randint(0, 256, n // 40 + 1), rng.randint(1, 80, n // 40 + 1)
        return b"".join(bytes([int(v)]) * int(r) for v, r in zip(values, runs))[:n]
    if kind == "text":
        letters = list(b"etaoinshrdlucmfw")
        words = [bytes(rng.choice(letters, rng.randint(2, 9))) for _ in range(300)]
        return b" ".join(words[int(i)] for i in rng.randint(0, 300, n // 5))[:n]
    return np.cumsum(rng.randint(-3, 4, n // 2)).astype("<i2").tobytes()  # "samples"


@pytest.mark.parametrize("kind", ["incompressible", "constant runs", "text", "samples"])
@pytest.mark.parametrize("level", [1, 3, 19, 22])
def test_zstd_decoder_equals_zstandard(kind, level):
    """Every frame kind python-zstandard writes at these levels (with and
    without checksum and content size) decodes to its payload, as
    zstandard.decompress gives it; the strip decoder (libtiff's first
    frame) gives the same."""
    rng = np.random.RandomState(level * 7 + len(kind))
    for checksum, size in ((False, True), (True, True), (True, False)):
        data = _payload(kind, rng, int(rng.randint(1, 20000)))
        frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                         write_content_size=size).compress(data)
        want = zstandard.ZstdDecompressor().decompress(frame, max_output_size=len(data) + 1)
        assert want == data
        assert native.zstd_frames(frame, 1 << 20) == want
        assert native.tiff_zstd(frame, len(data)) == want


def test_zstd_decoder_across_frames_and_blocks():
    """Concatenated frames, skippable frames between them, a frame
    streamed in flushed blocks without a content size, and payloads past
    128 KiB (several blocks a frame) decode as python-zstandard reads
    across frames."""
    rng = np.random.RandomState(5)
    big = _payload("samples", rng, 300000)
    streamed = zstandard.ZstdCompressor(level=3).compressobj()
    parts = [streamed.compress(big[:70000]), streamed.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK),
             streamed.compress(big[70000:]), streamed.flush()]
    skip = struct.pack("<II", 0x184D2A53, 7) + rng.bytes(7)
    frames = [zstandard.ZstdCompressor(level=19, write_checksum=True).compress(big),
              skip, b"".join(parts), skip,
              zstandard.ZstdCompressor(level=1).compress(_payload("text", rng, 150000))]
    stream = b"".join(frames)
    want = zstandard.ZstdDecompressor().stream_reader(io.BytesIO(stream),
                                                      read_across_frames=True).read()
    assert len(want) > 128 * 1024 * 3
    assert native.zstd_frames(stream, 1 << 22) == want
    # libtiff's strip: the first frame only; a skippable frame first gives nothing.
    assert native.tiff_zstd(stream, len(big)) == big
    assert native.tiff_zstd(skip + frames[0], len(big)) == b""
    with pytest.raises(ImageError):
        native.zstd_frames(stream[:-3], 1 << 22)


# -- corrupt and truncated strips ----------------------------------------------------


def _strip_tiff(path, strip: bytes, compression, px):
    _tiff_file(path, px, rows_per_strip=px.shape[0], compression=compression,
               codec=lambda raw: strip)


def _corrupt(kind, rng, raw):
    zc = zstandard.ZstdCompressor
    if kind == "zstd truncated":
        return 50000, zc(level=3).compress(raw)[:-9]
    if kind == "zstd bad checksum":
        f = bytearray(zc(level=3, write_checksum=True).compress(raw))
        f[-1] ^= 0x40
        return 50000, bytes(f)
    if kind == "zstd bad checksum past the strip":  # libtiff stops before it
        f = bytearray(zc(level=3, write_checksum=True).compress(raw + rng.bytes(300)))
        f[-1] ^= 0x40
        return 50000, bytes(f)
    if kind == "zstd two frames":
        return 50000, zc(level=3).compress(raw[:100]) + zc(level=3).compress(raw[100:])
    if kind == "zstd skippable frame first":
        return 50000, struct.pack("<II", 0x184D2A50, 2) + b"ab" + zc(level=3).compress(raw)
    if kind == "zstd trailing bytes":
        return 50000, zc(level=3).compress(raw) + rng.bytes(11)
    if kind == "zstd dictionary id":
        f = bytearray(zc(level=3, write_content_size=False, write_dict_id=False).compress(raw))
        f[4] |= 1
        return 50000, bytes(f[:5]) + b"\x07" + bytes(f[5:])
    if kind == "zstd reserved bit":
        f = bytearray(zc(level=3).compress(raw))
        f[4] |= 8
        return 50000, bytes(f)
    if kind == "xz truncated":
        return 34925, _xz(raw)[:-40]
    if kind == "xz trailing bytes":
        return 34925, _xz(raw) + rng.bytes(9)
    if kind == "xz check damaged":  # liblzma checks it after the strip is full
        f = bytearray(lzma.compress(raw, format=lzma.FORMAT_XZ, check=lzma.CHECK_CRC64,
                                    filters=[{"id": lzma.FILTER_LZMA2, "preset": 0}]))
        f[-20] ^= 1
        return 34925, bytes(f)
    # "xz not an xz stream"
    return 34925, b"\xfd7zXY" + _xz(raw)[5:]


CORRUPT = ["zstd truncated", "zstd bad checksum", "zstd bad checksum past the strip",
           "zstd two frames", "zstd skippable frame first", "zstd trailing bytes",
           "zstd dictionary id", "zstd reserved bit", "xz truncated", "xz trailing bytes",
           "xz check damaged", "xz not an xz stream"]


@pytest.mark.parametrize("kind", CORRUPT)
def test_corrupt_strips_raise_where_pillow_raises(tmp_path, kind):
    rng = np.random.RandomState(CORRUPT.index(kind))
    px = rng.randint(0, 256, (12, 20)).astype(np.uint8)
    compression, strip = _corrupt(kind, rng, px.tobytes())
    path = str(tmp_path / "c.tif")
    _strip_tiff(path, strip, compression, px)
    if isinstance(_jax_load(path), Exception):
        _assert_both_refuse(path)
    else:
        _assert_same(path)


def test_seeded_zstd_damage_raises_where_pillow_raises(tmp_path):
    """Bytes flipped, replaced or cut in zstd strips of many shapes
    (Huffman literals in one or four streams, FSE and repeated tables,
    frames with and without content size and checksum, several blocks):
    the port reads what Pillow's libtiff reads, the same pixels, and
    raises where it raises."""
    rng = np.random.RandomState(16)
    read = refused = 0
    for it in range(60):
        h, w = 30, 40
        px = (np.cumsum(rng.randint(-3, 4, (h, w)), axis=1) % 256).astype(np.uint8) \
            if it % 2 else rng.randint(0, int(rng.choice([4, 64, 256])), (h, w)).astype(np.uint8)
        raw = px.tobytes() + (rng.bytes(int(rng.randint(1, 900))) if it % 5 == 0 else b"")
        c = zstandard.ZstdCompressor(level=int(rng.choice([1, 3, 19])),
                                     write_checksum=bool(rng.rand() < 0.5),
                                     write_content_size=bool(rng.rand() < 0.7))
        strip = bytearray(c.compress(raw))
        for _ in range(int(rng.randint(1, 3))):
            strip[int(rng.randint(4, len(strip)))] ^= 1 << int(rng.randint(8))
        if it % 7 == 0:
            strip = strip[: int(rng.randint(6, len(strip)))]
        path = str(tmp_path / f"z{it}.tif")
        _strip_tiff(path, bytes(strip), 50000, px)
        with Image.open(path) as im:
            try:
                ref = np.asarray(im.convert("L"))
            except OSError:
                ref = None
        f = imageio.open_image(path)
        if ref is None:
            refused += 1
            with pytest.raises(ImageError):
                f.decode()
        else:
            read += 1
            np.testing.assert_array_equal(imageio.to_l(*f.decode()), ref)
    assert read > 10 and refused > 10


def test_seeded_lzma_damage_reads_where_pillow_reads(tmp_path):
    """Bits flipped in the xz strip of a 64x256 gradient (one strip; no
    check, CRC32 or CRC64; 1-3 flips at bytes [12, len - 12) from
    random.Random(7), 1,500 strips): where liblzma fills the strip and
    only then finds the damage, libtiff keeps the strip and Pillow reads
    the file. The port reads those strips (listed) to Pillow's pixels,
    and on every 40th other strip it refuses where Pillow refuses."""
    import random

    px = (np.cumsum(np.random.RandomState(1).randint(-3, 4, (64, 256)), axis=1) % 256
          ).astype(np.uint8)
    checks = [lzma.CHECK_NONE, lzma.CHECK_CRC32, lzma.CHECK_CRC64]
    streams = [lzma.compress(px.tobytes(), format=lzma.FORMAT_XZ, check=c) for c in checks]
    pillow_reads = {350, 541, 542, 867, 897, 1001, 1366, 1451}
    rnd = random.Random(7)
    read = refused = 0
    for it in range(1500):
        strip = bytearray(streams[it % 3])
        for _ in range(rnd.randint(1, 3)):
            strip[rnd.randrange(12, len(strip) - 12)] ^= 1 << rnd.randrange(8)
        if it not in pillow_reads and it % 40:
            continue
        path = str(tmp_path / f"x{it}.tif")
        _strip_tiff(path, bytes(strip), 34925, px)
        ref = _jax_load(path)
        assert isinstance(ref, Exception) == (it not in pillow_reads), it
        if isinstance(ref, Exception):
            refused += 1
            _assert_both_refuse(path)
        else:
            read += 1
            _assert_same(path)
    assert read == len(pillow_reads) and refused > 30


# -- refusals --------------------------------------------------------------------------


def test_icns_with_a_jpeg2000_best_entry_is_refused_by_name(tmp_path):
    """Pillow reads an ICNS whose best entry is JPEG 2000 (OpenJPEG); the
    port names the gap."""
    rng = np.random.RandomState(2)
    buf = io.BytesIO()
    Image.fromarray(_texture(rng, 32, 32, 3)).save(buf, "JPEG2000")
    path = str(tmp_path / "j.icns")
    _write(path, _icns_file([(b"ic11", buf.getvalue()), _icns_rgb(b"is32", 16, rng)]))
    with Image.open(path) as im:
        im.load()
    with pytest.raises(UnsupportedImageError, match="JPEG 2000 .*not supported yet"):
        timages.SourceImage.load(path)


def _broken_icon(kind, path, rng):
    if kind == "ico AND mask past the file":
        data = _icon_dir(1, [(13, 7, 8, _icon_bitmap(path, rng, 8, 13, 7))])
        _write(path, data[:-20])
    elif kind == "ico 32-bit alpha past the file":
        bitmap = _icon_bitmap(path, rng, 24, 9, 6)
        _write(path, _icon_dir(1, [(9, 6, 32, bitmap[:-40])]))
    elif kind == "icns RLE overrunning its plane":
        _write(path, _icns_file([(b"is32", b"\xff\x07" * 3 + b"\x00\x01" * 300)]))
    elif kind == "icns mask only":
        _write(path, _icns_file([(b"s8mk", rng.bytes(256))]))
    elif kind == "icns it32 without its zero bytes":
        code, data = _icns_rgb(b"it32", 128, rng)
        _write(path, _icns_file([(code, b"\1" + data[1:])]))
    else:  # "icns png of a size Pillow refuses"
        buf = io.BytesIO()
        Image.fromarray(_texture(rng, 20, 24, 3)).save(buf, "PNG")
        _write(path, _icns_file([(b"icp4", buf.getvalue())]))


@pytest.mark.parametrize("kind", ["ico AND mask past the file", "ico 32-bit alpha past the file",
                                  "icns RLE overrunning its plane", "icns mask only",
                                  "icns it32 without its zero bytes",
                                  "icns png of a size Pillow refuses"])
def test_broken_icons_raise_where_pillow_raises(tmp_path, kind):
    path = str(tmp_path / ("b.icns" if kind.startswith("icns") else "b.ico"))
    _broken_icon(kind, path, np.random.RandomState(4))
    _assert_both_refuse(path)


def test_native_only_codecs_without_native_name_the_compiler(tmp_path, monkeypatch):
    """No fallback: without the native library a zstd TIFF and an ICNS RLE
    icon raise an error that says what is missing; LZMA (the standard
    library's lzma) and an ICNS's raw planes still read."""
    paths = {}
    for k, name in enumerate(["tif L zstd predictor 2", "icns il32 RLE, no mask",
                              "tif L lzma predictor 2", "icns ih32 raw + h8mk"]):
        (tmp_path / str(k)).mkdir()
        paths[name] = _write_case(tmp_path / str(k), name)
    planes = {n: timages.SourceImage.load(p).img for n, p in paths.items()}

    def refuse():
        raise ImportError("no native library")

    monkeypatch.setattr(native, "load", refuse)
    for name in ["tif L zstd predictor 2", "icns il32 RLE, no mask"]:
        with pytest.raises(NativeDecoderError, match="C\\+\\+ compiler"):
            timages.SourceImage.load(paths[name])
    for name in ["tif L lzma predictor 2", "icns ih32 raw + h8mk"]:
        np.testing.assert_array_equal(timages.SourceImage.load(paths[name]).img, planes[name])


def test_lzma_without_the_lzma_module_is_named(tmp_path, monkeypatch):
    import sys

    path = _write_case(tmp_path, "tif L lzma predictor 1")
    monkeypatch.setitem(sys.modules, "lzma", None)
    with pytest.raises(NativeDecoderError, match="lzma module"):
        timages.SourceImage.load(path)


def test_identify_names_the_new_readers(tmp_path):
    """identify gives each new kind to the reader of Pillow's plugin."""
    for name, fmt in (("dib pillow RGB", "DIB"), ("ico 8-bit", "ICO"),
                      ("cur largest of three", "CUR"), ("icns pillow png", "ICNS")):
        path = _write_case(tmp_path, name)
        with Image.open(path) as im:
            assert im.format == fmt
        assert imageio.open_image(path).format == fmt
