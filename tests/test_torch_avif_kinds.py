"""The AVIF kinds the port reads since its grid, matrix coefficient,
quantizer matrix and film grain support (imageio/avif.py, native/av1*.cpp,
native/avifrgb.cpp), against Pillow 12.1 with libavif 1.3 (dav1d 1.5.1,
libyuv 1909), which the JAX package reads through.

The files are the committed ones of chip_smoke.AVIF_KINDS_* and
AVIF_GRID_SEM, written through the wheel's libavif encoder by
tests/gen_torch_formats_fixture.py (Pillow's save writes none of these
kinds): every plane is Pillow's live and by the committed SHA-256; the
files Pillow fails on fail at the same step (open or load) in the port;
the JAX package's loader gives the port's planes; each file carries the
kind it is named for. Quantizer matrices and film grain are also written
live through Pillow's `advanced` codec options.
"""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

import chip_smoke
from cybervision_tpu import images as jimages
from cybervision_tpu_torch import images as timages
from cybervision_tpu_torch import imageio, native
from cybervision_tpu_torch.errors import ImageError
from cybervision_tpu_torch.imageio import avif
from cybervision_tpu_torch.imageio.errors import UnsupportedImageError

from .test_torch_avif import _natural, _pillow, _port, _screen
from .test_torch_images import _jax_load

with open(chip_smoke.FORMATS_SHA256) as _fh:
    COMMITTED = json.load(_fh)["avif kinds"]

READ = sorted(chip_smoke.AVIF_KINDS_DECODE_ONLY) + [os.path.basename(p)
                                                     for p in chip_smoke.AVIF_GRID_SEM]


def _data(name: str) -> bytes:
    with open(os.path.join(chip_smoke.AVIF_DIR, name), "rb") as fh:
        return fh.read()


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", READ)
def test_planes_equal_pillows(name):
    """The port's mode and pixels are Pillow's, bit for bit, and its gray
    and colour planes have the committed SHA-256 of Pillow's."""
    data = _data(name)
    mode, px = _port(data)
    ref_mode, ref = _pillow(data)
    assert mode == ref_mode
    np.testing.assert_array_equal(px, ref)
    assert _sha(imageio.to_l(mode, px, None)) == COMMITTED[name]["l"]
    assert _sha(imageio.to_rgb(mode, px, None)) == COMMITTED[name]["rgb"]


@pytest.mark.parametrize("name", sorted(chip_smoke.AVIF_KINDS_FAIL))
def test_fails_where_pillow_fails(name):
    """Matrix coefficients libavif cannot convert and damaged grids fail in
    the port at the step where Pillow fails (committed and live), and the
    JAX package's loader and the port's both raise."""
    data = _data(name)
    step = chip_smoke.AVIF_KINDS_FAIL[name]
    assert COMMITTED[name] == {"fails": step}
    assert _pillow(data)[0] == step
    assert _port(data)[0] == step
    path = os.path.join(chip_smoke.AVIF_DIR, name)
    with pytest.raises(Exception):
        jimages.SourceImage.load(path)
    with pytest.raises(ImageError):
        timages.SourceImage.load(path)


def _fields(name: str) -> tuple[avif.AvifFile, dict]:
    """The parsed file and its (first tile's) AV1 header fields."""
    f = avif.parse(_data(name))
    if isinstance(f.color, avif.Grid):
        extents, size = f.color.tiles[0]
    else:
        extents, size = f.color, f.size
    return f, native.av1_decode(avif._payload(f, extents), *size)[1]


def test_fixtures_carry_their_kinds():
    """Each file is the kind it is named for: its matrix coefficients,
    colour primaries and range in colr; grids of 2x3 and 2x2 tiles, an
    alpha grid, a cropping ImageGrid; at least three quantizer matrix
    levels, luma and chroma ones apart; film grain applied; 4:0:0 grain."""
    for name in chip_smoke.AVIF_KINDS_DECODE_ONLY:
        if name.startswith("mc"):
            code, fmt, rng = name[2:-5].split("_")
            f, fields = _fields(name)
            primaries = 4 if code == "12" else 1
            assert f.nclx == (primaries, 13, int(code.split("p")[0]), rng == "full")
            assert fields["subsampling"] == ((0, 0) if fmt == "444" else (1, 1))
    f, _ = _fields("grid_2x3_alpha.avif")
    assert (f.color.rows, f.color.cols, f.color.width, f.color.height) == (2, 3, 192, 128)
    assert isinstance(f.alpha, avif.Grid) and f.mode == "RGBA"
    f, _ = _fields("grid_2x3_alpha_cropped.avif")
    assert (f.color.width, f.color.height, f.size) == (160, 100, (160, 100))
    levels = {q for n in ("qm_420.avif", "qm_iq_444_low.avif", "qm_iq_444_high.avif")
              for q in _fields(n)[1]["qm"]}
    assert len(levels) >= 3 and 15 not in levels
    for name in ("qm_420.avif", "qm_iq_444_low.avif"):
        y, u, v = _fields(name)[1]["qm"]
        assert y != u == v
    for name in ("grain_v1.avif", "grain_v2.avif", "grain_v10.avif", "grain_v16.avif",
                 "grain_400.avif", "sem_grid_0.avif"):
        assert _fields(name)[1]["grain"] == 1
    assert _fields("grain_400.avif")[1]["mono"] == 1
    f, fields = _fields("sem_grid_1.avif")
    assert (f.color.rows, f.color.cols, f.size) == (2, 2, (chip_smoke.SIZE,) * 2)
    assert fields["qm"] != (15, 15, 15) and f.nclx == (1, 13, 1, 1)


@pytest.mark.parametrize("name", ["sem_grid_0.avif", "grid_2x3_alpha_cropped.avif",
                                  "mc1_420_full.avif", "mc12_444_limited.avif",
                                  "mc8_444_full.avif", "qm_iq_444_high.avif", "grain_v10.avif",
                                  "grain_400.avif"])
def test_jax_loader_equals_ports(name):
    """The JAX package's SourceImage.load and load_rgb against the port's
    on the same file: equal gray and colour arrays (a grid, a cropped RGBA
    grid, a libyuv matrix, libavif's own float paths, quantizer matrices,
    film grain in colour and in 4:0:0)."""
    path = os.path.join(chip_smoke.AVIF_DIR, name)
    src_j, rgb_j = _jax_load(path)
    src_t = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src_t.img, src_j.img)
    np.testing.assert_array_equal(src_t.load_rgb_plane(), rgb_j)


def _iloc_entries(data: bytes) -> dict:
    """{item id: offset of its entry} of a libavif file's version 0 iloc
    (4-byte offsets and lengths, one extent an item)."""
    at = data.index(b"iloc") + 4
    assert data[at:at + 6] == b"\0\0\0\0\x44\x00"
    count = struct.unpack_from(">H", data, at + 6)[0]
    return {struct.unpack_from(">H", data, at + 8 + 14 * k)[0]: at + 8 + 14 * k
            for k in range(count)}


def _grid_damage(kind: str) -> bytes:
    data = _data("grid_2x3_alpha.avif")
    meta = next((s, e) for t, s, e in avif._boxes(data, 0, len(data)) if t == b"meta")
    items, primary, _ = avif._parse_meta(data, *meta)
    alpha_grid = next(i.id for i in items.values() if i.type == b"grid" and i.id != primary)
    tile = items[primary].refs[b"dimg"][1]
    entries = _iloc_entries(data)
    edits = {
        # The alpha grid loses its location: libavif skips an item with no
        # data, so the image has no alpha.
        "alpha grid without data": (entries[alpha_grid], struct.pack(">H", 0x7F00)),
        "tile longer than the file": (entries[tile] + 10, struct.pack(">I", len(data) + 1)),
        "tile of no data": (entries[tile] + 10, struct.pack(">I", 0)),
        "grid payload cut by the end": (entries[primary] + 6, struct.pack(">I", len(data) - 4)),
        # Two bytes of the dimg box are left over past its references.
        "dimg count one short": (data.index(b"dimg") + 6, struct.pack(">H", 5)),
    }
    at, new = edits[kind]
    return data[:at] + new + data[at + len(new):]


@pytest.mark.parametrize("kind", ["alpha grid without data", "tile longer than the file",
                                  "tile of no data", "grid payload cut by the end",
                                  "dimg count one short"])
def test_damaged_grid_items_as_pillow(kind):
    """Edits of a grid file's item locations and references, as libavif's
    parse takes them: an alpha grid with no data is skipped (Pillow reads
    RGB); a tile longer than the file or with no data, a grid payload cut
    by the end of the file, or a dimg box with bytes past its references,
    is a parse failure: Pillow's open passes the file on to the other
    plugins (UnidentifiedImageError), and so does the port's identify."""
    data = _grid_damage(kind)
    ref, got = _pillow(data), _port(data)
    assert got[0] == ref[0] == ("RGB" if kind.startswith("alpha") else "open")
    if ref[0] == "RGB":
        np.testing.assert_array_equal(got[1], ref[1])
    else:
        assert isinstance(ref[1], UnidentifiedImageError)
        assert isinstance(got[1], UnsupportedImageError)
        assert "this file format is not supported" in str(got[1])


LIVE = {
    "qm natural 4:2:0": ("natural", 48, 70, {"advanced": {"enable-qm": "1", "qm-min": "0",
                                                          "qm-max": "15"}, "quality": 70}),
    "qm screen 4:4:4": ("screen", 64, 64, {"subsampling": "4:4:4", "speed": 4,
                                           "advanced": {"enable-qm": "1", "qm-min": "3",
                                                        "qm-max": "9"}}),
    "qm natural 4:2:2 odd": ("natural", 37, 53, {"subsampling": "4:2:2", "advanced": {
        "enable-qm": "1", "tune": "iq"}}),
    "grain 4:2:0 odd": ("natural", 41, 59, {"advanced": {"film-grain-test": "4"}}),
    "grain 4:4:4": ("natural", 40, 48, {"subsampling": "4:4:4",
                                        "advanced": {"film-grain-test": "12"}}),
    "grain 4:2:2 rgba": ("natural", 33, 40, {"subsampling": "4:2:2", "mode": "RGBA",
                                             "advanced": {"film-grain-test": "7"}}),
    "qm and grain 4:0:0": ("natural", 36, 36, {"subsampling": "4:0:0", "advanced": {
        "enable-qm": "1", "film-grain-test": "15"}}),
}


@pytest.mark.parametrize("name", sorted(LIVE))
def test_pillow_written_qm_and_grain(name):
    """Quantizer matrices and film grain written through Pillow's save
    (aom's options in `advanced`), natural and screen content, every
    subsampling, odd sizes and an alpha plane with grain: the port's
    pixels are Pillow's."""
    content, h, w, opts = LIVE[name]
    opts = dict(opts)
    mode = opts.pop("mode", "RGB")
    img = (_natural if content == "natural" else _screen)(h, w, len(name))
    if mode == "RGBA":
        img = np.dstack([img, img[:, :, 1]])
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "AVIF", **opts)
    ref, got = _pillow(buf.getvalue()), _port(buf.getvalue())
    assert got[0] == ref[0] == mode
    np.testing.assert_array_equal(got[1], ref[1])
