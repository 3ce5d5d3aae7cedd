"""The port's AVIF reader on 10- and 12-bit files and on premultiplied
alpha (imageio/avif.py, native/av1*.cpp, native/avifrgb.cpp) against
Pillow 12.1 with libavif 1.3 (dav1d 1.5.1, libyuv 1909), which the JAX
package reads through.

The wheel's aom writes 8 bits only, so the high-depth files are its
8-bit files with every AV1 sequence header, av1C and pixi rewritten
(tests/gen_torch_formats_fixture.py's high_depth): dav1d reads the same
tile data at 10 or 12 bits. Each stage is pinned on its own: the 10- and
12-bit quantizer lookups against dav1d's table in the wheel's bytes; the
decoder's YUV planes against the wheel's dav1d; the YUV->RGB(A)
conversion and the un-premultiply against the wheel's exported
avifImageYUVToRGB and avifRGBImageUnpremultiplyAlpha on seeded planes;
then whole files (every subsampling, both ranges, with and
without alpha, every matrix code the port reads, a grid, quantizer
matrices, film grain, premultiplied alpha) against Pillow's planes, the
files Pillow fails on at the same step, the JAX package's loader, and
one CLI run.
"""

import glob
import json
import os
import re
import struct
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from cybervision_tpu.config import MeshMode as JMeshMode
from cybervision_tpu.reconstruction import reconstruct as jax_reconstruct
from cybervision_tpu_torch import cli, native
from cybervision_tpu_torch import images as timages
from cybervision_tpu_torch.imageio import avif

from .gen_torch_formats_fixture import Dav1d, Libavif, high_depth
from .test_pipeline import _fast_cfg, _sem_pair
from .test_torch_avif import _assert_as_pillow, _avif, _focal_exif, _natural, _pillow
from .test_torch_images import _jax_load
from .test_torch_pipeline import _port_fast_cfg, _read_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    return Libavif()


def _data(name: str) -> bytes:
    with open(os.path.join(chip_smoke.AVIF_DIR, name), "rb") as fh:
        return fh.read()


def _rgba(h, w, seed):
    img = _natural(h, w, seed)
    y, x = np.mgrid[0:h, 0:w]
    return np.dstack([img, (128 + 127 * np.sin(x / 5.0 + y / 7.0)).astype(np.uint8)])


# -- the stages ------------------------------------------------------------------------


def test_quantizer_lookups_are_dav1ds():
    """av1tables.h's Dc_Qlookup / Ac_Qlookup at 8, 10 and 12 bits equal
    dav1d's dq_tbl, found again in the wheel's library bytes: (DC, AC)
    pairs in three blocks of 256, the 10- and 12-bit ones ending at the
    AV1 specification's 5347/7312 and 21387/29247."""
    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    with open(glob.glob(os.path.join(libs, "libavif-*.so*"))[0], "rb") as fh:
        data = fh.read()
    at = data.find(np.array([4, 4, 8, 8, 8, 9, 9, 10, 10, 11], "<u2").tobytes())
    assert at >= 0
    dq = np.frombuffer(data[at:at + 3 * 256 * 4], "<u2").reshape(3, 256, 2)
    with open(os.path.join(ROOT, "cybervision_tpu_torch", "native", "av1tables.h")) as fh:
        header = fh.read()
    for name, k in (("kDcQLookup", 0), ("kAcQLookup", 1)):
        body = re.search(rf"{name}\[3\]\[256\] = \{{([^}}]*)\}}", header).group(1)
        table = np.array([int(v) for v in body.replace("\n", " ").split(",") if v.strip()])
        np.testing.assert_array_equal(table.reshape(3, 256), dq[:, :, k], name)
    assert tuple(dq[1, -1]) == (5347, 7312) and tuple(dq[2, -1]) == (21387, 29247)


MATRICES = ((1, 1), (2, 1), (5, 1), (6, 1), (9, 1), (0, 1), (4, 1), (7, 1), (8, 1), (12, 1),
            (12, 4), (12, 5), (12, 9), (12, 22), (15, 1), (16, 1), (3, 1), (10, 1), (11, 1),
            (13, 1), (14, 1), (17, 1))


@pytest.mark.parametrize("fmt", ["400", "420", "422", "444"])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_conversion_is_libavifs(lib, depth, channels, fmt):
    """native.avif_yuv_to_rgb (with the alpha plane) against the wheel's
    avifImageYUVToRGB to 8-bit RGB or RGBA on seeded planes: both ranges,
    every matrix code with its primaries (libyuv's constants, libavif's
    float paths, the codes libavif refuses), odd and even sizes. At 10 and
    12 bits libavif cuts every plane to 8 bits for libyuv's 8-bit rows,
    but for 10-bit RGBA (libyuv's 10-bit AlphaToARGB rows) and 12-bit
    4:2:0 RGBA (I012ToARGBMatrix, nearest chroma), and takes its float
    paths at the planes' depth elsewhere."""
    rng = np.random.default_rng(depth * 10 + channels + int(fmt))
    sx, sy = {"400": (1, 1), "420": (1, 1), "422": (1, 0), "444": (0, 0)}[fmt]
    mono = fmt == "400"
    for full in (1, 0):
        for mc, prim in MATRICES:
            for h, w in ((13, 18), (7, 9), (1, 1), (2, 3)):
                planes = [rng.integers(0, 1 << depth, (h, w))]
                if not mono:
                    planes += [rng.integers(0, 1 << depth, ((h + sy) >> sy, (w + sx) >> sx))
                               for _ in range(2)]
                alpha = rng.integers(0, 1 << depth, (h, w)) if channels == 4 else None
                want = lib.yuv_to_rgb(planes, depth, fmt, full, (prim, 13, mc), alpha)
                case = (depth, fmt, channels, full, mc, prim, h, w)
                if isinstance(want, int):  # libavif's reformat fails
                    with pytest.raises(Exception, match="libavif cannot convert"):
                        native.avif_yuv_to_rgb(planes, (sx, sy), full, mc, prim, channels,
                                               depth, alpha)
                    continue
                got = native.avif_yuv_to_rgb(planes, (sx, sy), full, mc, prim, channels, depth,
                                             alpha)
                np.testing.assert_array_equal(got, want, str(case))


def test_unpremultiply_is_libavifs(lib):
    """native.avif_unpremultiply against the wheel's
    avifRGBImageUnpremultiplyAlpha on every (colour, alpha) pair of 8-bit
    values and on seeded RGBA: libyuv's ARGBUnattenuate as its x86 SIMD
    rows compute it (alpha 1 takes a colour of 128 or more to 0)."""
    grid = np.zeros((256, 256, 4), np.uint8)
    values = np.arange(256, dtype=np.uint8)
    grid[:, :, 0], grid[:, :, 1] = values[None, :], values[None, ::-1]
    grid[:, :, 2] = np.random.default_rng(1).integers(0, 256, (256, 256))
    grid[:, :, 3] = values[:, None]
    for rgba in (grid, np.random.default_rng(2).integers(0, 256, (37, 53, 4)).astype(np.uint8)):
        got = rgba.copy()
        native.avif_unpremultiply(got)
        np.testing.assert_array_equal(got, lib.unpremultiply(rgba))
    assert grid[1, 200, 3] == 1 and lib.unpremultiply(grid)[1, 200, 0] == 0


DECODER_FILES = ("sem_400_0.avif", "persp_420_v0.avif", "yuv444.avif", "limited.avif",
                 "lossless.avif", "tiled.avif", "qm_iq_444_low.avif", "grain_v1.avif",
                 "grain_v16.avif", "grain_400.avif", "grid_2x3_alpha.avif")


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("name", DECODER_FILES)
def test_decoder_planes_are_dav1ds(name, depth):
    """native.av1_decode against the wheel's dav1d (ctypes, film grain
    applied) on the committed files rewritten to 10 and 12 bits, every
    av01 item (colour, alpha, grid tiles): the same uint16 YUV planes, so
    the decoder is held apart from the conversion (4:0:0, 4:2:0, 4:2:2,
    4:4:4, limited range, lossless, tiles, quantizer matrices, film grain,
    the loop filters)."""
    dav1d = Dav1d()
    data = high_depth(_data(name), depth)
    items, _ = _items(data)
    samples = [(item, b"".join(data[o:o + n] for o, n in item.extents))
               for item in items.values() if item.type == b"av01"]
    assert samples
    for item, sample in samples:
        want, bpc = dav1d.decode(sample)
        got, fields = native.av1_decode(sample, *avif._ispe(data, item))
        assert bpc == fields["depth"] == depth and len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, f"item {item.id}")


# -- whole files -------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("rng", ["full", "limited"])
@pytest.mark.parametrize("sub", ["4:0:0", "4:2:0", "4:2:2", "4:4:4"])
@pytest.mark.parametrize("depth", [10, 12])
def test_files_equal_pillows(depth, sub, rng, alpha):
    """Pillow's 8-bit files rewritten to 10 and 12 bits, every
    subsampling, both ranges, RGB and RGBA (the alpha a 10- or 12-bit
    stream too, at the colour's range): the port's mode and pixels are
    Pillow's, bit for bit."""
    seed = depth + len(sub) + len(rng) + alpha
    img = _rgba(40, 56, seed) if alpha else _natural(40, 56, seed)
    data = _avif(img, "RGBA" if alpha else "RGB", subsampling=sub, range=rng, quality=70)
    out = high_depth(data, depth)
    assert avif.parse(out).mode == ("RGBA" if alpha else "RGB")
    _assert_as_pillow(out)


def test_probe_files_read_as_pillow():
    """The two kinds the port refused until it read them: a 64x48 RGB
    4:2:0 file with only the sequence header's high_bitdepth set (a
    10-bit profile 0 stream inside 8-bit boxes) and Pillow's
    alpha_premultiplied=True RGBA file."""
    from .test_torch_avif import _seq_header_bits, _set_bit

    data = _avif(_natural(48, 64, 3), "RGB")
    bits, fwb, fhb = _seq_header_bits(data)
    ten = _set_bit(data, bits + 24 + fwb + fhb)
    assert native.av1_decode(*(lambda f: (b"".join(ten[o:o + n] for o, n in f.color),
                                          *f.size))(avif.parse(ten)))[1]["depth"] == 10
    _assert_as_pillow(ten)
    prem = _avif(_rgba(48, 64, 4), "RGBA", alpha_premultiplied=True)
    assert avif.parse(prem).premultiplied
    _assert_as_pillow(prem)


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4", "4:0:0"])
def test_premultiplied_alpha_files(depth, sub):
    """Pillow's premultiplied RGBA files (a prem reference from the alpha
    to the colour), at 8 bits and rewritten to 10 and 12: the port
    divides the alpha out after the conversion as libavif does, to
    Pillow's planes bit for bit."""
    data = _avif(_rgba(33, 47, depth), "RGBA", subsampling=sub, alpha_premultiplied=True)
    _assert_as_pillow(data if depth == 8 else high_depth(data, depth))


KIND_FILES = ("grid_2x3_alpha.avif", "grid_2x3_alpha_cropped.avif", "qm_420.avif",
              "qm_iq_444_high.avif", "grain_v10.avif", "grain_400.avif")


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("name", KIND_FILES)
def test_grid_qm_and_grain_files(name, depth):
    """The committed grid (colour and alpha, whole and cropped), quantizer
    matrix and film grain files rewritten to 10 and 12 bits: Pillow's
    planes bit for bit (dequantisation, QM weights and grain at the new
    depth; tiles stitched in 16-bit YUV)."""
    _assert_as_pillow(high_depth(_data(name), depth))


MATRIX_FILES = sorted(n for n in (*chip_smoke.AVIF_KINDS_DECODE_ONLY, *chip_smoke.AVIF_KINDS_FAIL)
                      if n.startswith("mc"))


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("name", MATRIX_FILES)
def test_matrix_code_files(name, depth):
    """One file per matrix code (4:4:4 and 4:2:0, full and limited range)
    rewritten to 10 and 12 bits: read to Pillow's planes, or refused at
    the step Pillow's load fails at (the codes libavif cannot convert)."""
    _assert_as_pillow(high_depth(_data(name), depth))


def _items(data):
    meta = next((s, e) for t, s, e in avif._boxes(data, 0, len(data)) if t == b"meta")
    items, primary, _ = avif._parse_meta(data, *meta)
    return items, primary


def _with_tile_config(data, tile_pos, edit):
    """The grid file with its tile_pos'th colour tile given its own copy of
    the av1C property, edited by edit(bytes) -> bytes (same length)."""
    top = list(avif._boxes(data, 0, len(data)))
    meta = next((s, e) for t, s, e in top if t == b"meta")
    items, primary, _ = avif._parse_meta(data, *meta)
    tid = items[primary].refs[b"dimg"][tile_pos]
    iprp = next((s, e) for t, s, e in avif._boxes(data, meta[0] + 4, meta[1]) if t == b"iprp")
    ipco = next((s, e) for t, s, e in avif._boxes(data, *iprp) if t == b"ipco")
    props = list(avif._boxes(data, *ipco))
    k = next(i for i, (t, s, e) in enumerate(props) if t == b"av1C" and any(
        tt == b"av1C" and ss == s for tt, ss, ee in items[tid].props))
    t, s, e = props[k]
    box = data[s - 8:e]
    new = box[:8] + edit(box[8:])
    n = len(new)
    out = bytearray(data[:ipco[1]] + new + data[ipco[1]:])
    for hdr in (meta[0] - 8, iprp[0] - 8, ipco[0] - 8):
        struct.pack_into(">I", out, hdr, struct.unpack_from(">I", data, hdr)[0] + n)
    # ipma: the tile's association with property k + 1 now names the new one.
    ipma = next((s2, e2) for t2, s2, e2 in avif._boxes(data, *iprp) if t2 == b"ipma")
    assert data[ipma[0]:ipma[0] + 4] == b"\0\0\0\0"
    p = ipma[0] + 8
    for _ in range(struct.unpack_from(">I", data, ipma[0] + 4)[0]):
        iid, cnt = struct.unpack_from(">HB", data, p)
        for j in range(cnt):
            if iid == tid and data[p + 3 + j] & 0x7F == k + 1:
                out[p + 3 + j + n] = (data[p + 3 + j] & 0x80) | (len(props) + 1)
        p += 3 + cnt
    # iloc: every extent (in mdat, after meta) moves by n.
    iloc = next(s2 for t2, s2, e2 in avif._boxes(data, meta[0] + 4, meta[1]) if t2 == b"iloc")
    assert data[iloc:iloc + 6] == b"\0\0\0\0\x44\x00"
    q = iloc + 8
    for _ in range(struct.unpack_from(">H", data, iloc + 6)[0]):
        ne = struct.unpack_from(">H", data, q + 4)[0]
        q += 6
        for _ in range(ne):
            off, ln = struct.unpack_from(">II", data, q)
            struct.pack_into(">I", out, q, off + n)
            q += 8
    return bytes(out)


def _refused():
    """Files Pillow fails on, by kind."""
    rgba = _avif(_rgba(32, 48, 7), "RGBA")
    items, primary = _items(rgba)
    alpha = next(i for i in items if i != primary and items[i].type == b"av01")
    ten = high_depth(_avif(_natural(32, 48, 8), "RGB"), 10)
    pixi = ten.index(b"pixi") + 4  # version, flags, channel count, depths
    av1c = ten.index(b"av1C") + 6  # tier, high_bitdepth, twelve_bit, mono, subsampling
    eight = high_depth(_avif(_natural(32, 48, 8), "RGB"), 10, boxes=False)
    eight_av1c = eight.index(b"av1C") + 6
    grid = high_depth(_data("grid_2x3_alpha.avif"), 10)
    return {
        "alpha 8 bits, colour 10": high_depth(rgba, 10, skip=(alpha,)),
        "alpha 10 bits, colour 8": high_depth(rgba, 10, skip=(primary,)),
        "alpha 12 bits, colour 10": high_depth(high_depth(rgba, 10, skip=(alpha,)), 12,
                                               skip=(primary,)),
        "alpha stream 8 bits in 10-bit boxes": high_depth(
            high_depth(rgba, 10, skip=(alpha,)), 10, skip=(primary,), stream=False),
        "av1C 10 with pixi 8": eight[:eight_av1c] + bytes([eight[eight_av1c] | 0x40])
        + eight[eight_av1c + 1:],
        "pixi of no channel": ten[:pixi + 4] + b"\x00" + ten[pixi + 5:],
        "pixi of mixed depths": ten[:pixi + 6] + b"\x08" + ten[pixi + 7:],
        "av1C 12 with pixi 10": ten[:av1c] + bytes([ten[av1c] | 0x20]) + ten[av1c + 1:],
        "grid tile of another chroma sample position": _with_tile_config(
            grid, 1, lambda b: b[:2] + bytes([b[2] ^ 0x01]) + b[3:]),
        "grid tile of another level": _with_tile_config(
            grid, 4, lambda b: b[:1] + bytes([b[1] ^ 0x01]) + b[2:]),
    }


@pytest.mark.parametrize("kind", sorted(_refused()))
def test_fails_where_pillow_fails(kind):
    """Files Pillow fails on fail in the port at the same step: an alpha
    stream of another depth than the colour's (the load), pixi depths
    that are not av1C's (the open passes the file on), a pixi of no
    channel or of mixed depths (libavif's open: not implemented), a grid
    tile whose av1C differs from the other tiles' (the open)."""
    data = _refused()[kind]
    assert _pillow(data)[0] in ("open", "load"), kind
    _assert_as_pillow(data)


def test_grid_tile_of_its_own_equal_av1c():
    """A grid tile with its own av1C property, equal to the other tiles'
    but in its initial presentation delay byte, reads as Pillow reads it
    (libavif compares the profile, level, tier, depth, monochrome,
    subsampling and chroma sample position fields only)."""
    grid = high_depth(_data("grid_2x3_alpha.avif"), 12)
    _assert_as_pillow(_with_tile_config(grid, 1, lambda b: b))
    _assert_as_pillow(_with_tile_config(grid, 2, lambda b: b[:3] + bytes([b[3] ^ 0x10])))


def test_boxes_do_not_set_the_depth():
    """libavif takes the depth from the AV1 stream, whatever av1C and pixi
    say: a 10-bit stream in 8-bit boxes and an 8-bit stream in 10-bit
    boxes both read, to Pillow's planes."""
    data = _avif(_natural(32, 48, 9), "RGB")
    for out in (high_depth(data, 10, boxes=False), high_depth(data, 10, stream=False)):
        _assert_as_pillow(out)


def test_no_high_depth_refusal_left():
    """No refusal of high bit depth or premultiplied alpha is left in the
    port's reader."""
    pkg = os.path.join(ROOT, "cybervision_tpu_torch")
    for path in glob.glob(os.path.join(pkg, "**", "*.*"), recursive=True):
        if path.endswith((".py", ".cpp", ".h")):
            with open(path) as fh:
                text = fh.read()
            assert "bit depth above 8" not in text and "premultiplied alpha is not" not in text


# -- the committed files, the JAX package's loader, the CLI ---------------------------


def test_phase8x_files_decode_to_the_committed_hashes():
    """Phase 8 (x)'s committed files (chip_smoke.AVIF_DEPTH_*) decode to
    the committed SHA-256 of Pillow's planes, which Pillow here gives
    too; the views carry EXIF focal length 43."""
    with open(chip_smoke.FORMATS_SHA256) as fh:
        committed = json.load(fh)["avif depth"]
    paths = chip_smoke.AVIF_DEPTH_SEM + chip_smoke.AVIF_DEPTH_PERSP
    assert sorted(committed) == sorted(os.path.basename(p) for p in paths)
    for path in paths:
        src = timages.SourceImage.load(path)
        want = committed[os.path.basename(path)]
        assert chip_smoke._plane_sha(src.img) == want["l"], path
        assert chip_smoke._plane_sha(src.load_rgb_plane()) == want["rgb"], path
        with Image.open(path) as im:
            assert chip_smoke._plane_sha(np.asarray(im.convert("RGB"))) == want["rgb"], path
    assert all(timages.SourceImage.load(p).focal_length_35mm == 43
               for p in chip_smoke.AVIF_DEPTH_PERSP)
    f = avif.parse(_data(os.path.basename(chip_smoke.AVIF_DEPTH_PERSP[0])))
    assert f.premultiplied and f.mode == "RGBA"


@pytest.mark.parametrize("case", ["10-bit gray 4:0:0", "12-bit premultiplied RGBA focal 43"])
def test_jax_loader_equals_ports(tmp_path, case):
    """The JAX package's SourceImage.load and load_rgb against the port's
    on the same 10- or 12-bit file: equal gray and colour arrays and
    focal length."""
    img = _natural(48, 64, 11)
    if case.startswith("10-bit"):
        data = high_depth(_avif(img[:, :, 0], "L", subsampling="4:0:0"), 10)
    else:
        data = high_depth(_avif(_rgba(48, 64, 12), "RGBA", alpha_premultiplied=True,
                                exif=_focal_exif(0)), 12)
    path = str(tmp_path / "v.avif")
    with open(path, "wb") as fh:
        fh.write(data)
    src_j, rgb_j = _jax_load(path)
    src_t = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src_t.img, src_j.img)
    np.testing.assert_array_equal(src_t.load_rgb_plane(), rgb_j)
    assert src_t.focal_length_35mm == (None if case.startswith("10-bit") else 43)


def test_cli_cpu_10bit_pair_ply_matches_jax_without_pillow(tmp_path, monkeypatch):
    """tests/test_pipeline.py's 160x160 SEM pair as 10-bit 4:0:0 AVIF: the
    port's cli.main, with every import of Pillow blocked, writes the JAX
    CLI's PLY."""
    img1, img2, _ = _sem_pair(np.random.RandomState(7))
    paths = []
    for k, img in enumerate((img1, img2)):
        paths.append(str(tmp_path / f"sem{k}.avif"))
        with open(paths[-1], "wb") as fh:
            fh.write(high_depth(_avif(img, "L", subsampling="4:0:0", quality=90), 10))
    out_j, out_t = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jax_reconstruct(paths, out_j, _fast_cfg(mesh=JMeshMode.VERTEX_COLORS), quiet=True)
    monkeypatch.setattr(cli, "ReconstructionConfig", _port_fast_cfg)
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)  # any import of Pillow now raises
    rc = cli.main(["--mode=cpu", "--projection=parallel", "--mesh=vertex-colors", *paths, out_t])
    assert rc == 0
    nv_j, nf_j, _ = _read_ply(out_j)
    nv_t, nf_t, _ = _read_ply(out_t)
    assert nv_j > 3000 and (nv_t, nf_t) == (nv_j, nf_j)
    with open(out_j, "rb") as fa, open(out_t, "rb") as fb:
        assert fa.read() == fb.read()
