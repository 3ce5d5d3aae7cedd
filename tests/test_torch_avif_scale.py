"""The port's AVIF reader on superres AV1 key frames and on frames of
another size than their item's ispe (native/av1obu.cpp, av1filter.cpp,
native/yuvscale.cpp, imageio/avif.py) against Pillow 12.1 with libavif
1.3 (dav1d 1.5.1, libyuv 1909), which the JAX package reads through; and
CVTPU_PROFILE's trace of a run.

The wheel's aom writes no superres, so the superres streams are aom's
(or the port's own encoder's) streams coded at the downscaled width,
rewritten as superres streams of the upscaled width
(tests/gen_torch_formats_fixture.py's superres_stream and superres);
the scaled files are files whose ispe was edited (with_ispe). Each stage
is pinned on its own: the upscaling taps against dav1d's table in the
wheel's bytes, the decoder's upscaled planes against the wheel's dav1d,
the plane scaling against the wheel's exported avifImageScale on seeded
planes (every path libyuv takes, at 8, 10 and 12 bits); then whole files
against Pillow's planes, the committed hashes and the JAX package's
loader, and the sizes libavif refuses at the step where Pillow fails.
"""

import glob
import io
import json
import os
import re
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from cybervision_tpu_torch import config as tcfg
from cybervision_tpu_torch import images as timages
from cybervision_tpu_torch import native
from cybervision_tpu_torch.imageio import avif
from cybervision_tpu_torch.reconstruction import Reconstruction, reconstruct

from .gen_torch_formats_fixture import (
    Dav1d, Libavif, _high_depth_sample, _superres_coded, depth_views, frame_headers, high_depth,
    superres, superres_stream, with_ispe, yuv_field,
)
from .test_pipeline import _sem_pair
from .test_torch_avif import _assert_as_pillow, _iloc_rewritten, _pillow, _port
from .test_torch_images import _jax_load
from .test_torch_pipeline import _port_fast_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    return Libavif()


@pytest.fixture(scope="module")
def dav1d():
    return Dav1d()


def _data(name: str) -> bytes:
    with open(os.path.join(chip_smoke.AVIF_DIR, name), "rb") as fh:
        return fh.read()


def _sample(data: bytes) -> bytes:
    f = avif.parse(data)
    return b"".join(data[o:o + n] for o, n in f.color)


# -- the stages ------------------------------------------------------------------------


def test_upscale_filter_is_dav1ds():
    """av1tables.h's Upscale_Filter equals dav1d's dav1d_resize_filter
    (the specification's taps negated), found again in the wheel's
    library bytes: 64 phases of 8 taps summing to 128."""
    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    with open(glob.glob(os.path.join(libs, "libavif-*.so*"))[0], "rb") as fh:
        data = fh.read()
    at = data.find(np.array([0, 0, 0, -128, 0, 0, 0, 0, 0, 0, 1, -128], "i1").tobytes())
    assert at >= 0
    theirs = -np.frombuffer(data[at:at + 512], "i1").astype(int).reshape(64, 8)
    with open(os.path.join(ROOT, "cybervision_tpu_torch", "native", "av1tables.h")) as fh:
        body = re.search(r"kUpscaleFilter\[64\]\[8\] = \{([^}]*)\}", fh.read()).group(1)
    ours = np.array([int(v) for v in body.replace("\n", " ").split(",") if v.strip()])
    np.testing.assert_array_equal(ours.reshape(64, 8), theirs)
    assert (theirs.sum(axis=1) == 128).all()


# (encoder, subsampling, denominator, upscaled width, height, depth, aom
# options): aom's streams through the wheel's libavif, the port's own
# encoder's (4:2:0 and 4:0:0 only); odd widths; the 16-sample floor,
# where dav1d keeps the width; loop restoration and CDEF on aom's.
STREAMS = {
    "port 4:2:0 d9 1024": ("port", "420", 9, 1024, 64, 8, ()),
    "port 4:0:0 d12 odd": ("port", "400", 12, 97, 33, 8, ()),
    "port 4:2:0 d16 15 wide": ("port", "420", 16, 15, 9, 8, ()),
    "aom 4:4:4 d10": ("aom", "444", 10, 120, 40, 8, ()),
    "aom 4:2:2 d14 odd": ("aom", "422", 14, 121, 64, 8, ()),
    "aom 4:0:0 d11 10-bit": ("aom", "400", 11, 77, 50, 10, ()),
    "aom 4:2:0 d16 12-bit": ("aom", "420", 16, 99, 70, 12, ()),
    "aom 4:4:4 d13 12-bit": ("aom", "444", 13, 83, 47, 12, ()),
    "aom 4:2:0 cdef lr": ("aom", "420", 12, 150, 80, 8, (("enable-restoration", "1"),
                                                         ("enable-cdef", "1"))),
    "aom 4:2:0 cdef lr 10-bit": ("aom", "420", 9, 95, 70, 10, (("enable-restoration", "1"),
                                                               ("enable-cdef", "1"))),
    "aom 4:4:4 lr 12-bit": ("aom", "444", 15, 301, 64, 12, (("enable-restoration", "1"),)),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_superres_planes_are_dav1ds(lib, dav1d, case):
    """native.av1_decode of a superres stream gives the wheel's dav1d's
    upscaled planes bit for bit: CDEF on the coded width, the upscaling
    (8 taps, 14-bit positions, chroma at its own widths, every depth),
    loop restoration on the upscaled frame (one unit a plane at either
    width, so the units' symbols sit where the superres frame reads
    them)."""
    kind, fmt, denom, width, height, depth, options = STREAMS[case]
    coded = _superres_coded(width, denom)
    field = yuv_field(height, coded, denom, fmt)
    if options:  # noise, so that aom's search keeps its restoration
        rng = np.random.default_rng(denom)
        field = [np.clip(p.astype(int) + rng.integers(-30, 30, p.shape), 0, 255).astype(np.uint8)
                 for p in field]
    if kind == "port":
        stream = native.av1_encode(field)
    else:
        data = lib.encode([lib.image(field, fmt, True, (1, 13, 6))], quality=30,
                          speed=0 if options else 6, options=options)
        if options:
            seq, frame = frame_headers(data)
            assert seq.restoration and any(frame.lr), frame.lr
        stream = _sample(data)
    stream = superres_stream(stream, denom, width)
    if depth > 8:
        stream = _high_depth_sample(stream, depth)[0]
    want, bpc = dav1d.decode(stream)
    got, fields = native.av1_decode(stream, width, height)
    assert bpc == fields["depth"] == depth
    assert [p.shape for p in got] == [p.shape for p in want]
    assert got[0].shape == (height, width)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b, case)


# (source size, destination size) of each path libyuv's ScalePlane takes
# at kFilterBox after ScaleFilterReduce.
PATHS = {
    "copy (a chroma plane of the same size)": ((95, 39), (96, 40)),
    "vertical, bilinear": ((50, 40), (50, 79)),
    "vertical, nearest (a third of the rows)": ((50, 60), (50, 20)),
    "3/4 (SSSE3 rows and their C tail)": ((136, 40), (102, 30)),
    "1/2": ((64, 48), (32, 24)),
    "3/8": ((128, 48), (48, 18)),
    "3/8 (SSSE3 rows and their C tail)": ((72, 24), (27, 9)),
    "1/4": ((64, 64), (16, 16)),
    "box": ((97, 61), (30, 20)),
    "box of more rows than 16-bit sums hold": ((700, 600), (3, 2)),
    "2x bilinear": ((51, 41), (101, 81)),
    "2x linear (rows kept)": ((50, 40), (99, 40)),
    "bilinear up": ((50, 40), (77, 53)),
    "bilinear down": ((50, 40), (37, 29)),
    "bilinear down the rows, up the columns": ((50, 40), (77, 29)),
    "linear (rows kept)": ((50, 40), (37, 40)),
    "nearest (a third of the columns, rows kept)": ((60, 40), (20, 40)),
    "nearest (one column)": ((1, 40), (3, 20)),
}


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_yuvscale_is_libavifs(lib, path, depth):
    """native.avif_scale of seeded planes equals the wheel's exported
    avifImageScale (libavif's avifImageScaleWithLimit over libyuv's
    ScalePlane at 8 bits, ScalePlane_12 above, at kFilterBox) bit for bit
    on every path, with the rows this CPU's libyuv picks (SSSE3 and AVX2:
    ScaleFilterCols_SSSE3's 7-bit blend, the 3/4 and 3/8 SSSE3 boxes'
    rows blended first, ScaleAddRow_AVX2's saturating sums), on a lone
    luma plane and on 4:2:0 planes with an alpha."""
    (sw, sh), (dw, dh) = PATHS[path]
    rng = np.random.default_rng(sw * 1000 + dw + depth)
    dtype = np.uint16 if depth > 8 else np.uint8
    y = rng.integers(0, 1 << depth, (sh, sw)).astype(dtype)
    if path.startswith("box of more rows"):
        y[:, :400] = (1 << depth) - 1  # sums past 16 bits on the SIMD columns
    want = lib.scale([y], depth, "400", dw, dh)
    np.testing.assert_array_equal(native.avif_scale([y], (0, 0), dw, dh)[0], want[0])
    chroma = [rng.integers(0, 1 << depth, ((sh + 1) // 2, (sw + 1) // 2)).astype(dtype)
              for _ in range(2)]
    alpha = rng.integers(0, 1 << depth, (sh, sw)).astype(dtype)
    want = lib.scale([y, *chroma], depth, "420", dw, dh, alpha)
    got = native.avif_scale([y, *chroma], (1, 1), dw, dh) + native.avif_scale([alpha], (0, 0),
                                                                              dw, dh)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_yuvscale_seeded_sizes_are_libavifs(lib):
    """The same on 300 seeded sizes and formats: random ratios, the
    exact ones and 2x, up and down, at 8, 10 and 12 bits."""
    rng = np.random.default_rng(7)
    for _ in range(300):
        depth = int(rng.choice([8, 10, 12]))
        fmt = str(rng.choice(["400", "420", "422", "444"]))
        sw, sh = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        mode = int(rng.integers(0, 5))
        if mode == 1:
            k = int(rng.choice([2, 4]))
            sw, sh, dw, dh = sw * k, sh * k, sw, sh
        elif mode == 2:
            sw, sh, dw, dh = sw * 8, sh * 8, sw * 3, sh * 3
        elif mode == 3:
            dw, dh = sw * 2 - int(rng.integers(0, 2)), sh * 2 - int(rng.integers(0, 2))
        else:
            dw, dh = int(rng.integers(1, 140)), int(rng.integers(1, 140))
        sx, sy = {"420": (1, 1), "422": (1, 0)}.get(fmt, (0, 0))
        dtype = np.uint16 if depth > 8 else np.uint8
        planes_ = [rng.integers(0, 1 << depth, (sh, sw)).astype(dtype)]
        if fmt != "400":
            planes_ += [rng.integers(0, 1 << depth, ((sh + sy) >> sy, (sw + sx) >> sx)
                                     ).astype(dtype) for _ in range(2)]
        want = lib.scale(planes_, depth, fmt, dw, dh)
        for a, b in zip(native.avif_scale(planes_, (sx, sy), dw, dh), want):
            np.testing.assert_array_equal(a, b, str((depth, fmt, sw, sh, dw, dh)))


@pytest.mark.parametrize("src,dst", [((40, 30), (0, 30)), ((40, 30), (40, 0)),
                                     ((16385, 2), (100, 2)), ((2, 16385), (2, 100))])
def test_scale_refusals_are_libavifs(lib, src, dst):
    """The sizes avifImageScaleWithLimit refuses, with its diagnostic: a
    destination of no size, a source past libyuv's 16384 a side."""
    y = np.zeros(src[::-1], np.uint8)
    code, why = lib.scale([y], 8, "400", *dst)
    assert code != 0
    with pytest.raises(Exception, match=re.escape(why)):
        native.avif_scale([y], (0, 0), *dst)


# -- whole files -------------------------------------------------------------------------

COMMITTED = (chip_smoke.AVIF_SCALE_DECODE_ONLY + tuple(chip_smoke.AVIF_SCALE_FAIL)
             + tuple(os.path.basename(p) for p in chip_smoke.AVIF_SUPERRES_SEM))


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_files_as_pillow(name):
    """Phase 8 (y)'s committed files (superres: denominators 9-16, 4:0:0,
    4:2:0 and 4:4:4, 8, 10 and 12 bits, odd widths, alpha, loop
    restoration, a grid; scaled: the colour item, a shared colour and
    alpha ispe, a grid's tiles, up, down, one axis, 8 and 12 bits; the
    frame libyuv refuses) read as Pillow reads them, to the committed
    hashes of Pillow's planes, or fail at its step."""
    with open(chip_smoke.FORMATS_SHA256) as fh:
        committed = json.load(fh)["avif scale"][name]
    data = _data(name)
    _assert_as_pillow(data)
    if "fails" in committed:
        assert _port(data)[0] == committed["fails"]
        return
    src = timages.SourceImage.load(os.path.join(chip_smoke.AVIF_DIR, name))
    assert chip_smoke._plane_sha(src.img) == committed["l"]
    assert chip_smoke._plane_sha(src.load_rgb_plane()) == committed["rgb"]


def _limited_alpha(data: bytes) -> bytes:
    """A Pillow RGBA file with its alpha stream's color_range set to
    limited."""
    from .gen_torch_formats_fixture import _SeqBits, _leb128, _obus, _packed, _with_edits

    meta = next((s, e) for t, s, e in avif._boxes(data, 0, len(data)) if t == b"meta")
    items, primary, _ = avif._parse_meta(data, *meta)
    alpha = next(i for i in items.values() if i.type == b"av01" and i.id != primary)
    off, n = alpha.extents[0]
    out = b""
    for hdr, payload in _obus(data[off:off + n]):
        if (hdr[0] >> 3) & 15 == 1:
            seq = _SeqBits(payload)
            at = seq.cc + 3 + (24 if seq.cicp else 0)  # high_bitdepth, mono, cicp flag
            bits = list(seq.bits[:seq.end])
            assert seq.mono and bits[at] == 1
            bits[at] = 0
            payload = _packed(bits + [1])
        out += hdr + _leb128(len(payload)) + payload
    return _with_edits(data, [(off, n, out)])


def _rgba_file(h=60, w=90) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(depth_views()[1][100:100 + h, 40:40 + w], "RGBA").save(buf, "AVIF", quality=60)
    return buf.getvalue()


def _sequence_sized(size) -> bytes:
    """The committed three-frame sequence with its track header's size
    set to `size`: libavif scales a track's frames to it."""
    data = bytearray(_data("sequence.avif"))
    at = data.index(b"tkhd") + 4
    width = at + 4 + (84 if data[at] == 1 else 72)
    struct.pack_into(">II", data, width, size[0] << 16, size[1] << 16)
    return bytes(data)


GENERATED = {
    "limited-range alpha, scaled (full range before the scale)":
        lambda: with_ispe(_limited_alpha(_rgba_file()), (131, 47)),
    "limited-range alpha, 12-bit, scaled": lambda: with_ispe(
        high_depth(_limited_alpha(_rgba_file()), 12), (45, 30)),
    "ispe of one column": lambda: with_ispe(_data("mc1_420_full.avif"), (1, 80)),
    "ispe of one row, 10-bit": lambda: with_ispe(high_depth(_data("mc1_444_full.avif"), 10),
                                                 (96, 1)),
    "ispe of no width": lambda: with_ispe(_data("mc1_420_full.avif"), (0, 80)),
    "grid tiles of no height": lambda: with_ispe(_data("grid_2x3_alpha.avif"), (64, 0),
                                                 lambda item: item.type == b"av01"),
    "grid tiles scaled too small": lambda: with_ispe(_data("grid_2x3_alpha.avif"), (63, 64),
                                                     lambda item: item.type == b"av01"),
    "superres grid tiles scaled": lambda: with_ispe(_data("superres_grid_alpha.avif"), (80, 70),
                                                    lambda item: item.type == b"av01"),
    "superres item scaled back down": lambda: with_ispe(_data("superres_d9_420.avif"), (86, 80)),
    "sequence track larger than its frames": lambda: _sequence_sized((192, 144)),
    "sequence track smaller than its frames": lambda: _sequence_sized((64, 48)),
    "superres RGBA, 12-bit": lambda: high_depth(superres(_rgba_file(56, 70), 10, 88), 12),
}


@pytest.mark.parametrize("case", sorted(GENERATED))
def test_generated_files_as_pillow(case):
    """Files made here: a limited-range alpha scaled (libavif widens it to
    full range before the scale), one-column and one-row items, items and
    tiles of no size (Pillow's open fails), tiles scaled below the grid
    (its load fails), superres tiles and items scaled, a sequence whose
    track header asks for another size, a 12-bit superres RGBA file."""
    _assert_as_pillow(GENERATED[case]())


def test_construction_method_2_fails_as_pillow():
    """iloc version 1 with construction method 2 (item offsets): libavif's
    parse fails ("unsupported construction method"), so Pillow's open
    does, and the port's."""
    data = _iloc_rewritten(_data("mc1_420_full.avif"), 1, 2)
    assert _pillow(data)[0] == "open"
    assert _port(data)[0] == "open"


@pytest.mark.parametrize("name", ["sem_400_superres_0.avif", "superres_d10_rgba.avif",
                                  "scaled_rgba_12bit.avif", "scaled_grid_tiles.avif",
                                  "scaled_wide_refused.avif"])
def test_jax_loader_equals_ports(name):
    """The JAX package's SourceImage.load and load_rgb (Pillow) against the
    port's on superres and scaled files: the same planes, or both refuse."""
    path = os.path.join(chip_smoke.AVIF_DIR, name)
    ref = _jax_load(path)
    if isinstance(ref, Exception):
        assert name in chip_smoke.AVIF_SCALE_FAIL
        with pytest.raises(Exception):
            timages.SourceImage.load(path).load_rgb_plane()
        return
    src_j, rgb_j = ref
    src_t = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src_t.img, src_j.img)
    np.testing.assert_array_equal(src_t.load_rgb_plane(), rgb_j)


# -- CVTPU_PROFILE -------------------------------------------------------------------------


def _run(tmp_path, monkeypatch, profile: bool):
    """A CPU run of the 160x160 pair with CVTPU_PROFILE set to a directory
    under tmp_path, or unset; the torch.profiler.profile calls made."""
    img1, img2, _ = _sem_pair(np.random.RandomState(7))
    images = [timages.SourceImage(im) for im in (img1, img2)]
    calls = []
    real = torch.profiler.profile

    def counted(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(torch.profiler, "profile", counted)
    if profile:
        monkeypatch.setenv("CVTPU_PROFILE", str(tmp_path / "trace"))
    else:
        monkeypatch.delenv("CVTPU_PROFILE", raising=False)
    torch.set_num_threads(2)
    reconstruct(["a", "b"], str(tmp_path / "out.ply"), _port_fast_cfg(
        projection=tcfg.ProjectionMode.AFFINE, hardware=tcfg.HardwareMode.CPU), quiet=True,
        images=images)
    return calls


def test_cvtpu_profile_writes_a_trace(tmp_path, monkeypatch):
    """CVTPU_PROFILE=<dir> runs Reconstruction.run under torch.profiler
    (the JAX package's jax.profiler.trace) and writes its Chrome trace
    into the directory: host operators only on the CPU."""
    calls = _run(tmp_path, monkeypatch, True)
    assert len(calls) == 1
    activities = calls[0]["activities"]
    assert activities == [torch.profiler.ProfilerActivity.CPU]
    traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_no_profiler_without_cvtpu_profile(tmp_path, monkeypatch):
    """Unset, no profiler runs and nothing is written (the pipeline's own
    work stubbed: only Reconstruction.run's wrapping is under test)."""
    monkeypatch.setattr(Reconstruction, "_run_affine", lambda self: torch.ones(3).sum())
    assert _run(tmp_path, monkeypatch, False) == []
    assert not (tmp_path / "trace").exists()
