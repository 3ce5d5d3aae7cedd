"""The JPEG codings the port's reader took last (imageio/jpeg.py and the
native library's jpeg_decode): arithmetic-coded sequential and
progressive JPEG, 8-bit lossless JPEG and libjpeg-turbo's block smoothing
of progressive files whose last scans are missing, against the JAX
package, which reads through Pillow 12.1 (libjpeg-turbo 3.1): for every
file the same read_metadata, SourceImage.load gray plane and colour
plane, bit for bit; where Pillow refuses a file the port raises an
ImageError, and where it refuses one libjpeg-turbo does not decode
either, without "yet".

Pillow writes neither arithmetic-coded nor lossless JPEG: chip_smoke.py's
writers do (arith_jpeg, lossless_jpeg). An arithmetic file made from the
quantised coefficients of a baseline file Pillow wrote (read back by
_baseline_coefficients) must read, in Pillow and in the port, to that
baseline file's planes; a lossless file with point transform 0 to the
source samples.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from cybervision_tpu import images as jimages
from cybervision_tpu_torch import imageio
from cybervision_tpu_torch import images as timages
from cybervision_tpu_torch.errors import ImageError
from cybervision_tpu_torch.imageio import UnsupportedImageError, jpeg

from .test_torch_images import _exif_bytes, _jax_load, _meta, _texture
from .test_torch_raster_formats import _assert_same, _write

JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def _adobe(transform: int) -> bytes:
    return b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform])


def _exif_segment(focal: int) -> bytes:
    body = b"Exif\x00\x00" + _exif_bytes(ifd0={41989: focal})
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def _baseline_coefficients(data: bytes):
    """(coefficients, quant, sampling, width, height, ids) of a baseline
    Huffman JPEG with one scan, as arith_jpeg takes them: per component
    (rows, cols, 64) natural order over its MCU grid (a one-component
    file's own block grid, sampling 1x1), the (n, 64) tables of its
    components in natural order."""
    pos, qt, huff, restart = 2, {}, {}, 0
    while True:
        marker = data[pos + 1]
        (n,) = struct.unpack_from(">H", data, pos + 2)
        body = data[pos + 4 : pos + 2 + n]
        pos += 2 + n
        k = 0
        if marker == 0xDB:
            while k < len(body):
                table = np.zeros(64, np.uint16)
                table[chip_smoke.JPEG_NATURAL] = np.frombuffer(body[k + 1 : k + 65], np.uint8)
                qt[body[k] & 15] = table
                k += 65
        elif marker == 0xC4:
            while k < len(body):
                counts = list(body[k + 1 : k + 17])
                codes, code, j = {}, 0, 0
                for length in range(1, 17):
                    for _ in range(counts[length - 1]):
                        codes[(length, code)] = body[k + 17 + j]
                        code, j = code + 1, j + 1
                    code <<= 1
                huff[(body[k] >> 4, body[k] & 15)] = codes
                k += 17 + sum(counts)
        elif marker == 0xC0:
            height, width, nc = struct.unpack_from(">HHB", body, 1)
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                      body[8 + 3 * i]) for i in range(nc)]
        elif marker == 0xDD:
            (restart,) = struct.unpack_from(">H", body)
        elif marker == 0xDA:
            tables = [(body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15) for i in range(body[0])]
            break
    if len(comps) == 1:  # a one-component scan covers the component's own blocks
        comps = [(comps[0][0], 1, 1, comps[0][3])]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    coefs = [np.zeros((mcuy * c[2], mcux * c[1], 64), np.int64) for c in comps]
    bits: list[int] = []
    at = [0, pos]  # bit position, byte position

    def interval():
        raw, p = bytearray(), at[1]
        while not (data[p] == 0xFF and data[p + 1] != 0):
            raw.append(data[p])
            p += 2 if data[p] == 0xFF else 1
        bits[:] = np.unpackbits(np.frombuffer(bytes(raw), np.uint8)).tolist()
        at[0], at[1] = 0, p

    def read(n):
        v = 0
        for _ in range(n):
            v = (v << 1) | (bits[at[0]] if at[0] < len(bits) else 1)
            at[0] += 1
        return v

    def symbol(codes):
        code = 0
        for length in range(1, 17):
            code = (code << 1) | read(1)
            if (length, code) in codes:
                return codes[(length, code)]
        raise ValueError("bad Huffman code")

    def extend(v, t):
        return v - (1 << t) + 1 if t and v < (1 << (t - 1)) else v

    interval()
    pred = [0] * len(comps)
    for m in range(mcux * mcuy):
        if restart and m and m % restart == 0:
            at[1] += 2  # RSTn
            interval()
            pred = [0] * len(comps)
        my, mx = divmod(m, mcux)
        for ci, (_, h, v, _) in enumerate(comps):
            td, ta = tables[ci]
            for by in range(v):
                for bx in range(h):
                    blk = coefs[ci][my * v + by, mx * h + bx]
                    t = symbol(huff[(0, td)])
                    pred[ci] += extend(read(t), t)
                    blk[0] = pred[ci]
                    k = 1
                    while k < 64:
                        rs = symbol(huff[(1, ta)])
                        if rs & 15:
                            k += rs >> 4
                            blk[chip_smoke.JPEG_NATURAL[k]] = extend(read(rs & 15), rs & 15)
                            k += 1
                        elif rs == 0xF0:
                            k += 16
                        else:
                            break
    quant = np.stack([qt[c[3]] for c in comps])
    return coefs, quant, [c[1:3] for c in comps], width, height, [c[0] for c in comps]


def _pillow_jpeg(px, **save) -> bytes:
    """Pillow's JPEG of an array or of an image (CMYK)."""
    buf = io.BytesIO()
    (px if isinstance(px, Image.Image) else Image.fromarray(px)).save(buf, "JPEG", **save)
    return buf.getvalue()


def _planes(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("L")), np.asarray(im.convert("RGB"))


def _assert_twin(path, twin: bytes) -> None:
    """The port's planes of `path` equal Pillow's of the Huffman twin."""
    src = timages.SourceImage.load(path)
    ref_l, ref_rgb = _planes(twin)
    np.testing.assert_array_equal(src.img, ref_l)
    np.testing.assert_array_equal(src.load_rgb_plane(), ref_rgb)


def _arith_twin(px, progressive=False, restart=0, dac=None, markers=JFIF, adobe=None,
                **save) -> tuple[bytes, bytes]:
    """(arithmetic file, Pillow's baseline twin) of the same coefficients;
    with `adobe`, the twin's Adobe transform rewritten to it and the
    arithmetic file given the same marker."""
    twin = bytearray(_pillow_jpeg(px, **save))
    if adobe is not None:
        at = twin.find(b"\xff\xee\x00\x0eAdobe")
        twin[at + 15] = adobe
        markers = _adobe(adobe)
    coefs, quant, sampling, w, h, ids = _baseline_coefficients(bytes(twin))
    data = chip_smoke.arith_jpeg(coefs, quant, w, h, sampling, ids=ids, progressive=progressive,
                                 restart=restart, dac=dac, markers=markers)
    return data, bytes(twin)


# name -> (image kind, size, save options, arith_jpeg options)
ARITH_CASES = {
    "gray": ("gray", (23, 31), {"quality": 80}, {}),
    "gray restart interval": ("gray", (40, 33), {"quality": 70}, {"restart": 2}),
    "gray 1x1": ("gray", (1, 1), {"quality": 90}, {}),
    "4:4:4": ("rgb", (29, 35), {"quality": 85, "subsampling": 0}, {}),
    "4:2:2": ("rgb", (29, 35), {"quality": 60, "subsampling": 1}, {}),
    "4:2:0": ("rgb", (37, 45), {"quality": 75, "subsampling": 2}, {}),
    "4:2:0 33x3": ("rgb", (3, 33), {"quality": 90, "subsampling": 2}, {}),
    "4:2:0 restart interval": ("rgb", (37, 45), {"quality": 75, "subsampling": 2}, {"restart": 1}),
    "4:2:0 DAC": ("rgb", (37, 45), {"quality": 95, "subsampling": 2},
                  {"dac": {0: [(0, 0, 0x52), (0, 1, 0x20), (1, 0, 12), (1, 1, 1)]}}),
    "4:2:2 DAC and restarts": ("rgb", (30, 50), {"quality": 50, "subsampling": 1},
                               {"dac": {0: [(0, 0, 0xF0), (1, 0, 63)]}, "restart": 3}),
    "CMYK": ("cmyk", (21, 26), {"quality": 85}, {"adobe": 0}),
    "YCCK": ("cmyk", (21, 26), {"quality": 85}, {"adobe": 2}),
}


def _arith_case_image(kind, size, rng):
    h, w = size
    if kind == "gray":
        return _texture(rng, h, w)
    if kind == "cmyk":
        return Image.fromarray(_texture(rng, h, w, 3)).convert("CMYK")
    return _texture(rng, h, w, 3)


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("name", sorted(ARITH_CASES))
def test_arithmetic_matches_jax_and_its_huffman_twin(tmp_path, name, progressive):
    """Each case as an arithmetic-coded sequential (SOF9) and progressive
    (SOF10, libjpeg's simple progression) file: the JAX package's planes,
    and the planes Pillow reads from the baseline file whose coefficients
    it codes. The progressive DAC cases put their DAC before scan 3 as
    well, which only the later scans may read."""
    kind, size, save, opts = ARITH_CASES[name]
    rng = np.random.RandomState(sorted(ARITH_CASES).index(name))
    px = _arith_case_image(kind, size, rng)
    opts = dict(opts)
    if progressive and "dac" in opts:
        opts["dac"] = {**opts["dac"], 3: [(1, 0, 2), (1, 1, 40), (0, 0, 0x11)]}
    data, twin = _arith_twin(px, progressive=progressive, **opts, **save)
    assert bytes([0xFF, 0xCA if progressive else 0xC9]) in data
    path = str(tmp_path / "a.jpg")
    _write(path, data)
    _assert_same(path)
    _assert_twin(path, twin)


@pytest.mark.parametrize("chunk", range(3))
def test_arithmetic_random_files_match_pillow_and_twin(tmp_path, chunk):
    """12 seeded files a chunk: sizes 1-48, qualities 5-100, gray or
    4:4:4 / 4:2:2 / 4:2:0, noise or texture, sequential or progressive,
    restart intervals 0-3 and DAC segments at random."""
    rng = np.random.RandomState(4000 + chunk)
    path = str(tmp_path / "r.jpg")
    for _ in range(12):
        h, w = rng.randint(1, 49, 2)
        px = (rng.randint(0, 256, (h, w, 3)).astype(np.uint8) if rng.rand() < 0.4
              else _texture(rng, h, w, 3))
        if rng.rand() < 0.25:
            px = px[..., 0]
        progressive = bool(rng.rand() < 0.5)
        dac = None
        if rng.rand() < 0.4:
            lo = int(rng.randint(0, 6))
            dac = {int(rng.randint(0, 3)): [(0, 0, lo | int(rng.randint(lo, 16)) << 4),
                                             (1, int(rng.randint(0, 2)), int(rng.randint(1, 64)))]}
        data, twin = _arith_twin(px, progressive=progressive, restart=int(rng.randint(0, 4)),
                                 dac=dac, quality=int(rng.randint(5, 101)),
                                 subsampling=int(rng.randint(3)))
        _write(path, data)
        msg = str((h, w, progressive, dac))
        ref = _jax_load(path)
        assert not isinstance(ref, Exception), msg
        src = timages.SourceImage.load(path)
        np.testing.assert_array_equal(src.img, ref[0].img, err_msg=msg)
        np.testing.assert_array_equal(src.load_rgb_plane(), ref[1], err_msg=msg)
        _assert_twin(path, twin)


def test_arithmetic_exif_metadata(tmp_path):
    """An arithmetic progressive file with an EXIF APP1 (focal length 43
    mm in IFD0): read_metadata and the planes as the JAX package reads
    them."""
    px = _texture(np.random.RandomState(3), 32, 40, 3)
    data, _ = _arith_twin(px, progressive=True, markers=JFIF + _exif_segment(43), quality=80)
    path = str(tmp_path / "e.jpg")
    _write(path, data)
    _assert_same(path)
    assert timages.read_metadata(path).focal_length_35mm == 43


def test_arithmetic_past_pillows_read_block(tmp_path):
    """Pillow feeds libjpeg its file 64 KiB at a time, and libjpeg's
    arithmetic decoder cannot wait for more data (JERR_CANT_SUSPEND):
    Pillow fails on an arithmetic file whose coded data runs past its
    first read, as the JAX package then does. libjpeg-turbo given the
    whole file (Pillow with a larger read block) decodes it, to the
    baseline twin's planes; the port reads it to those planes."""
    px = np.random.RandomState(6).randint(0, 256, (320, 320)).astype(np.uint8)
    data, twin = _arith_twin(px, quality=90)
    assert len(data) > 65536
    path = str(tmp_path / "big.jpg")
    _write(path, data)
    assert isinstance(_jax_load(path), Exception)
    with Image.open(path) as im:
        im.decodermaxblock = len(data)
        whole = np.asarray(im.convert("L"))
    src = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src.img, whole)
    np.testing.assert_array_equal(src.img, _planes(twin)[0])


# predictor -> [(components, Pt, restart rows, interleaved, optimised tables)]
LOSSLESS_VARIANTS = {
    1: [(1, 0, 0, True, True), (3, 1, 2, True, False), (4, 0, 1, False, True)],
    2: [(3, 0, 0, False, True), (1, 2, 3, True, False), (4, 3, 0, True, True)],
    3: [(1, 3, 1, True, True), (3, 0, 0, True, True), (4, 1, 2, False, False)],
    4: [(3, 2, 0, True, True), (1, 0, 1, True, False), (4, 0, 0, True, True)],
    5: [(1, 1, 0, True, True), (3, 3, 1, False, True), (4, 2, 0, True, False)],
    6: [(3, 0, 2, True, True), (1, 3, 0, True, True), (4, 0, 3, True, True)],
    7: [(1, 0, 0, True, False), (3, 1, 0, True, True), (4, 2, 1, False, True)],
}


@pytest.mark.parametrize("predictor", sorted(LOSSLESS_VARIANTS))
def test_lossless_matches_jax_and_the_source(tmp_path, predictor):
    """8-bit lossless files (SOF3) of every predictor: 1, 3 (RGB: no JFIF
    or Adobe marker, so libjpeg-turbo takes them as RGB) and 4 (CMYK)
    components, point transforms 0-3, restarts every 1-3 rows, one
    interleaved scan or a scan per component, optimised or standard
    tables. The planes are the JAX package's, and the source samples with
    their low Pt bits cleared."""
    rng = np.random.RandomState(100 + predictor)
    path = str(tmp_path / "l.jpg")
    for n, pt, restart, interleaved, optimal in LOSSLESS_VARIANTS[predictor]:
        h, w = rng.randint(1, 40, 2)
        src = [_texture(rng, h, w) if rng.rand() < 0.7 else rng.randint(0, 256, (h, w)).astype(
            np.uint8) for _ in range(n)]
        _write(path, chip_smoke.lossless_jpeg(src, predictor, pt, restart, interleaved, optimal))
        _assert_same(path)
        want = np.stack([(p >> pt) << pt for p in src], -1)
        f = imageio.open_image(path)
        mode, px, _ = f.decode()
        np.testing.assert_array_equal(px.reshape(want.shape), 255 - want if n == 4 else want)


@pytest.mark.parametrize("sampling", [[(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)],
                                      [(1, 2), (1, 1), (1, 1)], [(1, 1), (2, 2), (1, 1)]],
                         ids=["Y 2x2", "Y 2x1", "Y 1x2", "Cb 2x2"])
def test_lossless_subsampled_components_replicate(tmp_path, sampling):
    """Lossless RGB with a component at other sampling factors: libjpeg-
    turbo reads it and upsamples by replication (no fancy upsampling at a
    DCT size of 1); interleaved and one scan per component, with restarts."""
    rng = np.random.RandomState(7)
    h, w = 19, 27
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    planes = [_texture(rng, -(-h * v // vmax), -(-w * hh // hmax)) for hh, v in sampling]
    path = str(tmp_path / "s.jpg")
    for interleaved, restart in ((True, 0), (False, 0), (True, 2)):
        _write(path, chip_smoke.lossless_jpeg(planes, 4, 0, restart, interleaved,
                                              sampling=sampling))
        _assert_same(path)


@pytest.mark.parametrize("kind", ["JFIF", "Adobe transform 1", "YCCK", "TIFF YCbCr strip"])
def test_lossless_colour_conversion_is_refused(tmp_path, kind):
    """libjpeg-turbo converts no colour space of a lossless file ("Unsupported
    color conversion request"): a lossless YCbCr file (JFIF marker, or
    Adobe transform 1), a YCCK one (4 components, Adobe transform 2) and a
    lossless strip of a YCbCr TIFF fail in the JAX package; the port
    refuses each by name, without "yet"."""
    from .test_torch_images import _tiff_file

    rng = np.random.RandomState(8)
    path = str(tmp_path / ("c.tif" if kind.startswith("TIFF") else "c.jpg"))
    planes = [_texture(rng, 16, 20) for _ in range(4 if kind == "YCCK" else 3)]
    if kind.startswith("TIFF"):
        _tiff_file(path, np.stack(planes, -1), compression=7, rows_per_strip=8, photometric=6,
                   extra_tags=[(530, 3, [1, 1])],
                   jpeg_coder=lambda part: chip_smoke.lossless_jpeg(
                       [part[..., c] for c in range(3)]))
    else:
        markers = {"JFIF": JFIF, "Adobe transform 1": _adobe(1), "YCCK": _adobe(2)}[kind]
        _write(path, chip_smoke.lossless_jpeg(planes, markers=markers))
    assert isinstance(_jax_load(path), Exception)
    with pytest.raises(UnsupportedImageError, match="not supported") as err:
        timages.SourceImage.load(path).load_rgb_plane()
    assert "yet" not in str(err.value)


def test_lossless_restart_interval_of_part_rows_is_refused(tmp_path):
    """jddiffct.c takes restarts at MCU-row boundaries only: a lossless
    file whose DRI interval is no whole number of MCU rows fails in
    libjpeg-turbo (JERR_BAD_RESTART), so in the JAX package; the port
    raises too."""
    rng = np.random.RandomState(9)
    data = bytearray(chip_smoke.lossless_jpeg([_texture(rng, 10, 12)], 1, 0, 1))
    at = data.find(b"\xff\xdd\x00\x04")
    data[at + 5] = 5  # 5 samples of a 12-sample row
    path = str(tmp_path / "r.jpg")
    _write(path, bytes(data))
    assert isinstance(_jax_load(path), Exception)
    with pytest.raises(ImageError):
        timages.SourceImage.load(path)


def _scans(data: bytes) -> list[tuple[int, int]]:
    """(start, end) of each scan: its SOS marker to its data's end."""
    return [(data.rfind(b"\xff\xda", 0, off), off + n) for off, n, *_ in jpeg.parse(data).scans]


def _cut(data: bytes, drop) -> bytes:
    scans = _scans(data)
    for i in sorted(drop, reverse=True):
        data = data[: scans[i][0]] + data[scans[i][1]:]
    return data


# The block grids of the smoothing cases (columns, rows of 8x8 blocks of
# the full-resolution component).
SMOOTH_GRIDS = [(1, 1), (1, 4), (2, 2), (3, 5), (4, 3), (5, 6), (6, 2), (6, 6)]


@pytest.mark.parametrize("grid", SMOOTH_GRIDS, ids=[f"{c}x{r} blocks" for c, r in SMOOTH_GRIDS])
def test_block_smoothing_matches_jax(tmp_path, grid):
    """Progressive files (Pillow's Huffman ones and arithmetic twins) with
    scans left out so that libjpeg-turbo smooths them (jdcoefct.c
    decompress_smooth_data): the last refinement scans (AC 1-9 unrefined),
    the first AC scans of a component (AC 1-9 never sent), and every AC
    scan of the chroma (only DC known: the DC interpolation). Gray,
    4:2:0, 4:2:2 and 4:4:4 at sizes whose block grids are `grid` (or cut
    one sample short). Each plane is the JAX package's; past one block,
    smoothing changes some of them against the plain decode (a lone
    block is its own neighbourhood: every estimate is 0 and the DC
    stays)."""
    cols, rows = grid
    rng = np.random.RandomState(cols * 10 + rows)
    path = str(tmp_path / "s.jpg")
    differs = 0
    # libjpeg's simple progression: gray 0 DC, 1 AC 1-5, 2 AC 6-63, 3 AC
    # refinement to bit 1, 4 DC refinement, 5 AC refinement to bit 0;
    # YCbCr 0 DC, 1 Y 1-5, 2 Cr, 3 Cb, 4 Y 6-63, 5 Y to bit 1, 6 DC
    # refinement, 7 Cr, 8 Cb and 9 Y refinements to bit 0.
    for sub, drop in ((None, [5]), (None, [1, 2, 3, 5]), (2, [9]), (2, [2, 3, 7, 8]),
                      (1, [7, 8]), (0, [1, 4, 5, 9])):
        h = max(1, rows * 8 - int(rng.randint(0, 2)))
        w = max(1, cols * 8 - int(rng.randint(0, 2)))
        px = _texture(rng, h, w) if sub is None else _texture(rng, h, w, 3)
        save = {"quality": int(rng.randint(30, 95))}
        if sub is not None:
            save["subsampling"] = sub
        for arithmetic in (False, True):
            if arithmetic:
                data, _ = _arith_twin(px, progressive=True, **save)
            else:
                data = _pillow_jpeg(px, progressive=True, **save)
            cut = _cut(data, drop)
            parsed = jpeg.parse(cut)
            assert parsed.needs_smoothing, (grid, sub, drop)
            _write(path, cut)
            _assert_same(path)
            parsed.needs_smoothing = False  # the plain decode, which libjpeg does not give
            plain = imageio.to_rgb(*imageio.ImageFile("JPEG", parsed).decode())
            differs += bool((plain != timages.SourceImage.load(path).load_rgb_plane()).any())
    assert differs == 0 if grid == (1, 1) else differs > 0


def test_progressive_cut_that_needs_no_smoothing(tmp_path):
    """Cutting the first AC scan of Y's 1-5 band, which a later scan
    refines, leaves every one of AC 1-9 refined: no smoothing, and the
    planes are the JAX package's."""
    data = _pillow_jpeg(_texture(np.random.RandomState(9), 40, 50, 3), progressive=True)
    cut = _cut(data, [1])
    assert not jpeg.parse(cut).needs_smoothing
    path = str(tmp_path / "c.jpg")
    _write(path, cut)
    _assert_same(path)


def _damaged(data: bytes, rng) -> bytes:
    """`data` with 1-3 bits of one scan's coded bytes flipped (never into
    or out of a 0xFF byte), and/or cut inside a scan, an EOI after the
    cut or none."""
    scans = [(off, off + n) for off, n, *_ in jpeg.parse(data).scans]
    s0, s1 = scans[rng.randint(len(scans))]
    d = bytearray(data)
    how = rng.randint(4)
    if how in (0, 3) and s1 - s0 > 1:
        for _ in range(rng.randint(1, 4)):
            i = int(rng.randint(s0, s1))
            v = d[i] ^ (1 << int(rng.randint(8)))
            if d[i] != 0xFF and d[i - 1] != 0xFF and v != 0xFF:
                d[i] = v
    if how in (1, 2, 3):
        i = int(rng.randint(s0, max(s0 + 1, s1)))
        i -= d[i - 1] == 0xFF
        d = d[:i] + (b"" if how == 2 else b"\xff\xd9")
    return bytes(d)


@pytest.mark.parametrize("kind", ["arithmetic", "arithmetic progressive", "lossless",
                                  "huffman with restarts"])
def test_damaged_streams_read_or_raise_where_pillow_does(tmp_path, kind):
    """24 damaged files of each coding: flipped bits (the arithmetic
    decoder's spectral and magnitude overflows, which leave the rest of
    the interval's blocks as they are; bad lossless differences), cuts
    with an EOI after them (libjpeg feeds zeros: the arithmetic decoder
    decodes them, the lossless one fills each row after the data with
    128s) and cuts without (both refuse). With restart intervals at
    random; each file reads to the JAX package's planes or fails in both.
    The Huffman files are Pillow's, with restart intervals: the port skips
    to the next restart marker as libjpeg does."""
    rng = np.random.RandomState(["arithmetic", "arithmetic progressive", "lossless",
                                 "huffman with restarts"].index(kind) + 500)
    path = str(tmp_path / "d.jpg")
    for i in range(24):
        h, w = rng.randint(8, 40, 2)
        px = _texture(rng, h, w, 3) if rng.rand() < 0.6 else _texture(rng, h, w)
        restart = int(rng.choice([0, 1, 3]))
        if kind == "lossless":
            planes = [px[..., c] for c in range(3)] if px.ndim == 3 else [px]
            data = chip_smoke.lossless_jpeg(planes, int(rng.randint(1, 8)), int(rng.randint(3)),
                                            restart, bool(rng.rand() < 0.5))
        elif kind == "huffman with restarts":
            data = _pillow_jpeg(px, quality=int(rng.randint(30, 95)), restart_marker_blocks=restart + 1,
                                progressive=bool(rng.rand() < 0.5))
        else:
            data, _ = _arith_twin(px, progressive=kind.endswith("progressive"), restart=restart,
                                  quality=int(rng.randint(30, 95)))
        _write(path, _damaged(data, rng))
        ref = _jax_load(path)
        if isinstance(ref, Exception):
            with pytest.raises(ImageError):
                timages.SourceImage.load(path).load_rgb_plane()
            continue
        src = timages.SourceImage.load(path)
        np.testing.assert_array_equal(src.img, ref[0].img, err_msg=str(i))
        np.testing.assert_array_equal(src.load_rgb_plane(), ref[1], err_msg=str(i))


def test_extreme_coefficients_take_libjpeg_turbos_simd_idct(tmp_path):
    """Coefficients whose dequantised values overflow 16 bits (corrupt
    data): Pillow's libjpeg-turbo runs its SIMD islow IDCT, whose 16-bit
    lanes wrap and saturate where jidctint.c's C code does not; the port
    gives its pixels. 60 seeded 16x16 files: tables of 1-255, coefficients
    up to 32767, DC-only blocks (the SIMD code's shortcut) among them."""
    rng = np.random.RandomState(10)
    path = str(tmp_path / "x.jpg")
    for i in range(60):
        q = (rng.randint(1, 256, (2, 64)) if rng.rand() < 0.5
             else np.full((2, 64), rng.choice([1, 2, 8, 30, 255]))).astype(np.uint16)
        mag = int(rng.choice([20, 200, 2000, 32767]))
        coefs = rng.randint(-mag, mag + 1, (2, 2, 64)) * (rng.rand(2, 2, 64) < rng.rand() ** 3)
        if i % 3 == 0:
            coefs[..., 1:] = 0
        _write(path, chip_smoke.arith_jpeg([coefs], q, 16, 16))
        ref = _jax_load(path)
        np.testing.assert_array_equal(timages.SourceImage.load(path).img, ref[0].img,
                                      err_msg=str(i))


def _frame(marker: int, precision: int = 8, components: int = 3) -> bytes:
    """A baseline file of Pillow's with its SOF0 rewritten: another frame
    marker, precision or component count (the segment kept its length,
    so the component entries past the count are left over)."""
    data = bytearray(_pillow_jpeg(_texture(np.random.RandomState(5), 24, 24, 3), quality=75,
                                  subsampling=0))
    at = data.find(b"\xff\xc0")
    data[at + 1], data[at + 4], data[at + 9] = marker, precision, components
    return bytes(data)


REFUSED_FRAMES = {
    "12-bit sequential": (_frame(0xC1, 12), "nor any other Pillow plugin"),
    "12-bit lossless": (_frame(0xC3, 12), "nor any other Pillow plugin"),
    "16-bit lossless": (_frame(0xC3, 16), "nor any other Pillow plugin"),
    "2-component": (_frame(0xC0, components=2), "nor any other Pillow plugin"),
    "5-component": (_frame(0xC0, components=5), "nor any other Pillow plugin"),
    **{f"hierarchical SOF{m - 0xC0}": (_frame(m), "hierarchical JPEG")
       for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)},
    "arithmetic-coded lossless SOF11": (_frame(0xCB), "arithmetic-coded lossless JPEG"),
}


@pytest.mark.parametrize("name", sorted(REFUSED_FRAMES))
def test_frames_pillow_refuses_are_refused(tmp_path, name):
    """Pillow's SOF handler raises SyntaxError for another precision than 8
    and for 2 or more than 4 components, and Image.open tries its other
    plugins ("cannot identify"); libjpeg-turbo fails on hierarchical and
    arithmetic-coded lossless frames when Pillow loads them. The JAX
    package fails on each; the port refuses each, without "yet": the
    first kinds through identify's walk of Pillow's plugins, the others
    by name. Where Pillow opens the file, read_metadata reads it as the
    JAX package's does."""
    data, match = REFUSED_FRAMES[name]
    path = str(tmp_path / "f.jpg")
    _write(path, data)
    assert isinstance(_jax_load(path), Exception)
    with pytest.raises(ImageError, match=match) as err:
        timages.SourceImage.load(path).load_rgb_plane()
    assert "yet" not in str(err.value)
    if "Pillow plugin" not in match:
        assert _meta(timages.read_metadata(path)) == _meta(jimages.read_metadata(path))
