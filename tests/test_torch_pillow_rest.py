"""The port's readers of old-style JPEG-in-TIFF (imageio/ojpeg.py, after
libtiff's tif_ojpeg.c and TIFFRGBAImage), PSD, FITS and the raw-pixel
rest of Pillow's readers (DCX in imageio/pcx.py, GBR, IM Tools, IPTC/NAA,
McIdas, PIXAR, XV thumbnail) against the JAX package's, which reads
through Pillow 12.1: for every file the same read_metadata, the same
SourceImage.load gray plane and metadata and the same colour plane, bit
for bit; where Pillow refuses a file the port raises an ImageError, and
where Pillow's plugin passes a file on, it reaches the same later plugin.

Files are made at test time from numpy seeds by chip_smoke.py's writers
(Pillow writes none of these formats): ojpeg_tiff (over huffman_jpeg),
psd_file, fits_file, dcx_file, gbr_file, imt_file, iptc_file,
mcidas_file, pixar_file and xv_thumbnail, with Pillow as the reader of
record.
"""

import functools
import io
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as cs
from cybervision_tpu import images as jimages
from cybervision_tpu_torch import cli, imageio, native
from cybervision_tpu_torch import config as tcfg
from cybervision_tpu_torch import images as timages
from cybervision_tpu_torch.errors import ImageError
from cybervision_tpu_torch.imageio import NativeDecoderError, UnsupportedImageError, ojpeg
from cybervision_tpu_torch.imageio.jpeg_encode import quant_tables
from cybervision_tpu_torch.reconstruction import reconstruct as treconstruct

from .test_pipeline import _sem_pair
from .test_torch_images import _jax_load, _meta, _texture
from .test_torch_pipeline import _port_fast_cfg, _read_ply
from .test_torch_raster_formats import _assert_same, _write

torch.set_num_threads(2)

_SEM = cs.SEM_TEXT.format(px=9.7656e-08, tilt=0.1745329, bar=6)


# -- old-style JPEG-in-TIFF --------------------------------------------------------------


def _ojpeg(layout, ss=(2, 2), gray=False, h=40, w=48, **opts):
    def build(path, rng):
        img = _texture(rng, h, w) if gray else _texture(rng, h, w, 3)
        _write(path, cs.ojpeg_tiff(img, layout, ss, **opts))
    return build


def _rational(*values):
    return (5, [(round(v * 10000), 10000) for v in values])


OJPEG = {
    **{f"ojpeg {lay} {a}x{b} strips": _ojpeg(lay, (a, b), rows_per_strip=16)
       for lay in ("tables", "interchange") for a, b in ((1, 1), (2, 1), (2, 2), (1, 2))},
    **{f"ojpeg {lay} 2x2 one strip": _ojpeg(lay) for lay in ("tables", "interchange")},
    "ojpeg tables 2x2 odd size": _ojpeg("tables", h=37, w=50, rows_per_strip=16),
    "ojpeg interchange 2x1 odd size": _ojpeg("interchange", (2, 1), h=29, w=33),
    "ojpeg tables 2x2 tiles": _ojpeg("tables", h=45, w=50, tile=(64, 16)),
    "ojpeg interchange 2x1 tiles": _ojpeg("interchange", (2, 1), h=37, w=40, tile=(48, 8)),
    "ojpeg gray tables strips": _ojpeg("tables", gray=True, h=37, w=50, rows_per_strip=8),
    "ojpeg gray interchange tiles": _ojpeg("interchange", gray=True, h=37, w=50, tile=(56, 16)),
    "ojpeg planar interchange": _ojpeg("interchange", (1, 1), planar=2),
    "ojpeg planar interchange strips": _ojpeg("interchange", (1, 1), h=37, w=50,
                                              rows_per_strip=8, planar=2),
    "ojpeg tables 2x2 with the FEI tag": _ojpeg("tables", h=46, sem_text=_SEM,
                                               rows_per_strip=16),
    "ojpeg photometric RGB, read as YCbCr": _ojpeg("tables", extra_tags={262: (3, [2])}),
    "ojpeg subsampling tag corrected by the frame": _ojpeg(
        "interchange", (1, 1), extra_tags={530: (3, [2, 2])}),
    "ojpeg reference black and white": _ojpeg(
        "tables", (2, 1), extra_tags={532: _rational(16, 235, 128, 240, 128, 240)}),
    "ojpeg BT.709 coefficients": _ojpeg(
        "tables", extra_tags={529: _rational(0.2126, 0.7152, 0.0722)}),
    "ojpeg JPEGProc 14, decoded as baseline": _ojpeg("tables", extra_tags={512: (3, [14])}),
}


# -- PSD ---------------------------------------------------------------------------------


def _psd(kind, compressed=False, layers=False, h=13, w=21):
    def build(path, rng):
        g, rgb, rgba = _texture(rng, h, w), _texture(rng, h, w, 3), _texture(rng, h, w, 4)
        if kind == "bitmap":
            data = cs.psd_file(np.packbits(g > 128, axis=1)[None], 0, w, 1, compressed)
        elif kind in ("gray", "multichannel", "duotone"):
            mode = {"gray": 1, "multichannel": 7, "duotone": 8}[kind]
            data = cs.psd_file(g[None], mode, w, 8, compressed, layers=layers)
        elif kind == "indexed":
            data = cs.psd_file(g[None], 2, w, 8, compressed, rng.bytes(768))
        elif kind == "indexed, short colour data (black)":
            data = cs.psd_file(g[None], 2, w, 8, compressed, rng.bytes(300))
        elif kind == "gray with an alpha channel":
            data = cs.psd_file(np.stack([g, rgba[:, :, 3]]), 1, w, 8, compressed)
        elif kind == "RGB":
            data = cs.psd_file(rgb.transpose(2, 0, 1), 3, w, 8, compressed, layers=layers)
        elif kind == "RGBA":
            data = cs.psd_file(rgba.transpose(2, 0, 1), 3, w, 8, compressed, layers=layers)
        elif kind == "CMYK":
            data = cs.psd_file(rgba.transpose(2, 0, 1), 4, w, 8, compressed, layers=layers)
        else:  # "CMYK with a spot channel"
            data = cs.psd_file(np.concatenate([rgba, g[:, :, None]], 2).transpose(2, 0, 1), 4,
                               w, 8, compressed)
        _write(path, data)
    return build


PSD = {
    **{f"psd {k} {'packbits' if c else 'raw'}": _psd(k, c) for c in (False, True) for k in (
        "bitmap", "gray", "multichannel", "duotone", "indexed",
        "indexed, short colour data (black)", "gray with an alpha channel", "RGB", "RGBA",
        "CMYK")},
    "psd CMYK with a spot channel raw": _psd("CMYK with a spot channel"),
    "psd RGB packbits, layered": _psd("RGB", True, True),
    "psd CMYK raw, layered": _psd("CMYK", False, True),
    "psd gray raw, layered, odd size": _psd("gray", False, True, 7, 1),
    "psd bitmap packbits, 9 wide": _psd("bitmap", True, h=5, w=9),
}


# -- FITS, DCX, GBR, IM Tools, IPTC, McIdas, PIXAR, XV -----------------------------------


def _fits(bitpix, **opts):
    def build(path, rng):
        g = _texture(rng, 11, 17).astype(np.int64)
        px = g * 300 - 20000 if bitpix in (16, 32) else g
        _write(path, cs.fits_file(px, bitpix, **opts))
    return build


def _fits_cards(path, rng):
    """BZERO, BSCALE, comments and a HISTORY card, which Pillow skips."""
    data = cs.fits_file(_texture(rng, 9, 14).astype(np.int64) * 100, 16)
    extra = "".join(c.ljust(80) for c in ("BZERO   =                32768 / offset",
                                          "BSCALE  =                  1.0", "HISTORY made here",
                                          "COMMENT a seeded image"))
    end = data.index(b"END     ")
    _write(path, data[:end] + extra.encode() + data[end : 2880 - len(extra)] + data[2880:])


def _fits_naxis1(path, rng):
    data = cs.fits_file(_texture(rng, 1, 23), 8)
    _write(path, data.replace(b"NAXIS   =                    2", b"NAXIS   =                    1"))


def _small(kind):
    def build(path, rng):
        h, w = (31, 37) if kind.startswith("dcx") else (13, 21)  # a PCX of its palette tail
        g, rgb, rgba = _texture(rng, h, w), _texture(rng, h, w, 3), _texture(rng, h, w, 4)
        if kind == "dcx one page":
            data = cs.dcx_file([cs.pcx_file(g)])
        elif kind == "dcx two pages, RGB first":
            data = cs.dcx_file([cs.pcx_file(rgb), cs.pcx_file(g)])
        elif kind == "dcx palette page":
            data = cs.dcx_file([cs.pcx_file(g, rng.randint(0, 256, (256, 3)).astype(np.uint8))])
        elif kind.startswith("gbr"):
            data = cs.gbr_file(rgba if "RGBA" in kind else g, 1 if "v1" in kind else 2)
        elif kind == "imt":
            data = cs.imt_file(g)
        elif kind == "imt with comments and other keys":
            data = cs.imt_file(g).replace(b"pixel n8\n", b"* note\nscale 2\npixel n8\nname x\n")
        elif kind == "mcidas 8-bit":
            data = cs.mcidas_file(g)
        elif kind == "mcidas 16-bit, line prefixes":
            data = cs.mcidas_file(g.astype(">u2") * 300, prefix=4)
        elif kind == "mcidas 32-bit signed":
            data = cs.mcidas_file((g.astype(np.int64) * 1000 - 90000).astype(">i4"), prefix=8)
        elif kind == "pixar":
            data = cs.pixar_file(rgb)
        elif kind == "xv thumbnail":
            data = cs.xv_thumbnail(g)
        else:  # "xv thumbnail, extra comment lines"
            data = cs.xv_thumbnail(g).replace(b"#END", b"#a comment\n#another\n#END")
        _write(path, data)
    return build


def _iptc(kind):
    def build(path, rng):
        h, w = 11, 19
        g = _texture(rng, h, w)
        if "jpeg" in kind:
            quant = quant_tables(90)
            coefs = cs.dct_coefficients([g], quant, [(1, 1)], w, h)
            payload, _ = cs.huffman_jpeg(coefs, quant, w, h)
        else:
            payload = g.tobytes()
        layout = {"gray": (1, 0, None), "RGB, band 2": (3, 1, 1), "CMYK, band 4": (4, 1, 3),
                  "RGB, no band field": (3, 1, None)}[kind.split(" raw")[0].split(" jpeg")[0]]
        band = layout[2]
        data = cs.iptc_file(payload, (w, h), layout[0], layout[1], band,
                            5 if "jpeg" in kind else 1, 37 if "chunks" in kind else 30000)
        if kind == "RGB, no band field raw":  # the band defaults to the first
            data = cs.iptc_file(payload, (w, h), 3, 1, None, 1)
        if "extended" in kind:  # one (8, 10) field with a four-byte size
            data = data.replace(bytes([0x1C, 8, 10]) + struct.pack(">H", len(payload)),
                                bytes([0x1C, 8, 10, 0x84]) + struct.pack(">I", len(payload)))
        _write(path, data)
    return build


SMALL = {
    **{f"fits BITPIX {b}": _fits(b) for b in (8, 16, 32, -32, -64)},
    **{f"fits BITPIX {b} after an empty primary": _fits(b, empty_primary=True) for b in (8, -32)},
    **{f"fits GZIP_1 BITPIX {b}": _fits(b, compressed=True) for b in (8, 16, 32)},
    "fits NAXIS 1": _fits_naxis1,
    "fits BZERO, BSCALE and comments (ignored)": _fits_cards,
    **{k: _small(k) for k in (
        "dcx one page", "dcx two pages, RGB first", "dcx palette page", "gbr v1 gray",
        "gbr v2 gray", "gbr v1 RGBA", "gbr v2 RGBA", "imt", "imt with comments and other keys",
        "mcidas 8-bit", "mcidas 16-bit, line prefixes", "mcidas 32-bit signed", "pixar",
        "xv thumbnail", "xv thumbnail, extra comment lines")},
    **{f"iptc {k}": _iptc(k) for k in (
        "gray raw", "gray raw chunks", "gray raw extended", "RGB, band 2 raw", "CMYK, band 4 raw",
        "RGB, no band field raw", "gray jpeg", "RGB, band 2 jpeg")},
}

_EXT = {"ojpeg": "tif", "psd": "psd", "fits": "fits", "dcx": "dcx", "gbr": "gbr", "imt": "imt",
        "iptc": "iim", "mcidas": "area", "pixar": "pxr", "xv": "xv"}
CASES = {**OJPEG, **PSD, **SMALL}


def _write_case(tmp_path, name: str) -> str:
    path = str(tmp_path / f"case.{_EXT[name.split()[0]]}")
    CASES[name](path, np.random.RandomState(sorted(CASES).index(name)))
    return path


@pytest.mark.parametrize("name", sorted(CASES))
def test_pillow_rest_matches_jax(tmp_path, name):
    _assert_same(_write_case(tmp_path, name))


def test_fei_tag_of_an_old_style_jpeg_tiff_crops_its_databar(tmp_path):
    """The FEI tag 34683 is read from an old-style JPEG-in-TIFF as from any
    TIFF: the scale, tilt and databar of the JAX package, the databar's 6
    rows cropped from both planes."""
    path = _write_case(tmp_path, "ojpeg tables 2x2 with the FEI tag")
    meta = timages.read_metadata(path)
    assert _meta(meta) == _meta(jimages.read_metadata(path))
    assert meta.databar_height == 6 and meta.scale == (9.7656e-08, 9.7656e-08)
    src = timages.SourceImage.load(path)
    assert src.img.shape == (40, 48) and src.load_rgb_plane().shape == (40, 48, 3)


def test_colour_old_style_jpeg_is_libtiffs_raw_decode(tmp_path):
    """At 2x1 and 2x2 sampling Pillow's planes (libtiff's raw samples,
    chroma repeated over its block, libtiff's YCbCr conversion) are not
    the embedded JPEG's own (libjpeg's fancy upsampling and conversion),
    and the port reads Pillow's."""
    for ss in ((2, 1), (2, 2)):
        path = str(tmp_path / f"o{ss[0]}{ss[1]}.tif")
        img = _texture(np.random.RandomState(ss[1]), 32, 48, 3)
        data = cs.ojpeg_tiff(img, "interchange", ss)
        _write(path, data)
        t = imageio.open_image(path).parsed
        stream = data[t.get(513) : t.get(513) + t.get(514)]
        with Image.open(io.BytesIO(stream)) as im:
            own = np.asarray(im.convert("RGB"))
        with Image.open(path) as im:
            pillow = np.asarray(im.convert("RGB"))
        assert (own != pillow).mean() > 0.05
        np.testing.assert_array_equal(timages.SourceImage.load(path).load_rgb_plane(), pillow)


def _libtiff():
    """Pillow's own libtiff (pillow.libs), its dependencies loaded first."""
    import ctypes
    import glob
    import os

    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    for dep in ("libzstd", "liblzma", "libjpeg"):
        for path in glob.glob(os.path.join(libs, dep + "-*")):
            ctypes.CDLL(path, mode=ctypes.RTLD_GLOBAL)
    (path,) = glob.glob(os.path.join(libs, "libtiff-*"))
    return ctypes.CDLL(path)


@pytest.mark.parametrize("setting", ["default", "reference", "coefficients"])
def test_libtiff_ycbcr_conversion(setting):
    """ojpeg.ycbcr_rgb's tables (tif_color.c's, built in float32) are the
    ones TIFFYCbCrToRGBInit of Pillow's own libtiff builds, entry for
    entry, and the conversion is its TIFFYCbCrtoRGB on a seeded sample
    of triples and the extremes."""
    import ctypes

    lib = _libtiff()
    luma = (0.2126, 0.7152, 0.0722) if setting == "coefficients" else (0.299, 0.587, 0.114)
    ref = (16, 235, 128, 240, 128, 240) if setting == "reference" else (0, 255, 128, 255, 128,
                                                                       255)
    state = ctypes.create_string_buffer(1 << 16)
    assert lib.TIFFYCbCrToRGBInit(state, (ctypes.c_float * 3)(*luma),
                                  (ctypes.c_float * 6)(*ref)) == 0
    pointers = (ctypes.c_void_p * 6).from_buffer(state)  # clamptab, Cr_r, Cb_b, Cr_g, Cb_g, Y
    theirs = [np.ctypeslib.as_array((ctypes.c_int32 * 256).from_address(pointers[k]))
              for k in range(1, 6)]
    ours = ojpeg.ycbcr_tables(luma, ref)
    for k, name in enumerate(("Cr_r", "Cb_b", "Cr_g", "Cb_g", "Y")):
        np.testing.assert_array_equal(ours[name], theirs[k], err_msg=name)
    rng = np.random.RandomState(["default", "reference", "coefficients"].index(setting))
    picks = np.concatenate([rng.randint(0, 256, (500, 3)), [[0, 0, 0], [255, 255, 255],
                                                            [0, 255, 0], [255, 0, 255]]])
    port = ojpeg.ycbcr_rgb(picks.astype(np.uint8), luma, ref)
    rgb = (ctypes.c_uint32 * 3)()
    for (a, b, c), want in zip(picks, port):
        lib.TIFFYCbCrtoRGB(state, ctypes.c_uint32(int(a)), ctypes.c_int32(int(b)),
                           ctypes.c_int32(int(c)), ctypes.byref(rgb, 0), ctypes.byref(rgb, 4),
                           ctypes.byref(rgb, 8))
        assert list(want) == list(rgb), (a, b, c)


# -- what Pillow refuses, and what its plugins pass on ---------------------------------


def _refused(kind, path, rng):
    g, rgb = _texture(rng, 9, 14), _texture(rng, 9, 14, 3)
    if kind == "psd not enough channels":
        data = cs.psd_file(rgb.transpose(2, 0, 1)[:2], 3, 14)
    elif kind == "psd raw cut short":
        data = cs.psd_file(rgb.transpose(2, 0, 1), 3, 14)[:-20]
    elif kind == "psd packbits cut short":
        data = cs.psd_file(rgb.transpose(2, 0, 1), 3, 14, compressed=True)[:-20]
    elif kind == "psd compression 2":
        data = bytearray(cs.psd_file(g[None], 1, 14))
        data[len(data) - g.size - 1] = 2
    elif kind == "fits without image data":
        data = cs.fits_file(g, 8).replace(b"NAXIS   =                    2",
                                          b"NAXIS   =                    0")
    elif kind == "fits header cut short":
        data = cs.fits_file(g, 8)[:1000]
    elif kind == "fits data cut short":
        data = cs.fits_file(g, 16)[: 2880 + 100]
    elif kind == "fits GZIP_1 of floats":
        data = cs.fits_file(g, -32, compressed=True)
    elif kind == "fits GZIP_1 data damaged":
        data = bytearray(cs.fits_file(g, 8, compressed=True))
        data[2 * 2880 + 8 * 9 + 12] ^= 0xFF
    elif kind == "fits NAXIS1 not a number":
        data = cs.fits_file(g, 8).replace(b"NAXIS1  =                   14",
                                          b"NAXIS1  =                  1.5")
    elif kind == "gbr pixels cut short":
        data = cs.gbr_file(g)[:-5]
    elif kind == "imt without its form feed":
        data = cs.imt_file(g).replace(b"\x0c", b"\n")
    elif kind == "imt width not a number":
        data = cs.imt_file(g).replace(b"width 14", b"width x4")
    elif kind == "iptc unknown compression":
        data = cs.iptc_file(g.tobytes(), (14, 9), compression=2)
    elif kind == "iptc without image data":
        data = cs.iptc_file(g.tobytes(), (14, 9))
        data = data[: data.index(bytes([0x1C, 8, 10]))]
    elif kind == "iptc field length past 132":
        data = cs.iptc_file(g.tobytes(), (14, 9)).replace(bytes([0x1C, 3, 120, 0]),
                                                           bytes([0x1C, 3, 120, 0x90]))
    elif kind == "iptc raw data cut short":
        data = cs.iptc_file(g.tobytes()[:-9], (14, 9))
    elif kind == "iptc colour JPEG as gray":
        coefs = cs.dct_coefficients(cs.ycbcr_planes(rgb, [(1, 1)] * 3), quant_tables(90),
                                    [(1, 1)] * 3, 14, 9)
        data = cs.iptc_file(cs.huffman_jpeg(coefs, quant_tables(90), 14, 9)[0], (14, 9),
                            compression=5)
    elif kind == "iptc band past the bands":
        data = cs.iptc_file(g.tobytes(), (14, 9), 3, 1, 5)
    elif kind == "mcidas cut short":
        data = cs.mcidas_file(g)[:-3]
    elif kind == "pixar cut short":
        data = cs.pixar_file(rgb)[:-1]
    elif kind == "xv cut short":
        data = cs.xv_thumbnail(g)[:-1]
    elif kind == "xv size line without numbers":
        data = cs.xv_thumbnail(g).replace(b"14 9 255", b"14 x 255")
    elif kind == "dcx page cut short":
        data = cs.dcx_file([cs.pcx_file(rgb)])[:200]
    elif kind == "ojpeg without its tables":
        data = cs.ojpeg_tiff(rgb, "tables", extra_tags={519: (4, [0, 0, 0])})
    elif kind == "ojpeg restart marker renumbered":
        data = bytearray(cs.ojpeg_tiff(_texture(rng, 40, 32, 3), "interchange",
                                       rows_per_strip=16))
        at = bytes(data).index(b"\xff\xd0", 200)
        data[at + 1] = 0xD3
    elif kind == "ojpeg DHT of an over-full code":
        data = bytearray(cs.ojpeg_tiff(_texture(rng, 16, 16), "tables"))
        counts = struct.unpack_from("<I", data, bytes(data).index(b"\x08\x02\x04\x00") + 8)[0]
        data[counts] = 3  # three codes of one bit
    else:  # "ojpeg lossless frame"
        data = bytearray(cs.ojpeg_tiff(g, "interchange"))
        at = bytes(data).index(b"\xff\xc0")
        data[at + 1] = 0xC3
    _write(path, bytes(data))


REFUSED = ["psd not enough channels", "psd raw cut short", "psd packbits cut short",
           "psd compression 2", "fits without image data", "fits header cut short",
           "fits data cut short", "fits GZIP_1 of floats", "fits GZIP_1 data damaged",
           "fits NAXIS1 not a number", "gbr pixels cut short", "imt without its form feed",
           "imt width not a number", "iptc unknown compression", "iptc without image data",
           "iptc field length past 132", "iptc raw data cut short", "iptc colour JPEG as gray",
           "iptc band past the bands", "mcidas cut short", "pixar cut short", "xv cut short",
           "xv size line without numbers", "dcx page cut short", "ojpeg without its tables",
           "ojpeg restart marker renumbered", "ojpeg DHT of an over-full code",
           "ojpeg lossless frame"]


@pytest.mark.parametrize("kind", REFUSED)
def test_kinds_pillow_refuses_are_refused(tmp_path, kind):
    """Files Pillow 12.1 does not read (data short of the image, a header
    its plugin rejects outright, what libtiff's old-style JPEG codec
    fails on): the JAX package's load raises, and so does the port's,
    with an ImageError without "yet"; the metadata agree."""
    path = str(tmp_path / "refused.bin")
    _refused(kind, path, np.random.RandomState(REFUSED.index(kind)))
    assert _meta(timages.read_metadata(path)) == _meta(jimages.read_metadata(path))
    assert isinstance(_jax_load(path), Exception)
    with pytest.raises(ImageError) as err:
        timages.SourceImage.load(path).load_rgb_plane()
    assert "yet" not in str(err.value)


def test_psd_packbits_with_more_channels_than_read_is_read_as_pillow_reads_it(tmp_path):
    """A PackBits PSD of more channels than its mode reads (CMYK and a
    spot channel): Pillow takes only the byte counts of the channels it
    reads, so its channels start inside the count table; what that reads,
    or whether the data runs out, depends on the bytes (seeds 16-23 hold
    both outcomes). The port reads the same planes where Pillow reads,
    and raises where it raises."""
    outcomes = set()
    for seed in range(16, 24):
        rng = np.random.RandomState(seed)
        path = str(tmp_path / f"spot{seed}.psd")
        px = np.concatenate([_texture(rng, 9, 14, 4), _texture(rng, 9, 14, 1)], 2)
        _write(path, cs.psd_file(px.transpose(2, 0, 1), 4, 14, 8, True))
        ref = _jax_load(path)
        outcomes.add(isinstance(ref, Exception))
        if isinstance(ref, Exception):
            with pytest.raises(ImageError):
                timages.SourceImage.load(path)
        else:
            _assert_same(path)
    assert outcomes == {True, False}


def _passed_on(kind, path, rng):
    g, rgb = _texture(rng, 9, 14), _texture(rng, 9, 14, 3)
    if kind == "psd of 16 bits":
        data = cs.psd_file(np.repeat(rgb.transpose(2, 0, 1), 2, axis=2), 3, 14, 16)
    elif kind == "psd of 32 bits":
        data = cs.psd_file(np.repeat(g[None], 4, axis=2), 1, 14, 32)
    elif kind == "psd in Lab of 16 bits":
        data = cs.psd_file(np.repeat(rgb.transpose(2, 0, 1), 2, axis=2), 9, 14, 16)
    elif kind == "fits BITPIX 64":
        data = cs.fits_file(g, 32).replace(b"BITPIX  =                   32",
                                           b"BITPIX  =                   64")
    elif kind == "fits without SIMPLE = T":
        data = cs.fits_file(g, 8).replace(b"SIMPLE  =                    T",
                                          b"SIMPLE  =                    F")
    elif kind == "pixar of another mode":
        data = bytearray(cs.pixar_file(rgb))
        data[424] = 15
    elif kind == "gbr of depth 3":
        data = bytearray(cs.gbr_file(g))
        data[19] = 3
    elif kind == "mcidas of 3-byte samples":
        data = bytearray(cs.mcidas_file(g))
        data[43] = 3
    elif kind == "xv ending in its comments":
        data = cs.xv_thumbnail(g)[:40]
    elif kind == "iptc without its layers field":
        data = cs.iptc_file(g.tobytes(), (14, 9)).replace(bytes([0x1C, 3, 60]),
                                                           bytes([0x1C, 3, 61]))
    else:  # "dcx without a page"
        data = struct.pack("<II", 0x3ADE68B1, 0) + cs.pcx_file(g)
    _write(path, bytes(data))


PASSED_ON = ["psd of 16 bits", "psd of 32 bits", "psd in Lab of 16 bits", "fits BITPIX 64",
             "fits without SIMPLE = T", "pixar of another mode", "gbr of depth 3",
             "mcidas of 3-byte samples", "xv ending in its comments",
             "iptc without its layers field", "dcx without a page"]


@pytest.mark.parametrize("kind", PASSED_ON)
def test_files_pillows_plugin_passes_on_reach_no_reader(tmp_path, kind):
    """A header Pillow's plugin fails with SyntaxError (or KeyError, as a
    PSD of 16 or 32 bits does, or no mode) passes the file on to the
    plugins after it; none of them takes these files, so Pillow cannot
    identify them, and the port names every reader and plugin."""
    path = str(tmp_path / "passed.bin")
    _passed_on(kind, path, np.random.RandomState(PASSED_ON.index(kind)))
    with pytest.raises(Image.UnidentifiedImageError):
        Image.open(path)
    with pytest.raises(UnsupportedImageError, match="nor any other Pillow plugin"):
        timages.SourceImage.load(path)


def test_lab_psd_is_refused_as_the_jax_package_fails_on_it(tmp_path):
    """A Lab PSD opens as "LAB", which Pillow cannot convert to "L": the
    JAX package's SourceImage.load fails, so its CLI fails on the file,
    and the port's load raises. (Pillow converts "LAB" to "RGB" through
    LittleCMS; no run of either package gets there, since the gray load
    comes first, and the port's to_rgb names the gap.)"""
    path = str(tmp_path / "lab.psd")
    _write(path, cs.psd_file(_texture(np.random.RandomState(1), 9, 14, 3).transpose(2, 0, 1),
                             9, 14))
    with Image.open(path) as im:
        assert im.mode == "LAB"
        with pytest.raises(ValueError):
            im.convert("L")
    assert isinstance(_jax_load(path), Exception)
    with pytest.raises(ImageError):
        timages.SourceImage.load(path)
    mode, px, palette = imageio.open_image(path).decode()
    assert mode == "LAB" and px.shape == (9, 14, 3)
    with pytest.raises(UnsupportedImageError, match="LittleCMS"):
        imageio.to_rgb(mode, px, palette)


def test_identify_gives_each_to_pillows_plugin(tmp_path):
    """Each new reader takes the files Pillow's plugin of its name takes
    (an old-style JPEG-in-TIFF is Pillow's TIFF)."""
    for name in ("ojpeg tables 2x2 one strip", "psd RGB raw", "fits BITPIX 8", "dcx one page",
                 "gbr v2 gray", "imt", "iptc gray raw", "mcidas 8-bit", "pixar", "xv thumbnail"):
        path = _write_case(tmp_path, name)
        with Image.open(path) as im:
            assert imageio.open_image(path).format == im.format, name


def test_identify_names_the_readers_when_no_plugin_takes_a_file():
    """The refusal of a file no plugin takes lists every reader, the ten
    of this slice too."""
    with pytest.raises(UnsupportedImageError) as err:
        imageio.identify(b"\x00\x07 nothing any plugin reads" + bytes(64))
    message = str(err.value)
    for reader in ("PNG", "TIFF", "JPEG", "PCX and DCX", "IM Tools", "IPTC/NAA", "McIdas",
                   "PIXAR", "PSD", "FITS", "GBR", "XV thumbnail", "Sun raster", "XPM"):
        assert reader in message, reader
    assert message.endswith("nor any other Pillow plugin take it")


# -- seeded damage ---------------------------------------------------------------------


def _damaged(kind, rng, it):
    h, w = rng.randint(6, 40, 2)
    if kind == "ojpeg":
        ss = ((1, 1), (2, 1), (2, 2))[it % 3]
        data = bytearray(cs.ojpeg_tiff(_texture(rng, h, 8 * w // 8 + 8, 3), ("tables",
                                       "interchange")[it % 2], ss, rows_per_strip=16 * ss[1]))
        n = struct.unpack_from("<H", data, 8)[0]
        start = 8 + 2 + 12 * n + 4  # past the directory: the data and tables
    elif kind == "psd":
        px = _texture(rng, h, w, 4).transpose(2, 0, 1)
        data = bytearray(cs.psd_file(px[: 3 + it % 2], (3, 4)[it % 3 == 0] if it % 2 else 3, w,
                                     compressed=bool(it % 3)))
        start = 26
    elif kind == "fits":
        data = bytearray(cs.fits_file(_texture(rng, h, w).astype(np.int64) * 97,
                                      (8, 16, 32)[it % 3], compressed=it % 4 == 0))
        start = 0
    else:
        payload = _texture(rng, h, w).tobytes()
        data = bytearray(cs.iptc_file(payload, (w, h), *((1, 0, None), (3, 1, 1))[it % 2],
                                      chunk=int(rng.randint(10, 200))))
        start = 0
    if it % 4 == 0:
        data = data[: int(rng.randint(start, len(data)))]
    else:
        for _ in range(int(rng.randint(1, 4))):
            data[int(rng.randint(start, len(data)))] ^= 1 << int(rng.randint(8))
    return bytes(data)


@pytest.mark.parametrize("kind", ["ojpeg", "psd", "fits", "iptc"])
def test_seeded_damage_reads_where_pillow_reads(tmp_path, kind):
    """Bits flipped and files cut (an old-style JPEG-in-TIFF past its
    directory: its tables, markers and entropy-coded strips): the port
    reads what Pillow reads, the same planes, and raises where it
    raises."""
    rng = np.random.RandomState({"ojpeg": 41, "psd": 42, "fits": 43, "iptc": 44}[kind])
    read = refused = 0
    for it in range(40):
        path = str(tmp_path / f"d{it}.bin")
        _write(path, _damaged(kind, rng, it))
        try:
            with Image.open(path) as im:
                ref = np.asarray(im.convert("L")), np.asarray(im.convert("RGB"))
        except (OSError, ValueError, SyntaxError, EOFError):
            ref = None
        if ref is None:
            refused += 1
            with pytest.raises(ImageError):
                src = timages.SourceImage.load(path)
                src.load_rgb_plane()
        else:
            read += 1
            src = timages.SourceImage.load(path)
            np.testing.assert_array_equal(src.img, ref[0])
            np.testing.assert_array_equal(src.load_rgb_plane(), ref[1])
    assert read > 5 and refused > 5


# -- without the native library --------------------------------------------------------


def test_coded_kinds_without_native_name_the_compiler(tmp_path, monkeypatch):
    """No fallback: without the native library an old-style JPEG-in-TIFF,
    a PackBits PSD and a DCX raise an error that says what is missing;
    raw PSD, FITS (the GZIP_1 kind too: Python's gzip), GBR, IM Tools,
    IPTC raw, McIdas, PIXAR and XV files still read through numpy."""
    native_only = ["ojpeg tables 2x2 one strip", "psd RGB packbits", "dcx one page"]
    numpy_paths = ["psd CMYK raw", "fits BITPIX -32", "fits GZIP_1 BITPIX 16", "gbr v1 RGBA",
                   "imt", "iptc RGB, band 2 raw", "mcidas 32-bit signed", "pixar",
                   "xv thumbnail"]
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


# -- the CLI from old-style JPEG-in-TIFFs ----------------------------------------------


def test_cli_cpu_ojpeg_pair_ply_equals_the_in_memory_run_without_pillow(tmp_path, monkeypatch):
    """tests/test_pipeline.py's 160x160 SEM pair as colour (gray in every
    channel) old-style JPEG-in-TIFFs, 2x2 subsampled, tables only, 32
    rows a strip -> PLY through the port's cli.main with every import of
    Pillow blocked: byte for byte the port's reconstruct on the planes
    Pillow decodes (tests/test_torch_pipeline.py holds that run to the JAX
    CLI's PLY), as chip_smoke.py's phase 8 (o) holds it on the card."""
    img1, img2, _ = _sem_pair(np.random.RandomState(7))
    paths = [str(tmp_path / "sem0.tif"), str(tmp_path / "sem1.tif")]
    mem = []
    for p, img in zip(paths, (img1, img2)):
        _write(p, cs.ojpeg_tiff(np.repeat(img[:, :, None], 3, axis=2), "tables",
                                rows_per_strip=32))
        with Image.open(p) as im:
            src = timages.SourceImage(np.asarray(im.convert("L")))
            src.load_rgb_plane = functools.partial(np.array, np.asarray(im.convert("RGB")))
        mem.append(src)
    cfg = dict(projection=tcfg.ProjectionMode.AFFINE, mesh=tcfg.MeshMode.VERTEX_COLORS,
               hardware=tcfg.HardwareMode.CPU)
    ref, out = str(tmp_path / "mem.ply"), str(tmp_path / "port.ply")
    treconstruct(["a", "b"], ref, _port_fast_cfg(**cfg), quiet=True, images=mem)
    monkeypatch.setattr(cli, "ReconstructionConfig", _port_fast_cfg)
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)  # any import of Pillow now raises
    rc = cli.main(["--mode=cpu", "--projection=parallel", "--mesh=vertex-colors", *paths, out])
    assert rc == 0
    nv, _, _ = _read_ply(out)
    assert nv > 3000
    with open(ref, "rb") as fa, open(out, "rb") as fb:
        assert fa.read() == fb.read()


# -- phase 8 (o)'s files ---------------------------------------------------------------


def test_writers_here_give_pillow_their_pixels():
    """chip_smoke.py's PSD, FITS (BITPIX 8, rows stored bottom-up), DCX,
    GBR, IM Tools, IPTC, McIdas, PIXAR and XV writers decode (through
    Pillow) to the pixels they were given, so a case that passes holds the
    port to a file of known content."""
    rng = np.random.RandomState(24)
    gray, rgb, rgba = _texture(rng, 5, 11), _texture(rng, 5, 11, 3), _texture(rng, 5, 11, 4)

    def pillow(data, mode=None):
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert(mode) if mode else im)

    np.testing.assert_array_equal(pillow(cs.psd_file(rgb.transpose(2, 0, 1), 3, 11, 8, True)),
                                  rgb)
    np.testing.assert_array_equal(pillow(cs.psd_file(gray[None], 1, 11)), gray)
    np.testing.assert_array_equal(pillow(cs.fits_file(gray, 8)), gray)
    np.testing.assert_array_equal(pillow(cs.dcx_file([cs.pcx_file(gray)])), gray)
    np.testing.assert_array_equal(pillow(cs.gbr_file(rgba)), rgba)
    np.testing.assert_array_equal(pillow(cs.imt_file(gray)), gray)
    np.testing.assert_array_equal(pillow(cs.iptc_file(gray.tobytes(), (11, 5))), gray)
    np.testing.assert_array_equal(pillow(cs.mcidas_file(gray, prefix=4)), gray)
    np.testing.assert_array_equal(pillow(cs.pixar_file(rgb)), rgb)
    np.testing.assert_array_equal(pillow(cs.xv_thumbnail(gray)), gray)
    quant = quant_tables(100)
    coefs = cs.dct_coefficients([gray], quant, [(1, 1)], 11, 5)
    assert np.abs(pillow(cs.huffman_jpeg(coefs, quant, 11, 5)[0]).astype(int) - gray).max() < 4


def test_phase8o_files_decode_to_the_committed_hashes(tmp_path):
    """chip_smoke.pillow_rest_files (phase 3's 1024x1024 SEM pair as
    old-style JPEG-in-TIFFs, PackBits PSDs and FITS files, BASELINE #3's
    views as CMYK PSDs, the decode-only files of every other kind):
    Pillow's L and RGB planes have the SHA-256 committed for phase 8 (o)
    (torch_formats_sha256.json, "pillow rest"), and so do the port's, read
    with every import of Pillow blocked."""
    import hashlib
    import json
    import os

    with open(cs.FORMATS_SHA256) as fh:
        committed = json.load(fh)["pillow rest"]
    img1, img2, _ = cs.synth_sem_pair(cs.SIZE, cs.SIZE)
    files = cs.pillow_rest_files(str(tmp_path), img1, img2)
    paths = [p for ps in files.values() for p in ps]
    assert sorted(committed) == sorted(os.path.basename(p) for p in paths)

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for p in paths:
        with Image.open(p) as im:
            assert {"l": sha(np.asarray(im.convert("L"))),
                    "rgb": sha(np.asarray(im.convert("RGB")))} == committed[os.path.basename(p)]
    with cs._NoPillow():
        for p in paths:
            src = timages.SourceImage.load(p)
            assert {"l": sha(src.img), "rgb": sha(src.load_rgb_plane())} \
                == committed[os.path.basename(p)], p


# -- the JPEG reader's repairs ---------------------------------------------------------


def _jpeg_segments(data: bytes) -> list[bytes]:
    """SOI, then each marker segment up to the first scan, then the rest."""
    out, i = [data[:2]], 2
    while data[i + 1] != 0xDA:
        n = struct.unpack_from(">H", data, i + 2)[0]
        out.append(data[i : i + 2 + n])
        i += 2 + n
    return out + [data[i:]]


def _jpeg_repair_case(kind, path, rng):
    buf = io.BytesIO()
    Image.fromarray(_texture(rng, 24, 32, 3)).save(buf, "JPEG",
                                                   progressive=kind.startswith("progressive"))
    parts = _jpeg_segments(buf.getvalue())
    if kind in ("sequential without chroma tables", "progressive without chroma tables"):
        parts = [p for p in parts if not (p[1] == 0xC4 and p[4] in (0x01, 0x11))]
    elif kind == "sequential without any Huffman table":
        parts = [p for p in parts if p[1] != 0xC4]
    elif kind == "a Huffman code of all ones":
        # The luma DC table (codes of 2 bits: 1, of 3 bits: 5, ...): two of
        # its codes moved to 1 bit, the second of them all ones.
        at = next(k for k, p in enumerate(parts) if p[1] == 0xC4 and p[4] == 0x00)
        table = bytearray(parts[at])
        table[5], table[7] = 2, table[7] - 2
        parts[at] = bytes(table)
    else:  # "a damaged marker before the scan"
        at = next(k for k, p in enumerate(parts) if p[1] == 0xC4)
        parts[at] = b"\xff\x44" + parts[at][2:]
    _write(path, b"".join(parts))


@pytest.mark.parametrize("kind", ["sequential without chroma tables",
                                  "sequential without any Huffman table",
                                  "progressive without chroma tables",
                                  "a Huffman code of all ones",
                                  "a damaged marker before the scan"])
def test_jpeg_reader_repairs_read_where_pillow_reads(tmp_path, kind):
    """The JPEG reader's repairs found here (ROADMAP Queue 3): a
    sequential file without its Huffman tables reads with Annex K's, as
    libjpeg-turbo fills them in (a progressive one is refused, as
    libjpeg-turbo refuses it); a table with an over-full code and a
    marker byte below 0xC0 before the scan are refused as Pillow refuses
    them."""
    path = str(tmp_path / "repair.jpg")
    _jpeg_repair_case(kind, path, np.random.RandomState(3))
    ref = _jax_load(path)
    if kind.startswith("sequential"):
        assert not isinstance(ref, Exception), ref
        _assert_same(path)
    else:
        assert isinstance(ref, Exception)
        with pytest.raises(ImageError):
            timages.SourceImage.load(path)
