"""Regenerate the fixtures of the port's file formats:

* tests/fixtures/torch_persp_full_v{0,1}.jpg: the pair of phase 6's scene
  at full width (chip_smoke.render_perspective at 1024x820, seed 3,
  camera 2 = pair_cam, the focal length exactly what 43 mm gives),
  tinted as tests/gen_torch_persp_fixture.py tints it, as progressive
  JPEGs written by Pillow at its default quality (75) with 4:2:0 sampling
  and EXIF FocalLengthIn35mmFilm = 43 in the Exif sub-IFD;
* tests/fixtures/torch_persp_full_v{0,1}_baseline.jpg: their baseline
  twins, the same quality and sampling;
* tests/fixtures/torch_formats_sha256.json: the SHA-256 of Pillow's
  convert("L") and convert("RGB") planes of the progressive files
  ("decoder"), of Pillow's default JPEG bytes of each of
  chip_smoke.encoder_cases()'s arrays ("encoder"), and of Pillow's
  planes of the BMP, float TIFF, JPEG-in-TIFF and RLE8 BMP files that
  chip_smoke.instrument_files writes from phase 3's SEM pair ("phase8"),
  of the GIF and WebP files of phase 8 (j) ("gif_webp"), and of the
  16-bit PGM, SPIDER, RLE TGA and CMYK TIFF files of phase 8 (k)
  (chip_smoke.raster_files, "raster"), of the LZMA TIFF, DIB, text-EXIF
  PNG and zstd TIFF files of phase 8 (l) (chip_smoke.codec_files,
  "codecs") and of its icons (chip_smoke.icon_files, "icons"), of the
  Sun raster, IM, MSP, XBM and XPM files of phase 8 (m)
  (chip_smoke.legacy_files, "legacy"), of the damaged LZMA TIFF below
  ("lzma damaged"), of the arithmetic-coded and lossless JPEGs of
  phase 8 (n) that Pillow reads (chip_smoke.jpeg_coding_files, "jpeg
  codings", read with Pillow's read block raised to the whole file) and
  of the old-style JPEG-in-TIFF, PSD, FITS and small raw-format files of
  phase 8 (o) (chip_smoke.pillow_rest_files, "pillow rest") and of the
  DDS, BLP and FTEX files of phase 8 (p) (chip_smoke.block_texture_files,
  "block textures") and of the FLI/FLC and Photo CD files of phase 8 (q)
  (chip_smoke.fli_pcd_files, "fli pcd"), of the JPEG 2000 files below
  ("jpeg2000"), and of Pillow's PNG, APNG, GIF, ICO and ICNS bytes of
  phase 8 (s)'s seeded depth map and of their deflate-free forms
  (depth_writer_hashes, "depth writers"), and of Pillow's .jp2, .j2k,
  .j2c, .jpc, .jpf, .jpx and .pdf bytes of that map, the PDF's dates at
  chip_smoke.PDF_CLOCK (jpeg2000_writer_hashes, "jpeg2000 writer"), and
  of Pillow's .webp bytes of that map, an opaque and a fully transparent
  copy (chip_smoke.webp_writer_maps, webp_writer_hashes, "webp writer"),
  and of the port's own .avif bytes of those three maps with Pillow's
  bytes of each and the PSNR of Pillow's file on its opaque pixels
  (chip_smoke.avif_writer_maps, avif_writer_fixture, "avif writer";
  `python -m tests.gen_torch_formats_fixture avif-writer` rewrites only
  that entry);
* tests/fixtures/jpeg2000/: phase 8 (r)'s JPEG 2000 files
  (jpeg2000_fixtures, chip_smoke.J2K_*), written by Pillow's OpenJPEG;
* tests/fixtures/avif/: phase 8 (v)'s AVIF files (avif_fixtures,
  chip_smoke.AVIF_*), written by Pillow's libavif with aom, and the
  SHA-256 of Pillow's planes of them ("avif"); and phase 8 (v3)'s, the
  kinds Pillow's save does not write (grids, matrix coefficients,
  quantizer matrices, film grain, damaged grids), written through the
  same library's encoder with ctypes (avif_kind_fixtures, Libavif), with
  Pillow's plane hashes or the step at which Pillow fails ("avif kinds");
  and phase 8 (x)'s 10- and 12-bit files, Pillow's 8-bit files with their
  AV1 sequence headers, av1C and pixi rewritten (avif_depth_fixtures,
  high_depth), with Pillow's plane hashes ("avif depth"); and phase 8
  (y)'s superres files, aom's streams coded at the downscaled width with
  their headers rewritten (superres), and files whose ispe is not their
  frame's size (with_ispe), with Pillow's plane hashes or the step at
  which Pillow fails (avif_scale_fixtures, "avif scale");
* tests/fixtures/torch_lzma_damaged.tif: a 64x256 gradient as one
  xz-compressed strip (no check) with bits flipped where liblzma fills the
  strip before it finds the damage, so that Pillow's libtiff reads it
  (lzma_damaged_strip);
* tests/fixtures/torch_persp_full_v{0,1}.webp: the full-width pair as
  lossy WebPs at Pillow's default quality (80), with an alpha plane
  that is not all opaque (so the encoder writes an ALPH chunk) and the
  EXIF block above (a VP8X file with ALPH, VP8 and EXIF chunks);
* tests/fixtures/torch_persp_v{0,1}_lossless.webp: BASELINE #3's two
  320x256 views (tests/gen_torch_persp_fixture.py's tint) as lossless
  WebPs (VP8L) with the same EXIF block;
* tests/fixtures/torch_persp_v{0,1}_zstd.tif: the same views
  (chip_smoke.tint) as zstd-compressed RGB TIFFs with horizontal
  differencing (predictor 2), written by Pillow's libtiff.

Run from the repo root:

    python -m tests.gen_torch_formats_fixture
    python -m tests.gen_torch_formats_fixture avif   # the AVIF files alone
    python -m tests.gen_torch_formats_fixture avif-kinds   # only those of "avif kinds"
    python -m tests.gen_torch_formats_fixture avif-depth   # only those of "avif depth"
    python -m tests.gen_torch_formats_fixture avif-scale   # only those of "avif scale"

The port must decode the files to those planes and encode the arrays to
those bytes (tests/test_torch_images.py, tests/test_torch_jpeg_encode.py,
tests/test_torch_gif_webp.py, tests/test_torch_raster_formats.py and
tests/test_torch_icons_codecs.py, tests/test_torch_legacy_rasters.py and
tests/test_torch_pillow_rest.py, tests/test_torch_block_textures.py,
tests/test_torch_fli_pcd_writers.py, tests/test_torch_jpeg2000.py,
tests/test_torch_depth_writers.py, tests/test_torch_jpeg2000_encode.py,
tests/test_torch_webp_encode.py and tests/test_torch_avif.py here;
chip_smoke.py phase 8 (e), (f) and (h)-(v) on the card, with Pillow
blocked).
"""

import hashlib
import io
import json
import os
import struct
import sys
import tempfile
import zlib

import numpy as np
from PIL import Image

import chip_smoke
from tests.gen_torch_persp_fixture import tinted


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def pillow_jpeg(px: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG")
    return buf.getvalue()


def phase8_planes() -> dict:
    """{file name: {"l", "rgb": SHA-256 of Pillow's planes}} of the files
    chip_smoke.instrument_files writes from phase 3's pair."""
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for paths in chip_smoke.instrument_files(td, img1, img2).values():
            for path in paths:
                out[os.path.basename(path)] = planes(path)
    return out


def planes(path: str) -> dict:
    """SHA-256 of Pillow's convert("L") and convert("RGB") planes."""
    with Image.open(path) as im:
        return {"l": sha256(np.asarray(im.convert("L")).tobytes()),
                "rgb": sha256(np.asarray(im.convert("RGB")).tobytes())}


def focal_exif() -> bytes:
    exif = Image.Exif()
    exif.get_ifd(0x8769)[41989] = chip_smoke.PERSP_FOCAL_35MM
    return exif.tobytes()


def webp_fixtures(full_views) -> None:
    """Write the four WebP fixtures (module docstring)."""
    rng = np.random.RandomState(14)
    for view, path in zip(full_views, chip_smoke.PERSP_FULL_WEBPS):
        rgba = np.empty(view.shape + (4,), np.uint8)
        rgba[:, :, :3] = tinted(view)
        rgba[:, :, 3] = 255
        rgba[-64:, -96:, 3] = rng.randint(160, 256, (64, 96))
        Image.fromarray(rgba).save(path, exif=focal_exif())
        print(path, os.path.getsize(path), "bytes")
    views, _, _, _ = chip_smoke.render_perspective(
        chip_smoke.PERSP_W, chip_smoke.PERSP_H, chip_smoke.PERSP_CAMS[:1], exact_focal=True)
    for view, path in zip(views, chip_smoke.PERSP_WEBPS_LOSSLESS):
        Image.fromarray(tinted(view)).save(path, lossless=True, exif=focal_exif())
        print(path, os.path.getsize(path), "bytes")


def gif_webp_planes() -> dict:
    """{file name: Pillow's plane hashes} of phase 8 (j)'s files: the GIFs
    chip_smoke.gif_pair writes from phase 3's pair and the WebP fixtures."""
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for path in chip_smoke.gif_pair(td, img1, img2):
            out[os.path.basename(path)] = planes(path)
    for path in chip_smoke.PERSP_FULL_WEBPS + chip_smoke.PERSP_WEBPS_LOSSLESS:
        out[os.path.basename(path)] = planes(path)
    return out


def raster_planes() -> dict:
    """{file name: Pillow's plane hashes} of phase 8 (k)'s files, which
    chip_smoke.raster_files writes."""
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for paths in chip_smoke.raster_files(td, img1, img2).values():
            for path in paths:
                out[os.path.basename(path)] = planes(path)
    return out


def zstd_fixtures() -> None:
    """Write the two zstd TIFF fixtures (module docstring)."""
    views, _, _, _ = chip_smoke.render_perspective(
        chip_smoke.PERSP_W, chip_smoke.PERSP_H, chip_smoke.PERSP_CAMS[:1], exact_focal=True)
    for view, path in zip(views, chip_smoke.PERSP_ZSTD_TIFFS):
        Image.fromarray(chip_smoke.tint(view)).save(path, compression="zstd", tiffinfo={317: 2})
        print(path, os.path.getsize(path), "bytes")


def codec_icon_planes() -> tuple[dict, dict]:
    """({file name: Pillow's plane hashes} of phase 8 (l)'s pairs, the
    same of its icons), as chip_smoke.codec_files and icon_files write
    them."""
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    codecs = {}
    with tempfile.TemporaryDirectory() as td:
        for paths in chip_smoke.codec_files(td, img1, img2).values():
            for path in paths:
                codecs[os.path.basename(path)] = planes(path)
        icons = {os.path.basename(p): planes(p) for p in chip_smoke.icon_files(td)}
    return codecs, icons


def legacy_planes() -> dict:
    """{file name: Pillow's plane hashes} of phase 8 (m)'s files, which
    chip_smoke.legacy_files writes."""
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for paths in chip_smoke.legacy_files(td, img1, img2).values():
            for path in paths:
                out[os.path.basename(path)] = planes(path)
    return out


def jpeg_coding_planes() -> dict:
    """{file name: Pillow's plane hashes} of phase 8 (n)'s files that
    Pillow reads (chip_smoke.jpeg_coding_files), with its read block
    raised to the file: Pillow fails on arithmetic-coded data past its
    first 64 KiB read, libjpeg-turbo given the whole file decodes it."""
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for kind, paths in chip_smoke.jpeg_coding_files(td, img1, img2).items():
            for path in paths if kind != "refused" else ():
                with Image.open(path) as im:
                    im.decodermaxblock = os.path.getsize(path)
                    out[os.path.basename(path)] = {
                        "l": sha256(np.asarray(im.convert("L")).tobytes()),
                        "rgb": sha256(np.asarray(im.convert("RGB")).tobytes())}
    return out


def pillow_rest_planes() -> dict:
    """{file name: Pillow's plane hashes} of phase 8 (o)'s files, which
    chip_smoke.pillow_rest_files writes."""
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for paths in chip_smoke.pillow_rest_files(td, img1, img2).values():
            for path in paths:
                out[os.path.basename(path)] = planes(path)
    return out


def block_texture_planes() -> dict:
    """{file name: Pillow's plane hashes} of phase 8 (p)'s files, which
    chip_smoke.block_texture_files writes."""
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for paths in chip_smoke.block_texture_files(td, img1, img2).values():
            for path in paths:
                out[os.path.basename(path)] = planes(path)
    return out


def fli_pcd_planes() -> dict:
    """{file name: Pillow's plane hashes} of phase 8 (q)'s files, which
    chip_smoke.fli_pcd_files writes."""
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for paths in chip_smoke.fli_pcd_files(td, img1, img2).values():
            for path in paths:
                out[os.path.basename(path)] = planes(path)
    return out


def jpeg2000_fixtures() -> dict:
    """Write phase 8 (r)'s JPEG 2000 files (chip_smoke.J2K_*) with Pillow;
    {file name: Pillow's plane hashes}. The rates keep each full-width file
    near 60 KB and each SEM file near 50 KB (about 550 KB in all); the
    tile offset (1, 1) is odd and the image offset (33, 17) puts the
    grid's last column of tiles 32 pixels wide."""
    os.makedirs(chip_smoke.J2K_DIR, exist_ok=True)
    w, h = round(chip_smoke.PERSP_W * chip_smoke.FULL_SCALE), round(
        chip_smoke.PERSP_H * chip_smoke.FULL_SCALE)
    full, _, _, _ = chip_smoke.render_perspective(w, h, chip_smoke.PERSP_CAMS[:1],
                                                  exact_focal=True)
    for view, path in zip(full, chip_smoke.J2K_FULL):
        Image.fromarray(tinted(view)).save(
            path, irreversible=True, quality_mode="rates", quality_layers=[160, 80, 40],
            progression="RPCL", tile_size=(512, 512), tile_offset=(1, 1), offset=(33, 17))
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    for img, path in zip((img1, img2), chip_smoke.J2K_SEM):
        Image.fromarray(img).save(path, irreversible=True, quality_mode="rates",
                                  quality_layers=[20])
    views, _, _, _ = chip_smoke.render_perspective(
        chip_smoke.PERSP_W, chip_smoke.PERSP_H, chip_smoke.PERSP_CAMS[:1], exact_focal=True)
    for view, path in zip(views, chip_smoke.J2K_PERSP):
        Image.fromarray(tinted(view)).save(path, progression="LRCP", precinct_size=(64, 64))
    rgb = tinted(views[0])[100:124, 120:152]
    gray, alpha = rgb[:, :, 1], rgb[:, :, 0]
    cmyk = Image.frombytes("CMYK", rgb.shape[1::-1], np.dstack([rgb, alpha]).tobytes())
    small = {
        "la.jp2": (Image.fromarray(np.dstack([gray, alpha]), "LA"), {}),
        "rgba.j2k": (Image.fromarray(np.dstack([rgb, gray]), "RGBA"), {"irreversible": True}),
        "cmyk.jp2": (cmyk, {}),
        "cmyk.j2k": (cmyk, {"irreversible": True}),
        "ycbcr.jp2": (Image.fromarray(rgb).convert("YCbCr"), {}),
        "i16.j2k": (Image.fromarray(gray.astype(np.uint16) * 257).convert("I;16"), {}),
        "signed.jp2": (Image.fromarray(rgb), {"signed": True, "irreversible": True}),
        "pcrl.j2k": (Image.fromarray(rgb), {"progression": "PCRL", "precinct_size": (32, 32),
                                            "num_resolutions": 3}),
        "cprl.jp2": (Image.fromarray(gray), {"progression": "CPRL", "irreversible": True}),
        "rlcp.j2k": (Image.fromarray(rgb), {"progression": "RLCP", "quality_mode": "dB",
                                            "quality_layers": [30, 40, 50]}),
        "plt.j2k": (Image.fromarray(rgb), {"plt": True, "tile_size": (16, 16)}),
    }
    for name, (im, opts) in small.items():
        im.save(os.path.join(chip_smoke.J2K_DIR, name), **opts)
    idx = (gray // 43).astype(np.uint8)  # six palette indices
    colours = [tuple(int(v) for v in c) for c in rgb.reshape(-1, 3)[::127][:6]]
    for name, im in (("p.jp2", Image.fromarray(idx)),
                     ("pa.jp2", Image.fromarray(np.dstack([idx, alpha]), "LA"))):
        buf = io.BytesIO()
        im.save(buf, "JPEG2000")
        with open(os.path.join(chip_smoke.J2K_DIR, name), "wb") as fh:
            fh.write(chip_smoke.jp2_with_palette(buf.getvalue(), colours))
    buf = io.BytesIO()
    Image.fromarray(tinted(views[0])[:32, :32]).save(buf, "JPEG2000")
    with open(os.path.join(chip_smoke.J2K_DIR, "entry.icns"), "wb") as fh:
        fh.write(chip_smoke.icns_file([(b"ic11", buf.getvalue())]))
    paths = (chip_smoke.J2K_FULL + chip_smoke.J2K_SEM + chip_smoke.J2K_PERSP
             + [os.path.join(chip_smoke.J2K_DIR, n) for n in chip_smoke.J2K_DECODE_ONLY])
    print(chip_smoke.J2K_DIR, sum(os.path.getsize(p) for p in paths), "bytes")
    return {os.path.basename(p): planes(p) for p in paths}


def avif_fixtures() -> dict:
    """Write phase 8 (v)'s AVIF files (chip_smoke.AVIF_*) with Pillow's
    libavif (aom 3.12.1); {file name: Pillow's plane hashes}. Phase 3's
    SEM pair as 4:0:0 at quality 50 (about 200 KB each); BASELINE #3's
    views as RGB 4:2:0 at the default quality 75 with EXIF focal length
    43 and orientation 6 (which Pillow's save moves into irot); small
    decode-only files: RGBA with a varying alpha, 4:4:4, limited range,
    lossless, explicit 2x2 tiles, and a three-frame sequence (avis)."""
    os.makedirs(chip_smoke.AVIF_DIR, exist_ok=True)
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    for img, path in zip((img1, img2), chip_smoke.AVIF_SEM):
        Image.fromarray(img).save(path, quality=50, subsampling="4:0:0")
    views, _, _, _ = chip_smoke.render_perspective(
        chip_smoke.PERSP_W, chip_smoke.PERSP_H, chip_smoke.PERSP_CAMS[:1], exact_focal=True)
    exif = Image.Exif()
    exif[0x0112] = 6
    exif.get_ifd(0x8769)[41989] = chip_smoke.PERSP_FOCAL_35MM
    for view, path in zip(views, chip_smoke.AVIF_PERSP):
        Image.fromarray(tinted(view)).save(path, exif=exif.tobytes())
    rgb = tinted(views[0])[64:160, 96:224]
    alpha = np.round(np.linspace(0, 255, rgb.shape[1]))[None, :].repeat(rgb.shape[0], 0)
    small = {
        "rgba.avif": (Image.fromarray(np.dstack([rgb, alpha.astype(np.uint8)]), "RGBA"), {}),
        "yuv444.avif": (Image.fromarray(rgb), {"subsampling": "4:4:4", "quality": 60}),
        "limited.avif": (Image.fromarray(rgb), {"range": "limited", "subsampling": "4:2:2"}),
        "lossless.avif": (Image.fromarray(rgb), {"quality": 100, "subsampling": "4:4:4"}),
        "tiled.avif": (Image.fromarray(tinted(views[1])), {"tile_rows": 1, "tile_cols": 1}),
    }
    for name, (im, opts) in small.items():
        im.save(os.path.join(chip_smoke.AVIF_DIR, name), **opts)
    frames = [Image.fromarray(tinted(v)[64:160, 96:224]) for v in (*views, views[0][::-1])]
    frames[0].save(os.path.join(chip_smoke.AVIF_DIR, "sequence.avif"), save_all=True,
                   append_images=frames[1:])
    paths = (chip_smoke.AVIF_SEM + chip_smoke.AVIF_PERSP
             + [os.path.join(chip_smoke.AVIF_DIR, n) for n in chip_smoke.AVIF_DECODE_ONLY])
    print(chip_smoke.AVIF_DIR, sum(os.path.getsize(p) for p in paths), "bytes")
    return {os.path.basename(p): planes(p) for p in paths}


class Libavif:
    """The encoder of the libavif in Pillow's wheel (libavif 1.3.0, aom
    3.12.1), called through ctypes: it writes grids, any CICP and aom's
    codec options (quantizer matrices, film grain), which Pillow's save
    does not; and its YUV->RGB and un-premultiply, which Pillow's load
    runs. The avifImage, avifRGBImage and avifEncoder field offsets are
    libavif 1.3.0's on a 64-bit machine, all here; the version is
    asserted."""

    VERSION = b"1.3.0"
    FORMATS = {"444": 1, "422": 2, "420": 3, "400": 4}  # avifPixelFormat
    # avifImage: yuvRange, yuvPlanes[3], yuvRowBytes[3], alphaPlane,
    # alphaRowBytes, alphaPremultiplied, colorPrimaries /
    # transferCharacteristics / matrixCoefficients (uint16 each).
    IMAGE_RANGE, IMAGE_PLANES, IMAGE_ROW_BYTES = 16, 24, 48
    IMAGE_ALPHA, IMAGE_ALPHA_ROW_BYTES, IMAGE_PREMULTIPLIED, IMAGE_CICP = 64, 72, 80, 104
    # avifRGBImage: width, height, depth, format (RGB 0, RGBA 1), ...,
    # maxThreads, pixels, rowBytes.
    RGB_DEPTH, RGB_FORMAT, RGB_MAX_THREADS, RGB_PIXELS, RGB_ROW_BYTES = 8, 12, 40, 48, 56
    # avifEncoder: speed, quality, qualityAlpha.
    ENCODER_SPEED, ENCODER_QUALITY, ENCODER_QUALITY_ALPHA = 8, 32, 36
    PLANES_YUV, PLANES_ALL = 1, 0xFF
    ADD_IMAGE_FLAG_SINGLE = 2

    def __init__(self):
        import ctypes
        import glob

        import PIL

        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        self.ct = ctypes
        lib = self.lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libavif-*.so*"))[0])
        lib.avifVersion.restype = ctypes.c_char_p
        assert lib.avifVersion() == self.VERSION, lib.avifVersion()
        vp = ctypes.c_void_p
        lib.avifImageCreate.restype = vp
        lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int]
        lib.avifImageAllocatePlanes.argtypes = [vp, ctypes.c_int]
        lib.avifImageDestroy.argtypes = [vp]
        lib.avifEncoderCreate.restype = vp
        lib.avifEncoderDestroy.argtypes = [vp]
        lib.avifEncoderSetCodecSpecificOption.argtypes = [vp, ctypes.c_char_p, ctypes.c_char_p]
        lib.avifEncoderAddImage.argtypes = [vp, vp, ctypes.c_uint64, ctypes.c_uint32]
        lib.avifEncoderAddImageGrid.argtypes = [vp, ctypes.c_uint32, ctypes.c_uint32,
                                                ctypes.POINTER(vp), ctypes.c_uint32]

        class RWData(ctypes.Structure):
            _fields_ = [("data", vp), ("size", ctypes.c_size_t)]

        self.RWData = RWData
        lib.avifEncoderFinish.argtypes = [vp, ctypes.POINTER(RWData)]
        lib.avifRWDataFree.argtypes = [ctypes.POINTER(RWData)]

    def image(self, planes, fmt: str, full: bool, cicp: tuple, alpha=None) -> int:
        """An avifImage of 8-bit planes ([Y] or [Y, U, V] uint8 arrays),
        its range and (primaries, transfer, matrix) codes."""
        ct, lib = self.ct, self.lib
        h, w = planes[0].shape
        im = lib.avifImageCreate(w, h, 8, self.FORMATS[fmt])
        ct.c_int.from_address(im + self.IMAGE_RANGE).value = int(full)
        for k, code in enumerate(cicp):
            ct.c_uint16.from_address(im + self.IMAGE_CICP + 2 * k).value = code
        assert lib.avifImageAllocatePlanes(
            im, self.PLANES_YUV if alpha is None else self.PLANES_ALL) == 0
        targets = [(self.IMAGE_PLANES + 8 * k, self.IMAGE_ROW_BYTES + 4 * k, p)
                   for k, p in enumerate(planes)]
        if alpha is not None:
            targets.append((self.IMAGE_ALPHA, self.IMAGE_ALPHA_ROW_BYTES, alpha))
        for at, rb_at, plane in targets:
            ptr = ct.c_void_p.from_address(im + at).value
            row_bytes = ct.c_uint32.from_address(im + rb_at).value
            plane = np.ascontiguousarray(plane, np.uint8)
            for r in range(plane.shape[0]):
                ct.memmove(ptr + r * row_bytes, plane[r].ctypes.data, plane.shape[1])
        return im

    def yuv_to_rgb(self, planes, depth: int, fmt: str, full: bool, cicp: tuple, alpha=None,
                   premultiplied: bool = False, channels: int | None = None):
        """avifImageYUVToRGB of the planes ([Y] or [Y, U, V], and an alpha
        plane; uint8 at depth 8, uint16 above) to 8-bit RGB, or RGBA where
        there is alpha or `channels` is 4, as Pillow asks for it; its
        avifResult where it fails."""
        ct, lib = self.ct, self.lib
        lib.avifRGBImageSetDefaults.argtypes = [ct.c_void_p, ct.c_void_p]
        lib.avifImageYUVToRGB.argtypes = [ct.c_void_p, ct.c_void_p]
        lib.avifImageYUVToRGB.restype = ct.c_int
        h, w = planes[0].shape
        im = lib.avifImageCreate(w, h, depth, self.FORMATS[fmt])
        try:
            ct.c_int.from_address(im + self.IMAGE_RANGE).value = int(full)
            ct.c_int.from_address(im + self.IMAGE_PREMULTIPLIED).value = int(premultiplied)
            for k, code in enumerate(cicp):
                ct.c_uint16.from_address(im + self.IMAGE_CICP + 2 * k).value = code
            assert lib.avifImageAllocatePlanes(
                im, self.PLANES_YUV if alpha is None else self.PLANES_ALL) == 0
            targets = [(self.IMAGE_PLANES + 8 * k, self.IMAGE_ROW_BYTES + 4 * k, p)
                       for k, p in enumerate(planes)]
            if alpha is not None:
                targets.append((self.IMAGE_ALPHA, self.IMAGE_ALPHA_ROW_BYTES, alpha))
            dtype = np.uint16 if depth > 8 else np.uint8
            for at, rb_at, plane in targets:
                ptr = ct.c_void_p.from_address(im + at).value
                row_bytes = ct.c_uint32.from_address(im + rb_at).value
                plane = np.ascontiguousarray(plane, dtype)
                for r in range(plane.shape[0]):
                    ct.memmove(ptr + r * row_bytes, plane[r].ctypes.data, plane[r].nbytes)
            channels = channels or (3 if alpha is None else 4)
            rgb = ct.create_string_buffer(128)
            lib.avifRGBImageSetDefaults(rgb, im)
            base = ct.addressof(rgb)
            ct.c_uint32.from_address(base + self.RGB_DEPTH).value = 8
            ct.c_uint32.from_address(base + self.RGB_FORMAT).value = int(channels == 4)
            out = np.zeros((h, w, channels), np.uint8)
            ct.c_void_p.from_address(base + self.RGB_PIXELS).value = out.ctypes.data
            ct.c_uint32.from_address(base + self.RGB_ROW_BYTES).value = channels * w
            res = lib.avifImageYUVToRGB(im, rgb)
            return out if res == 0 else res
        finally:
            lib.avifImageDestroy(im)

    def unpremultiply(self, rgba: np.ndarray) -> np.ndarray:
        """avifRGBImageUnpremultiplyAlpha of 8-bit RGBA, on a copy."""
        ct, lib = self.ct, self.lib
        lib.avifRGBImageUnpremultiplyAlpha.argtypes = [ct.c_void_p]
        lib.avifRGBImageUnpremultiplyAlpha.restype = ct.c_int
        out = np.array(rgba, np.uint8, order="C")
        h, w = out.shape[:2]
        rgb = ct.create_string_buffer(128)
        base = ct.addressof(rgb)
        for at, v in ((0, w), (4, h), (self.RGB_DEPTH, 8), (self.RGB_FORMAT, 1)):
            ct.c_uint32.from_address(base + at).value = v
        ct.c_int.from_address(base + self.RGB_MAX_THREADS).value = 1
        ct.c_void_p.from_address(base + self.RGB_PIXELS).value = out.ctypes.data
        ct.c_uint32.from_address(base + self.RGB_ROW_BYTES).value = 4 * w
        assert lib.avifRGBImageUnpremultiplyAlpha(rgb) == 0
        return out

    def scale(self, planes, depth: int, fmt: str, width: int, height: int, alpha=None):
        """avifImageScale of the planes ([Y] or [Y, U, V], and an alpha
        plane; uint8 at depth 8, uint16 above) to width x height: the
        scaled planes (the alpha last), or (avifResult, its diagnostic)
        where it fails."""
        ct, lib = self.ct, self.lib
        lib.avifImageScale.argtypes = [ct.c_void_p, ct.c_uint32, ct.c_uint32, ct.c_void_p]
        lib.avifImageScale.restype = ct.c_int
        h, w = planes[0].shape
        im = lib.avifImageCreate(w, h, depth, self.FORMATS[fmt])
        dtype = np.dtype(np.uint16 if depth > 8 else np.uint8)
        try:
            assert lib.avifImageAllocatePlanes(
                im, self.PLANES_YUV if alpha is None else self.PLANES_ALL) == 0
            targets = [(self.IMAGE_PLANES + 8 * k, self.IMAGE_ROW_BYTES + 4 * k)
                       for k in range(len(planes))]
            if alpha is not None:
                targets.append((self.IMAGE_ALPHA, self.IMAGE_ALPHA_ROW_BYTES))
            for (at, rb_at), plane in zip(targets, [*planes] + ([alpha] if alpha is not None
                                                                else [])):
                ptr = ct.c_void_p.from_address(im + at).value
                row_bytes = ct.c_uint32.from_address(im + rb_at).value
                plane = np.ascontiguousarray(plane, dtype)
                for r in range(plane.shape[0]):
                    ct.memmove(ptr + r * row_bytes, plane[r].ctypes.data, plane[r].nbytes)
            diag = ct.create_string_buffer(512)
            res = lib.avifImageScale(im, width, height, diag)
            if res != 0:
                return res, diag.value.decode()
            out = []
            for k, (at, rb_at) in enumerate(targets):
                ptr = ct.c_void_p.from_address(im + at).value
                row_bytes = ct.c_uint32.from_address(im + rb_at).value
                sx, sy = ({"420": (1, 1), "422": (1, 0)}.get(fmt, (0, 0))
                          if 0 < k < len(planes) else (0, 0))
                pw, ph = (width + sx) >> sx, (height + sy) >> sy
                out.append(np.stack([np.frombuffer(ct.string_at(ptr + r * row_bytes,
                                                                pw * dtype.itemsize), dtype)
                                     for r in range(ph)]))
            return out
        finally:
            lib.avifImageDestroy(im)

    def encode(self, images: list, grid=None, options=(), quality=60, speed=6) -> bytes:
        """One image, or a (rows, cols) grid of them, at the quality (also
        the alpha's) and speed, with aom's codec options; the images are
        freed."""
        ct, lib = self.ct, self.lib
        enc = lib.avifEncoderCreate()
        try:
            ct.c_int.from_address(enc + self.ENCODER_SPEED).value = speed
            ct.c_int.from_address(enc + self.ENCODER_QUALITY).value = quality
            ct.c_int.from_address(enc + self.ENCODER_QUALITY_ALPHA).value = quality
            for key, value in options:
                assert lib.avifEncoderSetCodecSpecificOption(enc, key.encode(),
                                                             value.encode()) == 0, key
            if grid:
                cells = (ct.c_void_p * len(images))(*images)
                res = lib.avifEncoderAddImageGrid(enc, grid[1], grid[0], cells,
                                                  self.ADD_IMAGE_FLAG_SINGLE)
            else:
                res = lib.avifEncoderAddImage(enc, images[0], 1, self.ADD_IMAGE_FLAG_SINGLE)
            assert res == 0, res
            out = self.RWData()
            assert lib.avifEncoderFinish(enc, ct.byref(out)) == 0
            data = ct.string_at(out.data, out.size)
            lib.avifRWDataFree(ct.byref(out))
            return data
        finally:
            lib.avifEncoderDestroy(enc)
            for im in images:
                lib.avifImageDestroy(im)


class Dav1d:
    """The dav1d 1.5.1 linked into the wheel's libavif (its API is
    exported), through ctypes: the YUV planes of an AV1 sample's first
    frame as libavif gets them for Pillow (film grain applied). The
    Dav1dSettings and Dav1dPicture field offsets are dav1d 1.5's on a
    64-bit machine."""

    SETTINGS_THREADS, SETTINGS_APPLY_GRAIN = 0, 8
    PICTURE_DATA, PICTURE_STRIDE, PICTURE_PARAMS = 16, 40, 56  # params: w, h, layout, bpc

    def __init__(self):
        import ctypes
        import glob

        import PIL

        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        self.ct = ctypes
        lib = self.lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libavif-*.so*"))[0])
        vp = ctypes.c_void_p
        lib.dav1d_data_create.restype = vp
        lib.dav1d_data_create.argtypes = [vp, ctypes.c_size_t]
        lib.dav1d_open.argtypes = [ctypes.POINTER(vp), vp]
        lib.dav1d_send_data.argtypes = [vp, vp]
        lib.dav1d_get_picture.argtypes = [vp, vp]
        lib.dav1d_picture_unref.argtypes = [vp]
        lib.dav1d_close.argtypes = [ctypes.POINTER(vp)]
        lib.dav1d_default_settings.argtypes = [vp]

    def decode(self, sample: bytes) -> tuple[list, int]:
        """([Y] or [Y, U, V] planes, uint8 at 8 bits and uint16 above, and
        the bit depth); RuntimeError where dav1d refuses the stream."""
        ct, lib = self.ct, self.lib
        settings = ct.create_string_buffer(256)
        lib.dav1d_default_settings(settings)
        ct.c_int.from_buffer(settings, self.SETTINGS_THREADS).value = 1
        ct.c_int.from_buffer(settings, self.SETTINGS_APPLY_GRAIN).value = 1
        ctx = ct.c_void_p()
        assert lib.dav1d_open(ct.byref(ctx), settings) == 0
        try:
            data, pic = ct.create_string_buffer(128), ct.create_string_buffer(512)
            ct.memmove(lib.dav1d_data_create(data, len(sample)), sample, len(sample))
            sent = lib.dav1d_send_data(ctx, data)
            if lib.dav1d_get_picture(ctx, pic) != 0:
                raise RuntimeError(f"dav1d refuses the stream (send {sent})")
            w, h, layout, bpc = (ct.c_int.from_buffer(pic, self.PICTURE_PARAMS + 4 * k).value
                                 for k in range(4))
            ptrs = [ct.c_void_p.from_buffer(pic, self.PICTURE_DATA + 8 * k).value
                    for k in range(3)]
            strides = [ct.c_ssize_t.from_buffer(pic, self.PICTURE_STRIDE + 8 * k).value
                       for k in range(2)]
            dtype = np.dtype(np.uint16 if bpc > 8 else np.uint8)
            sx, sy = {1: (1, 1), 2: (1, 0), 3: (0, 0)}.get(layout, (0, 0))  # I420, I422, I444
            planes = []
            for k in range(1 if layout == 0 else 3):
                pw, ph = (w, h) if k == 0 else ((w + sx) >> sx, (h + sy) >> sy)
                stride = strides[min(k, 1)]
                rows = [np.frombuffer(ct.string_at(ptrs[k] + r * stride, pw * dtype.itemsize),
                                      dtype) for r in range(ph)]
                planes.append(np.stack(rows))
            lib.dav1d_picture_unref(pic)
            return planes, bpc
        finally:
            lib.dav1d_close(ct.byref(ctx))


def yuv_field(h: int, w: int, seed: int, fmt: str) -> list:
    """Seeded smooth 8-bit Y, U and V planes (Y alone for 4:0:0) of an
    h x w image, the chroma at the format's subsampling."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    luma = 128 + 70 * np.sin(x / (6.0 + seed % 5)) * np.cos(y / 9.0) + rng.normal(0, 4, (h, w))
    out = [luma]
    if fmt != "400":
        sx, sy = int(fmt != "444"), int(fmt == "420")
        cy, cx = np.mgrid[0:(h + sy) >> sy, 0:(w + sx) >> sx]
        out += [128 + 60 * np.sin(cx / 4.0 + seed), 128 + 60 * np.cos(cy / 5.0 + cx / 7.0)]
    return [np.clip(p, 0, 255).astype(np.uint8) for p in out]


def _edit(data: bytes, at: int, new: bytes) -> bytes:
    return data[:at] + new + data[at + len(new):]


def _grid_layout(data: bytes) -> dict:
    """Where a libavif grid file keeps what the damaged copies edit: the
    colour grid's ImageGrid payload, its ispe's width field, its dimg
    references and each item's ipma property indices."""
    from cybervision_tpu_torch.imageio import avif

    meta = next((s, e) for t, s, e in avif._boxes(data, 0, len(data)) if t == b"meta")
    items, primary, _ = avif._parse_meta(data, *meta)
    grid = items[primary]
    ispe = next(s for t, s, e in grid.props if t == b"ispe")
    dimg = data.index(b"dimg") + 4 + 4  # past the from id and the count
    ipma = data.index(b"ipma") + 4
    assert data[ipma:ipma + 4] == b"\0\0\0\0"  # version 0: 16-bit ids, 8-bit indices
    entries, p = {}, ipma + 8
    for _ in range(struct.unpack_from(">I", data, ipma + 4)[0]):
        iid, n = struct.unpack_from(">HB", data, p)
        entries[iid] = p + 3  # its first property index
        p += 3 + n
    return {"payload": grid.extents[0][0], "ispe": ispe + 4, "dimg": dimg, "ipma": entries,
            "primary": primary, "tiles": items[primary].refs[b"dimg"]}


# -- high bit depth rewrites of the wheel's 8-bit files ----------------------------


class _SeqBits:
    """An AV1 sequence header OBU's payload as bits, parsed as far as
    film_grain_params_present (av1obu.cpp's sequence_header), with where
    its colour_config starts and ends."""

    def __init__(self, payload: bytes):
        self.bits = [(byte >> (7 - k)) & 1 for byte in payload for k in range(8)]
        self.pos = 0
        f = self.f
        self.profile = f(3)
        f(1)
        reduced = f(1)
        decoder_model = buffer_delay = 0
        if reduced:
            f(5)
        else:
            if f(1):  # timing_info_present_flag
                f(64)
                if f(1):  # equal_picture_interval
                    lead = 0
                    while not f(1):
                        lead += 1
                    f(lead)
                decoder_model = f(1)
                if decoder_model:
                    buffer_delay = f(5) + 1
                    f(32)
                    f(10)
            display_delay = f(1)
            for _ in range(f(5) + 1):
                f(12)
                if f(5) > 7:
                    f(1)
                if decoder_model and f(1):
                    f(2 * buffer_delay + 1)
                if display_delay and f(1):
                    f(4)
        self.reduced, self.decoder_model = reduced, decoder_model
        self.dims = self.pos
        self.fwb, self.fhb = f(4) + 1, f(4) + 1
        self.max_w, self.max_h = f(self.fwb) + 1, f(self.fhb) + 1
        self.dims_end = self.pos
        self.frame_ids = not reduced and f(1)  # frame_id_numbers_present_flag
        if self.frame_ids:
            f(7)
        self.sb128 = f(1)
        f(2)
        self.screen = self.integer_mv = 2
        self.order_hint_bits = 0
        if not reduced:
            f(4)
            order_hint = f(1)
            if order_hint:
                f(2)
            self.screen = 2 if f(1) else f(1)
            self.integer_mv = (2 if f(1) else f(1)) if self.screen > 0 else 2
            if order_hint:
                self.order_hint_bits = f(3) + 1
        self.tools = self.pos
        self.superres, self.cdef, self.restoration = f(1), f(1), f(1)
        self.cc = self.pos
        high = f(1)
        depth = (12 if f(1) else 10) if self.profile == 2 and high else (10 if high else 8)
        assert depth == 8, depth
        self.mono = 0 if self.profile == 1 else f(1)
        self.cicp = None
        if f(1):
            self.cicp = (f(8), f(8), f(8))
        self.range = self.sub = self.csp = None
        if self.mono:
            self.range, self.sub = f(1), (1, 1)
        elif self.cicp == (1, 13, 0):
            self.sub = (0, 0)
        else:
            self.range = f(1)
            self.sub = {0: (1, 1), 1: (0, 0), 2: (1, 0)}[self.profile]
            if self.sub == (1, 1):
                self.csp = f(2)
        self.sep_uv = 0 if self.mono else f(1)
        self.cc_end = self.pos
        self.grain = f(1)  # film_grain_params_present
        self.end = self.pos

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bits[self.pos]
            self.pos += 1
        return v

    def profile_for(self, depth: int) -> int:
        if depth == 12:
            return 2
        return 0 if self.sub == (1, 1) else 1 if self.sub == (0, 0) else 2

    def rewritten(self, depth: int) -> bytes:
        """The payload at `depth` (10 or 12): the profile that carries the
        format at that depth, high_bitdepth (and twelve_bit), the rest of
        the header as it was, new trailing bits."""
        profile = self.profile_for(depth)

        def put(v, n):
            return [(v >> (n - 1 - k)) & 1 for k in range(n)]

        cc = [1] + (put(depth == 12, 1) if profile == 2 else [])
        cc += put(self.mono, 1) if profile != 1 else []
        cc += [1] + sum((put(c, 8) for c in self.cicp), []) if self.cicp else [0]
        if self.mono:
            cc += [self.range]
        elif self.cicp != (1, 13, 0):
            cc += [self.range]
            if profile == 2 and depth == 12:
                cc += [self.sub[0]] + ([self.sub[1]] if self.sub[0] else [])
            if self.sub == (1, 1):
                cc += put(self.csp, 2)
        cc += [] if self.mono else [self.sep_uv]
        bits = put(profile, 3) + self.bits[3:self.cc] + cc + self.bits[self.cc_end:self.end] + [1]
        bits += [0] * (-len(bits) % 8)
        return bytes(sum(b << (7 - k) for k, b in enumerate(bits[i:i + 8]))
                     for i in range(0, len(bits), 8))


def _leb128(v: int) -> bytes:
    out = bytearray()
    while True:
        out.append((v & 0x7F) | (0x80 if v >= 0x80 else 0))
        v >>= 7
        if not v:
            return bytes(out)


def _obus(data: bytes):
    """(header bytes, payload) of each OBU of a sample (every one with a
    size field, as aom writes them)."""
    at = 0
    while at < len(data):
        hdr = data[at:at + 1 + ((data[at] >> 2) & 1)]
        assert data[at] & 2, "an OBU without its size field"
        at += len(hdr)
        size = shift = 0
        while True:
            byte = data[at]
            at += 1
            size |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        yield hdr, data[at:at + size]
        at += size


def _high_depth_sample(data: bytes, depth: int) -> tuple[bytes, _SeqBits]:
    out, seq = bytearray(), None
    for hdr, payload in _obus(data):
        if (hdr[0] >> 3) & 15 == 1:
            seq = _SeqBits(payload)
            payload = seq.rewritten(depth)
        out += hdr + _leb128(len(payload)) + payload
    assert seq is not None, "a sample without a sequence header"
    return bytes(out), seq


def _put(v: int, n: int) -> list:
    return [(v >> (n - 1 - k)) & 1 for k in range(n)]


def _packed(bits: list) -> bytes:
    bits = bits + [0] * (-len(bits) % 8)
    return bytes(sum(b << (7 - k) for k, b in enumerate(bits[i:i + 8]))
                 for i in range(0, len(bits), 8))


class _FrameBits:
    """A shown key frame's uncompressed header over its sequence header
    (a _SeqBits without a decoder model or frame ids), parsed as
    av1obu.cpp's frame_header reads it: where superres_params sit
    (`sr`), allow_intrabc's bit (`intrabc`, None where it is not read),
    where the header ends (`end`), and the frame's loop restoration
    types and unit size (`lr`, `lr_size`)."""

    def __init__(self, payload: bytes, seq: _SeqBits):
        assert not seq.decoder_model and not seq.frame_ids
        self.bits = [(byte >> (7 - k)) & 1 for byte in payload for k in range(8)]
        self.pos = 0
        f = self.f
        planes = 1 if seq.mono else 3
        if not seq.reduced:
            assert f(1) == 0 and f(2) == 0 and f(1) == 1, "a shown key frame"
        no_cdf_update = f(1)
        screen = f(1) if seq.screen == 2 else seq.screen
        if screen and seq.integer_mv == 2:
            f(1)
        assert seq.reduced or f(1) == 0, "frame_size_override_flag"
        f(seq.order_hint_bits)
        w, h = seq.max_w, seq.max_h
        self.sr = self.pos
        assert not seq.superres, "a sequence header that allows superres already"
        self.width, self.height = w, h
        if f(1):  # render_and_frame_size_different
            f(32)
        self.intrabc = None
        intrabc = 0
        if screen:
            self.intrabc = self.pos
            intrabc = f(1)
        if not seq.reduced and not no_cdf_update:
            f(1)  # disable_frame_end_update_cdf
        self._tile_info(seq, 2 * ((w + 7) >> 3), 2 * ((h + 7) >> 3))
        base_q = f(8)
        deltas = [self._delta_q()]
        if planes > 1:
            diff = f(1) if seq.sep_uv else 0
            deltas += [self._delta_q(), self._delta_q()]
            if diff:
                deltas += [self._delta_q(), self._delta_q()]
        if f(1):  # using_qmatrix
            f(8 + 4 * seq.sep_uv)
        seg_q = [base_q] * 8
        if f(1):  # segmentation_enabled
            bits, signed = (8, 6, 6, 6, 6, 3, 0, 0), (1, 1, 1, 1, 1, 0, 0, 0)
            for i in range(8):
                for j in range(8):
                    if f(1):
                        v = f(1 + bits[j]) if signed[j] else f(bits[j])
                        if j == 0:
                            v -= (v >> 8) << 9
                            seg_q[i] = min(max(base_q + max(-255, min(255, v)), 0), 255)
        delta_q = f(1) if base_q > 0 else 0
        if delta_q:
            f(2)
            if not intrabc and f(1):
                f(3)
        lossless = not any(seg_q) and not any(deltas)
        self.lossless = lossless
        if not lossless and not intrabc:
            levels = [f(6), f(6)]
            if planes > 1 and any(levels):
                f(12)
            f(3)
            if f(1) and f(1):  # loop_filter_delta_enabled, _update
                for _ in range(10):
                    if f(1):
                        f(7)
        if not lossless and not intrabc and seq.cdef:
            f(2)
            for _ in range(1 << f(2)):
                f(6 if planes == 1 else 12)
        self.lr, self.lr_size = [0] * planes, None
        if not lossless and not intrabc and seq.restoration:
            self.lr = [f(2) for _ in range(planes)]
            if any(self.lr):
                shift = f(1) + 1 if seq.sb128 else f(1)
                if not seq.sb128 and shift:
                    shift += f(1)
                self.lr_size = 256 >> (2 - shift)
                if seq.sub == (1, 1) and any(self.lr[1:]):
                    f(1)
        if not lossless:
            f(1)  # tx_mode_select
        f(1)  # reduced_tx_set
        if seq.grain:
            self._film_grain(seq)
        self.end = self.pos

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bits[self.pos]
            self.pos += 1
        return v

    def _delta_q(self) -> int:
        if not self.f(1):
            return 0
        v = self.f(7)
        return v - 128 if v & 64 else v

    def _ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def _tile_info(self, seq, mi_cols, mi_rows):
        f = self.f
        shift = 5 if seq.sb128 else 4
        sb_cols, sb_rows = -(-mi_cols >> shift), -(-mi_rows >> shift)
        size = shift + 2
        max_w_sb, max_area_sb = 4096 >> size, (4096 * 2304) >> (2 * size)

        def tile_log2(blk, target):
            k = 0
            while (blk << k) < target:
                k += 1
            return k

        min_cols = tile_log2(max_w_sb, sb_cols)
        max_cols, max_rows = tile_log2(1, min(sb_cols, 64)), tile_log2(1, min(sb_rows, 64))
        min_tiles = max(min_cols, tile_log2(max_area_sb, sb_rows * sb_cols))
        if f(1):  # uniform_tile_spacing_flag
            cols = min_cols
            while cols < max_cols and f(1):
                cols += 1
            rows = max(min_tiles - cols, 0)
            while rows < max_rows and f(1):
                rows += 1
            n_cols = len(range(0, sb_cols, (sb_cols + (1 << cols) - 1) >> cols))
            n_rows = len(range(0, sb_rows, (sb_rows + (1 << rows) - 1) >> rows))
        else:
            widest, start, n_cols = 0, 0, 0
            while start < sb_cols:
                size_sb = self._ns(min(sb_cols - start, max_w_sb)) + 1
                widest, start, n_cols = max(widest, size_sb), start + size_sb, n_cols + 1
            area = (sb_rows * sb_cols) >> (min_tiles + 1) if min_tiles else sb_rows * sb_cols
            start, n_rows = 0, 0
            while start < sb_rows:
                start += self._ns(min(sb_rows - start, max(area // widest, 1))) + 1
                n_rows += 1
            cols, rows = tile_log2(1, n_cols), tile_log2(1, n_rows)
        if cols or rows:
            f(cols + rows + 2)

    def _film_grain(self, seq):
        f = self.f
        if not f(1):  # apply_grain
            return
        f(16)
        num_y = f(4)
        f(16 * num_y)
        cfl = 0 if seq.mono else f(1)
        num_uv = [0, 0]
        if not (seq.mono or cfl or (seq.sub == (1, 1) and not num_y)):
            for k in range(2):
                num_uv[k] = f(4)
                f(16 * num_uv[k])
        f(2)
        lag = f(2)
        pos = 2 * lag * (lag + 1)
        if num_y:
            f(8 * pos)
        for k in range(2):
            if num_uv[k] or cfl:
                f(8 * (pos + (1 if num_y else 0)))
        f(4)
        for k in range(2):
            if num_uv[k]:
                f(25)
        f(2)


def superres_stream(data: bytes, denom: int, width: int) -> bytes:
    """An AV1 sample (OBUs with size fields, one shown key frame coded
    without superres) rewritten as the same frame coded with superres:
    the sequence header allows it and its frame width becomes `width`
    (the field's bits grow where they must), and the frame header gains
    use_superres and coded_denom (`denom` - 9) after its frame size and
    loses allow_intrabc, which must have been 0. The coded width, the
    downscaled one, must be what `width` and `denom` give (as dav1d
    computes it), so the tile data reads the same; the upscaled frame is
    what a decoder outputs."""
    out, seq = bytearray(), None
    for hdr, payload in _obus(data):
        kind = (hdr[0] >> 3) & 15
        if kind == 1:
            seq = _SeqBits(payload)
            fwb = max(seq.fwb, (width - 1).bit_length())
            bits = (seq.bits[:seq.dims] + _put(fwb - 1, 4) + _put(seq.fhb - 1, 4)
                    + _put(width - 1, fwb) + _put(seq.max_h - 1, seq.fhb)
                    + seq.bits[seq.dims_end:seq.tools] + [1] + seq.bits[seq.tools + 1:seq.end]
                    + [1])
            payload = _packed(bits)
        elif kind in (3, 6):
            fr = _FrameBits(payload, seq)
            coded = max((width * 8 + denom // 2) // denom, min(16, width))
            assert coded == fr.width, (coded, fr.width, "not the coded width of", width, denom)
            assert not (fr.lossless and seq.restoration), "lr_params would be read"
            bits = fr.bits[:fr.sr] + [1] + _put(denom - 9, 3)
            if fr.intrabc is None:
                bits += fr.bits[fr.sr:fr.end]
            else:
                assert fr.bits[fr.intrabc] == 0, "intra block copy is on"
                bits += fr.bits[fr.sr:fr.intrabc] + fr.bits[fr.intrabc + 1:fr.end]
            if kind == 3:
                bits += [1]  # trailing bits
            payload = _packed(bits) + (payload[(fr.end + 7) // 8:] if kind == 6 else b"")
        out += hdr + _leb128(len(payload)) + payload
    return bytes(out)


def high_depth(data: bytes, depth: int, stream: bool = True, boxes: bool = True,
               skip: tuple = ()) -> bytes:
    """A still AVIF file of the wheel's 8-bit av01 items (Pillow's save or
    Libavif's) rewritten as a `depth`-bit file (10 or 12): every av01
    item's sequence header OBU (colour, alpha and grid tiles) names the
    profile and bit depth, av1C's profile and depth bits and the pixi
    channel depths of every av01 and grid item follow, and iloc's extents
    and mdat's size follow the OBUs' new lengths. The tile data is the
    8-bit stream's, which a decoder reads at the new depth (the tile
    syntax depends on the depth only through palette colours). For the
    damaged kinds: `stream` or `boxes` False leaves the OBUs or the boxes
    at 8 bits, and the items in `skip` stay 8-bit files."""
    from cybervision_tpu_torch.imageio import avif

    top = list(avif._boxes(data, 0, len(data)))
    meta = next((s, e) for t, s, e in top if t == b"meta")
    assert not any(t == b"moov" for t, _, _ in top), "a sequence"
    items, _, _ = avif._parse_meta(data, *meta)
    edits = []  # (offset, old length, new bytes)
    for item in items.values():
        if item.type not in (b"av01", b"grid") or item.id in skip:
            continue
        for typ, s, e in item.props if boxes else ():
            if typ == b"pixi":
                edits.append((s + 5, data[s + 4], bytes([depth] * data[s + 4])))
        if item.type == b"grid":
            continue
        assert item.construction == 0 and len(item.extents) == 1
        off, n = item.extents[0]
        new, seq = _high_depth_sample(data[off:off + n], depth)
        if stream:
            edits.append((off, n, new))
        for typ, s, e in item.props if boxes else ():
            if typ == b"av1C":
                profile = seq.profile_for(depth)
                byte2 = (data[s + 2] & 0x80) | 0x40 | (0x20 if depth == 12 else 0)
                byte2 |= seq.mono << 4 | seq.sub[0] << 3 | seq.sub[1] << 2 | (data[s + 2] & 3)
                edits.append((s + 1, 2, bytes([profile << 5 | (data[s + 1] & 31), byte2])))
    return _with_edits(data, edits)


def _with_edits(data: bytes, edits: list) -> bytes:
    """A still AVIF file with its bytes edited ((offset, old length, new
    bytes), any order): iloc's extents (version 0 or 1, no base offset)
    and mdat's size follow the edits' lengths."""
    from cybervision_tpu_torch.imageio import avif

    top = list(avif._boxes(data, 0, len(data)))
    meta = next((s, e) for t, s, e in top if t == b"meta")
    edits = sorted(set(edits))

    def moved(at: int) -> int:
        return at + sum(len(new) - n for o, n, new in edits if o + n <= at)

    out = bytearray()
    last = 0
    for o, n, new in edits:
        out += data[last:o] + new
        last = o + n
    out += data[last:]
    # iloc (version 0 or 1, no base offset): each extent's new place and size.
    iloc = next(s for t, s, e in avif._boxes(data, meta[0] + 4, meta[1]) if t == b"iloc")
    version, sizes = data[iloc], data[iloc + 4:iloc + 6]
    assert version in (0, 1) and sizes[0] == 0x44 and sizes[1] >> 4 == 0
    p = iloc + 6
    count, p = struct.unpack_from(">H", data, p)[0], p + 2
    for _ in range(count):
        p += 2 + (2 if version else 0) + 2
        n_ext, p = struct.unpack_from(">H", data, p)[0], p + 2
        for _ in range(n_ext):
            off, n = struct.unpack_from(">II", data, p)
            grow = sum(len(new) - m for o, m, new in edits if off <= o < off + n)
            struct.pack_into(">II", out, moved(p), moved(off), n + grow)
            p += 8
    for t, s, e in top:
        if t == b"mdat":
            hdr = s - 8
            struct.pack_into(">I", out, moved(hdr), moved(e) - moved(hdr))
    return bytes(out)


def frame_headers(data: bytes) -> tuple:
    """(_SeqBits, _FrameBits) of a still AVIF file's colour item (an
    av01 item, or a grid's first tile)."""
    from cybervision_tpu_torch.imageio import avif

    f = avif.parse(data)
    extents = f.color.tiles[0][0] if isinstance(f.color, avif.Grid) else f.color
    seq = frame = None
    for hdr, payload in _obus(b"".join(data[o:o + n] for o, n in extents)):
        kind = (hdr[0] >> 3) & 15
        if kind == 1:
            seq = _SeqBits(payload)
        elif kind in (3, 6):
            frame = _FrameBits(payload, seq)
    return seq, frame


def superres(data: bytes, denom: int, width: int) -> bytes:
    """A still AVIF file whose av01 items (colour, alpha, grid tiles) are
    coded at the width that `width` and `denom` give with superres (as
    dav1d computes it) rewritten as superres items of `width` columns:
    each item's stream (superres_stream) and ispe, and a grid's ImageGrid
    output width and ispe (its columns times `width`)."""
    from cybervision_tpu_torch.imageio import avif

    meta = next((s, e) for t, s, e in avif._boxes(data, 0, len(data)) if t == b"meta")
    items, _, idat = avif._parse_meta(data, *meta)
    edits = []
    for item in items.values():
        if item.type == b"av01":
            off, n = item.extents[0]
            edits.append((off, n, superres_stream(data[off:off + n], denom, width)))
            new_width = width
        elif item.type == b"grid":
            (off, n), = avif._extents(data, item, idat)
            cols = data[off + 3] + 1
            new_width = cols * width
            wide = data[off + 1] & 1
            edits.append((off + 4, 4 if wide else 2,
                          struct.pack(">I" if wide else ">H", new_width)))
        else:
            continue
        for typ, s, e in item.props:
            if typ == b"ispe":
                edits.append((s + 4, 4, struct.pack(">I", new_width)))
    return _with_edits(data, edits)


def with_ispe(data: bytes, size: tuple, which=lambda item: True) -> bytes:
    """The file with the ispe of every av01 or grid item `which` takes
    (all by default) set to `size` (width, height)."""
    from cybervision_tpu_torch.imageio import avif

    meta = next((s, e) for t, s, e in avif._boxes(data, 0, len(data)) if t == b"meta")
    items, _, _ = avif._parse_meta(data, *meta)
    edits = {(s + 4, 8, struct.pack(">II", *size)) for item in items.values()
             if item.type in (b"av01", b"grid") and which(item)
             for typ, s, e in item.props if typ == b"ispe"}
    return _with_edits(data, list(edits))


def _superres_coded(width: int, denom: int) -> int:
    """The width a frame of `width` columns is coded at with superres
    denominator `denom` (dav1d's)."""
    return max((width * 8 + denom // 2) // denom, min(16, width))


def avif_scale_fixtures() -> dict:
    """Write phase 8 (y)'s AVIF files (chip_smoke.AVIF_SUPERRES_SEM,
    AVIF_SCALE_DECODE_ONLY, AVIF_SCALE_FAIL): superres files, the wheel's
    aom streams coded at the downscaled width and rewritten (superres);
    files whose ispe is not their frame's size (with_ispe); {file name:
    Pillow's plane hashes, or the step Pillow fails at}."""
    enc = Libavif()
    files = {}
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    coded = chip_smoke.AVIF_SUPERRES_CODED
    assert _superres_coded(chip_smoke.SIZE, 9) == coded
    for img, path in zip((img1, img2), chip_smoke.AVIF_SUPERRES_SEM):
        narrow = np.asarray(Image.fromarray(img).resize((coded, chip_smoke.SIZE), Image.BOX))
        data = enc.encode([enc.image([narrow], "400", True, (1, 13, 6))], quality=50)
        files[os.path.basename(path)] = superres(data, 9, chip_smoke.SIZE)

    def coded_file(fmt, denom, w, h, seed, alpha=False, options=(), quality=60):
        cw = _superres_coded(w, denom)
        planes = yuv_field(h, cw, seed, fmt)
        a = np.add.outer(np.arange(h) * 3, np.arange(cw) * 2).astype(np.uint8) if alpha else None
        return enc.encode([enc.image(planes, fmt, True, (1, 13, 6), alpha=a)], quality=quality,
                          options=options)

    for name, (fmt, denom, w, h, depth) in {
            "superres_d9_420.avif": ("420", 9, 97, 80, 8),
            "superres_d12_444.avif": ("444", 12, 96, 64, 8),
            "superres_d16_400.avif": ("400", 16, 95, 48, 8),
            "superres_d13_420_10bit.avif": ("420", 13, 101, 72, 10),
            "superres_d11_444_12bit.avif": ("444", 11, 90, 66, 12)}.items():
        data = superres(coded_file(fmt, denom, w, h, denom), denom, w)
        files[name] = data if depth == 8 else high_depth(data, depth)
    files["superres_d10_rgba.avif"] = superres(coded_file("420", 10, 88, 56, 4, alpha=True),
                                               10, 88)
    # Loop restoration (Wiener on luma and chroma at aom's speed 0) and
    # CDEF on: one restoration unit a plane at either width, so that the
    # units' symbols are read where the superres frame reads them.
    rng = np.random.default_rng(3)
    cw = _superres_coded(160, 14)
    noisy = [np.clip(p.astype(int) + rng.integers(-30, 30, p.shape), 0, 255).astype(np.uint8)
             for p in yuv_field(80, cw, 6, "420")]
    lr = enc.encode([enc.image(noisy, "420", True, (1, 13, 6))], quality=30, speed=0,
                    options=[("enable-restoration", "1"), ("enable-cdef", "1")])
    seq, frame = frame_headers(lr)
    assert seq.cdef and frame.lr[0] and frame.lr[1] and frame.lr_size >= 160, frame.lr
    files["superres_lr_420.avif"] = superres(lr, 14, 160)
    # A 2x2 grid of 96x64 tiles (coded at 64 columns), with an alpha grid.
    field = yuv_field(128, 128, 8, "420")
    alpha = np.add.outer(np.arange(128), np.arange(128) * 2).astype(np.uint8)
    tiles = [enc.image([p[r * 64 // s:(r + 1) * 64 // s, c * 64 // s:(c + 1) * 64 // s]
                        for p, s in zip(field, (1, 2, 2))], "420", True, (1, 13, 6),
                       alpha=alpha[r * 64:(r + 1) * 64, c * 64:(c + 1) * 64])
             for r in range(2) for c in range(2)]
    files["superres_grid_alpha.avif"] = superres(enc.encode(tiles, grid=(2, 2), quality=50),
                                                 12, 96)

    def kind(name):
        with open(os.path.join(chip_smoke.AVIF_DIR, name), "rb") as fh:
            return fh.read()

    mc1, mc1_444 = kind("mc1_420_full.avif"), kind("mc1_444_full.avif")  # 96x80
    files["scaled_up2_420.avif"] = with_ispe(mc1, (192, 160))
    files["scaled_down2_420.avif"] = with_ispe(mc1, (48, 40))
    files["scaled_up_420.avif"] = with_ispe(mc1, (112, 88))
    files["scaled_height_444.avif"] = with_ispe(mc1_444, (96, 53))
    files["scaled_box_444.avif"] = with_ispe(mc1_444, (30, 25))
    files["scaled_down34_12bit.avif"] = with_ispe(high_depth(mc1, 12), (72, 60))
    rgba = io.BytesIO()
    Image.fromarray(depth_views()[0][64:144, 96:200], "RGBA").save(rgba, "AVIF", quality=60)
    files["scaled_rgba_12bit.avif"] = with_ispe(high_depth(rgba.getvalue(), 12), (130, 97))
    files["scaled_grid_tiles.avif"] = with_ispe(kind("grid_2x3_alpha.avif"), (80, 80),
                                                lambda item: item.type == b"av01")
    # A frame wider than libyuv's limit (16384), its ispe narrower.
    wide = np.tile(np.arange(16400, dtype=np.uint16) % 251, (16, 1)).astype(np.uint8)
    files["scaled_wide_refused.avif"] = with_ispe(
        enc.encode([enc.image([wide], "400", True, (1, 13, 6))], quality=50, speed=9),
        (16384, 16))
    out = {}
    for name, data in files.items():
        path = os.path.join(chip_smoke.AVIF_DIR, name)
        with open(path, "wb") as fh:
            fh.write(data)
        if name in chip_smoke.AVIF_SCALE_FAIL:
            step = pillow_failure(path)
            assert step == chip_smoke.AVIF_SCALE_FAIL[name], (name, step)
            out[name] = {"fails": step}
        else:
            assert pillow_failure(path) is None, name
            out[name] = planes(path)
    print(chip_smoke.AVIF_DIR, sum(len(d) for d in files.values()), "bytes in", len(files),
          "files")
    return out


def avif_kind_fixtures() -> dict:
    """Write phase 8 (v3)'s AVIF files (chip_smoke.AVIF_GRID_SEM,
    AVIF_KINDS_DECODE_ONLY, AVIF_KINDS_FAIL) through the wheel's libavif
    encoder; {file name: Pillow's plane hashes, or the step Pillow fails
    at}. Decode-only files are 96x80 but the grids, whose tiles libavif
    wants 64 samples a side at least."""
    enc = Libavif()
    os.makedirs(chip_smoke.AVIF_DIR, exist_ok=True)
    files = {}
    wanted = chip_smoke.AVIF_KINDS_DECODE_ONLY + tuple(chip_smoke.AVIF_KINDS_FAIL)
    for mc in (*chip_smoke.AVIF_MATRIX_READ, 3, 10, 11, 13, 14, 16):
        for fmt in ("444", "420"):
            for rng in ("full", "limited"):
                name = f"mc{mc}_{fmt}_{rng}.avif"
                if name not in wanted:
                    continue
                primaries = 4 if mc == 12 else 1  # BT.470 M: libavif's own Kr/Kb
                files[name] = enc.encode([enc.image(yuv_field(80, 96, mc, fmt), fmt, rng == "full",
                                                    (primaries, 13, mc))], quality=50)
    files["mc12p1_420_full.avif"] = enc.encode(
        [enc.image(yuv_field(80, 96, 12, "420"), "420", True, (1, 13, 12))], quality=50)

    # A 2x3 grid of 64x64 tiles cut from one field, with an alpha grid.
    field, alpha = yuv_field(128, 192, 40, "420"), np.add.outer(
        np.arange(128), np.arange(192)).astype(np.uint8)

    def grid_file():
        tiles = []
        for r in range(2):
            for c in range(3):
                planes = [p[r * 64 // s:(r + 1) * 64 // s, c * 64 // s:(c + 1) * 64 // s]
                          for p, s in zip(field, (1, 2, 2))]
                tiles.append(enc.image(planes, "420", True, (1, 13, 1),
                                       alpha=alpha[r * 64:(r + 1) * 64, c * 64:(c + 1) * 64]))
        return enc.encode(tiles, grid=(2, 3), quality=50)

    grid = files["grid_2x3_alpha.avif"] = grid_file()
    at = _grid_layout(grid)
    # The colour and alpha grids share their ImageGrid payload and ispe.
    files["grid_2x3_alpha_cropped.avif"] = _edit(_edit(
        grid, at["payload"] + 4, struct.pack(">HH", 160, 100)), at["ispe"],
        struct.pack(">II", 160, 100))
    files["grid_not_covering.avif"] = _edit(_edit(
        grid, at["payload"] + 4, struct.pack(">HH", 200, 128)), at["ispe"],
        struct.pack(">II", 200, 128))
    files["grid_missing_tile.avif"] = _edit(grid, at["dimg"] + 2 * 2, struct.pack(">H", 0x7F))
    # The third tile takes the grid's ispe (192x128) as its own.
    files["grid_tile_size.avif"] = _edit(grid, at["ipma"][at["tiles"][2]], b"\x01")

    y420 = yuv_field(80, 96, 7, "420")
    y444 = yuv_field(80, 96, 8, "444")
    files["qm_420.avif"] = enc.encode([enc.image(y420, "420", True, (1, 13, 6))], quality=60,
                                      options=[("enable-qm", "1"), ("enable-chroma-deltaq", "1")])
    for name, q in (("qm_iq_444_low.avif", 30), ("qm_iq_444_high.avif", 85)):
        files[name] = enc.encode([enc.image(y444, "444", True, (1, 13, 6))], quality=q,
                                 options=[("enable-qm", "1"), ("enable-chroma-deltaq", "1"),
                                          ("tune", "iq")])
    for vec in (1, 2, 10, 16):
        files[f"grain_v{vec}.avif"] = enc.encode(
            [enc.image(yuv_field(80, 96, vec, "420"), "420", True, (1, 13, 1))], quality=60,
            options=[("film-grain-test", str(vec))])
    files["grain_400.avif"] = enc.encode(
        [enc.image(yuv_field(80, 96, 3, "400"), "400", False, (1, 13, 6))], quality=60,
        options=[("film-grain-test", "1")])

    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    half = chip_smoke.SIZE // 2
    for img, path in zip((img1, img2), chip_smoke.AVIF_GRID_SEM):
        tiles = []
        for r in range(2):
            for c in range(2):
                y = img[r * half:(r + 1) * half, c * half:(c + 1) * half]
                chroma = np.full((half // 2, half // 2), 128, np.uint8)
                tiles.append(enc.image([y, chroma, chroma], "420", True, (1, 13, 1)))
        files[os.path.basename(path)] = enc.encode(
            tiles, grid=(2, 2), quality=50,
            options=[("enable-qm", "1"), ("film-grain-test", "1")])
    out = {}
    for name, data in files.items():
        path = os.path.join(chip_smoke.AVIF_DIR, name)
        with open(path, "wb") as fh:
            fh.write(data)
        if name in chip_smoke.AVIF_KINDS_FAIL:
            step = pillow_failure(path)
            assert step == chip_smoke.AVIF_KINDS_FAIL[name], (name, step)
            out[name] = {"fails": step}
        else:
            out[name] = planes(path)
    print(chip_smoke.AVIF_DIR, sum(len(d) for d in files.values()), "bytes in", len(files),
          "new files")
    return out


def depth_views() -> list:
    """BASELINE #3's two views (tinted) as RGBA with a smooth alpha of
    200-255, for phase 8 (x)'s premultiplied files."""
    views, _, _, _ = chip_smoke.render_perspective(
        chip_smoke.PERSP_W, chip_smoke.PERSP_H, chip_smoke.PERSP_CAMS[:1], exact_focal=True)
    y, x = np.mgrid[0:chip_smoke.PERSP_H, 0:chip_smoke.PERSP_W]
    alpha = np.round(227.5 + 27.5 * np.cos(x / 37.0) * np.sin(y / 23.0)).astype(np.uint8)
    return [np.dstack([tinted(v), alpha]) for v in views]


def avif_depth_fixtures() -> dict:
    """Write phase 8 (x)'s AVIF files (chip_smoke.AVIF_DEPTH_*): the
    committed 4:0:0 SEM pair (AVIF_SEM) rewritten to 10 bits, and
    BASELINE #3's views saved by Pillow as premultiplied RGBA 4:2:0 with
    EXIF focal 43, rewritten to 12 bits; {file name: Pillow's plane
    hashes}. Pillow must read each."""
    for src, path in zip(chip_smoke.AVIF_SEM, chip_smoke.AVIF_DEPTH_SEM):
        with open(src, "rb") as fh:
            data = high_depth(fh.read(), 10)
        with open(path, "wb") as fh:
            fh.write(data)
    for rgba, path in zip(depth_views(), chip_smoke.AVIF_DEPTH_PERSP):
        buf = io.BytesIO()
        Image.fromarray(rgba, "RGBA").save(buf, "AVIF", alpha_premultiplied=True,
                                           exif=focal_exif())
        with open(path, "wb") as fh:
            fh.write(high_depth(buf.getvalue(), 12))
    paths = chip_smoke.AVIF_DEPTH_SEM + chip_smoke.AVIF_DEPTH_PERSP
    for path in paths:
        assert pillow_failure(path) is None, path
    print(chip_smoke.AVIF_DIR, sum(os.path.getsize(p) for p in paths), "bytes in", len(paths),
          "files")
    return {os.path.basename(p): planes(p) for p in paths}


def pillow_failure(path: str) -> str | None:
    """The step at which Pillow fails on the file: "open" or "load"."""
    try:
        im = Image.open(path)
    except Exception:  # noqa: BLE001 - Pillow's refusal is the result
        return "open"
    try:
        im.load()
    except Exception:  # noqa: BLE001
        return "load"
    return None


def depth_writer_hashes() -> dict:
    """The SHA-256 of Pillow's bytes of chip_smoke.depth_writer_rgba() for
    each of chip_smoke.DEPTH_WRITER_EXTS, and of their deflate-free forms
    (chip_smoke.deflate_free), with the zlib and C library they were made
    with (phase 8 (s))."""
    rgba = chip_smoke.depth_writer_rgba()
    files = {}
    for ext in chip_smoke.DEPTH_WRITER_EXTS:
        buf = io.BytesIO()
        Image.fromarray(rgba, "RGBA").save(buf, Image.registered_extensions()[ext])
        data = buf.getvalue()
        files[ext] = {"bytes": sha256(data),
                      "deflate free": sha256(chip_smoke.deflate_free(ext, data))}
    return {"zlib": zlib.ZLIB_RUNTIME_VERSION, "libc": os.confstr("CS_GNU_LIBC_VERSION"),
            "files": files}


def jpeg2000_writer_hashes() -> dict:
    """The SHA-256 of Pillow's bytes of chip_smoke.depth_writer_rgba() for
    each of chip_smoke.J2K_WRITER_EXTS, written as "seeded<ext>" (the
    PDF's title) with time.gmtime() at chip_smoke.PDF_CLOCK (phase 8 (t))."""
    rgba = chip_smoke.depth_writer_rgba()
    files = {}
    with tempfile.TemporaryDirectory() as td, chip_smoke.fixed_clock():
        for ext in chip_smoke.J2K_WRITER_EXTS:
            path = os.path.join(td, f"seeded{ext}")
            Image.fromarray(rgba, "RGBA").save(path)
            with open(path, "rb") as fh:
                files[ext] = sha256(fh.read())
    return files


def webp_writer_hashes() -> dict:
    """The SHA-256 of Pillow's .webp bytes of each of
    chip_smoke.webp_writer_maps() (phase 8 (u))."""
    files = {}
    for name, rgba in chip_smoke.webp_writer_maps().items():
        buf = io.BytesIO()
        Image.fromarray(rgba, "RGBA").save(buf, "WEBP")
        files[name] = sha256(buf.getvalue())
    return files


def avif_writer_fixture() -> dict:
    """For each of chip_smoke.avif_writer_maps() (phase 8 (w)): the
    SHA-256 of the port's .avif bytes (encode_avif; aom's are not one
    file), and Pillow's bytes and, where the map has opaque pixels, the
    PSNR of Pillow's file there (read back by Pillow), against which (w)
    holds the port's file on the card."""
    from cybervision_tpu_torch.imageio.avif_encode import encode_avif

    out = {}
    for name, rgba in chip_smoke.avif_writer_maps().items():
        buf = io.BytesIO()
        Image.fromarray(rgba, "RGBA").save(buf, "AVIF", max_threads=8)
        row = {"sha256": sha256(encode_avif(rgba)), "pillow_bytes": len(buf.getvalue())}
        if (rgba[:, :, 3] == 255).any():
            back = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGBA"))
            row["pillow_psnr"] = chip_smoke.psnr_opaque(rgba, back)
        out[name] = row
    return out


def lzma_damaged_strip() -> tuple[np.ndarray, bytes]:
    """(pixels, strip) of the damaged LZMA fixture: the 64x256 gradient of
    tests/test_torch_icons_codecs.py::test_seeded_lzma_damage_reads_where_pillow_reads
    and its strip number 350 (no check), one of those Pillow reads."""
    import lzma
    import random

    px = (np.cumsum(np.random.RandomState(1).randint(-3, 4, (64, 256)), axis=1) % 256
          ).astype(np.uint8)
    checks = [lzma.CHECK_NONE, lzma.CHECK_CRC32, lzma.CHECK_CRC64]
    rnd = random.Random(7)
    for it in range(351):
        strip = bytearray(lzma.compress(px.tobytes(), format=lzma.FORMAT_XZ, check=checks[it % 3]))
        for _ in range(rnd.randint(1, 3)):
            strip[rnd.randrange(12, len(strip) - 12)] ^= 1 << rnd.randrange(8)
    return px, bytes(strip)


def lzma_fixture() -> dict:
    """Write the damaged LZMA TIFF (module docstring); Pillow's plane hashes."""
    from tests.test_torch_images import _tiff_file

    px, strip = lzma_damaged_strip()
    _tiff_file(chip_smoke.LZMA_DAMAGED_TIFF, px, rows_per_strip=64, compression=34925,
               codec=lambda raw: strip)
    print(chip_smoke.LZMA_DAMAGED_TIFF, os.path.getsize(chip_smoke.LZMA_DAMAGED_TIFF), "bytes")
    return planes(chip_smoke.LZMA_DAMAGED_TIFF)


def main():
    if sys.argv[1:] == ["avif-writer"]:
        with open(chip_smoke.FORMATS_SHA256) as fh:
            hashes = json.load(fh)
        hashes["avif writer"] = avif_writer_fixture()
        with open(chip_smoke.FORMATS_SHA256, "w") as fh:
            json.dump(hashes, fh, indent=1, sort_keys=True)
            fh.write("\n")
        return
    if sys.argv[1:] == ["avif-scale"]:
        with open(chip_smoke.FORMATS_SHA256) as fh:
            hashes = json.load(fh)
        hashes["avif scale"] = avif_scale_fixtures()
        with open(chip_smoke.FORMATS_SHA256, "w") as fh:
            json.dump(hashes, fh, indent=1, sort_keys=True)
            fh.write("\n")
        return
    if sys.argv[1:] == ["avif-depth"]:
        with open(chip_smoke.FORMATS_SHA256) as fh:
            hashes = json.load(fh)
        hashes["avif depth"] = avif_depth_fixtures()
        with open(chip_smoke.FORMATS_SHA256, "w") as fh:
            json.dump(hashes, fh, indent=1, sort_keys=True)
            fh.write("\n")
        return
    if sys.argv[1:] in (["avif"], ["avif-kinds"]):
        # Only the AVIF files and their hashes (or only those the wheel's
        # libavif encoder writes); the other entries stay.
        with open(chip_smoke.FORMATS_SHA256) as fh:
            hashes = json.load(fh)
        if sys.argv[1] == "avif":
            hashes["avif"] = avif_fixtures()
        hashes["avif kinds"] = avif_kind_fixtures()
        with open(chip_smoke.FORMATS_SHA256, "w") as fh:
            json.dump(hashes, fh, indent=1, sort_keys=True)
            fh.write("\n")
        return
    w, h = round(chip_smoke.PERSP_W * chip_smoke.FULL_SCALE), round(chip_smoke.PERSP_H * chip_smoke.FULL_SCALE)
    views, _, _, _ = chip_smoke.render_perspective(w, h, chip_smoke.PERSP_CAMS[:1], exact_focal=True)
    decoder = {}
    for view, prog, twin in zip(views, chip_smoke.PERSP_FULL_JPEGS, chip_smoke.PERSP_FULL_TWINS):
        for path, progressive in ((prog, True), (twin, False)):
            Image.fromarray(tinted(view)).save(path, quality=75, subsampling=2,
                                               progressive=progressive, exif=focal_exif())
            print(path, os.path.getsize(path), "bytes")
        decoder[os.path.basename(prog)] = planes(prog)
    webp_fixtures(views)
    zstd_fixtures()
    codecs, icons = codec_icon_planes()
    encoder = {name: sha256(pillow_jpeg(px)) for name, px in chip_smoke.encoder_cases()}
    with open(chip_smoke.FORMATS_SHA256, "w") as fh:
        json.dump({"decoder": decoder, "encoder": encoder, "phase8": phase8_planes(),
                   "gif_webp": gif_webp_planes(), "raster": raster_planes(), "codecs": codecs,
                   "icons": icons, "legacy": legacy_planes(), "lzma damaged": lzma_fixture(),
                   "jpeg codings": jpeg_coding_planes(), "pillow rest": pillow_rest_planes(),
                   "block textures": block_texture_planes(), "fli pcd": fli_pcd_planes(),
                   "jpeg2000": jpeg2000_fixtures(), "depth writers": depth_writer_hashes(),
                   "jpeg2000 writer": jpeg2000_writer_hashes(),
                   "webp writer": webp_writer_hashes(), "avif": avif_fixtures(),
                   "avif writer": avif_writer_fixture(),
                   "avif kinds": avif_kind_fixtures(), "avif depth": avif_depth_fixtures(),
                   "avif scale": avif_scale_fixtures()},
                  fh, indent=1,
                  sort_keys=True)
        fh.write("\n")
    print(chip_smoke.FORMATS_SHA256, len(encoder), "encoder cases")


if __name__ == "__main__":
    main()
