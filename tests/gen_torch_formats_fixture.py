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
  "block textures");
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

The port must decode the files to those planes and encode the arrays to
those bytes (tests/test_torch_images.py, tests/test_torch_jpeg_encode.py,
tests/test_torch_gif_webp.py, tests/test_torch_raster_formats.py and
tests/test_torch_icons_codecs.py, tests/test_torch_legacy_rasters.py and
tests/test_torch_pillow_rest.py and tests/test_torch_block_textures.py
here; chip_smoke.py phase 8 (e), (f) and (h)-(p) on the card, with Pillow
blocked).
"""

import hashlib
import io
import json
import os
import tempfile

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
                   "block textures": block_texture_planes()},
                  fh, indent=1,
                  sort_keys=True)
        fh.write("\n")
    print(chip_smoke.FORMATS_SHA256, len(encoder), "encoder cases")


if __name__ == "__main__":
    main()
