"""Readers for the CLI's input files, without Pillow: PNG (Adam7 and
1-16 bits included, EXIF from eXIf or a "Raw profile type exif" text
chunk), TIFF (the FEI SEM format; strips or tiles, chunky or planar, 1 to
32-bit integer and float samples, gray, palette, RGB, LA, PA and CMYK,
LZW, Deflate, LZMA, zstd, CCITT, JPEG and old-style JPEG strips, classic
or BigTIFF),
JPEG (sequential or progressive; gray, YCbCr, RGB, CMYK or YCCK), BMP
and headerless DIB (palettes, 16 to 32 bits, bit fields, RLE), GIF (the
first frame), WebP (lossless, lossy with alpha, VP8X with EXIF, an
animation's first frame), Netpbm (PBM, PGM, PPM, PFM, plain or binary),
ICO and CUR (PNG or BMP entries), ICNS (PNG entries, 24-bit RLE icons
and their masks), SPIDER, TGA, SGI, PCX and DCX, QOI, Sun raster, IM,
MSP, XBM, XPM, PSD (the composite), FITS (raw or GZIP_1 tiles), GBR, IM
Tools, IPTC/NAA, McIdas, PIXAR, XV thumbnails, DDS (channel masks,
luminance, palette, BC1-BC7 blocks), BLP (JPEG, palette, DXT), FTEX
(DXT1 or raw), FLI/FLC (the first frame), Kodak Photo CD (the base
image), JPEG 2000 (JP2 files and codestreams) and AVIF (an item or a
sequence's first frame, 8-bit AV1 key frames), giving what the JAX
package reads through Pillow — the SEM metadata tag, the EXIF focal
length, and the planes of convert("L") and convert("RGB"), bit for bit.
A file goes to the reader of the plugin Pillow's Image.open would pick
(identify). The writers of the depth maps are jpeg_encode (JPEG) and
rgba_encode (TIFF, BMP, Netpbm, TGA, SGI, IM, QOI, DIB, DDS).

The containers are parsed here in Python; the pixel loops run in the
native library (native/imagedecode.cpp, native/webpdecode.cpp,
native/bcndecode.cpp, native/j2kdecode.cpp, native/av1*.cpp and
native/avifrgb.cpp), built at first use. PNG, uncompressed BMP, TGA and
SGI, Netpbm, SPIDER, raw Sun rasters, IM, MSP version 1, XBM, XPM, raw
PSD, FITS, GBR, IM Tools, McIdas, PIXAR, XV thumbnails, DDS of channel
masks, luminance or a palette, raw FTEX, BLP palettes, Photo CD and uncompressed,
PackBits, Deflate or LZMA TIFF have a numpy path for when it cannot be
built; JPEG, LZW, zstd, CCITT, JPEG-in-TIFF (both kinds), RLE BMP, TGA,
SGI, ICNS, Sun and MSP version 2, IM's bit-packed floats, PCX and DCX,
PackBits PSD, QOI, GIF, WebP, block-compressed DDS, FTEX DXT1, BLP's
JPEG and DXT textures, FLI/FLC, JPEG 2000 and AVIF then raise
NativeDecoderError.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio import (
    avif, blp, bmp, dds, exif, fits, fli, ftex, gbr, gif, icns, ico, im, imt, iptc, jpeg, jpeg2000,
    mcidas, msp,
    netpbm, pcd, pcx, pixar, png, psd, qoi, sgi, spider, sun, tga, tiff, webp, xbm, xpm, xvthumb,
)
from cybervision_tpu_torch.imageio.convert import to_l, to_rgb
from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NativeDecoderError,
    NotThisFormat,
    TruncatedImageError,
    UnsupportedImageError,
)

__all__ = [
    "CorruptImageError", "ImageFile", "NativeDecoderError", "TruncatedImageError",
    "UnsupportedImageError", "open_image", "to_l", "to_rgb",
]


def _native():
    """The native library's bindings, or None when it cannot be built."""
    from cybervision_tpu_torch import native

    try:
        native.load()
    except ImportError:
        return None
    return native


@dataclasses.dataclass
class ImageFile:
    """One parsed input file: its container read, its pixels not yet
    decoded."""

    format: str
    parsed: object
    # decode()'s result, kept: a PNG's EXIF may need its rows decoded first,
    # and Pillow reuses that decode for the conversions too.
    decoded: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def sem(self):
        """The FEI SEM metadata tag's value as Pillow's tag_v2 gives it
        (str, bytes, number or tuple), or None; only TIFF has one."""
        return self.parsed.sem if self.format == "TIFF" else None

    def focal_length_35mm(self) -> int | None:
        """The EXIF FocalLengthIn35mmFilm, through int(); raises where the
        JAX package's getexif() or int() would."""
        if self.format == "TIFF":
            return self.parsed.focal_length_35mm()
        if self.format not in ("PNG", "JPEG", "WebP", "AVIF"):
            return None
        if self.format == "PNG":
            # Pillow reads the chunks after the image data only by decoding
            # every row; a failed decode leaves them unread.
            block = png.exif_block(self.parsed, self.decode)
        else:
            block = self.parsed.exif
        return None if block is None else exif.exif_block_focal_length(block)

    def decode(self) -> tuple[str, np.ndarray, np.ndarray | None]:
        """(mode, pixels, palette); see the format modules."""
        if self.decoded is None:
            module = _DECODERS[self.format]
            self.decoded = module.decode(self.parsed, _native())
        return self.decoded


# -- Pillow's plugin order ----------------------------------------------------
#
# Image.open tries its plugins in Image.ID order (the order they registered:
# preinit's BMP, GIF, JPEG, PPM and PNG, then init's list, in a process like
# the JAX package's CLI, which imports no plugin module itself), each first
# through its accept test on the file's first 16 bytes, then through its
# open, where a SyntaxError (or an IndexError, KeyError, TypeError or
# struct.error) passes the file on to the next plugin. TGA and SPIDER have
# no accept test, so which plugin claims a file depends on the order;
# identify follows it. The formats the readers do not take are refused by
# name where their magic claims the file. Each reader's parse makes its
# plugin's open checks (NotThisFormat where the open passes the file on:
# IM, IM Tools, IPTC and PCD have no accept test, GBR a loose one); PCD's
# open checks (pcd.accept), and CUR's and ICO's loose tests, are made in
# the tests below, so that a TGA or SPIDER file reaches its reader only
# where Pillow's would.


def _u32(data: bytes, at: int) -> int | None:
    return struct.unpack_from("<I", data, at)[0] if len(data) >= at + 4 else None


def _u16(data: bytes, at: int) -> int | None:
    return struct.unpack_from("<H", data, at)[0] if len(data) >= at + 2 else None


def _entries(data: bytes) -> bool:
    """CUR and ICO: a directory of at least one 16-byte entry, all there."""
    n = _u16(data, 4)
    return bool(n) and len(data) >= 6 + 16 * n


def _avif(prefix: bytes) -> bool:
    return prefix[4:8] == b"ftyp" and prefix[8:12] in (b"avif", b"avis", b"mif1", b"msf1")


# (Pillow's format name, its test on the file, the reader's format or the
# refusal: a name the readers do not take yet, or, as a (name, why) pair,
# a format Pillow opens without reading its pixels).
_PLUGINS = (
    ("BMP", lambda d: d.startswith(b"BM"), "BMP"),
    ("DIB", lambda d: _u32(d, 0) in (12, 40, 52, 56, 64, 108, 124), "DIB"),
    ("GIF", lambda d: d[:6] in gif.SIGNATURES, "GIF"),
    ("JPEG", lambda d: d.startswith(b"\xff\xd8\xff"), "JPEG"),
    ("PPM", netpbm.accept, "PPM"),
    ("PNG", lambda d: d.startswith(png.SIGNATURE), "PNG"),
    ("AVIF", _avif, "AVIF"),
    ("BLP", lambda d: d.startswith((b"BLP1", b"BLP2")), "BLP"),
    ("BUFR", lambda d: d.startswith((b"BUFR", b"ZCZC")),
     ("BUFR", "Pillow names it but reads no pixels")),
    ("CUR", lambda d: d.startswith(b"\0\0\2\0") and _entries(d), "CUR"),
    ("PCX", pcx.accept, "PCX"),
    ("DCX", lambda d: _u32(d, 0) == pcx.DCX_MAGIC, "DCX"),
    ("DDS", lambda d: d.startswith(dds.MAGIC), "DDS"),
    ("EPS", lambda d: d.startswith(b"%!PS") or _u32(d, 0) == 0xC6D3D0C5,
     "EPS (PostScript, which Pillow renders through Ghostscript)"),
    ("FITS", lambda d: d.startswith(b"SIMPLE"), "FITS"),
    ("FLI", fli.accept, "FLI"),
    ("FTEX", lambda d: d.startswith(ftex.MAGIC), "FTEX"),
    ("GBR", gbr.accept, "GBR"),
    ("GRIB", lambda d: len(d) >= 8 and d.startswith(b"GRIB") and d[7] == 1,
     ("GRIB", "Pillow names it but reads no pixels")),
    ("HDF5", lambda d: d.startswith(b"\x89HDF\r\n\x1a\n"),
     ("HDF5", "Pillow names it but reads no pixels")),
    ("JPEG2000", lambda d: d.startswith((jpeg2000.SOC_SIZ, jpeg2000.JP2_SIGNATURE)), "JPEG2000"),
    ("ICNS", lambda d: d.startswith(b"icns"), "ICNS"),
    ("ICO", lambda d: d.startswith(b"\0\0\1\0") and _entries(d), "ICO"),
    ("IM", lambda d: True, "IM"),
    ("IMT", lambda d: True, "IMT"),
    ("IPTC", lambda d: True, "IPTC"),
    ("MCIDAS", lambda d: d.startswith(mcidas.MAGIC), "MCIDAS"),
    ("MPEG", lambda d: d.startswith(b"\0\0\x01\xb3"),
     ("MPEG", "Pillow identifies the stream but reads no pixels")),
    ("TIFF", lambda d: d[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"), "TIFF"),
    ("MSP", msp.accept, "MSP"),
    ("PCD", pcd.accept, "PCD"),
    ("PIXAR", lambda d: d.startswith(pixar.MAGIC), "PIXAR"),
    ("PSD", lambda d: d.startswith(psd.MAGIC), "PSD"),
    ("QOI", lambda d: d.startswith(qoi.MAGIC), "QOI"),
    ("SGI", sgi.accept, "SGI"),
    ("SPIDER", lambda d: True, "SPIDER"),
    ("SUN", sun.accept, "SUN"),
    ("TGA", lambda d: True, "TGA"),
    ("WEBP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP" and d[12:16] in webp.FIRST_CHUNKS,
     "WebP"),
    ("WMF", lambda d: d.startswith((b"\xd7\xcd\xc6\x9a\0\0", b"\x01\0\0\0")),
     ("WMF/EMF", "Pillow draws it only through a handler registered on Windows")),
    ("XBM", xbm.accept, "XBM"),
    ("XPM", xpm.accept, "XPM"),
    ("XVTHUMB", lambda d: d.startswith(xvthumb.MAGIC), "XVThumb"),
)
_PARSERS = {"PNG": png.parse, "TIFF": tiff.parse, "BMP": bmp.parse, "DIB": bmp.parse_dib,
            "GIF": gif.parse, "WebP": webp.parse, "PPM": netpbm.parse, "CUR": ico.parse_cur,
            "PCX": pcx.parse, "ICNS": icns.parse, "ICO": ico.parse, "QOI": qoi.parse,
            "SGI": sgi.parse, "SPIDER": spider.parse, "TGA": tga.parse, "IM": im.parse,
            "MSP": msp.parse, "SUN": sun.parse, "XBM": xbm.parse, "XPM": xpm.parse,
            "DCX": pcx.parse_dcx, "FITS": fits.parse, "GBR": gbr.parse, "IMT": imt.parse,
            "IPTC": iptc.parse, "MCIDAS": mcidas.parse, "PIXAR": pixar.parse, "PSD": psd.parse,
            "XVThumb": xvthumb.parse, "BLP": blp.parse, "DDS": dds.parse, "FTEX": ftex.parse,
            "FLI": fli.parse, "PCD": pcd.parse, "JPEG2000": jpeg2000.parse,
            "AVIF": avif.parse}
_DECODERS = {"PNG": png, "TIFF": tiff, "JPEG": jpeg, "BMP": bmp, "DIB": bmp, "GIF": gif,
             "WebP": webp, "PPM": netpbm, "CUR": bmp, "PCX": pcx, "ICNS": icns, "ICO": ico,
             "QOI": qoi, "SGI": sgi, "SPIDER": spider, "TGA": tga, "IM": im, "MSP": msp,
             "SUN": sun, "XBM": xbm, "XPM": xpm, "DCX": pcx, "FITS": fits, "GBR": gbr,
             "IMT": imt, "IPTC": iptc, "MCIDAS": mcidas, "PIXAR": pixar, "PSD": psd,
             "XVThumb": xvthumb, "BLP": blp, "DDS": dds, "FTEX": ftex, "FLI": fli, "PCD": pcd,
             "JPEG2000": jpeg2000, "AVIF": avif}


def identify(data: bytes, metadata_only: bool = False) -> tuple[str, object]:
    """(format, parsed container) of the first plugin in Pillow's order
    that claims the file; the refusal of a format the readers do not take;
    or, when none claims it, the error Pillow's "cannot identify" stands
    for."""
    for _, test, target in _PLUGINS:
        if not test(data):
            continue
        if isinstance(target, tuple):
            raise UnsupportedImageError(f"{target[0]} is not supported: {target[1]}")
        if target not in _PARSERS and target != "JPEG":
            raise UnsupportedImageError(f"{target} is not supported yet")
        try:
            if target == "JPEG":
                return target, jpeg.parse(data, metadata_only=metadata_only)
            return target, _PARSERS[target](data)
        except NotThisFormat:
            continue
    raise UnsupportedImageError("this file format is not supported: neither the readers (PNG,"
                                " TIFF, JPEG, BMP and DIB, GIF, WebP, Netpbm, PCX and DCX, ICO"
                                " and CUR, ICNS, IM, IM Tools, IPTC/NAA, MSP, McIdas, PIXAR, PSD,"
                                " FITS, GBR, QOI, SGI, SPIDER, Sun raster, TGA, XBM, XPM, XV"
                                " thumbnail, DDS, BLP, FTEX, FLI/FLC, Photo CD, JPEG 2000, AVIF) nor"
                                " any other Pillow plugin take it")


def open_image(path: str, metadata_only: bool = False) -> ImageFile:
    """Read and parse `path`. With metadata_only a JPEG's markers are read
    up to its first scan, as Pillow does on open."""
    with open(path, "rb") as fh:
        data = fh.read()
    return ImageFile(*identify(data, metadata_only))
