"""Readers for the CLI's input files, without Pillow: PNG (Adam7 and
1-16 bits included), TIFF (the FEI SEM format; strips or tiles, chunky
or planar, 1 to 32-bit integer and float samples, CCITT and JPEG
strips, classic or BigTIFF), JPEG (sequential or progressive; gray,
YCbCr, RGB, CMYK or YCCK), BMP (palettes, 16 to 32 bits, bit fields,
RLE), GIF (the first frame) and WebP (lossless, lossy with alpha, VP8X
with EXIF, an animation's first frame), giving what the JAX package
reads through Pillow — the SEM metadata tag, the EXIF focal length, and
the planes of convert("L") and convert("RGB"), bit for bit. The writers
of the depth maps are jpeg_encode (JPEG) and rgba_encode (TIFF, BMP).

The containers are parsed here in Python; the pixel loops run in the
native library (native/imagedecode.cpp, native/webpdecode.cpp), built at
first use. PNG, uncompressed BMP and uncompressed, PackBits or Deflate
TIFF have a numpy path for when it cannot be built; JPEG, LZW, CCITT,
JPEG-in-TIFF, RLE BMP, GIF and WebP then raise NativeDecoderError.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cybervision_tpu_torch.imageio import bmp, exif, gif, jpeg, png, tiff, webp
from cybervision_tpu_torch.imageio.convert import to_l, to_rgb
from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NativeDecoderError,
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
        if self.format in ("BMP", "GIF"):
            return None
        if self.format == "PNG":
            block = self.parsed.exif
            if block is None and self.parsed.late_exif is not None:
                # Pillow reads an eXIf after the image data only by
                # decoding every row; a failed decode leaves it unread.
                png.decode(self.parsed, _native())
                block = self.parsed.late_exif
        else:
            block = self.parsed.exif
        return None if block is None else exif.exif_block_focal_length(block)

    def decode(self) -> tuple[str, np.ndarray, np.ndarray | None]:
        """(mode, pixels, palette); see the format modules."""
        module = {"PNG": png, "TIFF": tiff, "JPEG": jpeg, "BMP": bmp, "GIF": gif,
                  "WebP": webp}[self.format]
        return module.decode(self.parsed, _native())


def sniff(data: bytes) -> str:
    if data.startswith(png.SIGNATURE):
        return "PNG"
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return "TIFF"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if data.startswith(b"BM"):
        return "BMP"
    if data[:6] in gif.SIGNATURES:
        return "GIF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP" and data[12:16] in webp.FIRST_CHUNKS:
        return "WebP"
    raise UnsupportedImageError("this file format is not supported: the readers take PNG, TIFF,"
                                " JPEG, BMP, GIF and WebP")


def open_image(path: str, metadata_only: bool = False) -> ImageFile:
    """Read and parse `path`. With metadata_only a JPEG's markers are read
    up to its first scan, as Pillow does on open."""
    with open(path, "rb") as fh:
        data = fh.read()
    fmt = sniff(data)
    if fmt == "PNG":
        parsed = png.parse(data)
    elif fmt == "TIFF":
        parsed = tiff.parse(data)
    elif fmt == "BMP":
        parsed = bmp.parse(data)
    elif fmt == "GIF":
        parsed = gif.parse(data)
    elif fmt == "WebP":
        parsed = webp.parse(data)
    else:
        parsed = jpeg.parse(data, metadata_only=metadata_only)
    return ImageFile(fmt, parsed)
