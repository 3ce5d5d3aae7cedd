"""TIFF container: II/MM byte order, classic or BigTIFF (version 43,
8-byte offsets, 20-byte entries), IFD0, its strips or tiles and the tags
the decode needs; the raw values of the FEI SEM tags (34683, 34682) and
IFD0 as the file's EXIF directory, as Pillow's tag_v2 and getexif() give
them to the JAX package.

Strips and tiles may be uncompressed, PackBits (numpy without the native
library), LZW, Deflate, LZMA (an xz stream, through liblzma as libtiff calls it:
imageio/liblzma.py), zstd (native only), CCITT (modified Huffman, T.4 1D or
2D, T.6: native only), JPEG (compression 7: each strip or tile a JPEG
stream completed by the JPEGTables tag, decoded by the JPEG reader) or
old-style JPEG (compression 6, imageio/ojpeg.py, as libtiff decodes it);
LZW,
Deflate, LZMA and zstd with horizontal differencing (predictor 2) or the
floating-point predictor (3) per row of a strip or tile, as libtiff
applies them. Each codec decodes a strip until it is full, as libtiff's
does: data after that is not read. Fill
order 2 reverses the bits of every byte before the codec, as libtiff
does for every codec but JPEG. Samples are chunky (PlanarConfiguration
1) or one plane per sample (2), each plane its own strips or tiles. Edge
tiles are cropped. Modes, as Pillow opens them (TiffImagePlugin.OPEN_INFO):
"1" from 1-bit and "L" from 2, 4 and 8-bit min-is-black or min-is-white
(inverted) gray, "I;16" / "I;16B" from 16-bit gray (little / big endian,
never inverted) and from 12-bit little-endian gray, "I" from signed 16
and 32-bit and little-endian unsigned 32-bit gray, "F" from 32-bit
float, "L" from signed 8-bit (read unsigned), "RGB" (and "RGBX", and
YCbCr through JPEG), "RGBA", 16-bit RGB, RGBA and RGBX as their samples'
high bytes ("RGB;16L/B", "RGBA;16L/B", "RGBX;16L/B"), "P" at 1, 2,
4 and 8 bits with its colour map's high bytes (and "PX", its extra
sample dropped), "LA" (8-bit gray with unassociated alpha), "PA" (an
8-bit palette index with alpha), and "CMYK" from 8-bit CMYK, with one or
two unnamed extra samples dropped, and from 16-bit CMYK as its samples'
high bytes. Uncompressed YCbCr and CIELAB, which Pillow misreads or
cannot convert, are refused.

Where Pillow 12.1 misreads a valid file of these layouts (a big-endian
BigTIFF it cannot open, an uncompressed planar file with 16-bit or
min-is-white samples, a planar 16-bit RGBX file, big-endian float or
signed samples through a codec, which libtiff hands Pillow in the
host's byte order; uncompressed planar LA, PA and CMYK with extra
samples, which it cannot load, planar CMYK with extra samples through a
codec, and uncompressed planar 16-bit CMYK), the port reads it as the
TIFF specification says.
Where Pillow has no raw mode for a layout (uncompressed fill order 2 in
min-is-white 8-bit or a 1, 2 or 4-bit palette), the port refuses it
too.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from cybervision_tpu_torch.imageio import exif as ifd
from cybervision_tpu_torch.imageio import liblzma, ojpeg
from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    TruncatedImageError,
    UnsupportedImageError,
    native_missing,
)

# FEI SEM TIFF private tags (reconstruction.rs:20-21).
TIFFTAG_META_PHENOM = 34683
TIFFTAG_META_QUANTA = 34682

_WIDTH, _HEIGHT, _BPS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_FILL_ORDER, _STRIP_OFFSETS, _SPP, _ROWS_PER_STRIP, _STRIP_BYTES = 266, 273, 277, 278, 279
_PLANAR, _PREDICTOR, _COLORMAP, _EXTRA, _SAMPLE_FORMAT = 284, 317, 320, 338, 339
_TILE_WIDTH, _TILE_LENGTH, _TILE_OFFSETS, _TILE_BYTES = 322, 323, 324, 325

_T4_OPTIONS, _JPEG_TABLES = 292, 347

_RAW, _LZW, _DEFLATE, _ADOBE_DEFLATE, _PACKBITS = 1, 5, 8, 32946, 32773
_CCITT_RLE, _CCITT_T4, _CCITT_T6, _OLD_JPEG, _JPEG = 2, 3, 4, 6, 7
_LZMA, _ZSTD = 34925, 50000
_CCITT = (_CCITT_RLE, _CCITT_T4, _CCITT_T6)
# Each byte with its bits in reverse order (fill order 2).
_BIT_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


@dataclasses.dataclass
class TiffFile:
    data: bytes
    endian: str
    ifd0: int
    entries: dict
    big: bool = False

    def get(self, tag: int, default=None):
        value = ifd.tag_value(self.entries, tag, self.endian)
        return default if value is None else value

    def values(self, tag: int, default: tuple) -> tuple:
        value = self.get(tag)
        if value is None:
            return default
        return value if isinstance(value, tuple) else (value,)

    @property
    def sem(self):
        """The FEI metadata tag's value: 34683, or 34682 when the first is
        missing or empty (cybervision_tpu/images.py:80)."""
        return self.get(TIFFTAG_META_PHENOM) or self.get(TIFFTAG_META_QUANTA)

    def focal_length_35mm(self) -> int | None:
        return ifd.focal_length_35mm(self.data, self.endian, self.ifd0, self.big)


def parse(data: bytes) -> TiffFile:
    try:
        endian, ifd0, big = ifd.tiff_file_header(data)
    except ValueError as err:
        raise CorruptImageError(str(err)) from err
    entries = ifd.read_ifd(data, ifd0, endian, big)
    if not entries:
        raise CorruptImageError("TIFF without a readable first directory")
    return TiffFile(data, endian, ifd0, entries, big)


@dataclasses.dataclass
class _Layout:
    mode: str  # see decode(); "L;I" and "1;I" are inverted on the way out
    spp: int  # samples per pixel
    bits: int  # per sample
    dtype: np.dtype | None  # of a sample at 8 bits and up, in the file's byte order


def _mode(t: TiffFile, compression: int) -> _Layout:
    """The layout of IFD0's pixels, as Pillow opens them
    (TiffImagePlugin.OPEN_INFO, keyed by photometric interpretation,
    sample format, fill order, bits per sample and extra samples), or
    UnsupportedImageError."""
    photometric = t.get(_PHOTOMETRIC, 0)
    spp = t.get(_SPP, 1)
    bps = t.values(_BPS, (1,))
    if len(bps) != spp:
        bps = bps[:1] * spp
    formats = t.values(_SAMPLE_FORMAT, (1,))
    if len(formats) > 1 and set(formats) == {1}:
        formats = (1,)
    extra = t.values(_EXTRA, ())
    fill = t.get(_FILL_ORDER, 1)
    little = t.endian == "<"
    if fill not in (1, 2):
        raise UnsupportedImageError(f"TIFF fill order {fill} is not supported yet")
    gray = photometric in (0, 1) and spp == 1 and not extra
    layout = None
    byte = np.dtype(np.uint8) if bps[0] == 8 else None  # None: 1, 2 or 4 bits
    if gray and formats == (1,) and bps[0] in (1, 2, 4, 8):
        mode = "1" if bps[0] == 1 else "L"
        layout = _Layout(mode + (";I" if photometric == 0 else ""), 1, bps[0], byte)
    elif photometric == 3 and spp == 1 and formats == (1,) and bps[0] in (1, 2, 4, 8):
        layout = _Layout("P", 1, bps[0], byte)
    elif photometric == 2 and spp == 3 and formats == (1,) and bps == (8,) * 3:
        layout = _Layout("RGB", 3, 8, byte)
    if layout is not None:
        if fill == 2 and compression == _RAW and (
                layout.mode == "L;I" or (layout.mode == "P" and layout.bits < 8)):
            # Pillow has no "L;IR", "P;1R", "P;2R" or "P;4R" raw mode.
            raise UnsupportedImageError(f"uncompressed TIFF of fill order 2 in {layout.bits}-bit"
                                        f" {layout.mode[0]} is not supported")
        return layout
    # Fill order 2 (Pillow's ";R" raw modes) exists only for the layouts
    # above and 16-bit little-endian gray.
    if fill == 2 and not (gray and formats == (1,) and bps == (16,) and little and photometric == 1):
        raise UnsupportedImageError(f"TIFF fill order 2 with {bps} bits per sample and photometric"
                                    f" {photometric} is not supported (Pillow has no such mode)")
    if gray and formats == (1,) and bps == (16,):
        if photometric == 0 and not little:
            raise UnsupportedImageError("big-endian 16-bit min-is-white TIFF")
        return _Layout("I;16" if little else "I;16B", 1, 16, np.dtype(t.endian + "u2"))
    if gray and photometric == 1 and formats == (1,) and bps == (12,) and little:
        return _Layout("I;16", 1, 12, None)  # Pillow's "I;12"
    if gray and photometric == 1 and formats == (2,) and bps[0] in (8, 16, 32):
        # Signed samples: 8 bits read as unsigned "L", 16 and 32 as "I".
        b = bps[0]
        return _Layout("L" if b == 8 else "I", 1, b,
                       np.dtype(np.uint8) if b == 8 else np.dtype(f"{t.endian}i{b // 8}"))
    if gray and photometric == 1 and formats == (1,) and bps == (32,) and little:
        return _Layout("I", 1, 32, np.dtype("<u4"))  # Pillow's "I;32N"
    if gray and formats == (3,) and bps == (32,):
        return _Layout("F", 1, 32, np.dtype(t.endian + "f4"))
    if photometric == 6 and spp == 1 and formats == (1,) and bps == (8,):
        return _Layout("L", 1, 8, np.dtype(np.uint8))
    if photometric == 6 and spp == 3 and formats == (1,) and bps == (8,) * 3 and not extra:
        if compression != _JPEG:
            raise UnsupportedImageError(
                "YCbCr TIFF without JPEG compression is not supported: Pillow reads its three"
                " samples a pixel as four (raw mode RGBX), so it misreads or runs out of data")
        return _Layout("RGB", 3, 8, np.dtype(np.uint8))
    if photometric == 8:
        raise UnsupportedImageError("CIELAB TIFF is not supported: Pillow opens it as LAB, which"
                                    " it cannot convert to L or RGB")
    u8 = np.dtype(np.uint8)
    if photometric == 1 and formats == (1,) and bps == (8, 8) and extra == (2,):
        return _Layout("LA", 2, 8, u8)
    if photometric == 3 and formats == (1,) and bps == (8, 8) and extra in ((0,), (2,)):
        return _Layout("PA" if extra == (2,) else "PX", 2, 8, u8)
    if photometric == 5 and formats == (1,):
        if (bps, extra) in (((8,) * 4, ()), ((8,) * 5, (0,)), ((8,) * 6, (0, 0))):
            return _Layout("CMYK", spp, 8, u8)
        if bps == (16,) * 4 and not extra:
            return _Layout("CMYK", 4, 16, np.dtype(t.endian + "u2"))
    if photometric == 2 and formats == (1,) and bps in ((8,) * spp, (16,) * spp):
        nbytes = bps[0] // 8
        dtype = np.dtype(t.endian + "u2") if nbytes == 2 else np.dtype(np.uint8)
        if spp == 4 and extra == (0,):
            return _Layout("RGBX", 4, 8 * nbytes, dtype)
        # 8 bits: RGBA unless the alpha is associated ("RGBa"); 16 bits:
        # only the unassociated or unnamed alpha.
        if spp == 4 and extra != (1,) and (nbytes == 1 or extra in ((), (2,))):
            return _Layout("RGBA", 4, 8 * nbytes, dtype)
        if spp == 3 and nbytes == 2:
            return _Layout("RGB", 3, 16, dtype)
    raise UnsupportedImageError(
        f"TIFF photometric {photometric} with {bps} bits per sample and sample format {formats}"
        " is not supported yet")


def _strip(raw: bytes, size: int, compression: int, native, ccitt=None) -> bytes:
    """One strip's or tile's `size` decoded bytes; `ccitt` = (width, rows,
    mode) of a CCITT-coded one."""
    if compression == _RAW:
        out = raw[:size]
    elif compression in (_DEFLATE, _ADOBE_DEFLATE):
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as err:
            raise CorruptImageError(f"TIFF Deflate strip: {err}") from err
    elif compression == _PACKBITS:
        out = native.tiff_packbits(raw, size) if native is not None else _packbits_numpy(raw, size)
    elif compression == _LZW:
        if native is None:
            raise native_missing("LZW-compressed TIFF")
        out = native.tiff_lzw(raw, size)
    elif compression == _LZMA:
        out = liblzma.decode_strip(raw, size)
    elif compression == _ZSTD:
        if native is None:
            raise native_missing("zstd-compressed TIFF")
        out = native.tiff_zstd(raw, size)
    elif compression in _CCITT:
        if native is None:
            raise native_missing("CCITT-coded TIFF")
        out = native.tiff_ccitt(raw, *ccitt).tobytes()
    else:
        raise UnsupportedImageError(f"TIFF compression {compression} is not supported yet")
    if len(out) < size:
        raise TruncatedImageError("a TIFF strip ends before its rows")
    return out


def _packbits_numpy(src: bytes, size: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(src) and len(out) < size:
        c = src[i] - 256 if src[i] > 127 else src[i]
        i += 1
        if c >= 0:
            out += src[i : i + c + 1]
            i += c + 1
        elif c != -128 and i < len(src):
            out += bytes([src[i]]) * (1 - c)
            i += 1
    return bytes(out[:size])


def _float_predictor(chunk: np.ndarray, nbytes: int, stride: int) -> np.ndarray:
    """libtiff's floating-point predictor (3) undone on (rows, row bytes):
    each row's bytes summed with the byte `stride` before them, then its
    byte planes (most significant first) put back together. The result
    is big-endian whatever the file's byte order."""
    rows = chunk.shape[0]
    acc = chunk.reshape(rows, -1, stride).cumsum(axis=1, dtype=np.uint8).reshape(rows, -1)
    return np.ascontiguousarray(acc.reshape(rows, nbytes, -1).transpose(0, 2, 1)).reshape(rows, -1)


def _unpack_bits(chunk: np.ndarray, n: int, bits: int) -> np.ndarray:
    """(rows, row bytes) of `bits`-bit samples, MSB first and rows
    byte-aligned -> (rows, n) uint16."""
    b = np.unpackbits(chunk, axis=1)[:, : n * bits].reshape(len(chunk), n, bits)
    return (b.astype(np.uint16) << np.arange(bits - 1, -1, -1, dtype=np.uint16)).sum(
        axis=2, dtype=np.uint16)


def _jpeg_chunk(t: TiffFile, raw: bytes, photometric: int, spp: int, native) -> np.ndarray:
    """A JPEG-compressed strip or tile (compression 7): its own JPEG
    stream, the JPEGTables tag's tables (a stream of DQT and DHT segments
    between SOI and EOI) read first, as libtiff has libjpeg do. YCbCr
    (photometric 6) is converted to RGB as libtiff's JPEGCOLORMODE_RGB has
    libjpeg convert it (Pillow sets that mode); gray and RGB are kept as
    stored. (rows, columns, spp) uint8 of the JPEG's frame."""
    from cybervision_tpu_torch.imageio import jpeg

    tables = t.get(_JPEG_TABLES)
    if isinstance(tables, bytes) and tables.startswith(b"\xff\xd8") and raw.startswith(b"\xff\xd8"):
        end = tables.rfind(b"\xff\xd9")
        # The tables from their SOI up to their EOI, then the strip after
        # its SOI: one stream.
        raw = tables[: end if end > 0 else len(tables)] + raw[2:]
    parsed = jpeg.parse(raw)
    if len(parsed.components) != spp:
        raise CorruptImageError(f"a TIFF JPEG strip of {len(parsed.components)} components for {spp}")
    parsed.color = 1 if photometric == 6 else 0
    _, px, _ = jpeg.decode(parsed, native)
    return px.reshape(px.shape[0], px.shape[1], spp)


def decode(t: TiffFile, native) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(mode, pixels, palette) of IFD0's image: "1" (0 or 255), "L",
    "RGB", "RGBA" and "P" as (H, W[, C]) uint8, "I;16" (either byte order)
    as (H, W) uint16, "I" as (H, W) int32, "F" as (H, W) float32, the
    palette (256, 3) uint8. `native` is the native library's module, or
    None for the numpy path."""
    width, height = t.get(_WIDTH), t.get(_HEIGHT)
    if not isinstance(width, int) or not isinstance(height, int) or width < 1 or height < 1:
        raise CorruptImageError("TIFF without its size")
    compression = t.get(_COMPRESSION, _RAW)
    if compression == _OLD_JPEG:
        return ojpeg.decode(t, native)
    if compression not in (_RAW, _LZW, _DEFLATE, _ADOBE_DEFLATE, _PACKBITS, _JPEG, _LZMA,
                           _ZSTD) + _CCITT:
        raise UnsupportedImageError(f"TIFF compression {compression} is not supported yet")
    lay = _mode(t, compression)
    spp, bits = lay.spp, lay.bits
    photometric = t.get(_PHOTOMETRIC, 0)
    planar = t.get(_PLANAR, 1)
    if planar not in (1, 2):
        raise CorruptImageError(f"TIFF PlanarConfiguration {planar}")
    if compression in _CCITT and (bits != 1 or spp != 1):
        raise CorruptImageError("a CCITT-coded TIFF must have one 1-bit sample a pixel")
    if compression == _JPEG and bits != 8:
        raise UnsupportedImageError(f"JPEG-in-TIFF of {bits} bits per sample is not supported yet")
    predictor = t.get(_PREDICTOR, 1)
    if predictor not in (1, 2, 3):
        raise UnsupportedImageError(f"TIFF predictor {predictor} is not supported yet")
    # libtiff applies the predictor in its LZW, Deflate, LZMA and zstd
    # codecs only.
    if compression not in (_LZW, _DEFLATE, _ADOBE_DEFLATE, _LZMA, _ZSTD):
        predictor = 1
    if predictor == 3 and lay.mode != "F":
        raise UnsupportedImageError("TIFF floating-point predictor on integer samples")
    ccitt_mode = {_CCITT_RLE: 2, _CCITT_T6: 4}.get(
        compression, 5 if t.values(_T4_OPTIONS, (0,))[0] & 1 else 3)
    # libtiff reverses the bits of fill order 2 before any codec but JPEG;
    # Pillow's ";R" raw modes do the same to uncompressed data.
    reverse = t.get(_FILL_ORDER, 1) == 2 and compression != _JPEG
    tiled = _TILE_WIDTH in t.entries
    if tiled:
        tw, th = t.get(_TILE_WIDTH), t.get(_TILE_LENGTH)
        offsets, counts = t.values(_TILE_OFFSETS, ()), t.values(_TILE_BYTES, ())
        if not isinstance(tw, int) or not isinstance(th, int) or tw < 1 or th < 1:
            raise CorruptImageError("TIFF with bad tile dimensions")
    else:
        tw, th = width, min(t.get(_ROWS_PER_STRIP, height), height) or height
        offsets, counts = t.values(_STRIP_OFFSETS, ()), t.values(_STRIP_BYTES, ())
    if not offsets:
        raise CorruptImageError("TIFF without its strips or tiles")
    planes, chunk_spp = (spp, 1) if planar == 2 else (1, spp)
    row_bytes = (tw * chunk_spp * bits + 7) // 8
    if lay.dtype is not None:
        px = np.empty((height, width, spp), lay.dtype.newbyteorder("="))
    else:
        px = np.empty((height, width, spp), np.uint16 if bits > 8 else np.uint8)
    k = 0
    for plane in range(planes):
        for y0 in range(0, height, th):
            for x0 in range(0, width, tw):
                if k >= len(offsets):
                    raise CorruptImageError("TIFF with fewer strips or tiles than its image")
                # A tile holds th full rows of tw pixels; a strip its rows
                # up to the image's last.
                rows = th if tiled else min(th, height - y0)
                size = rows * row_bytes
                # Uncompressed data is read by its row count, as Pillow does;
                # the rest by its byte count.
                end = offsets[k] + (size if compression == _RAW or k >= len(counts) else counts[k])
                raw = t.data[offsets[k] : end]
                if reverse:
                    raw = _BIT_REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
                h_in, w_in = min(rows, height - y0), min(tw, width - x0)
                sel = slice(plane, plane + 1) if planar == 2 else slice(None)
                if compression == _JPEG:
                    if native is None:
                        raise native_missing("JPEG-in-TIFF")
                    chunk = _jpeg_chunk(t, raw, photometric, chunk_spp, native)
                    if chunk.shape[0] < h_in or chunk.shape[1] < w_in:
                        raise CorruptImageError("a TIFF JPEG strip smaller than its place")
                    px[y0 : y0 + h_in, x0 : x0 + w_in, sel] = chunk[:h_in, :w_in]
                    k += 1
                    continue
                if compression == _RAW and tiled:
                    # Pillow reads an uncompressed edge tile up to its last
                    # pixel in the image.
                    need = ((h_in - 1) * tw + w_in) * chunk_spp * bits // 8
                    if len(raw) >= need:
                        raw = raw.ljust(size, b"\0")
                data = _strip(raw, size, compression, native, (tw, rows, ccitt_mode))
                chunk = np.frombuffer(data, np.uint8, size).reshape(rows, row_bytes)
                if lay.dtype is None:  # 1, 2, 4 or 12 bits
                    chunk = _unpack_bits(chunk, tw * chunk_spp, bits).astype(px.dtype)
                else:
                    dtype = lay.dtype
                    if predictor == 3:
                        chunk = _float_predictor(chunk, dtype.itemsize, chunk_spp)
                        dtype = dtype.newbyteorder(">")
                    chunk = chunk.view(dtype)
                    if predictor == 2:
                        # Horizontal differencing on the samples' integer
                        # words, in the file's byte order.
                        words = np.dtype(f"{dtype.byteorder}u{dtype.itemsize}")
                        acc = np.cumsum(chunk.view(words).reshape(rows, tw, chunk_spp), axis=1,
                                        dtype=words.newbyteorder("="))
                        chunk = acc.astype(words).reshape(rows, -1).view(dtype)
                chunk = chunk.reshape(rows, tw, chunk_spp)
                px[y0 : y0 + h_in, x0 : x0 + w_in, sel] = chunk[:h_in, :w_in]
                k += 1
    return _finish(t, lay, px)


def _finish(t: TiffFile, lay: _Layout, px: np.ndarray):
    mode, palette = lay.mode, None
    if lay.bits == 16 and mode in ("RGB", "RGBA", "RGBX", "CMYK"):
        px = (px >> 8).astype(np.uint8)  # "RGB;16L/B", "CMYK;16L/B": each sample's high byte
    if mode in ("1", "1;I", "L;I", "L") and lay.bits < 8:
        top = (1 << lay.bits) - 1
        if mode.endswith(";I"):
            px = top - px
        px = (px * (255 // top)).astype(np.uint8)
        mode = mode[0]
    elif mode == "L;I":
        mode, px = "L", 255 - px
    elif mode == "RGBX":
        mode, px = "RGB", px[:, :, :3]
    elif mode == "CMYK":
        px = px[:, :, :4]  # "CMYKX", "CMYKXX": the extra samples dropped
    elif mode == "I":
        px = px.astype(np.int32)
    if mode in ("P", "PA", "PX"):
        cmap = np.asarray(t.values(_COLORMAP, ()), np.int64)
        n = 1 << lay.bits
        if cmap.size != 3 * n:
            raise CorruptImageError(f"TIFF palette without a {n}-entry colour map")
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = cmap.reshape(3, n).T // 256
        if mode == "PX":
            mode, px = "P", px[:, :, :1]
    if px.shape[2] == 1:
        px = px[:, :, 0]
    return mode, np.ascontiguousarray(px), palette
