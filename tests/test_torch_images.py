"""The port's image readers (cybervision_tpu_torch.imageio and images.py)
against the JAX package's, which read through Pillow: for every file, the
same metadata (read_metadata), the same gray plane and metadata
(SourceImage.load) and the same colour plane (load_rgb_plane against
SourceImage.load_rgb), exactly; where Pillow refuses the file, the port
refuses it too.

The files are written at test time from a numpy seed: by Pillow, or, for
what Pillow does not write (big-endian TIFF, 16-bit RGB PNG, every PNG
row filter, Adam7 and 1/2/4-bit PNG, an eXIf chunk after the image
data, tiled, planar, 16-bit RGB and BigTIFF files, YCCK JPEG, JPEG-in-TIFF
strips coded arithmetically or losslessly), by the small writers here and
chip_smoke.py's, with Pillow as the reader of record.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

import chip_smoke
from cybervision_tpu import images as jimages
from cybervision_tpu_torch import imageio, native
from cybervision_tpu_torch import images as timages
from cybervision_tpu_torch.imageio import UnsupportedImageError

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SEM_TEXT = (
    "[User]\r\nDate=01/02/2024\r\n[Scan]\r\nPixelWidth=9.7656e-08\r\n"
    "PixelHeight=9.7656e-08\r\n[Stage]\r\nStageT=0.1745329\r\n"
    "[PrivateFei]\r\nDatabarHeight={bar}\r\n"
)


def _texture(rng, h, w, c=None):
    """A smooth texture with noise, (h, w) or (h, w, c) uint8."""
    shape = (h, w) if c is None else (h, w, c)
    walk = np.cumsum(np.cumsum(rng.randint(-4, 5, shape), axis=0), axis=1) // 4
    return np.clip(walk + 128 + rng.randint(-20, 21, shape), 0, 255).astype(np.uint8)


def _exif_bytes(ifd0=None, sub=None) -> bytes:
    exif = Image.Exif()
    for tag, value in (ifd0 or {}).items():
        exif[tag] = value
    for tag, value in (sub or {}).items():
        exif.get_ifd(0x8769)[tag] = value
    return exif.tobytes()


# -- the test's own writers --------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(raw: np.ndarray, bpp: int, rng) -> bytes:
    """PNG-filter each row of (h, row_bytes) uint8 with a random type."""
    h, n = raw.shape
    out = bytearray()
    prev = np.zeros(n, np.int32)
    for y in range(h):
        cur = raw[y].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        ftype = int(rng.randint(5))
        if ftype == 0:
            res = cur
        elif ftype == 1:
            res = cur - left
        elif ftype == 2:
            res = cur - prev
        elif ftype == 3:
            res = cur - (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
            res = cur - pred
        out += bytes([ftype]) + (res & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _pack_rows(px: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, row_bytes) uint8: 16 bits big-endian,
    1, 2, 4 or 12 bits MSB first, each row from a byte boundary."""
    h = px.shape[0]
    if depth == 16:
        return np.ascontiguousarray(px.astype(">u2")).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return np.ascontiguousarray(px).reshape(h, -1).astype(np.uint8)
    bits = (px.astype(np.uint16).reshape(h, -1, 1) >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _png(path, px, depth, ctype, rng, exif=None, exif_after=False, interlace=0, plte=None,
         trns=None):
    """A PNG of (h, w[, c]) samples (uint8, or uint16 at 16 bits; 1, 2 or
    4 bits for gray and palette) with a random row filter per row; Adam7
    interlaced, each pass filtered on its own, when `interlace`."""
    h, w = px.shape[:2]
    px = px.reshape(h, w, -1)
    c = px.shape[2]
    stream = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        part = px[y0::dy, x0::dx]
        if part.size:
            stream += _filter_rows(_pack_rows(part, depth), max(1, c * depth // 8), rng)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        data += _chunk(b"PLTE", plte)
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    ex = _chunk(b"eXIf", exif) if exif is not None else b""
    data += (b"" if exif_after else ex)
    data += _chunk(b"IDAT", zlib.compress(stream))
    data += (ex if exif_after else b"") + _chunk(b"IEND", b"")
    with open(path, "wb") as fh:
        fh.write(data)


def _packbits(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run > 1:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < len(data) and j - i < 128 and (j + 1 >= len(data) or data[j + 1] != data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff(path, px, endian=">", photometric=1, packbits=False, rows_per_strip=7,
          extra_tags=(), tiles=False):
    """An 8-bit TIFF of px (h, w) or (h, w, 3) in strips, optionally
    PackBits-compressed; extra_tags: (tag, type, count, value bytes)."""
    h, w = px.shape[:2]
    spp = 1 if px.ndim == 2 else px.shape[2]
    strips = []
    for y in range(0, h, rows_per_strip):
        body = np.ascontiguousarray(px[y : y + rows_per_strip]).tobytes()
        strips.append(_packbits(body) if packbits else body)
    blob = b"".join(strips)
    offsets = np.cumsum([0] + [len(s) for s in strips[:-1]]) + 8
    n = len(strips)
    tags = [
        (256, 4, 1, struct.pack(endian + "L", w)),
        (257, 4, 1, struct.pack(endian + "L", h)),
        (258, 3, spp, struct.pack(endian + f"{spp}H", *[8] * spp)),
        (259, 3, 1, struct.pack(endian + "H", 32773 if packbits else 1)),
        (262, 3, 1, struct.pack(endian + "H", photometric)),
        (273, 4, n, struct.pack(endian + f"{n}L", *offsets)),
        (277, 3, 1, struct.pack(endian + "H", spp)),
        (278, 4, 1, struct.pack(endian + "L", rows_per_strip)),
        (279, 4, n, struct.pack(endian + f"{n}L", *[len(s) for s in strips])),
    ]
    if tiles:
        tags += [(322, 4, 1, struct.pack(endian + "L", 16)), (323, 4, 1, struct.pack(endian + "L", 16))]
    tags = sorted(tags + list(extra_tags))
    ifd_at = 8 + len(blob)
    ifd_at += ifd_at % 2
    values_at = ifd_at + 2 + 12 * len(tags) + 4
    entries, values = b"", b""
    for tag, typ, count, value in tags:
        if len(value) <= 4:
            entries += struct.pack(endian + "HHL", tag, typ, count) + value.ljust(4, b"\0")
        else:
            entries += struct.pack(endian + "HHLL", tag, typ, count, values_at + len(values))
            values += value + b"\0" * (len(value) % 2)
    head = (b"II*\0" if endian == "<" else b"MM\0*") + struct.pack(endian + "L", ifd_at)
    data = head + blob + b"\0" * (ifd_at - 8 - len(blob))
    data += struct.pack(endian + "H", len(tags)) + entries + b"\0\0\0\0" + values
    with open(path, "wb") as fh:
        fh.write(data)


def _lzw(raw: np.ndarray) -> bytes:
    """TIFF LZW bytes of (rows, row_bytes) uint8, written by Pillow's
    libtiff as the one strip of a gray image."""
    buf = io.BytesIO()
    Image.fromarray(raw).save(buf, "TIFF", compression="tiff_lzw", tiffinfo={278: raw.shape[0]})
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        (off,), (n,) = im.tag_v2[273], im.tag_v2[279]
    return buf.getvalue()[off : off + n]


def _ccitt(bits: np.ndarray, compression: int, t4_options: int) -> bytes:
    """CCITT bytes of (rows, w) 0/1 samples (1: a black run), written by
    Pillow's libtiff as the one strip of a bilevel image: modified Huffman
    (2), T.4 (3, 2D when t4_options & 1) or T.6 (4)."""
    buf = io.BytesIO()
    kind = {2: "tiff_ccitt", 3: "group3", 4: "group4"}[compression]
    Image.fromarray(bits.astype(bool)).save(
        buf, "TIFF", compression=kind, tiffinfo={278: bits.shape[0], 292: t4_options})
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        (off,), (n,) = im.tag_v2[273], im.tag_v2[279]
    return buf.getvalue()[off : off + n]


def _jpeg_stream(px: np.ndarray, tables: bool) -> tuple[bytes, bytes]:
    """(JPEGTables, stream) of Pillow's JPEG of (rows, w[, 3]) uint8 at
    quality 80 (4:2:0 for colour): with `tables`, the DQT and DHT
    segments go into the tables, between SOI and EOI, and the stream
    keeps the rest."""
    buf = io.BytesIO()
    Image.fromarray(px if px.shape[-1] == 3 else px.reshape(px.shape[:2])).save(
        buf, "JPEG", quality=80)
    return chip_smoke.split_jpeg_tables(buf.getvalue()) if tables else (b"", buf.getvalue())


def _arith_strip(part: np.ndarray) -> bytes:
    """An arithmetic-coded YCbCr 4:2:0 JPEG of RGB (rows, w, 3) samples, a
    strip of a JPEG TIFF (chip_smoke.arith_jpeg; libjpeg's quality-80
    tables)."""
    from cybervision_tpu_torch.imageio.jpeg_encode import quant_tables

    h, w = part.shape[:2]
    sampling = [(2, 2), (1, 1), (1, 1)]
    quant = quant_tables(80)
    return chip_smoke.arith_jpeg(chip_smoke.dct_coefficients(
        chip_smoke.ycbcr_planes(part, sampling), quant, sampling, w, h), quant, w, h, sampling)


def _lossless_strip(part: np.ndarray) -> bytes:
    """A lossless JPEG (predictor 6) of (rows, w, c) samples, a strip of a
    JPEG TIFF (chip_smoke.lossless_jpeg)."""
    return chip_smoke.lossless_jpeg([part[:, :, k] for k in range(part.shape[2])], 6)


def _tiff_file(path, px, endian="<", big=False, tile=None, planar=False, compression=1,
               predictor=1, photometric=None, extra=None, rows_per_strip=7, extra_tags=(),
               bits=None, fill_order=1, t4_options=0, jpeg_tables=True, codec=None,
               jpeg_coder=None):
    """A TIFF of px ((h, w) or (h, w, c): uint8, uint16, int16, int32,
    uint32, float32 or float64 samples; 1, 2, 4 or 12-bit ones as `bits`
    of a uint8 / uint16 array) in strips or `tile` = (width, length) tiles
    (edge tiles padded with zeros), chunky or one plane per sample, raw,
    PackBits (32773), LZW (5), Deflate (8), CCITT (2, 3 with
    `t4_options`, 4: through Pillow's libtiff) or JPEG (7: Pillow's JPEG of
    each strip or tile, its tables in JPEGTables unless not
    `jpeg_tables`), with horizontal differencing (predictor 2) or the
    floating-point predictor (3), fill order 2 (every strip's bytes
    bit-reversed), classic or BigTIFF; extra_tags: (tag, type, values or
    bytes); codec: the coder (raw bytes -> bytes) of any other
    compression; jpeg_coder: the JPEG coder (samples -> a whole JPEG
    stream, no JPEGTables) of each strip or tile in place of Pillow's."""
    h, w = px.shape[:2]
    spp = 1 if px.ndim == 2 else px.shape[2]
    px3 = px.reshape(h, w, spp)
    bits = bits or px.dtype.itemsize * 8
    fmt = {"u": 1, "i": 2, "f": 3}[px.dtype.kind]
    tw, th = tile if tile else (w, rows_per_strip)
    chunks, tables = [], b""
    for plane in ([px3[:, :, k : k + 1] for k in range(spp)] if planar else [px3]):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                part = plane[y0 : y0 + th, x0 : x0 + tw]
                if tile:
                    part = np.pad(part, ((0, th - part.shape[0]), (0, tw - part.shape[1]), (0, 0)))
                rows = len(part)
                if bits < 8 or bits == 12:
                    raw = _pack_rows(part, bits).tobytes()
                else:
                    vals = part.astype(endian + px.dtype.kind + str(bits // 8))
                    if predictor == 2:  # on the samples' integer words
                        words = vals.view(endian + "u" + str(bits // 8))
                        diff = words.astype(np.int64)
                        diff[:, 1:] -= words[:, :-1]
                        vals = (diff % (1 << bits)).astype(words.dtype)
                    raw = vals.tobytes()
                    if predictor == 3:
                        planes = np.ascontiguousarray(
                            part.astype(">" + px.dtype.kind + str(bits // 8)).view(np.uint8)
                            .reshape(rows, -1, bits // 8).transpose(0, 2, 1)).reshape(rows, -1)
                        diff = planes.astype(np.int64)
                        diff[:, spp if not planar else 1 :] -= planes[:, : -(spp if not planar else 1)]
                        raw = (diff % 256).astype(np.uint8).tobytes()
                if compression == 7 and jpeg_coder:
                    chunk = jpeg_coder(part)
                elif compression == 7:
                    tables, chunk = _jpeg_stream(part, jpeg_tables)
                elif compression in (2, 3, 4):
                    chunk = _ccitt(part.reshape(rows, -1), compression, t4_options)
                else:
                    chunk = {32773: _packbits, 8: zlib.compress,
                             5: lambda r: _lzw(np.frombuffer(r, np.uint8).reshape(rows, -1))
                             }.get(compression, codec or bytes)(raw)
                if fill_order == 2:
                    chunk = bytes(int(f"{b:08b}"[::-1], 2) for b in chunk)
                chunks.append(chunk)
    offset_type, slot, head = (16, 8, 16) if big else (4, 4, 8)
    offsets = [int(v) for v in np.cumsum([head] + [len(c) for c in chunks[:-1]])]
    counts = [len(c) for c in chunks]
    if fmt != 1:
        extra_tags = [*extra_tags, (339, 3, [fmt] * spp)]
    if fill_order != 1:
        extra_tags = [*extra_tags, (266, 3, [fill_order])]
    if t4_options:
        extra_tags = [*extra_tags, (292, 4, [t4_options])]
    if tables:
        extra_tags = [*extra_tags, (347, 7, tables)]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [compression]),
            (262, 3, [photometric if photometric is not None else (1 if spp == 1 else 2)]),
            (277, 3, [spp])]
    if tile:
        tags += [(322, 3, [tw]), (323, 3, [th]), (324, offset_type, offsets),
                 (325, offset_type, counts)]
    else:
        tags += [(273, offset_type, offsets), (278, 3, [rows_per_strip]), (279, offset_type, counts)]
    if planar:
        tags.append((284, 3, [2]))
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if extra is not None:
        tags.append((338, 3, list(extra)))
    tags = sorted(tags + list(extra_tags), key=lambda t: t[0])
    codes = {1: "B", 2: "B", 3: "H", 4: "L", 5: "L", 7: "B", 16: "Q"}
    blob = b"".join(chunks)
    ifd_at = head + len(blob) + (head + len(blob)) % 2
    values_at = ifd_at + (8 if big else 2) + (20 if big else 12) * len(tags) + slot
    entries, values = b"", b""
    for tag, typ, vals in tags:
        raw = vals if isinstance(vals, bytes) else struct.pack(
            endian + f"{len(vals)}{codes[typ]}", *vals)
        count = len(raw) // (8 if typ == 5 else struct.calcsize(endian + codes[typ]))
        entries += struct.pack(endian + ("HHQ" if big else "HHL"), tag, typ, count)
        if len(raw) <= slot:
            entries += raw.ljust(slot, b"\0")
        else:
            entries += struct.pack(endian + ("Q" if big else "L"), values_at + len(values))
            values += raw + b"\0" * (len(raw) % 2)
    magic = (b"II" if endian == "<" else b"MM") + struct.pack(endian + "H", 43 if big else 42)
    first = struct.pack(endian + "HHQ", 8, 0, ifd_at) if big else struct.pack(endian + "L", ifd_at)
    data = magic + first + blob + b"\0" * (ifd_at - head - len(blob))
    data += struct.pack(endian + ("Q" if big else "H"), len(tags)) + entries + b"\0" * slot + values
    with open(path, "wb") as fh:
        fh.write(data)


def _rle_rows(idx: np.ndarray, rle4: bool, rng, delta_at=None, odd_runs=False,
              cut_rows=True) -> bytes:
    """BMP RLE8 / RLE4 data of (h, w) indices in file row order: encoded
    runs of repeated values, absolute runs of the rest (even lengths in
    RLE4 unless `odd_runs`), an end of line after each row but the last,
    rows cut short by an early end of line at random when `cut_rows`
    (their tails read as
    index 0), the last row whole, then the end of bitmap; `delta_at` = (row, x, right) writes
    a delta escape there, right and 0 up, instead of the pixels it skips."""
    h, w = idx.shape
    out = bytearray()
    y = 0
    while y < h:
        row = [int(v) for v in idx[y]]
        x = 0
        # The last row runs to its end: Pillow refuses a bitmap whose end
        # comes before its last pixel. No row is empty: an end of line at
        # a row's start moves nowhere (Pillow pads to the row's end).
        end = w if not cut_rows or rng.rand() < 0.8 or y == h - 1 else int(rng.randint(1, w + 1))
        while x < end:
            if delta_at is not None and (y, x) == delta_at[:2]:
                out += bytes([0, 2, delta_at[2], 0])
                x += delta_at[2]
                continue
            # Runs stop at the delta's place.
            lim = delta_at[1] if delta_at is not None and y == delta_at[0] and x < delta_at[1] else end
            run = 1
            while x + run < lim and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or lim - x < 3:
                run = max(1, min(run, lim - x))
                out += bytes([run, row[x] * 17 if rle4 else row[x]])
                x += run
                continue
            n = 3
            while x + n < lim and n < 254 and (n + 1 >= lim - x or row[x + n] != row[x + n + 1]):
                n += 1
            if rle4 and n % 2 and not odd_runs:
                n += 1 if x + n < lim else -1
            if n < 3:  # 1 and 2 are escapes, not absolute runs
                out += bytes([1, row[x] * 17 if rle4 else row[x]])
                x += 1
                continue
            vals = row[x : x + n]
            if rle4:
                body = bytes((vals[k] << 4) | (vals[k + 1] if k + 1 < n else 0) for k in range(0, n, 2))
            else:
                body = bytes(vals)
            out += bytes([0, n]) + body + b"\0" * (len(body) % 2)
            x += n
        y += 1
        out += b"\0\0" if y < h else b"\0\1"
    return bytes(out)


def _bmp_file(path, px, bits, header=40, palette=None, compression=0, masks=None,
              top_down=False, colors=None, data=None, off_bits=None):
    """A BMP of px: (h, w) palette indices at 1, 4 or 8 bits with
    `palette` ((n, 3) RGB), or (h, w, 3|4) RGB(A) at 16 (5-5-5 unless
    `masks`), 24 or 32 bits (B, G, R, X unless `masks`); `data` replaces
    the pixel data (RLE); the 12-byte core header or a 40-124 byte one;
    rows bottom-up unless `top_down`."""
    h, w = px.shape[:2]
    if data is None:
        stride = ((w * bits + 31) >> 3) & ~3
        if bits <= 8:
            per = 8 // bits
            v = np.zeros((h, -(-w // per) * per), np.uint8)
            v[:, :w] = px
            v = v.reshape(h, -1, per)
            packed = np.zeros(v.shape[:2], np.uint8)
            for k in range(per):
                packed |= (v[:, :, k] << (8 - bits * (k + 1))).astype(np.uint8)
        elif bits == 16:
            r, g, b = (px[:, :, k].astype(np.uint32) for k in range(3))
            if masks == (0xF800, 0x7E0, 0x1F, 0):
                v = ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)
            else:
                v = ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3)
            packed = v.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            nb = bits // 8
            vals = np.zeros((h, w), np.uint64)
            chan = list(px.transpose(2, 0, 1).astype(np.uint64))
            if masks is None:
                masks = (0xFF0000, 0xFF00, 0xFF, 0)
            for c, m in zip(chan, masks):
                if m:
                    shift = (m & -m).bit_length() - 1
                    vals |= c << np.uint64(shift)
            packed = vals.astype("<u8").view(np.uint8).reshape(h, w, 8)[:, :, :nb].reshape(h, -1)
        rows = np.zeros((h, stride), np.uint8)
        rows[:, : packed.shape[1]] = packed
        data = (rows if top_down else rows[::-1]).tobytes()
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r]) + (b"" if header == 12 else b"\0") for r, g, b in palette)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression,
                           len(data), 2835, 2835, len(palette) if colors is None and palette is not None
                           else (colors or 0), 0)
        if header > 40:
            info += struct.pack("<4I", *(masks or (0, 0, 0, 0)))
        info = info.ljust(header, b"\0")
    extra = struct.pack("<3I", *masks[:3]) if header == 40 and compression == 3 else b""
    off = 14 + len(info) + len(extra) + len(pal) if off_bits is None else off_bits
    body = info + extra + pal
    head = b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off)
    with open(path, "wb") as fh:
        fh.write((head + body).ljust(off, b"\0") + data)


def _sem_tags(text: str, typ: int = 2, tag: int = 34683):
    """tiffinfo with an FEI metadata block as ASCII (2), BYTE (1) or
    UNDEFINED (7)."""
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[tag] = text if typ == 2 else text.encode()
    info.tagtype[tag] = typ
    return info


# -- the cases ----------------------------------------------------------------


def _case_png(mode, **save):
    def build(path, rng):
        rgb = _texture(rng, 37, 53, 3)
        if mode == "P":
            img = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE, colors=200)
        elif mode == "I;16":
            img = Image.fromarray(rgb[:, :, 0].astype(np.uint16) * 3)
        else:
            img = Image.fromarray(rgb).convert(mode)
        img.save(path, **save)
    return "png", build


def _case_tiff(mode, databar=0, sem=None, **save):
    def build(path, rng):
        h, w = 41 + databar, 47
        rgb = _texture(rng, h, w, 3)
        if mode == "P":
            img = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE)
        elif mode == "I;16":
            img = Image.fromarray(rgb[:, :, 0].astype(np.uint16) * 300)
        elif mode == "I;16B":
            img = Image.fromarray(rgb[:, :, 0].astype(np.uint16) * 3).convert("I;16B")
        else:
            img = Image.fromarray(rgb).convert(mode)
        if sem is not None:
            save["tiffinfo"] = sem(databar)
        img.save(path, **save)
    return "tif", build


def _case_jpeg(gray=False, exif=None, size=(45, 61), **save):
    def build(path, rng):
        px = _texture(rng, *size) if gray else _texture(rng, *size, 3)
        if exif is not None:
            save["exif"] = exif
        Image.fromarray(px).save(path, **save)
    return "jpg", build


def _own_png(kind):
    def build(path, rng):
        if kind == "rgb16":
            _png(path, _texture(rng, 23, 29, 3).astype(np.uint16) * 257 + rng.randint(0, 257, (23, 29, 3)),
                 16, 2, rng)
        elif kind == "la16":
            _png(path, _texture(rng, 23, 29, 2).astype(np.uint16) * 251, 16, 4, rng)
        elif kind == "rgba-filters":
            _png(path, _texture(rng, 31, 33, 4), 8, 6, rng)
        elif kind == "short-palette":
            pal = rng.randint(0, 256, 16 * 3).astype(np.uint8).tobytes()
            _png(path, rng.randint(0, 16, (19, 21)).astype(np.uint8), 8, 3, rng, plte=pal)
        elif kind == "exif-after-idat":
            _png(path, _texture(rng, 23, 29, 3), 8, 2, rng,
                 exif=_exif_bytes(sub={41989: 35})[6:], exif_after=True)
    return "png", build


def _own_tiff(kind):
    def build(path, rng):
        if kind == "mm-gray":
            _tiff(path, _texture(rng, 30, 26), ">")
        elif kind == "mm-rgb-packbits":
            _tiff(path, _texture(rng, 30, 26, 3), ">", photometric=2, packbits=True)
        elif kind == "ii-min-is-white-packbits":
            _tiff(path, _texture(rng, 30, 26), "<", photometric=0, packbits=True)
        elif kind == "mm-sem-databar":
            text = SEM_TEXT.format(bar=6).encode() + b"\0"
            _tiff(path, _texture(rng, 36, 26), ">", extra_tags=[(34683, 2, len(text), text)])
        elif kind == "sem-corrupt-exif":
            # 41989 as a RATIONAL with a zero denominator: int() refuses
            # it, and the databar crop must survive.
            text = SEM_TEXT.format(bar=6).encode() + b"\0"
            _tiff(path, _texture(rng, 36, 26), "<", extra_tags=[
                (34683, 2, len(text), text), (41989, 5, 1, struct.pack("<LL", 43, 0))])
        elif kind == "sem-exif-sub-ifd":
            # A SEM block and an Exif sub-IFD whose offset lies past the
            # file's end.
            text = SEM_TEXT.format(bar=4).encode() + b"\0"
            _tiff(path, _texture(rng, 36, 26), "<", extra_tags=[
                (34683, 2, len(text), text), (0x8769, 4, 1, struct.pack("<L", 10**6))])
        elif kind == "sem-as-shorts":
            # A malformed metadata block: numbers, not text.
            _tiff(path, _texture(rng, 30, 26), "<",
                  extra_tags=[(34683, 3, 3, struct.pack("<3H", 1, 2, 3))])
    return "tif", build


def _png_bits(ctype, depth, interlace=0, trns=False, size=(13, 11)):
    """An own-written PNG at any colour type and bit depth: a texture
    quantised to the depth, or palette indices into a seeded palette;
    with tRNS when asked."""
    def build(path, rng):
        h, w = size
        c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        plte = t = None
        if ctype == 3:
            n = min(2 ** depth, 200)
            px = rng.randint(0, n, (h, w)).astype(np.uint8)
            plte = rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes()
            if trns:
                t = rng.randint(0, 256, n // 2 + 1).astype(np.uint8).tobytes()
        else:
            base = _texture(rng, h, w, c)
            if depth == 16:
                px = base.astype(np.uint16) * 257 + rng.randint(0, 257, base.shape).astype(np.uint16)
            else:
                px = base >> (8 - depth)
            if trns and ctype in (0, 2):
                t = struct.pack(f">{1 if ctype == 0 else 3}H", *rng.randint(0, 1 << depth, c))
        _png(path, px if c > 1 else px.reshape(h, w), depth, ctype, rng, interlace=interlace,
             plte=plte, trns=t)
    return "png", build


def _case_cmyk(progressive=False, transform=None, adobe=True):
    """Pillow's CMYK JPEG (an Adobe marker, transform 0); with `transform`
    its Adobe transform byte rewritten (2: YCCK), or without the marker."""
    def build(path, rng):
        buf = io.BytesIO()
        Image.fromarray(_texture(rng, 29, 35, 3)).convert("CMYK").save(
            buf, "JPEG", quality=85, progressive=progressive)
        data = bytearray(buf.getvalue())
        at = data.find(b"\xff\xee\x00\x0eAdobe")  # APP14 of length 14
        assert at > 0
        if transform is not None:
            data[at + 4 + 11] = transform
        if not adobe:
            del data[at : at + 2 + 14]
        with open(path, "wb") as fh:
            fh.write(bytes(data))
    return "jpg", build


def _layout_tiff(kind, databar=0, sem=False, exif=False, **layout):
    """A TIFF by _tiff_file: "L", "RGB", "RGBA", "I16" (gray up to 765),
    "RGB16", "RGBA16" or "RGBX16" samples, optionally with the FEI SEM
    tag over a `databar`-row databar, or EXIF 41989 = 43 in IFD0."""
    def build(path, rng):
        h, w = 41 + databar, 47
        c = {"L": 1, "I16": 1, "RGB": 3, "RGB16": 3}.get(kind, 4)
        px = _texture(rng, h, w, c)
        if kind.endswith("16"):
            px = px.astype(np.uint16) * (3 if kind == "I16" else 257)
            if kind != "I16":
                px += rng.randint(0, 257, px.shape).astype(np.uint16)
        tags = []
        if sem:
            tags.append((34683, 2, SEM_TEXT.format(bar=databar).encode() + b"\0"))
        if exif:
            tags.append((41989, 3, [43]))
        extra = {"RGBA": (2,), "RGBA16": (2,), "RGBX16": (0,)}.get(kind)
        _tiff_file(path, px if c > 1 else px.reshape(h, w), extra=extra, extra_tags=tags,
                   **layout)
    return "tif", build


def _bmp_case(bits, header=40, palette="random", compression=0, masks=None, top_down=False,
              colors=None, rle_early=False, off_bits=None, size=(23, 29)):
    """A BMP by _bmp_file: indices into a seeded `palette` ("random", "gray"
    (entry i = (i, i, i)), "bw" or "ramp" (levels 0..255 over its
    entries)) at 1, 4 or 8 bits, raw or RLE (compression 1 / 2), or a
    texture's RGB(A) at 16, 24 or 32 bits with `masks`."""
    def build(path, rng):
        h, w = size
        if bits <= 8:
            n = colors or (1 << bits)
            pal = {"random": lambda: rng.randint(0, 256, (n, 3)),
                   "gray": lambda: np.repeat(np.arange(n)[:, None], 3, 1),
                   "bw": lambda: np.array([[0, 0, 0], [255, 255, 255]]),
                   "ramp": lambda: np.repeat((np.arange(n) * 255 // max(n - 1, 1))[:, None], 3, 1),
                   }[palette]()
            px = (_texture(rng, h, w).astype(np.int64) * len(pal) // 256).astype(np.uint8)
            data = None
            if compression:
                data = _rle_rows(px if top_down else px[::-1], compression == 2, rng)
            _bmp_file(path, px, bits, header, pal.astype(np.uint8), compression, masks, top_down,
                      colors, data, off_bits)
        else:
            px = _texture(rng, h, w, 4 if masks and len(masks) == 4 and masks[3] else 3)
            _bmp_file(path, px, bits, header, None, compression, masks, top_down, off_bits=off_bits)
    return "bmp", build


def _pillow_bmp(mode):
    def build(path, rng):
        rgba = _texture(rng, 27, 31, 4)
        img = Image.fromarray(rgba, "RGBA") if mode == "RGBA" else Image.fromarray(rgba[:, :, :3])
        if mode == "P":
            img = img.convert("P", palette=Image.Palette.ADAPTIVE, colors=100)
        elif mode not in ("RGB", "RGBA"):
            img = img.convert(mode)
        img.save(path)
    return "bmp", build


def _bilevel(rng, h: int, w: int) -> np.ndarray:
    """(h, w) 0/1 rows of runs whose lengths cross every make-up code of
    T.4, both colours: row r opens with a white run of 64 (r + 1) plus
    0-63 and a black one of 64 (h - r) plus 0-63 (extended codes from
    1792 on, several codes past 2560 where w allows), then random short
    and middling runs; one row all white."""
    out = np.zeros((h, w), np.uint8)
    for r in range(h - 1):
        runs = [64 * (r + 1) + rng.randint(64), 64 * (h - r) + rng.randint(64)]
        while sum(runs) < w:
            runs.append(int(rng.choice([rng.randint(1, 8), rng.randint(8, 64),
                                        rng.randint(64, 300)])))
        x = 0
        for k, n in enumerate(runs):
            out[r, x : x + n] = k % 2
            x += n
    return out


def _sample_tiff(kind, databar=0, size=(29, 35), **layout):
    """A TIFF by _tiff_file of `kind`'s samples: "F32" / "F64" (a texture
    from -40 to 400 with NaN, infinities and fractions), "I16S", "I32S"
    (signed, negative to past 255), "U32" (past 2**31), "S8" (signed
    8-bit), "I12", "L1" / "L2" / "L4" (gray at 1, 2, 4 bits), "P1" / "P2" /
    "P4" (palette indices and a seeded colour map), "L", "RGB", "I16" or
    "BILEVEL" (_bilevel); with the FEI SEM tag over a `databar`-row
    databar when `databar`."""
    def build(path, rng):
        h, w = size[0] + databar, size[1]
        base = _texture(rng, h, w, 3 if kind == "RGB" else None)
        tags = list(layout.pop("extra_tags", ()))
        bits = None
        if kind in ("F32", "F64"):
            px = (base.astype(np.float64) * 1.8 - 40 + rng.uniform(0, 1, base.shape)).astype(
                np.float32 if kind == "F32" else np.float64)
            for v in (np.nan, np.inf, -np.inf, 255.0, 254.999, -0.0, 1e-30, 1e30):
                px[rng.randint(h), rng.randint(w)] = v
        elif kind in ("I16S", "I32S"):
            px = (base.astype(np.int64) * 5 - 300).astype(np.int16 if kind == "I16S" else np.int32)
        elif kind == "U32":
            px = base.astype(np.uint32) * 3
            px[:, ::3] += np.uint32(2**31)
        elif kind == "S8":
            px = base.view(np.int8)
        elif kind == "I12":
            px, bits = base.astype(np.uint16) * 16 + rng.randint(0, 16, base.shape).astype(np.uint16), 12
        elif kind[0] in "LP" and kind[1:] in ("1", "2", "4"):
            bits = int(kind[1:])
            px = base >> (8 - bits)
            if kind[0] == "P":
                tags.append((320, 3, [int(v) for v in rng.randint(0, 65536, 3 << bits)]))
                layout.setdefault("photometric", 3)
        elif kind == "BILEVEL":
            px, bits = _bilevel(rng, h, w), 1
        elif kind == "I16":
            px = base.astype(np.uint16) * 3
        else:
            px = base
        if databar:
            tags.append((34683, 2, SEM_TEXT.format(bar=databar).encode() + b"\0"))
        _tiff_file(path, px, bits=bits, extra_tags=tags, **layout)
    return "tif", build


def _truncated(ext, build_fn, keep):
    def build(path, rng):
        build_fn(path + "." + ext, rng)
        data = open(path + "." + ext, "rb").read()
        with open(path, "wb") as fh:
            fh.write(data[: int(len(data) * keep)])
    return ext, build


CASES = {
    "png L": _case_png("L"),
    "png RGB": _case_png("RGB"),
    "png P": _case_png("P"),
    "png LA": _case_png("LA"),
    "png RGBA": _case_png("RGBA"),
    "png I;16": _case_png("I;16"),
    "png RGB 16-bit": _own_png("rgb16"),
    "png LA 16-bit": _own_png("la16"),
    "png RGBA every filter": _own_png("rgba-filters"),
    "png short palette": _own_png("short-palette"),
    "png exif ifd0": _case_png("RGB", exif=_exif_bytes(ifd0={41989: 43})),
    "png exif sub-ifd": _case_png("L", exif=_exif_bytes(sub={41989: 28})),
    "png exif after idat": _own_png("exif-after-idat"),
    "tif L": _case_tiff("L"),
    "tif L packbits": _case_tiff("L", compression="packbits"),
    "tif L lzw": _case_tiff("L", compression="tiff_lzw"),
    "tif L lzw predictor 2": _case_tiff("L", compression="tiff_lzw", tiffinfo={317: 2}),
    "tif RGB": _case_tiff("RGB"),
    "tif RGB lzw predictor 2": _case_tiff("RGB", compression="tiff_lzw", tiffinfo={317: 2}),
    "tif RGB deflate": _case_tiff("RGB", compression="tiff_adobe_deflate"),
    "tif RGBA": _case_tiff("RGBA"),
    "tif P": _case_tiff("P"),
    "tif P packbits": _case_tiff("P", compression="packbits"),
    "tif I;16": _case_tiff("I;16"),
    "tif I;16 lzw predictor 2": _case_tiff("I;16", compression="tiff_lzw", tiffinfo={317: 2}),
    "tif I;16B (MM)": _case_tiff("I;16B"),
    "tif MM L": _own_tiff("mm-gray"),
    "tif MM RGB packbits": _own_tiff("mm-rgb-packbits"),
    "tif min-is-white packbits": _own_tiff("ii-min-is-white-packbits"),
    "tif sem 34683 ascii databar 60": _case_tiff(
        "L", databar=60, sem=lambda bar: _sem_tags(SEM_TEXT.format(bar=bar))),
    "tif sem 34683 bytes databar 0": _case_tiff(
        "L", sem=lambda bar: _sem_tags(SEM_TEXT.format(bar=bar), typ=1)),
    "tif sem 34682 undefined databar 60": _case_tiff(
        "L", databar=60, sem=lambda bar: _sem_tags(SEM_TEXT.format(bar=bar), typ=7, tag=34682)),
    "tif sem I;16 databar 60": _case_tiff(
        "I;16", databar=60, sem=lambda bar: _sem_tags(SEM_TEXT.format(bar=bar))),
    "tif sem RGB lzw databar 60": _case_tiff(
        "RGB", databar=60, compression="tiff_lzw",
        sem=lambda bar: _sem_tags(SEM_TEXT.format(bar=bar))),
    "tif sem MM databar": _own_tiff("mm-sem-databar"),
    "tif sem + corrupt exif": _own_tiff("sem-corrupt-exif"),
    "tif sem + exif sub-ifd past the end": _own_tiff("sem-exif-sub-ifd"),
    "tif malformed sem block": _own_tiff("sem-as-shorts"),
    "tif sem malformed values": _case_tiff(
        "L", sem=lambda bar: _sem_tags("[Scan]\nPixelWidth=abc\n[PrivateFei]\nDatabarHeight=x\n")),
    "jpg gray q75": _case_jpeg(gray=True, quality=75),
    "jpg gray q95": _case_jpeg(gray=True, quality=95),
    "jpg 4:4:4 q75": _case_jpeg(quality=75, subsampling=0),
    "jpg 4:4:4 q95": _case_jpeg(quality=95, subsampling=0),
    "jpg 4:2:2 q75": _case_jpeg(quality=75, subsampling=1),
    "jpg 4:2:2 q95": _case_jpeg(quality=95, subsampling=1),
    "jpg 4:2:0 q75": _case_jpeg(quality=75, subsampling=2),
    "jpg 4:2:0 q95": _case_jpeg(quality=95, subsampling=2),
    "jpg 4:2:0 restart interval": _case_jpeg(quality=90, subsampling=2, restart_marker_blocks=3),
    "jpg gray restart rows, optimized": _case_jpeg(
        gray=True, quality=80, restart_marker_rows=1, optimize=True),
    "jpg 4:2:0 odd size": _case_jpeg(size=(33, 3), quality=85, subsampling=2),
    "jpg exif ifd0": _case_jpeg(quality=90, exif=_exif_bytes(ifd0={41989: 43})),
    "jpg exif sub-ifd": _case_jpeg(quality=90, exif=_exif_bytes(sub={41989: 50})),
    "jpg corrupt exif": _case_jpeg(quality=90, exif=b"Exif\x00\x00XX*\x00garbage"),
    **{f"png adam7 {name} {depth}-bit": _png_bits(ctype, depth, interlace=1)
       for name, ctype, depths in (("gray", 0, (1, 2, 4, 8, 16)), ("RGB", 2, (8, 16)),
                                   ("palette", 3, (1, 2, 4, 8)), ("LA", 4, (8, 16)),
                                   ("RGBA", 6, (8, 16)))
       for depth in depths},
    "png adam7 3x2 (empty passes)": _png_bits(2, 8, interlace=1, size=(2, 3)),
    "png adam7 palette tRNS": _png_bits(3, 8, interlace=1, trns=True),
    "png gray 1-bit tRNS": _png_bits(0, 1, trns=True, size=(19, 23)),
    "png gray 2-bit": _png_bits(0, 2, size=(19, 23)),
    "png gray 4-bit tRNS": _png_bits(0, 4, trns=True, size=(19, 23)),
    "png palette 1-bit": _png_bits(3, 1, size=(19, 23)),
    "png palette 2-bit tRNS": _png_bits(3, 2, trns=True, size=(19, 23)),
    "png palette 4-bit tRNS": _png_bits(3, 4, trns=True, size=(19, 23)),
    "jpg progressive 4:2:0": _case_jpeg(quality=80, subsampling=2, progressive=True),
    "jpg progressive 4:2:2 restart interval": _case_jpeg(
        quality=60, subsampling=1, progressive=True, restart_marker_blocks=2),
    "jpg progressive 4:4:4 optimized": _case_jpeg(
        quality=95, subsampling=0, progressive=True, optimize=True),
    "jpg progressive gray": _case_jpeg(gray=True, quality=70, progressive=True),
    "jpg progressive exif sub-ifd": _case_jpeg(
        quality=90, progressive=True, exif=_exif_bytes(sub={41989: 50})),
    "jpg CMYK": _case_cmyk(),
    "jpg CMYK progressive": _case_cmyk(progressive=True),
    "jpg CMYK without an Adobe marker": _case_cmyk(adobe=False),
    "jpg YCCK": _case_cmyk(transform=2),
    "jpg YCCK progressive": _case_cmyk(progressive=True, transform=2),
    "tif tiled L, edge tiles": _layout_tiff("L", tile=(16, 16)),
    "tif tiled RGB packbits": _layout_tiff("RGB", tile=(16, 8), compression=32773),
    "tif tiled L lzw predictor 2": _layout_tiff("L", tile=(16, 16), compression=5, predictor=2),
    "tif tiled RGB deflate predictor 2 (MM)": _layout_tiff(
        "RGB", endian=">", tile=(32, 16), compression=8, predictor=2),
    "tif tiled I;16 lzw predictor 2": _layout_tiff("I16", tile=(16, 16), compression=5,
                                                   predictor=2),
    "tif tiled I;16B lzw (MM)": _layout_tiff("I16", endian=">", tile=(16, 32), compression=5),
    "tif planar RGB": _layout_tiff("RGB", planar=True),
    "tif planar RGB lzw predictor 2": _layout_tiff("RGB", planar=True, compression=5,
                                                   predictor=2),
    "tif planar RGBA deflate (MM)": _layout_tiff("RGBA", endian=">", planar=True, compression=8),
    "tif planar tiled RGB packbits": _layout_tiff("RGB", planar=True, tile=(16, 16),
                                                  compression=32773),
    "tif planar RGB 16-bit lzw": _layout_tiff("RGB16", planar=True, compression=5),
    "tif planar RGBA 16-bit deflate predictor 2 (MM)": _layout_tiff(
        "RGBA16", endian=">", planar=True, compression=8, predictor=2),
    "tif RGB 16-bit": _layout_tiff("RGB16"),
    "tif RGB 16-bit (MM)": _layout_tiff("RGB16", endian=">"),
    "tif RGB 16-bit lzw predictor 2 (MM)": _layout_tiff("RGB16", endian=">", compression=5,
                                                        predictor=2),
    "tif RGBA 16-bit": _layout_tiff("RGBA16"),
    "tif RGBA 16-bit packbits (MM)": _layout_tiff("RGBA16", endian=">", compression=32773),
    "tif RGBX 16-bit": _layout_tiff("RGBX16"),
    "tif RGBX 16-bit deflate (MM)": _layout_tiff("RGBX16", endian=">", compression=8),
    "tif bigtiff L": _layout_tiff("L", big=True),
    "tif bigtiff tiled RGB lzw": _layout_tiff("RGB", big=True, tile=(16, 16), compression=5),
    "tif bigtiff planar RGB 16-bit deflate": _layout_tiff("RGB16", big=True, planar=True,
                                                          compression=8),
    "tif bigtiff sem databar 60": _layout_tiff("L", databar=60, sem=True, big=True),
    "tif bigtiff exif 41989": _layout_tiff("L", exif=True, big=True),
    "tif tiled sem databar 60": _layout_tiff("L", databar=60, sem=True, tile=(32, 32)),
    "tif planar sem databar 60": _layout_tiff("RGB", databar=60, sem=True, planar=True),
    "bmp P 8-bit": _bmp_case(8),
    "bmp P 8-bit, colours used 0": _bmp_case(8, colors=0),
    "bmp P 8-bit, 100 colours, top-down": _bmp_case(8, colors=100, top_down=True),
    "bmp L (gray palette)": _bmp_case(8, palette="gray"),
    "bmp P 8-bit gray ramp of 16": _bmp_case(8, palette="ramp", colors=16),
    "bmp P 4-bit": _bmp_case(4),
    "bmp P 4-bit, 12 colours": _bmp_case(4, colors=12),
    "bmp P 1-bit": _bmp_case(1),
    "bmp 1 (black and white)": _bmp_case(1, palette="bw"),
    "bmp core header P 8-bit": _bmp_case(8, header=12),
    "bmp core header P 4-bit": _bmp_case(4, header=12),
    "bmp core header RGB": _bmp_case(24, header=12),
    "bmp RGB 16-bit 5-5-5": _bmp_case(16),
    "bmp RGB 24-bit top-down": _bmp_case(24, top_down=True),
    "bmp RGB 32-bit": _bmp_case(32),
    "bmp RGB 32-bit V5": _bmp_case(32, header=124),
    "bmp bitfields 5-6-5": _bmp_case(16, compression=3, masks=(0xF800, 0x7E0, 0x1F, 0)),
    "bmp bitfields 5-5-5 V4": _bmp_case(16, header=108, compression=3,
                                          masks=(0x7C00, 0x3E0, 0x1F, 0)),
    "bmp bitfields 24-bit": _bmp_case(24, compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0)),
    "bmp bitfields BGRX (V2)": _bmp_case(32, header=52, compression=3,
                                           masks=(0xFF0000, 0xFF00, 0xFF, 0)),
    "bmp bitfields XBGR": _bmp_case(32, compression=3, masks=(0xFF000000, 0xFF0000, 0xFF00, 0)),
    "bmp bitfields BGXR (V3)": _bmp_case(32, header=56, compression=3,
                                           masks=(0xFF000000, 0xFF00, 0xFF, 0)),
    "bmp bitfields BGRA V4": _bmp_case(32, header=108, compression=3,
                                         masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "bmp bitfields RGBA V5": _bmp_case(32, header=124, compression=3,
                                         masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "bmp bitfields ABGR (OS/2 v2)": _bmp_case(32, header=64, compression=3,
                                                masks=(0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
    "bmp bitfields BGAR V5": _bmp_case(32, header=124, compression=3,
                                         masks=(0xFF000000, 0xFF00, 0xFF, 0xFF0000)),
    "bmp RLE8": _bmp_case(8, compression=1),
    "bmp RLE8 gray palette": _bmp_case(8, palette="gray", compression=1),
    "bmp RLE8 V5, 40 colours": _bmp_case(8, header=124, colors=40, compression=1),
    "bmp RLE4": _bmp_case(4, compression=2),
    "bmp RLE4 gray ramp": _bmp_case(4, palette="ramp", compression=2, size=(37, 41)),
    "bmp pixels past a gap (bfOffBits)": _bmp_case(24, off_bits=200),
    "bmp bfOffBits at the palette": _bmp_case(8, colors=0, off_bits=54),
    "bmp Pillow RGB": _pillow_bmp("RGB"),
    "bmp Pillow RGBA": _pillow_bmp("RGBA"),
    "bmp Pillow L": _pillow_bmp("L"),
    "bmp Pillow P": _pillow_bmp("P"),
    "bmp Pillow 1": _pillow_bmp("1"),
    "tif F32": _sample_tiff("F32"),
    "tif F (Pillow)": _case_tiff("F"),
    "tif F32 (MM)": _sample_tiff("F32", endian=">"),
    "tif F32 min-is-white": _sample_tiff("F32", photometric=0),
    "tif F32 lzw predictor 3": _sample_tiff("F32", compression=5, predictor=3),
    "tif F32 tiled deflate predictor 3": _sample_tiff("F32", tile=(16, 16), compression=8,
                                                        predictor=3),
    "tif F32 deflate predictor 2": _sample_tiff("F32", compression=8, predictor=2),
    "tif I;16S": _sample_tiff("I16S"),
    "tif I;16S (MM)": _sample_tiff("I16S", endian=">"),
    "tif I;16S lzw predictor 2": _sample_tiff("I16S", compression=5, predictor=2),
    "tif I;32S": _sample_tiff("I32S"),
    "tif I;32S (MM) tiled": _sample_tiff("I32S", endian=">", tile=(16, 16)),
    "tif I;32S deflate predictor 2": _sample_tiff("I32S", compression=8, predictor=2),
    "tif 32-bit unsigned": _sample_tiff("U32"),
    "tif 32-bit unsigned lzw": _sample_tiff("U32", compression=5),
    "tif signed 8-bit": _sample_tiff("S8"),
    "tif 12-bit": _sample_tiff("I12"),
    "tif 12-bit lzw": _sample_tiff("I12", compression=5),
    "tif 1-bit": _sample_tiff("L1"),
    "tif 1-bit min-is-white packbits": _sample_tiff("L1", photometric=0, compression=32773),
    "tif 1-bit tiled": _sample_tiff("L1", tile=(16, 16)),
    "tif 2-bit": _sample_tiff("L2"),
    "tif 2-bit min-is-white lzw": _sample_tiff("L2", photometric=0, compression=5),
    "tif 4-bit": _sample_tiff("L4"),
    "tif 4-bit min-is-white deflate (MM)": _sample_tiff("L4", photometric=0, compression=8,
                                                          endian=">"),
    "tif P 1-bit": _sample_tiff("P1"),
    "tif P 2-bit lzw": _sample_tiff("P2", compression=5),
    "tif P 4-bit": _sample_tiff("P4"),
    "tif fill order 2 L": _sample_tiff("L", fill_order=2),
    "tif fill order 2 L lzw": _sample_tiff("L", fill_order=2, compression=5),
    "tif fill order 2 L deflate predictor 2": _sample_tiff("L", fill_order=2, compression=8,
                                                             predictor=2),
    "tif fill order 2 min-is-white packbits": _sample_tiff("L", fill_order=2, photometric=0,
                                                             compression=32773),
    "tif fill order 2 RGB": _sample_tiff("RGB", fill_order=2),
    "tif fill order 2 RGB lzw": _sample_tiff("RGB", fill_order=2, compression=5),
    "tif fill order 2 1-bit": _sample_tiff("L1", fill_order=2),
    "tif fill order 2 4-bit lzw": _sample_tiff("L4", fill_order=2, compression=5),
    "tif fill order 2 P 4-bit lzw": _sample_tiff("P4", fill_order=2, compression=5),
    "tif fill order 2 I;16": _sample_tiff("I16", fill_order=2),
    "tif fill order 2 I;16 lzw": _sample_tiff("I16", fill_order=2, compression=5),
    "tif ccitt modified Huffman": _sample_tiff("BILEVEL", size=(41, 2700), compression=2,
                                               rows_per_strip=16),
    "tif ccitt T.4 1D": _sample_tiff("BILEVEL", size=(41, 2700), compression=3,
                                     rows_per_strip=16),
    "tif ccitt T.4 2D": _sample_tiff("BILEVEL", size=(41, 2700), compression=3, t4_options=1,
                                     rows_per_strip=16),
    "tif ccitt T.6": _sample_tiff("BILEVEL", size=(41, 2700), compression=4, rows_per_strip=16),
    "tif ccitt T.6 min-is-white, tiles": _sample_tiff("BILEVEL", size=(41, 70), compression=4,
                                                      photometric=0, tile=(32, 16)),
    "tif ccitt T.4 2D fill order 2": _sample_tiff("BILEVEL", size=(20, 300), compression=3,
                                                  t4_options=1, fill_order=2),
    "tif ccitt T.6 fill order 2 (MM)": _sample_tiff("BILEVEL", size=(20, 300), compression=4,
                                                    fill_order=2, endian=">"),
    "tif ccitt modified Huffman min-is-white": _sample_tiff("BILEVEL", size=(20, 300),
                                                            compression=2, photometric=0),
    "tif ccitt group4 (Pillow)": _case_tiff("1", compression="group4"),
    "tif ccitt group3 (Pillow)": _case_tiff("1", compression="group3"),
    "tif ccitt modified Huffman (Pillow)": _case_tiff("1", compression="tiff_ccitt"),
    "tif jpeg gray (Pillow)": _case_tiff("L", compression="jpeg"),
    "tif jpeg RGB (Pillow)": _case_tiff("RGB", compression="jpeg"),
    "tif jpeg gray strips": _sample_tiff("L", compression=7, rows_per_strip=16),
    "tif jpeg YCbCr 2x2 strips": _sample_tiff("RGB", compression=7, rows_per_strip=16,
                                              photometric=6, extra_tags=[(530, 3, [2, 2])]),
    "tif jpeg YCbCr 2x2 strips, no JPEGTables": _sample_tiff(
        "RGB", compression=7, rows_per_strip=16, photometric=6, jpeg_tables=False,
        extra_tags=[(530, 3, [2, 2])]),
    "tif jpeg YCbCr 2x2 tiles": _sample_tiff("RGB", size=(45, 50), compression=7, tile=(32, 16),
                                             photometric=6, extra_tags=[(530, 3, [2, 2])]),
    "tif jpeg gray tiles (MM)": _sample_tiff("L", size=(45, 50), compression=7, tile=(16, 32),
                                             endian=">"),
    "tif jpeg arithmetic YCbCr 2x2 strips": _sample_tiff(
        "RGB", compression=7, rows_per_strip=16, photometric=6, extra_tags=[(530, 3, [2, 2])],
        jpeg_coder=_arith_strip),
    "tif jpeg lossless RGB strips": _sample_tiff("RGB", compression=7, rows_per_strip=16,
                                                 jpeg_coder=_lossless_strip),
    "tif sem F32 databar 60": _sample_tiff("F32", databar=60),
    "tif sem jpeg YCbCr databar 60": _sample_tiff("RGB", databar=60, compression=7,
                                                  rows_per_strip=16, photometric=6,
                                                  extra_tags=[(530, 3, [2, 2])]),
    "truncated png": _truncated("png", _case_png("RGB")[1], 0.6),
    "truncated tif": _truncated("tif", _case_tiff("L", databar=60, sem=lambda bar: _sem_tags(
        SEM_TEXT.format(bar=bar)))[1], 0.5),
    "truncated jpg": _truncated("jpg", _case_jpeg(quality=90, exif=_exif_bytes(ifd0={41989: 43}))[1],
                                0.6),
    "truncated bmp": _truncated("bmp", _bmp_case(24)[1], 0.7),
    "truncated bmp RLE8": _truncated("bmp", _bmp_case(8, compression=1)[1], 0.8),
}


def _write_case(tmp_path, name: str) -> str:
    ext, build = CASES[name]
    path = str(tmp_path / f"case.{ext}")
    build(path, np.random.RandomState(sorted(CASES).index(name)))
    return path


def _meta(m) -> tuple:
    return (m.scale, m.tilt_angle, m.databar_height, m.focal_length_35mm)


def _jax_load(path):
    """The JAX package's SourceImage.load and load_rgb, or the exception."""
    try:
        return jimages.SourceImage.load(path), jimages.SourceImage.load_rgb(path)
    except Exception as err:  # noqa: BLE001 - the reference's refusal is the result
        return err


@pytest.mark.parametrize("name", sorted(CASES))
def test_readers_match_jax(tmp_path, name):
    path = _write_case(tmp_path, name)
    assert _meta(timages.read_metadata(path)) == _meta(jimages.read_metadata(path))
    ref = _jax_load(path)
    # Pillow refuses only the truncated files: every other case is read.
    assert isinstance(ref, Exception) == name.startswith("truncated"), ref
    if isinstance(ref, Exception):
        with pytest.raises(Exception):
            timages.SourceImage.load(path).load_rgb_plane()
        return
    (src_j, rgb_j) = ref
    src_t = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src_t.img, src_j.img)
    assert (src_t.scale, src_t.tilt_angle, src_t.focal_length_35mm) == (
        src_j.scale, src_j.tilt_angle, src_j.focal_length_35mm)
    rgb_t = src_t.load_rgb_plane()
    assert rgb_t.dtype == np.uint8 and rgb_t.flags.c_contiguous
    np.testing.assert_array_equal(rgb_t, rgb_j)


@pytest.mark.parametrize(
    "name", ["png RGB", "png RGBA every filter", "png I;16", "png RGB 16-bit", "png P",
             "tif L packbits", "tif RGB", "tif MM RGB packbits", "tif I;16B (MM)",
             "png adam7 gray 2-bit", "png adam7 RGBA 16-bit", "png palette 4-bit tRNS",
             "tif tiled RGB packbits", "tif planar RGBA deflate (MM)", "tif RGBX 16-bit",
             "bmp P 4-bit", "bmp RGB 16-bit 5-5-5", "bmp bitfields BGRA V4", "bmp 1 (black and white)",
             "tif F32 tiled deflate predictor 3", "tif I;16S", "tif I;32S (MM) tiled",
             "tif 4-bit min-is-white deflate (MM)", "tif 12-bit", "tif P 1-bit",
             "tif fill order 2 L deflate predictor 2"])
def test_native_and_numpy_paths_agree(tmp_path, name):
    path = _write_case(tmp_path, name)
    f = imageio.open_image(path)
    mode_n, px_n, pal_n = f.decode()
    module = {"PNG": imageio.png, "TIFF": imageio.tiff, "BMP": imageio.bmp}[f.format]
    mode_p, px_p, pal_p = module.decode(f.parsed, None)
    assert mode_p == mode_n
    np.testing.assert_array_equal(px_p, px_n)
    if pal_n is not None:
        np.testing.assert_array_equal(pal_p, pal_n)


def test_jpeg_and_lzw_without_native_name_the_compiler(tmp_path, monkeypatch):
    """No fallback: without the native library a JPEG, an LZW, zstd,
    CCITT or JPEG strip of a TIFF or an RLE BMP raises an error that says
    what is missing."""
    paths = []
    for k, name in enumerate(("jpg 4:2:0 q75", "tif L lzw", "tif ccitt T.6", "tif jpeg gray strips",
                              "bmp RLE8", "bmp RLE4")):
        (tmp_path / str(k)).mkdir()
        paths.append(_write_case(tmp_path / str(k), name))
    paths.append(str(tmp_path / "zstd.tif"))
    Image.fromarray(_texture(np.random.RandomState(8), 9, 13)).save(paths[-1], compression="zstd")

    def refuse():
        raise ImportError("no native library")

    monkeypatch.setattr(native, "load", refuse)
    for path in paths:
        with pytest.raises(imageio.NativeDecoderError, match="C\\+\\+ compiler"):
            timages.SourceImage.load(path)


def _sof_rewritten(path, rng, marker: int, precision: int = 8, components: int = 3):
    """A baseline JPEG whose SOF0 marker, sample precision or component
    count is rewritten: the frame of a 12-bit, hierarchical or
    2-component file, the rest of the file unchanged."""
    buf = io.BytesIO()
    Image.fromarray(_texture(rng, 24, 24, 3)).save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    at = data.find(b"\xff\xc0")
    data[at + 1], data[at + 4], data[at + 9] = marker, precision, components
    with open(path, "wb") as fh:
        fh.write(bytes(data))


# -- the TIFF faults repaired: compressed YCbCr, 4- and 2-sample JPEG-in-TIFF -----------


def _ycbcr_units(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int, vs: int) -> bytes:
    """YCbCr data units of (rows, w) luma and the chroma at block
    resolution (at least one sample a block): each hs x vs luma samples
    row by row (the edge blocks padded with zeros), then Cb and Cr."""
    rows, w = y.shape
    by, bx = -(-rows // vs), -(-w // hs)
    full = np.zeros((by * vs, bx * hs), np.uint8)
    full[:rows, :w] = y
    units = np.empty((by, bx, hs * vs + 2), np.uint8)
    units[:, :, : hs * vs] = full.reshape(by, vs, bx, hs).transpose(0, 2, 1, 3).reshape(by, bx, -1)
    units[:, :, -2], units[:, :, -1] = cb[:by, :bx], cr[:by, :bx]
    return units.tobytes()


def _ycbcr_tiff(path, rng, size, sub, tile=None, rows_per_strip=None, tag=True, extra=None):
    """A Deflate YCbCr TIFF of seeded samples, (h, w) `size`, in packed
    data units of `sub` (hs, vs) in strips or (width, length) tiles;
    YCbCrSubSampling written unless not `tag` (TIFF's default is 2x2);
    extra: more entries {tag: (type, values)}."""
    (h, w), (hs, vs) = size, sub
    # Samples past the image, so that every tile is whole.
    y = rng.randint(0, 256, (h + 64, w + 64)).astype(np.uint8)
    cb, cr = (rng.randint(0, 256, (h // vs + 65, w // hs + 65)).astype(np.uint8) for _ in "bc")
    units = []
    if tile:
        tw, th = tile
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                units.append(_ycbcr_units(y[y0 : y0 + th, x0 : x0 + tw], cb[y0 // vs :, x0 // hs :],
                                          cr[y0 // vs :, x0 // hs :], hs, vs))
    else:
        rps = rows_per_strip or h
        units = [_ycbcr_units(y[y0 : min(y0 + rps, h), :w], cb[y0 // vs :], cr[y0 // vs :], hs, vs)
                 for y0 in range(0, h, rps)]
    blobs = [zlib.compress(u) for u in units]
    places = [("blob", k) for k in range(len(blobs))]
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [8]), 262: (3, [6]),
               277: (3, [3])}
    if tile:
        entries.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: (4, places),
                        325: (4, [len(b) for b in blobs])})
    else:
        entries.update({273: (4, places), 278: (3, [rps]), 279: (4, [len(b) for b in blobs])})
    if tag:
        entries[530] = (3, list(sub))
    entries.update(extra or {})
    with open(path, "wb") as fh:
        fh.write(chip_smoke._tiff_entries(entries, blobs))


def _stored_jpeg(part: np.ndarray, sampled: bool = False) -> bytes:
    """A baseline JPEG of (rows, w, c) samples as they are, one component
    each (chip_smoke.huffman_jpeg: libjpeg's quality-80 tables): what a
    JPEG-in-TIFF of any sample count holds; with `sampled` the first
    component sampled 2x1 (which libtiff refuses where it does not
    convert YCbCr)."""
    from cybervision_tpu_torch.imageio.jpeg_encode import quant_tables

    rows, w, c = part.shape
    sampling = [(2, 1) if sampled else (1, 1)] + [(1, 1)] * (c - 1)
    planes = [part[:, :, k] if k == 0 or not sampled else
              np.ascontiguousarray(part[:, ::2, k]) for k in range(c)]
    quant = quant_tables(80)
    return chip_smoke.huffman_jpeg(chip_smoke.dct_coefficients(planes, quant, sampling, w, rows),
                                   quant, w, rows, sampling)[0]


def _pillow_tiff(mode, size, **save):
    def build(path, rng):
        Image.fromarray(_texture(rng, *size, len(mode)), mode).save(path, **save)
    return build


def _ycbcr_case(size, sub, **kw):
    return lambda path, rng: _ycbcr_tiff(path, rng, size, sub, **kw)


def _jpeg_tiles_case(mode, photometric, extra=None):
    def build(path, rng):
        _tiff_file(path, _texture(rng, 45, 50, len(mode)), compression=7, tile=(32, 16),
                   photometric=photometric, extra=extra, jpeg_coder=_stored_jpeg)
    return build


TIFF_REPAIRS = {
    **{f"YCbCr {c} {w}x{h} (Pillow)": _pillow_tiff("RGB", (h, w), compression=c)
       for c in ("tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits", "lzma", "zstd")
       for w, h in ((67, 45), (130, 9))},
    "YCbCr 1x1 planar, predictor 2": lambda path, rng: _tiff_file(
        path, _texture(rng, 29, 35, 3), compression=8, planar=True, predictor=2, photometric=6,
        extra_tags=[(530, 3, [1, 1])]),
    "YCbCr 2x1 strips of 4 rows": _ycbcr_case((45, 67), (2, 1), rows_per_strip=4),
    "YCbCr 2x1 tiles": _ycbcr_case((45, 67), (2, 1), tile=(16, 16)),
    "YCbCr 2x2 strips of 8 rows": _ycbcr_case((45, 67), (2, 2), rows_per_strip=8),
    "YCbCr 2x2 strips of 5 rows": _ycbcr_case((45, 67), (2, 2), rows_per_strip=5),
    "YCbCr 2x2 tiles": _ycbcr_case((9, 130), (2, 2), tile=(32, 16)),
    "YCbCr 2x2 by default (no tag)": _ycbcr_case((45, 67), (2, 2), tag=False),
    "YCbCr 2x2, BT.709 coefficients and studio range": _ycbcr_case(
        (45, 67), (2, 2), extra={529: (5, [(2126, 10000), (7152, 10000), (722, 10000)]),
                                 532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                                           (240, 1)])}),
    "YCbCr 1x2 strips": _ycbcr_case((45, 67), (1, 2), rows_per_strip=8),
    "YCbCr 4x1 strips": _ycbcr_case((45, 67), (4, 1), rows_per_strip=4),
    "YCbCr 4x2 tiles": _ycbcr_case((45, 67), (4, 2), tile=(16, 16)),
    "YCbCr 4x4 strips, an odd count of units a row": _ycbcr_case((45, 67), (4, 4),
                                                                 rows_per_strip=16),
    "YCbCr 4x4 tiles, a partial right tile": _ycbcr_case((45, 67), (4, 4), tile=(16, 16)),
    **{f"jpeg {m} {w}x{h} strips (Pillow)": _pillow_tiff(m, (h, w), compression="jpeg",
                                                          tiffinfo={278: 16})
       for m in ("RGBA", "CMYK", "LA") for w, h in ((67, 45), (130, 9))},
    "jpeg YCbCr 1x1 strips without the tag (libtiff's fixup)": lambda path, rng: _tiff_file(
        path, _texture(rng, 45, 50, 3), compression=7, rows_per_strip=16, photometric=6,
        jpeg_coder=_stored_jpeg),
    "jpeg RGBA tiles": _jpeg_tiles_case("RGBA", 2, (2,)),
    "jpeg CMYK tiles": _jpeg_tiles_case("CMYK", 5),
    "jpeg LA tiles": _jpeg_tiles_case("LA", 1, (2,)),
}


@pytest.mark.parametrize("kind", sorted(TIFF_REPAIRS))
def test_repaired_tiff_faults_decode_to_pillows_planes(tmp_path, kind):
    """Compressed YCbCr (every codec Pillow writes it with, and files in
    packed data units of every subsampling libtiff converts, the 4x4
    quirks included: a strip read short of its last units, a partial
    right tile whose units libtiff misaligns) and 4- and 2-sample
    JPEG-in-TIFF (RGBA, CMYK and LA, samples as stored, not inverted):
    imageio's mode and pixels are Pillow's, and so are the JAX package's
    gray and colour planes."""
    path = str(tmp_path / "r.tif")
    TIFF_REPAIRS[kind](path, np.random.RandomState(sorted(TIFF_REPAIRS).index(kind)))
    with Image.open(path) as im:
        mode, px = im.mode, np.asarray(im)
    f = imageio.open_image(path)
    got_mode, got, _ = f.decode()
    assert got_mode == mode
    np.testing.assert_array_equal(got, px)
    (src_j, rgb_j) = _jax_load(path)
    src_t = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src_t.img, src_j.img)
    np.testing.assert_array_equal(src_t.load_rgb_plane(), rgb_j)


def _tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, the early width change) of `data`."""
    out, acc, nbits = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nbits
        acc, nbits = (acc << width) | code, nbits + width
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)

    table, nxt, width, w = {bytes([i]): i for i in range(256)}, 258, 9, b""
    put(256, 9)
    for c in data:
        if w + bytes([c]) in table:
            w += bytes([c])
            continue
        put(table[w], width)
        table[w + bytes([c])], nxt, w = nxt, nxt + 1, bytes([c])
        width = 12 if nxt >= 2048 else 11 if nxt >= 1024 else 10 if nxt >= 512 else 9
        if nxt == 4094:
            put(256, width)
            table, nxt, width = {bytes([i]): i for i in range(256)}, 258, 9
    put(table[w], width)
    nxt += 1
    put(257, 12 if nxt >= 2048 else 11 if nxt >= 1024 else 10 if nxt >= 512 else 9)
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


SHORT_STRIP_CODECS = {
    "Deflate": (8, zlib.compress),
    "LZW": (5, _tiff_lzw),
    # literal runs of 128 bytes, so that the cut falls inside one
    "PackBits": (32773, lambda d: b"".join(bytes([len(d[i : i + 128]) - 1]) + d[i : i + 128]
                                         for i in range(0, len(d), 128))),
    "LZMA": (34925, lambda d: __import__("lzma").compress(d)),
    "zstd": (50000, lambda d: __import__("zstandard").ZstdCompressor(level=3).compress(d)),
}


@pytest.mark.parametrize("sub", [(1, 1), (2, 2)])
@pytest.mark.parametrize("codec", sorted(SHORT_STRIP_CODECS))
def test_short_ycbcr_strip_reads_as_pillow_does(tmp_path, codec, sub):
    """A compressed YCbCr TIFF (45x67, strips of 16 rows) whose second
    strip holds half its compressed bytes: libtiff's codec stops at its
    own byte ("Not enough data at scanline 16"), and TIFFRGBAImage, with
    stoponerr 0, converts its zeroed strip buffer all the same, so Pillow
    returns an image; the port's planes are Pillow's, bit for bit."""
    compression, encode = SHORT_STRIP_CODECS[codec]
    rng = np.random.RandomState(22)
    (h, w), (hs, vs), rps = (45, 67), sub, 16
    y = rng.randint(0, 256, (h, w)).astype(np.uint8)
    cb, cr = (rng.randint(0, 256, (-(-h // vs), -(-w // hs))).astype(np.uint8) for _ in "bc")
    blobs = [encode(_ycbcr_units(y[y0 : y0 + rps], cb[y0 // vs :], cr[y0 // vs :], hs, vs))
             for y0 in range(0, h, rps)]
    blobs[1] = blobs[1][: len(blobs[1]) // 2]
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [compression]),
               262: (3, [6]), 277: (3, [3]), 278: (3, [rps]), 530: (3, list(sub)),
               273: (4, [("blob", k) for k in range(len(blobs))]),
               279: (4, [len(b) for b in blobs])}
    path = str(tmp_path / "short.tif")
    with open(path, "wb") as fh:
        fh.write(chip_smoke._tiff_entries(entries, blobs))
    with Image.open(path) as im:
        mode, px = im.mode, np.asarray(im)
    got_mode, got, _ = imageio.open_image(path).decode()
    assert (got_mode, mode) == ("RGB", "RGB")
    np.testing.assert_array_equal(got, px)
    src_j, rgb_j = _jax_load(path)
    src_t = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src_t.img, src_j.img)
    np.testing.assert_array_equal(src_t.load_rgb_plane(), rgb_j)


def _bad_tiff(kind, path, rng):
    if kind == "YCbCr 3x3":
        _ycbcr_tiff(path, rng, (24, 24), (3, 3))
    elif kind == "YCbCr 2x2 planar":
        _tiff_file(path, _texture(rng, 24, 24, 3), compression=8, planar=True, photometric=6,
                   extra_tags=[(530, 3, [2, 2])])
    else:  # a JPEG strip of another precision, component count or sampling
        px = _texture(rng, 16, 24, 3)
        stream = _stored_jpeg(px[:, :, :2] if kind == "jpeg strip of 2 components" else px,
                              sampled=kind == "jpeg RGB strip sampled 2x1")
        if kind == "jpeg strip of 12 bits":
            at = stream.find(b"\xff\xc0")
            stream = stream[: at + 4] + b"\x0c" + stream[at + 5 :]
        ycbcr = kind == "jpeg YCbCr strip 1x1, tagged 2x2"
        _tiff_file(path, px, compression=7, rows_per_strip=16, jpeg_coder=lambda part: stream,
                   photometric=6 if ycbcr else None,
                   extra_tags=[(530, 3, [2, 2])] if ycbcr else ())


@pytest.mark.parametrize("kind", ["YCbCr 3x3", "YCbCr 2x2 planar", "jpeg strip of 12 bits",
                                  "jpeg strip of 2 components", "jpeg RGB strip sampled 2x1",
                                  "jpeg YCbCr strip 1x1, tagged 2x2"])
def test_tiff_faults_pillow_fails_on_fail_by_name(tmp_path, kind):
    """Where Pillow fails too: a YCbCr subsampling libtiff has no
    conversion for, or subsampled planar YCbCr, is refused without "yet";
    a JPEG strip whose frame libjpeg or libtiff refuses (12 bits, fewer
    components than the samples, RGB with subsampled components, YCbCr
    sampled otherwise than its YCbCrSubSampling tag says) is a
    broken strip (CorruptImageError), never the NotThisFormat of Pillow's
    own JPEG plugin's checks, which would send identify on to other
    readers."""
    from cybervision_tpu_torch.imageio.errors import CorruptImageError, NotThisFormat

    path = str(tmp_path / "f.tif")
    _bad_tiff(kind, path, np.random.RandomState(21))
    assert isinstance(_jax_load(path), Exception)
    f = imageio.open_image(path)
    if kind.startswith("YCbCr"):
        with pytest.raises(UnsupportedImageError, match="not supported: ") as err:
            f.decode()
        assert "yet" not in str(err.value)
        return
    with pytest.raises(CorruptImageError) as err:
        f.decode()
    assert not isinstance(err.value, NotThisFormat)


# kind -> (extension, whether Pillow reads the file)
UNSUPPORTED = {
    "12-bit jpeg": ("jpg", False),
    "hierarchical jpeg": ("jpg", False),
    "2-component jpeg": ("jpg", False),
    "jpeg 2000 (jp2 boxes)": ("jp2", True),
    "jpeg 2000 (j2k codestream)": ("j2k", True),
    "avif": ("avif", True),
    "subsampled YCbCr tiff with a predictor": ("tif", True),
    "uncompressed YCbCr tiff": ("tif", False),
    "LAB tiff": ("tif", False),
}
# Kinds refused by name until the readers took them (JPEG 2000 since the
# port's jpeg2000 reader, AVIF since its avif reader): they now decode to
# the JAX package's planes.
NOW_READ = {"jpeg 2000 (jp2 boxes)", "jpeg 2000 (j2k codestream)", "avif"}
# Kinds Pillow does not read either, refused without "yet", and what the
# port's refusal says: the TIFFs and hierarchical JPEG by name; 12-bit
# and 2-component JPEG fail Pillow's open, so Image.open tries its other
# plugins and none takes them.
PILLOW_REFUSES_TOO = {
    "uncompressed YCbCr tiff": "not supported: Pillow",
    "LAB tiff": "not supported: Pillow",
    "hierarchical jpeg": "not supported: libjpeg-turbo",
    "12-bit jpeg": "nor any other Pillow plugin",
    "2-component jpeg": "nor any other Pillow plugin",
}


def _unsupported(kind, path):
    rng = np.random.RandomState(5)
    im = Image.fromarray(_texture(rng, 24, 24, 3))
    if kind == "subsampled YCbCr tiff with a predictor":
        _ycbcr_tiff(path, rng, (24, 24), (2, 2), extra={317: (3, [2])})
    elif kind in ("gif", "webp", "ico", "icns", "dib", "im", "msp", "xbm", "dds", "blp") \
            or UNSUPPORTED.get(kind, ("", False))[1]:
        im.convert({"msp": "1", "xbm": "1", "blp": "P"}.get(kind, "RGB")).save(path)
    elif kind == "sun":  # Pillow writes neither Sun rasters nor XPM
        with open(path, "wb") as fh:
            fh.write(chip_smoke.sun_raster(np.asarray(im), 24))
    elif kind == "xpm":
        idx, colours = chip_smoke.quantised(np.asarray(im), 4)
        with open(path, "wb") as fh:
            fh.write(chip_smoke.xpm_file(idx, colours, 1))
    elif kind.endswith("tiff"):
        im.convert("YCbCr" if kind.startswith("uncompressed YCbCr") else "LAB").save(path)
    elif kind == "12-bit jpeg":
        _sof_rewritten(path, rng, 0xC1, precision=12)
    elif kind == "hierarchical jpeg":
        _sof_rewritten(path, rng, 0xC5)
    elif kind == "2-component jpeg":
        _sof_rewritten(path, rng, 0xC0, components=2)


@pytest.mark.parametrize("kind", sorted(UNSUPPORTED))
def test_unsupported_formats_raise_their_named_error(tmp_path, kind):
    """The kinds the readers leave out (ROADMAP.md) raise
    UnsupportedImageError with "not supported yet"; where Pillow reads
    the file, the refusal is a gap of the port, named. The kinds Pillow
    does not read either (uncompressed YCbCr and CIELAB TIFF, 12-bit,
    hierarchical and 2-component JPEG: the JAX package fails on them) are
    refused without "yet". JPEG 2000 (.jp2 and .j2k) and AVIF, refused
    here until the port read them, now decode to the JAX package's planes
    instead."""
    ext, pillow_reads = UNSUPPORTED[kind]
    path = str(tmp_path / f"u.{ext}")
    _unsupported(kind, path)
    if pillow_reads:
        with Image.open(path) as im:
            im.load()
    if kind in NOW_READ:
        src_j, rgb_j = _jax_load(path)
        src_t = timages.SourceImage.load(path)
        np.testing.assert_array_equal(src_t.img, src_j.img)
        np.testing.assert_array_equal(src_t.load_rgb_plane(), rgb_j)
        return
    if kind in PILLOW_REFUSES_TOO:
        assert isinstance(_jax_load(path), Exception)
        with pytest.raises(UnsupportedImageError, match=PILLOW_REFUSES_TOO[kind]) as err:
            timages.SourceImage.load(path)
        assert "yet" not in str(err.value)
        return
    with pytest.raises(UnsupportedImageError, match="not supported yet"):
        timages.SourceImage.load(path)


@pytest.mark.parametrize("kind", ["gif", "webp", "ico", "icns", "dib", "im", "msp", "xbm", "xpm",
                                  "sun", "dds", "blp"])
def test_formats_once_refused_decode_to_pillows_planes(tmp_path, kind):
    """GIF, WebP, ICO, ICNS, DIB, IM, MSP, XBM, XPM, Sun raster, DDS and
    BLP, which the readers refused by name until they took them
    (tests/test_torch_gif_webp.py, tests/test_torch_icons_codecs.py,
    tests/test_torch_legacy_rasters.py and tests/test_torch_block_textures.py
    hold them in depth): the same 24x24 image, as Pillow writes it (an
    uncompressed RGB DDS, a BLP2 palette file; for XPM and Sun raster,
    which Pillow does not write, chip_smoke.py's writers), now reads as the
    JAX package reads it."""
    path = str(tmp_path / f"u.{kind}")
    _unsupported(kind, path)
    (src_j, rgb_j) = _jax_load(path)
    src_t = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src_t.img, src_j.img)
    np.testing.assert_array_equal(src_t.load_rgb_plane(), rgb_j)
    assert _meta(timages.read_metadata(path)) == _meta(jimages.read_metadata(path))


def _jpeg_scans(data: bytes) -> list[tuple[int, int]]:
    """(start, end) of each scan of a JPEG: its SOS marker to the end of
    its entropy-coded data."""
    from cybervision_tpu_torch.imageio import jpeg

    scans = []
    for off, n, *_ in jpeg.parse(data).scans:
        scans.append((data.rfind(b"\xff\xda", 0, off), off + n))
    return scans


def test_progressive_jpeg_needing_block_smoothing_raises():
    """A progressive file whose last refinement scan is cut leaves AC
    1-9 of a component unrefined: libjpeg decodes it with block
    smoothing. The port, which refused it until it smoothed too, now
    raises nothing: its planes are Pillow's, and differ from the plain
    decode. Cutting a scan that leaves every such coefficient refined
    (the first AC scan of Y's 1-5 band, refined later) needs no
    smoothing. tests/test_torch_jpeg_codings.py holds smoothing in depth."""
    from cybervision_tpu_torch.imageio import jpeg

    buf = io.BytesIO()
    Image.fromarray(_texture(np.random.RandomState(9), 40, 50, 3)).save(
        buf, "JPEG", progressive=True)
    data = buf.getvalue()
    scans = _jpeg_scans(data)
    assert len(scans) == 10  # libjpeg's jpeg_simple_progression for YCbCr
    for cut, smoothed in ((9, True), (7, True), (1, False)):
        start, end = scans[cut]
        broken = data[:start] + data[end:]
        with Image.open(io.BytesIO(broken)) as im:
            ref = np.asarray(im.convert("RGB"))
        parsed = jpeg.parse(broken)
        assert parsed.needs_smoothing == smoothed
        np.testing.assert_array_equal(imageio.to_rgb(*imageio.ImageFile("JPEG", parsed).decode()), ref)
        if smoothed:
            parsed.needs_smoothing = False  # the plain decode, which libjpeg does not give
            plain = imageio.to_rgb(*imageio.ImageFile("JPEG", parsed).decode())
            assert (plain != ref).any()


@pytest.mark.parametrize("chunk", range(4))
def test_progressive_jpeg_matches_pillow_and_its_baseline_twin(chunk):
    """40 progressive JPEGs a chunk, 160 in all, written by Pillow from a
    seed: sizes 1-60 px, qualities 1-100, gray or 4:4:4 / 4:2:2 / 4:2:0,
    restart intervals and optimised Huffman tables at random, noise,
    textures and flat images. Both planes equal Pillow's and the
    baseline twin's (the same quality and sampling)."""
    from cybervision_tpu_torch.imageio import jpeg

    rng = np.random.RandomState(3000 + chunk)
    for _ in range(40):
        h, w = rng.randint(1, 61, 2)
        kind = rng.randint(3)
        px = (rng.randint(0, 256, (h, w, 3)).astype(np.uint8) if kind == 0
              else _texture(rng, h, w, 3) if kind == 1
              else np.full((h, w, 3), rng.randint(256), np.uint8))
        save = {"quality": int(rng.randint(1, 101)), "subsampling": int(rng.randint(3))}
        if rng.rand() < 0.3:
            save["restart_marker_blocks"] = int(rng.randint(1, 5))
        if rng.rand() < 0.3:
            save["optimize"] = True
        img = Image.fromarray(px[:, :, 0] if rng.rand() < 0.2 else px)
        planes = []
        for progressive in (True, False):
            buf = io.BytesIO()
            img.save(buf, "JPEG", progressive=progressive, **save)
            decoded = imageio.ImageFile("JPEG", jpeg.parse(buf.getvalue())).decode()
            planes.append((imageio.to_l(*decoded), imageio.to_rgb(*decoded)))
            if progressive:
                with Image.open(io.BytesIO(buf.getvalue())) as ref:
                    assert ref.info.get("progressive") == 1
                    ref_l, ref_rgb = np.asarray(ref.convert("L")), np.asarray(ref.convert("RGB"))
        msg = str((h, w, save))
        np.testing.assert_array_equal(planes[0][0], ref_l, err_msg=msg)
        np.testing.assert_array_equal(planes[0][1], ref_rgb, err_msg=msg)
        np.testing.assert_array_equal(planes[0][0], planes[1][0], err_msg=msg)
        np.testing.assert_array_equal(planes[0][1], planes[1][1], err_msg=msg)


def _misread(kind, path, twin, rng):
    """A valid TIFF that Pillow 12.1 misreads or refuses, and its twin
    with the same pixels in a layout Pillow reads."""
    text = SEM_TEXT.format(bar=5).encode() + b"\0"
    if kind == "big-endian bigtiff":
        px, layout, twin_layout = _texture(rng, 30, 21), {"endian": ">", "big": True}, {"big": True}
    elif kind == "uncompressed planar RGB 16-bit":
        px = _texture(rng, 30, 21, 3).astype(np.uint16) * 257
        layout, twin_layout = {"planar": True}, {}
    elif kind == "uncompressed planar min-is-white":
        px, layout, twin_layout = _texture(rng, 30, 21), {"planar": True, "photometric": 0}, {
            "photometric": 0}
    elif kind == "planar RGBX 16-bit":
        px = _texture(rng, 30, 21, 4).astype(np.uint16) * 257
        layout, twin_layout = {"planar": True, "compression": 5, "extra": (0,)}, {"extra": (0,)}
    else:  # big-endian float or signed samples through a codec
        sample, compression, predictor = {
            "big-endian float, packbits": ("F32", 32773, 1),
            "big-endian float, lzw predictor 3": ("F32", 5, 3),
            "big-endian I;16S, lzw": ("I16S", 5, 1),
            "big-endian I;32S, deflate": ("I32S", 8, 1)}[kind]
        base = _texture(rng, 30, 21).astype(np.float64)
        px = (base * 1.7 - 30).astype(np.float32) if sample == "F32" else (
            (base * 5 - 300).astype(np.int16 if sample == "I16S" else np.int32))
        twin_layout = {"compression": compression, "predictor": predictor}
        layout = dict(twin_layout, endian=">")
    _tiff_file(path, px, extra_tags=[(34683, 2, text)], **layout)
    _tiff_file(twin, px, extra_tags=[(34683, 2, text)], **twin_layout)


@pytest.mark.parametrize("kind", ["big-endian bigtiff", "uncompressed planar RGB 16-bit",
                                  "uncompressed planar min-is-white", "planar RGBX 16-bit",
                                  "big-endian float, packbits", "big-endian float, lzw predictor 3",
                                  "big-endian I;16S, lzw", "big-endian I;32S, deflate"])
def test_tiffs_pillow_misreads_decode_as_their_twins(tmp_path, kind):
    """Where Pillow 12.1 misreads a valid TIFF (it cannot open a
    big-endian BigTIFF; its uncompressed planar path unpacks each plane
    with one character of the raw mode, so 16-bit planes come out wrong
    and min-is-white is not inverted; it refuses planar RGBX at 16 bits;
    it reads libtiff's decoded float and signed samples, which libtiff
    hands over in the host's byte order, as big-endian),
    the port reads it as the specification says: the planes and metadata
    the JAX package reads from the same pixels in a layout Pillow reads."""
    path, twin = str(tmp_path / "a.tif"), str(tmp_path / "twin.tif")
    _misread(kind, path, twin, np.random.RandomState(11))
    ref = _jax_load(path)
    twin_src, twin_rgb = _jax_load(twin)
    if not isinstance(ref, Exception):
        assert not np.array_equal(ref[1], twin_rgb)  # Pillow's reading is not the image
    src = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src.img, twin_src.img)
    np.testing.assert_array_equal(src.load_rgb_plane(), twin_rgb)
    assert _meta(timages.read_metadata(path)) == _meta(jimages.read_metadata(twin))
    assert src.scale == twin_src.scale != (1.0, 1.0)


def _bmp_misread(kind, path, twin, rng):
    """A valid RLE BMP that Pillow 12.1 misreads, and its twin: the same
    pixels uncompressed (a delta's skipped pixels as index 0)."""
    rle4 = kind.startswith("RLE4")
    bits = 4 if rle4 else 8
    pal = rng.randint(0, 256, (1 << bits, 3)).astype(np.uint8)
    idx = (_texture(rng, 19, 27).astype(np.int64) * len(pal) // 256).astype(np.uint8)
    file_rows = idx[::-1].copy()
    delta_at = (7, 5, 6) if "delta" in kind else None
    data = _rle_rows(file_rows, rle4, rng, delta_at=delta_at, odd_runs="odd" in kind,
                     cut_rows=False)
    _bmp_file(path, idx, bits, palette=pal, compression=2 if rle4 else 1, data=data)
    if delta_at is not None:
        file_rows[7, 5:11] = 0
    _bmp_file(twin, file_rows[::-1], bits, palette=pal)


@pytest.mark.parametrize("kind", ["RLE8 delta", "RLE4 delta", "RLE4 odd absolute runs"])
def test_bmps_pillow_misreads_decode_as_their_twins(tmp_path, kind):
    """Pillow 12.1's BmpRleDecoder reads a delta escape's two bytes and
    then two more, and an RLE4 absolute run of odd length one byte short;
    the port reads both as the BMP specification says: the planes of the
    same pixels stored uncompressed."""
    path, twin = str(tmp_path / "a.bmp"), str(tmp_path / "twin.bmp")
    _bmp_misread(kind, path, twin, np.random.RandomState(12))
    ref = _jax_load(path)
    twin_src, twin_rgb = _jax_load(twin)
    if not isinstance(ref, Exception):
        assert not np.array_equal(ref[1], twin_rgb)  # Pillow's reading is not the image
    src = timages.SourceImage.load(path)
    np.testing.assert_array_equal(src.img, twin_src.img)
    np.testing.assert_array_equal(src.load_rgb_plane(), twin_rgb)


def _refused(kind, path, rng):
    """A file of a kind Pillow 12.1 refuses."""
    if kind.startswith("tif"):
        sample, layout = {
            "tif float 64-bit": ("F64", {}),
            "tif 32-bit unsigned (MM)": ("U32", {"endian": ">"}),
            "tif uncompressed fill order 2 P 4-bit": ("P4", {"fill_order": 2}),
            "tif uncompressed fill order 2 min-is-white": ("L", {"fill_order": 2, "photometric": 0}),
            "tif fill order 2 RGBA": ("RGB", {"fill_order": 2, "extra": (2,)}),
        }[kind]
        if kind == "tif fill order 2 RGBA":
            _tiff_file(path, _texture(rng, 20, 20, 4), **layout)
        else:
            _sample_tiff(sample, **layout)[1](path, rng)
        return
    pal = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    idx = _texture(rng, 12, 13)
    if kind == "bmp 2-bit":
        _bmp_file(path, idx >> 6, 2, palette=pal[:4])
    elif kind == "bmp JPEG inside":
        _bmp_file(path, idx, 8, palette=pal, compression=4)
    elif kind == "bmp bit fields 10-10-10":
        _bmp_file(path, _texture(rng, 12, 13, 3), 32, compression=3,
                  masks=(0x3FF00000, 0xFFC00, 0x3FF, 0))
    elif kind == "bmp header of 20 bytes":
        _bmp_file(path, idx, 8, palette=pal)
        data = bytearray(open(path, "rb").read())
        data[14] = 20
        open(path, "wb").write(bytes(data))
    elif kind == "bmp RLE8 ending early":
        data = _rle_rows(idx[::-1], False, rng, cut_rows=False)
        _bmp_file(path, idx, 8, palette=pal, compression=1, data=data[: len(data) // 2] + b"\0\1")
    else:  # an RLE8 BMP with a black-and-white palette ("1")
        data = _rle_rows((idx[::-1] > 128).astype(np.uint8), False, rng, cut_rows=False)
        _bmp_file(path, idx > 128, 8, palette=np.array([[0, 0, 0], [255, 255, 255]], np.uint8),
                  compression=1, data=data)


@pytest.mark.parametrize("kind", [
    "tif float 64-bit", "tif 32-bit unsigned (MM)", "tif uncompressed fill order 2 P 4-bit",
    "tif uncompressed fill order 2 min-is-white", "tif fill order 2 RGBA", "bmp 2-bit", "bmp JPEG inside", "bmp bit fields 10-10-10",
    "bmp header of 20 bytes", "bmp RLE8 ending early", "bmp RLE8 black and white"])
def test_kinds_pillow_refuses_are_refused(tmp_path, kind):
    """Kinds Pillow 12.1 does not read (no OPEN_INFO entry or raw mode,
    a BMP depth, compression, bit-field layout or header it does not
    take, RLE data that ends before the last pixel): the JAX package's
    load raises, and so does the port's, with an ImageError the CLI
    reports as a failed run."""
    from cybervision_tpu_torch.errors import ImageError

    path = str(tmp_path / ("u." + kind[:3]))
    _refused(kind, path, np.random.RandomState(13))
    assert isinstance(_jax_load(path), Exception)
    with pytest.raises(ImageError):
        timages.SourceImage.load(path).load_rgb_plane()


def test_committed_jpeg_fixtures_decode_to_pillows_planes():
    """tests/fixtures/torch_persp_v{0,1}.jpg (BASELINE #3's views, 4:2:0,
    quality 95, EXIF 41989 = 43 in the Exif sub-IFD) decode to Pillow's L
    and RGB planes stored beside them, and carry the 43 mm focal length."""
    ref = np.load(os.path.join(FIXTURES, "torch_persp_decoded.npz"))
    for i in range(2):
        path = os.path.join(FIXTURES, f"torch_persp_v{i}.jpg")
        src = timages.SourceImage.load(path)
        np.testing.assert_array_equal(src.img, ref[f"v{i}_l"])
        np.testing.assert_array_equal(src.load_rgb_plane(), ref[f"v{i}_rgb"])
        assert src.focal_length_35mm == 43 == jimages.read_metadata(path).focal_length_35mm
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im.convert("L")), ref[f"v{i}_l"])
            assert (im.info["progressive"] if "progressive" in im.info else 0) == 0
            assert im.layer == [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]


def test_committed_progressive_fixtures_decode_to_pillows_planes():
    """tests/fixtures/torch_persp_full_v{0,1}.jpg (phase 6's pair at full
    width, progressive, 4:2:0, quality 75, EXIF 41989 = 43 in the Exif
    sub-IFD) decode to Pillow's planes, whose SHA-256 are committed for
    the card (torch_formats_sha256.json), and to their baseline twins'."""
    import hashlib
    import json

    with open(chip_smoke.FORMATS_SHA256) as fh:
        committed = json.load(fh)["decoder"]
    for path, twin in zip(chip_smoke.PERSP_FULL_JPEGS, chip_smoke.PERSP_FULL_TWINS):
        src, src_twin = timages.SourceImage.load(path), timages.SourceImage.load(twin)
        rgb = src.load_rgb_plane()
        with Image.open(path) as im:
            assert im.info.get("progressive") == 1 and im.size == (1024, 819)
            np.testing.assert_array_equal(src.img, np.asarray(im.convert("L")))
            np.testing.assert_array_equal(rgb, np.asarray(im.convert("RGB")))
        assert hashlib.sha256(src.img.tobytes()).hexdigest() == committed[os.path.basename(path)]["l"]
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == committed[os.path.basename(path)]["rgb"]
        np.testing.assert_array_equal(src.img, src_twin.img)
        np.testing.assert_array_equal(rgb, src_twin.load_rgb_plane())
        assert src.focal_length_35mm == 43 == jimages.read_metadata(path).focal_length_35mm


def test_phase8_instrument_files_decode_to_the_committed_hashes(tmp_path):
    """chip_smoke.instrument_files' pairs (phase 3's 1024x1024 SEM pair as
    gray-palette BMPs, float TIFFs, JPEG-compressed YCbCr TIFFs and RLE8
    BMPs): Pillow's L and RGB planes have the SHA-256 committed for phase
    8 (h) and (i) (torch_formats_sha256.json), and so do the port's."""
    import hashlib
    import json

    with open(chip_smoke.FORMATS_SHA256) as fh:
        committed = json.load(fh)["phase8"]
    img1, img2, _ = chip_smoke.synth_sem_pair(chip_smoke.SIZE, chip_smoke.SIZE)
    paths = [p for ps in chip_smoke.instrument_files(str(tmp_path), img1, img2).values() for p in ps]
    assert sorted(committed) == sorted(os.path.basename(p) for p in paths)
    for path in paths:
        want = committed[os.path.basename(path)]
        src = timages.SourceImage.load(path)
        with Image.open(path) as im:
            planes = {"l": np.asarray(im.convert("L")), "rgb": np.asarray(im.convert("RGB"))}
        for key, port in (("l", src.img), ("rgb", src.load_rgb_plane())):
            assert hashlib.sha256(planes[key].tobytes()).hexdigest() == want[key], path
            np.testing.assert_array_equal(port, planes[key], err_msg=path)


def test_in_memory_exif_block_reader():
    """An EXIF block as Pillow writes it, read directly: IFD0 first, the
    sub-IFD when IFD0 lacks the tag, None without either, and int() of
    the stored type."""
    from cybervision_tpu_torch.imageio.exif import exif_block_focal_length

    assert exif_block_focal_length(_exif_bytes(ifd0={41989: 43}, sub={41989: 50})) == 43
    assert exif_block_focal_length(_exif_bytes(sub={41989: 50})) == 50
    assert exif_block_focal_length(_exif_bytes(ifd0={271: "maker"})) is None
    assert exif_block_focal_length(b"Exif\x00\x00") is None


@pytest.mark.parametrize("chunk", range(6))
def test_jpeg_decoder_matches_pillow_on_seeded_files(chunk):
    """50 JPEGs a chunk, 300 in all, written by Pillow from a seed: sizes
    1-60 px, qualities 1-100, gray or 4:4:4 / 4:2:2 / 4:2:0, restart
    intervals and optimised Huffman tables at random, noise, gradients
    and flat images with one bright row. Both planes equal Pillow's."""
    import io

    from cybervision_tpu_torch.imageio import jpeg

    rng = np.random.RandomState(1000 + chunk)
    for _ in range(50):
        h, w = rng.randint(1, 61, 2)
        kind = rng.randint(3)
        if kind == 0:
            px = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        elif kind == 1:
            px = _texture(rng, h, w, 3)
        else:
            px = np.full((h, w, 3), rng.randint(256), np.uint8)
            px[rng.randint(h)] = 255
        save = {"quality": int(rng.randint(1, 101)), "subsampling": int(rng.randint(3))}
        if rng.rand() < 0.3:
            save["restart_marker_blocks"] = int(rng.randint(1, 5))
        if rng.rand() < 0.2:
            save["optimize"] = True
        img = Image.fromarray(px[:, :, 0] if rng.rand() < 0.2 else px)
        buf = io.BytesIO()
        img.save(buf, "JPEG", **save)
        with Image.open(io.BytesIO(buf.getvalue())) as ref:
            ref_l, ref_rgb = np.asarray(ref.convert("L")), np.asarray(ref.convert("RGB"))
        decoded = imageio.ImageFile("JPEG", jpeg.parse(buf.getvalue())).decode()
        np.testing.assert_array_equal(imageio.to_l(*decoded), ref_l, err_msg=str((h, w, save)))
        np.testing.assert_array_equal(imageio.to_rgb(*decoded), ref_rgb, err_msg=str((h, w, save)))
