"""Old-style JPEG-in-TIFF (compression 6) as libtiff 4.7's tif_ojpeg.c
decodes it for Pillow. Pillow opens such a file as YCbCr whatever its
photometric tag says: with 8-bit samples, one sample is "L" (read strip
by strip), three are "RGB" (through libtiff's TIFFRGBAImage); libtiff
reads IFD0 itself (_directory), takes a missing or RGB photometric tag
for YCbCr and a missing sample count for 3 (YCbCr) or 1.

libtiff reads the file's JPEG data as one stream: the
JPEGInterchangeFormat (513) bytes, if the tag points inside the file
(their length, 514, clamped to it), then each strip or tile in turn.
Its header pass reads the markers there (SOI, APPn and COM skipped, DQT
of 8-bit tables, DHT, DRI, SOF0/1/3, up to SOS; any other marker is an
error) and stops at the first SOS or at a byte that is not a marker;
without an SOF, the tables come from JPEGQTables, JPEGDCTables and
JPEGACTables (519-521, one per sample; the same offset as the sample
before shares its table) and the frame is baseline, the first sample
sampled YCbCrSubSampling (530, default 2x2), the others 1x1. JPEGProc
(512) is not read: a file that says lossless decodes as baseline. A
frame covers the strips (its width the image's) or a column of tiles;
libtiff writes its own stream for libjpeg: SOI, the tables, a DRI (the
stream's, else the MCUs of one strip when there are several, else
JPEGRestartInterval), the frame (of the samples of one plane), an SOS,
then the entropy-coded data from where the header pass stopped, each
strip after the first led by an RSTn marker, and EOI; a restart marker
that is not the next RSTn fails (libtiff's resync), and no row past the
last strip or tile is decoded.

The frame's sampling corrects YCbCrSubSampling (OJPEGSubsamplingCorrect).
Colour samples are read raw (jpeg_read_raw_data: neither upsampled nor
converted) and TIFFRGBAImage repeats each chroma sample over its block
of luma samples (no fancy upsampling) and converts with libtiff's own
tables (tif_color.c: TIFFYCbCrToRGBInit with YCbCrCoefficients, 529,
and ReferenceBlackWhite, 532): jpeg.decode_raw and ycbcr_rgb here.
Planar files (PlanarConfiguration 2) are decoded plane by plane, each a
one-component frame whose data follows its own SOS in the stream; they
need 1x1 sampling.

Refused, by name: layouts where libtiff errs, or reads uninitialised
memory and Pillow returns what its buffer held (frames of another size
than the strips', tiles in more than one column, sides past 65535);
lossless frames (SOF3: libtiff asks libjpeg for raw samples, which a
lossless frame has none of); sampling factors TIFF does not allow;
Orientation other than 1; sample layouts Pillow misreads.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio import exif as ifd
from cybervision_tpu_torch.imageio import jpeg
from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    UnsupportedImageError,
    native_missing,
)

_JIF, _JIF_LEN, _RESTART = 513, 514, 515
_QTABLES, _DCTABLES, _ACTABLES = 519, 520, 521
_COEFFICIENTS, _SUBSAMPLING, _REFERENCE = 529, 530, 532
_ORIENTATION = 274


def _chunks(data: bytes, offsets: tuple, counts: tuple) -> list[tuple[int, int]]:
    """(file offset, length) of each strip or tile as libtiff's
    OJPEGReadBufferFill reads it: an offset of 0 or past the file is
    empty, a byte count of 0 runs to the file's end, one past it is
    clamped."""
    n = len(data)
    out = []
    for k, pos in enumerate(offsets):
        count = counts[k] if k < len(counts) else 0
        if pos == 0 or pos >= n:
            out.append((0, 0))
        else:
            out.append((pos, n - pos if count == 0 or pos + count > n else count))
    return out


class _Stream:
    """The bytes libtiff's header pass reads: the interchange stream, then
    the strips, each a (file offset, length, is a strip) piece."""

    def __init__(self, data: bytes, pieces: list[tuple[int, int, bool]]):
        self.data, self.pieces = data, pieces
        self.piece, self.at = 0, 0

    def _settle(self) -> None:
        while self.piece < len(self.pieces) and self.at >= self.pieces[self.piece][1]:
            self.piece, self.at = self.piece + 1, 0

    def peek(self) -> int | None:
        self._settle()
        if self.piece >= len(self.pieces):
            return None
        return self.data[self.pieces[self.piece][0] + self.at]

    def byte(self) -> int:
        b = self.peek()
        if b is None:
            raise CorruptImageError("old-style JPEG data ends in its markers")
        self.at += 1
        return b

    def block(self, n: int) -> bytes:
        return bytes(self.byte() for _ in range(n))

    def word(self) -> int:
        return self.byte() << 8 | self.byte()

    def rest(self, strips: int) -> tuple[bytes, bool]:
        """The entropy-coded data from here on: what is left of this
        piece, then every later one, an RSTn after each strip that is
        not the last (libtiff's OJPEGWriteStreamCompressed); and whether
        libtiff ends it with EOI (after the last strip's data), where it
        otherwise fails once libjpeg asks for more."""
        self._settle()
        out, rst, eoi = bytearray(), 0, False
        for k in range(self.piece, len(self.pieces)):
            pos, n, strip_index = self.pieces[k]
            start = self.at if k == self.piece else 0
            out += self.data[pos + start : pos + n]
            if strip_index >= 0 and n:
                eoi = strip_index + 1 == strips
                if not eoi:
                    out += bytes([0xFF, 0xD0 + rst])
                    rst = (rst + 1) % 8
        return bytes(out), eoi


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


class _Header:
    def __init__(self):
        self.qtables: dict[int, bytes] = {}
        self.dc: dict[int, bytes] = {}
        self.ac: dict[int, bytes] = {}
        self.restart: int | None = None
        self.sof = None  # (marker, height, width, [(id, hv, tq)])
        self.sos = None  # [(id, table byte)]


def _header_pass(s: _Stream, h: _Header, spp_plane: int) -> None:
    """OJPEGReadHeaderInfoSec's marker loop, to the first SOS or the
    first byte that is not a marker."""
    if s.peek() is None:
        raise CorruptImageError("old-style JPEG-in-TIFF without data")
    while True:
        m = s.peek()
        if m != 0xFF:
            return
        s.byte()
        while m == 0xFF:
            m = s.byte()
        if m == 0xD8:
            continue
        if m == 0xFE or 0xE0 <= m <= 0xEF:
            n = s.word()
            if n < 2:
                raise CorruptImageError("Corrupt JPEG data")
            s.block(n - 2)
        elif m == 0xDD:
            if s.word() != 4:
                raise CorruptImageError("Corrupt DRI marker in JPEG data")
            h.restart = s.word()
        elif m == 0xDB:
            n = s.word()
            if n <= 2:
                raise CorruptImageError("Corrupt DQT marker in JPEG data")
            n -= 2
            while n:
                if n < 65:
                    raise CorruptImageError("Corrupt DQT marker in JPEG data")
                body = s.block(65)
                if body[0] & 0xF0 or body[0] > 3:
                    raise CorruptImageError("Corrupt DQT marker in JPEG data")
                h.qtables[body[0]] = body
                n -= 65
        elif m == 0xC4:
            n = s.word()
            if n <= 2:
                raise CorruptImageError("Corrupt DHT marker in JPEG data")
            body = s.block(n - 2)
            cls, tid = body[0] >> 4, body[0] & 15
            if cls > 1 or tid > 3:
                raise CorruptImageError("Corrupt DHT marker in JPEG data")
            (h.ac if cls else h.dc)[tid] = body
        elif m in (0xC0, 0xC1, 0xC3):
            if h.sof is not None:
                raise CorruptImageError("Corrupt JPEG data: a second frame")
            n = s.word()
            body = s.block(n - 2) if n >= 11 else b""
            if n < 11 or body[0] != 8 or n != 8 + 3 * body[5]:
                raise CorruptImageError("Corrupt SOF marker in JPEG data")
            height, width = struct.unpack_from(">HH", body, 1)
            h.sof = (m, height, width, [tuple(body[6 + 3 * k : 9 + 3 * k])
                                        for k in range(body[5])])
        elif m == 0xDA:
            n = s.word()
            if n != 6 + 2 * spp_plane:
                raise CorruptImageError("Corrupt SOS marker in JPEG data")
            body = s.block(n - 2)
            if body[0] != spp_plane:
                raise CorruptImageError("Corrupt SOS marker in JPEG data")
            h.sos = [tuple(body[1 + 2 * k : 3 + 2 * k]) for k in range(spp_plane)]
            return
        else:
            raise CorruptImageError(f"Unknown marker type {m} in JPEG data")


def _next_sos(s: _Stream, spp_plane: int) -> list:
    """OJPEGReadSecondarySos: on to the next SOS marker, and its tables."""
    while True:
        if s.byte() != 0xFF:
            continue
        m = 0xFF
        while m == 0xFF:
            m = s.byte()
        if m == 0xDA:
            break
    n = s.word()
    body = s.block(n - 2) if n == 6 + 2 * spp_plane else b""
    if not body or body[0] != spp_plane:
        raise CorruptImageError("Corrupt SOS marker in JPEG data")
    return [tuple(body[1 + 2 * k : 3 + 2 * k]) for k in range(spp_plane)]


def _tag_tables(t, spp: int, h: _Header) -> None:
    """The tables of JPEGQTables, JPEGDCTables and JPEGACTables
    (OJPEGReadHeaderInfoSecTables*): component k's table k, or the table
    of the component before when the offsets are equal."""
    data = t.data
    tq, tda = [], []
    for tag, kind in ((_QTABLES, "q"), (_DCTABLES, "dc"), (_ACTABLES, "ac")):
        offsets = t.values(tag, ())
        if len(offsets) > 3:
            raise CorruptImageError("JPEG tables tag has an incorrect count")
        ids = []
        if not all(isinstance(v, int) for v in offsets):
            raise CorruptImageError("Missing JPEG tables")
        for k in range(spp):
            pos = offsets[k] if k < len(offsets) else 0
            if pos == 0:
                raise CorruptImageError("Missing JPEG tables")
            if k and pos == offsets[k - 1]:
                ids.append(ids[-1])
                continue
            if kind == "q":
                body = data[pos : pos + 64]
                if len(body) < 64:
                    raise CorruptImageError("JPEG quantisation table past the file's end")
                h.qtables[k] = bytes([k]) + body
            else:
                counts = data[pos : pos + 16]
                total = sum(counts)
                if len(counts) < 16 or total > 256 or pos + 16 + total > len(data):
                    raise CorruptImageError("JPEG Huffman table past the file's end")
                body = bytes([(kind == "ac") << 4 | k]) + data[pos : pos + 16 + total]
                (h.ac if kind == "ac" else h.dc)[k] = body
            ids.append(k)
        (tq if kind == "q" else tda).append(ids)
    h.tq = tq[0]
    h.tda = [dc << 4 | ac for dc, ac in zip(tda[0], tda[1])]


def _stream(h: _Header, comps: list, sos: list, height: int, width: int, restart: int,
            rest: tuple[bytes, bool]) -> bytes:
    """libtiff's stream for libjpeg: SOI, DQT, DHT, DRI, the frame of
    `comps` (id, hv, tq), SOS of `sos` (id, tables), data, EOI."""
    out = bytearray(b"\xff\xd8")
    for k in sorted(h.qtables):
        out += _segment(0xDB, h.qtables[k])
    for tables in (h.dc, h.ac):
        for k in sorted(tables):
            out += _segment(0xC4, tables[k])
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    out += _segment(h.sof[0], struct.pack(">BHHB", 8, height, width, len(comps))
                    + b"".join(bytes(c) for c in comps))
    out += _segment(0xDA, bytes([len(sos)]) + b"".join(bytes(c) for c in sos) + b"\x00\x3f\x00")
    # The frame's one scan holds every component, so libjpeg reads no
    # marker after its data: the data ends at the first marker that is
    # not RSTn.
    data, eoi = rest
    end = jpeg.SEGMENT_END.search(data)
    if end is None and not eoi:
        raise CorruptImageError("Premature end of JPEG data")
    return bytes(out + (data if end is None else data[: end.start()]) + b"\xff\xd9")


def ycbcr_tables(coefficients=None, reference=None) -> dict:
    """libtiff's TIFFYCbCrToRGBInit tables, built in float32 as it builds
    them (luma defaults 0.299, 0.587, 0.114; reference black and white 0,
    255, 128, 255, 128, 255): {"Cr_r", "Cb_b", "Cr_g", "Cb_g", "Y"}, each
    256 int64 entries."""
    f32 = np.float32
    luma = [f32(v) for v in (coefficients or (0.299, 0.587, 0.114))]
    rbw = [f32(v) for v in (reference or (0, 255, 128, 255, 128, 255))]

    def fix(v):
        return int(float(min(max(v, f32(0)), f32(2))) * 65536 + 0.5)

    f1 = f32(2) - f32(2) * luma[0]
    f3 = f32(2) - f32(2) * luma[2]
    d1, d2 = fix(f1), -fix(luma[0] * f1 / luma[1])
    d3, d4 = fix(f3), -fix(luma[2] * f3 / luma[1])

    def code2v(c, rb, rw, cr):
        span = rw - rb
        return (c.astype(f32) - rb) * f32(cr) / (span if span != 0 else f32(1))

    x = np.arange(256) - 128
    lo, hi = f32(-128 * 32), f32(128 * 32)
    cr = np.clip(code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127), lo, hi).astype(np.int64)
    cb = np.clip(code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127), lo, hi).astype(np.int64)
    return {"Cr_r": (d1 * cr + 32768) >> 16, "Cb_b": (d3 * cb + 32768) >> 16,
            "Cr_g": d2 * cr, "Cb_g": d4 * cb + 32768,
            "Y": np.clip(code2v(x + 128, rbw[0], rbw[1], 255), lo, hi).astype(np.int64)}


def ycbcr_rgb(ycc: np.ndarray, coefficients=None, reference=None) -> np.ndarray:
    """(..., 3) YCbCr -> RGB uint8 as libtiff's TIFFYCbCrtoRGB converts
    with ycbcr_tables."""
    return _planes_rgb(ycc[..., 0], ycc[..., 1], ycc[..., 2], coefficients, reference)


def _planes_rgb(y, cb, cr, coefficients=None, reference=None) -> np.ndarray:
    t = ycbcr_tables(coefficients, reference)
    # Every table entry and sum fits 16 bits; green's two terms are one
    # table over (Cb, Cr).
    g = ((t["Cb_g"][:, None] + t["Cr_g"][None, :]) >> 16).astype(np.int16)
    y = t["Y"].astype(np.int16)[y]
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = np.clip(y + t["Cr_r"].astype(np.int16)[cr], 0, 255)
    out[..., 1] = np.clip(y + g[cb, cr], 0, 255)
    out[..., 2] = np.clip(y + t["Cb_b"].astype(np.int16)[cb], 0, 255)
    return out


# The tags libtiff's TIFFReadDirectory fails on when their type or count
# is wrong or their values lie past the file (it ignores the others); of
# the strip and tile tables only the type is checked.
_CORE = (256, 257, 258, 259, 277, 278, 284, 322, 323, 338, 339)
_TABLES = (273, 279, 324, 325)
_INTEGERS = (1, 3, 4, 6, 8, 9, 13, 16, 17, 18)


def _directory(t):
    """IFD0 as libtiff reads it for Pillow's decoder (TIFFFetchDirectory
    and TIFFReadDirectory): an entry count it cannot read, or a tag it
    needs (_CORE) of an unknown type, of another count or past the file,
    fails; another entry past the file is skipped (where Pillow's parser
    stops); the first of two entries of a tag wins. Returns the file with
    those entries, and the raw (type, count, value field) of the strip
    and tile tables, which strile_table reads."""
    count_size, entry_size = (8, 20) if t.big else (2, 12)
    count = int.from_bytes(t.data[t.ifd0 : t.ifd0 + count_size],
                           "little" if t.endian == "<" else "big")
    if count > (1 << 16 if t.big else 4096) or \
            t.ifd0 + count_size + entry_size * count > len(t.data):
        raise CorruptImageError("Can not read TIFF directory")
    fmt = t.endian + ("HHQ8s" if t.big else "HHI4s")
    tables = {}
    for k in range(count):
        tag, typ, n, field = struct.unpack_from(fmt, t.data,
                                                t.ifd0 + count_size + entry_size * k)
        if tag in tables or tag not in _CORE + _TABLES:
            continue
        tables[tag] = (typ, n, field)
        if typ not in ifd.TYPES:
            raise CorruptImageError(f"TIFF tag {tag} of unknown type {typ}")
        size = n * ifd.TYPES[typ][0]
        at = int.from_bytes(field, "little" if t.endian == "<" else "big")
        if tag in _CORE and (typ not in _INTEGERS or n != 1 and tag not in (258, 338, 339)
                             or size > len(field) and at + size > len(t.data)):
            raise CorruptImageError(f"TIFF tag {tag} of {n} values past the file's end")
    entries = ifd.read_ifd(t.data, t.ifd0, t.endian, t.big, every_entry=True)
    return dataclasses.replace(t, entries=entries), {k: v for k, v in tables.items()
                                                     if k in _TABLES}


def _strile_table(t, raw: dict, tag: int, n_striles: int) -> tuple:
    """TIFFFetchStripThing: the first `n_striles` values of a strip or
    tile table (of an integer type; zeros past a short table), or the
    failure where they lie past the file."""
    if tag not in raw:
        return ()
    typ, n, field = raw[tag]
    if typ not in _INTEGERS:
        raise CorruptImageError(f"TIFF tag {tag} of type {typ}, not integers")
    unit, code = ifd.TYPES[typ]
    code = code or "B"
    keep = min(n, n_striles)
    if n * unit <= len(field):
        values = field[: keep * unit]
    else:
        at = int.from_bytes(field, "little" if t.endian == "<" else "big")
        values = t.data[at : at + keep * unit]
        if len(values) < keep * unit:
            raise CorruptImageError(f"TIFF tag {tag} past the file's end")
    out = struct.unpack(t.endian + code * keep, values)
    return out + (0,) * (n_striles - keep)


def _int(t, tag: int, default: int) -> int:
    """A one-number tag as libtiff reads it: a BYTE where it reads a
    SHORT is that byte; another type or count is ignored (the default)."""
    value = t.get(tag, default)
    if isinstance(value, bytes) and len(value) == 1:
        value = value[0]
    return value if isinstance(value, int) else default


def decode(t, native) -> tuple[str, np.ndarray, None]:
    """("L", (H, W)) or ("RGB", (H, W, 3)) uint8 of an old-style
    JPEG-in-TIFF, as Pillow reads it through libtiff."""
    if native is None:
        raise native_missing("old-style JPEG-in-TIFF")
    # Pillow's OPEN_INFO for photometric 6 (which it takes the file to
    # be), on the tags its own parser read: "L" or "RGB".
    p_spp = t.get(277, 3)
    bps = t.values(258, (1,))
    if p_spp in (1, 3):
        bps = bps * p_spp if len(bps) == 1 else bps[:p_spp]
    if p_spp not in (1, 3) or bps != (8,) * p_spp or t.values(339, (1,))[:1] != (1,) \
            or t.get(266, 1) != 1 or t.values(338, ()):
        raise UnsupportedImageError(
            f"old-style JPEG-in-TIFF of {p_spp} samples of {bps} bits is not supported: Pillow"
            " has no mode for it")
    t, raw = _directory(t)
    width, height = t.get(256), t.get(257)
    # libtiff's OJPEG fixes: photometric missing or RGB is YCbCr, samples
    # per pixel missing 3 for YCbCr and 1 otherwise.
    photometric = _int(t, 262, 6)
    if photometric == 2:
        photometric = 6
    spp = _int(t, 277, 3 if photometric == 6 else 1)
    colour = p_spp == 3
    if (spp, photometric == 6) != ((3, True) if colour else (1, False)):
        raise UnsupportedImageError(
            f"old-style JPEG-in-TIFF of {spp} samples with photometric {photometric} is not"
            f" supported: Pillow opens it as {'RGB' if colour else 'L'} and misreads it")
    if _int(t, _ORIENTATION, 1) != 1:
        raise UnsupportedImageError("old-style JPEG-in-TIFF with an Orientation other than 1 is"
                                    " not supported")
    planar = _int(t, 284, 1)
    if planar not in (1, 2):
        raise CorruptImageError(f"TIFF PlanarConfiguration {planar}")
    if width > 0xFFFF or height > 0xFFFF:
        raise UnsupportedImageError("old-style JPEG-in-TIFF past 65535 samples a side is not"
                                    " supported: a JPEG frame cannot hold it")
    tiled = 322 in t.entries
    if tiled:
        sw, sl = _int(t, 322, 0), _int(t, 323, 0)
        if sw < 1 or sl < 1:
            raise CorruptImageError("TIFF with bad tile dimensions")
        if -(-width // sw) != 1:
            raise UnsupportedImageError("old-style JPEG-in-TIFF with more than one column of"
                                        " tiles is not supported: libtiff decodes past its frame")
        total = -(-height // sl) * sl
    else:
        sw, sl = width, min(_int(t, 278, height), height) or height
        total = height
    planes = spp if planar == 2 else 1
    n_striles = -(-height // sl) * planes
    offsets = _strile_table(t, raw, 324 if tiled else 273, n_striles)
    counts = _strile_table(t, raw, 325 if tiled else 279, n_striles)
    chunks = _chunks(t.data, offsets, counts)
    # libtiff requires the offsets, but for one strip (its OJPEG hack).
    if not offsets and (tiled or n_striles != 1):
        raise CorruptImageError(f"TIFF directory is missing required"
                                f" {'TileOffsets' if tiled else 'StripOffsets'}")
    n = len(t.data)
    pieces = []
    jif = _int(t, _JIF, 0)
    if jif and jif < n:
        length = _int(t, _JIF_LEN, 0)
        if length == 0 or jif + length > n:
            length = n - jif
        pieces.append((jif, length, -1))
    pieces += [(pos, count, k) for k, (pos, count) in enumerate(chunks)]
    stream = _Stream(t.data, pieces)
    spp_plane = 1 if planar == 2 else spp
    # Subsampling: the tag (default 2x2), corrected by the frame's.
    # libtiff keeps the tag's values as bytes.
    hs, vs = ((v & 0xFF for v in (t.values(_SUBSAMPLING, (2, 2)) + (2,))[:2]) if colour
              else (1, 1))
    head = _Header()
    _header_pass(stream, head, spp_plane)
    if head.sof is not None and colour:
        hv = head.sof[3][0][1]
        hs, vs = hv >> 4, hv & 15
        if hs not in (1, 2, 4) or vs not in (1, 2, 4) or any(c[1] != 0x11 for c in head.sof[3][1:]):
            raise UnsupportedImageError(
                "old-style JPEG-in-TIFF whose frame's sampling TIFF does not allow is not"
                " supported (libtiff upsamples it inside libjpeg)")
    restart = _int(t, _RESTART, 0)
    if sl < height:
        if hs not in (1, 2, 4) or vs not in (1, 2, 4):
            raise CorruptImageError("Invalid subsampling values")
        if sl % (vs * 8):
            raise CorruptImageError("Incompatible vertical subsampling and image strip/tile"
                                    " length")
        restart = -(-sw // (hs * 8)) * (sl // (vs * 8))
    if head.restart is not None:
        restart = head.restart
    if head.sof is None:
        if head.sos is not None:
            raise CorruptImageError("old-style JPEG data with a scan before its frame")
        _tag_tables(t, spp, head)
        sampling = [hs << 4 | vs] + [0x11] * (spp - 1)
        head.sof = (0xC0, total, sw, [(k, sampling[k], head.tq[k]) for k in range(spp)])
        head.sos = [(k, head.tda[k]) for k in range(spp)]
    marker, f_height, f_width, comps = head.sof
    if marker == 0xC3:
        raise UnsupportedImageError("lossless old-style JPEG-in-TIFF (SOF3) is not supported:"
                                    " libtiff asks libjpeg for raw samples, which it has none of")
    if len(comps) != spp:
        raise CorruptImageError("JPEG compressed data indicates unexpected number of samples")
    if (f_height < height and f_height < total) or (f_width < width and f_width < sw) \
            or f_width > sw:
        raise CorruptImageError("JPEG compressed data indicates an unexpected frame size")
    if f_width != sw or f_height < height:
        raise UnsupportedImageError("old-style JPEG-in-TIFF whose frame is narrower than its"
                                    " strips is not supported (libtiff leaves rows unwritten)")
    if head.sos is None:
        raise CorruptImageError("old-style JPEG data without a scan")
    strips = len(chunks)
    # libtiff decodes the frame no further than its last strip or tile
    # row: a taller frame's rows past it are never read.
    rows = min(f_height, total)
    if rows > 0xFFFF:
        raise UnsupportedImageError("old-style JPEG-in-TIFF past 65535 samples a side is not"
                                    " supported: a JPEG frame cannot hold it")
    if planar == 2 and colour and comps[0][1] != 0x11:
        raise UnsupportedImageError("planar old-style JPEG-in-TIFF with subsampled chroma is"
                                    " not supported: libtiff has no conversion for it")
    if planar == 2 or not colour:
        planes = []
        sos = head.sos
        for s in range(spp):
            if s:
                sos = _next_sos(stream, spp_plane)
            # A copy: each plane's data runs from its own SOS on.
            at = _Stream(t.data, pieces)
            at.piece, at.at = stream.piece, stream.at
            data = _stream(head, [comps[s]] if planar == 2 else comps, sos, rows, f_width,
                           restart, at.rest(strips))
            parsed = jpeg.parse(data)
            parsed.color = 0
            _, px, _ = jpeg.decode(parsed, native, strict_restarts=True)
            planes.append(px[:height, :width])
        if not colour:
            return "L", np.ascontiguousarray(planes[0]), None
    else:
        data = _stream(head, comps, head.sos, rows, f_width, restart, stream.rest(strips))
        parsed = jpeg.parse(data)
        y, cb, cr = jpeg.decode_raw(parsed, native, strict_restarts=True)
        block_rows, block_cols = np.arange(height) // vs, np.arange(width) // hs
        planes = (y[:height, :width], cb[block_rows][:, block_cols],
                  cr[block_rows][:, block_cols])
    coefficients = t.values(_COEFFICIENTS, ()) or None
    reference = t.values(_REFERENCE, ()) or None
    return "RGB", _planes_rgb(*planes, coefficients, reference), None
