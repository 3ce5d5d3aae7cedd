"""JPEG container: SOI, APPn (APP0 JFIF, APP1 Exif, APP14 Adobe), DQT,
DHT, DAC, SOF0-SOF3, SOF9, SOF10, DRI, SOS with its entropy-coded segment
and the RSTn markers inside it, EOI. The native library decodes the scans
(native/imagedecode.cpp); without it a JPEG cannot be read.

Metadata follows Pillow's reader: the markers before the first SOS; the
EXIF block is the first APP1 "Exif\\0\\0" payload with every later one's
appended after its prefix. A frame of another precision than 8 bits, or
of 2 or more than 4 components, fails Pillow's open (SyntaxError), so
Pillow tries its other plugins: parse raises NotThisFormat. Pixels follow
libjpeg-turbo's defaults for sequential, progressive and lossless files,
Huffman or arithmetic coded, of 1 component ("L"), 3 ("RGB": YCbCr
converted unless an Adobe marker without JFIF says the file stores RGB,
or the component ids spell R, G, B, or the file is lossless without
either marker) or 4 ("CMYK": YCCK converted when the Adobe marker's
transform is not 0, then inverted as Pillow's "CMYK;I" raw mode reads
every 4-component JPEG). A progressive file whose last scans leave some of
the first ten coefficients of a component unrefined is decoded with
libjpeg-turbo's block smoothing (jdcoefct.c smoothing_ok).

libjpeg-turbo refuses hierarchical (SOF5-SOF7, SOF13-SOF15) and
arithmetic-coded lossless (SOF11) files, and lossless files it would have
to convert from YCbCr or YCCK; so does the port (UnsupportedImageError).
"""

from __future__ import annotations

import dataclasses
import re
import struct

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    TruncatedImageError,
    UnsupportedImageError,
    native_missing,
)

# Zigzag index -> natural (row-major) index in an 8x8 block (DQT stores
# its tables in zigzag order).
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
# The end of an entropy-coded segment: 0xFF neither stuffed (0xFF00) nor
# starting a restart marker.
SEGMENT_END = re.compile(rb"\xff(?![\x00\xd0-\xd7])")
_HUFF_SPEC = 16 + 256
# Frame markers: (progressive, arithmetic, lossless) of the ones read.
_CODINGS = {0xC0: (False, False, False), 0xC1: (False, False, False), 0xC2: (True, False, False),
            0xC3: (False, False, True), 0xC9: (False, True, False), 0xCA: (True, True, False)}
_SOF_MARKERS = (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)
# libjpeg's defaults of the arithmetic conditioning (DAC) at SOI: L, U, Kx.
_DAC_DEFAULT = np.concatenate([np.zeros(16), np.ones(16), np.full(16, 5)]).astype(np.uint8)


@dataclasses.dataclass
class JpegFile:
    data: bytes
    exif: bytes | None
    width: int
    height: int
    components: list  # (id, h, v, quant table id)
    color: int  # 0: as stored, 1: YCbCr -> RGB, 2: YCCK -> CMYK
    progressive: bool
    # Each scan: (segment offset, segment length, restart interval,
    # [(component index, dc table, ac table)], Huffman tables (8, 272),
    # (Ss, Se, Ah, Al), arithmetic conditioning (48,): L, U, Kx of tables
    # 0-15). A lossless scan's Ss is its predictor, Al its point transform.
    scans: list
    quant: np.ndarray  # (n components, 64) uint16, natural order
    needs_smoothing: bool = False
    arithmetic: bool = False
    lossless: bool = False
    # Per component, the bits still unsent of zigzag coefficients 0-9
    # after the last scan (-1: never sent), what smoothing reads.
    coef_bits: np.ndarray | None = None

    @property
    def mode(self) -> str:
        return {1: "L", 3: "RGB", 4: "CMYK"}[len(self.components)]


def _segment(data: bytes, pos: int) -> tuple[bytes, int]:
    if pos + 2 > len(data):
        raise TruncatedImageError("JPEG marker segment past the file's end")
    (n,) = struct.unpack_from(">H", data, pos)
    body = data[pos + 2 : pos + n]
    if n < 2 or len(body) < n - 2:
        raise TruncatedImageError("JPEG marker segment past the file's end")
    return body, pos + n


def parse(data: bytes, metadata_only: bool = False) -> JpegFile:
    """The markers of a JPEG file, up to its first scan when
    `metadata_only` (what Pillow reads on open), else to EOI."""
    if not data.startswith(b"\xff\xd8\xff"):
        raise CorruptImageError("not a JPEG file")
    pos = 2
    exif = None
    frame = None
    jfif = adobe = False
    transform = 1
    restart = 0
    progressive = arithmetic = lossless = False
    coef_bits = None
    dac = _DAC_DEFAULT.copy()
    qt: dict[int, np.ndarray] = {}
    huff = np.zeros((8, _HUFF_SPEC), np.uint8)
    latched: dict[int, np.ndarray] = {}
    scans: list = []
    while True:
        # Skip fill bytes (0xFF runs) and any bytes before a marker.
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            if scans:
                break  # no EOI after the last scan
            raise TruncatedImageError("JPEG ends before its image data")
        marker = data[pos]
        pos += 1
        if not scans and marker < 0xC0:
            # Pillow's open, up to the first scan: 0xFF00 is skipped, any
            # other marker below 0xFFC0 fails it (the file passes on).
            if marker == 0x00:
                continue
            raise NotThisFormat("no marker found")
        if marker == 0xD9:  # EOI
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            continue  # TEM, stray RSTn / SOI: no segment
        body, pos = _segment(data, pos)
        if 0xE0 <= marker <= 0xEF:
            if marker == 0xE0 and body.startswith(b"JFIF\x00") and len(body) >= 14:
                jfif = True
            elif marker == 0xE1 and body.startswith(b"Exif\x00\x00") and not scans:
                exif = body if exif is None else exif + body[6:]
            elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
                adobe, transform = True, body[11]
        elif marker == 0xDB:  # DQT
            k = 0
            while k < len(body):
                pq, tq = body[k] >> 4, body[k] & 15
                n = 128 if pq else 64
                raw = body[k + 1 : k + 1 + n]
                if len(raw) < n or tq > 3:
                    raise CorruptImageError("bad DQT segment")
                vals = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.uint16)
                table = np.zeros(64, np.uint16)
                table[_NATURAL] = vals
                qt[tq] = table
                k += 1 + n
        elif marker == 0xC4:  # DHT
            k = 0
            while k < len(body):
                tc, th = body[k] >> 4, body[k] & 15
                counts = body[k + 1 : k + 17]
                total = sum(counts)
                vals = body[k + 17 : k + 17 + total]
                if len(counts) < 16 or len(vals) < total or tc > 1 or th > 3 or total > 256:
                    raise CorruptImageError("bad DHT segment")
                spec = np.zeros(_HUFF_SPEC, np.uint8)
                spec[:16] = np.frombuffer(counts, np.uint8)
                spec[16 : 16 + total] = np.frombuffer(vals, np.uint8)
                huff[tc * 4 + th] = spec
                k += 17 + total
        elif marker == 0xDD:  # DRI
            if len(body) < 2:
                raise CorruptImageError("bad DRI segment")
            (restart,) = struct.unpack_from(">H", body)
        elif marker == 0xCC:  # DAC
            if len(body) % 2:
                raise CorruptImageError("bad DAC segment")
            for index, value in zip(body[0::2], body[1::2]):
                if index >= 32:
                    raise CorruptImageError("bad DAC segment")
                if index >= 16:
                    dac[32 + index - 16] = value
                elif value & 15 > value >> 4:
                    raise CorruptImageError("bad DAC segment: L above U")
                else:
                    dac[index], dac[16 + index] = value & 15, value >> 4
        elif marker in _SOF_MARKERS:
            # Pillow's SOF handler: another precision or layer count fails
            # its open, and Image.open goes on to the next plugin.
            if not body or body[0] != 8:
                raise NotThisFormat(f"cannot handle {body[0] if body else '?'}-bit layers")
            if len(body) < 6 or body[5] not in (1, 3, 4):
                raise NotThisFormat(f"cannot handle {body[5] if len(body) > 5 else '?'}-layer images")
            if frame is not None:
                raise CorruptImageError("JPEG with two frames")
            height, width, n = struct.unpack_from(">HHB", body, 1)
            if len(body) < 6 + 3 * n:
                raise CorruptImageError("bad SOF segment")
            frame = (width, height,
                     [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                       body[8 + 3 * i]) for i in range(n)])
            if marker not in _CODINGS and not metadata_only:
                # Pillow opens the file; libjpeg-turbo fails on it at load.
                kind = "arithmetic-coded lossless" if marker == 0xCB else "hierarchical"
                raise UnsupportedImageError(
                    f"{kind} JPEG (SOF{marker - 0xC0}) is not supported: libjpeg-turbo, which"
                    " Pillow decodes with, does not decode it either")
            progressive, arithmetic, lossless = _CODINGS.get(marker, (False, False, False))
            coef_bits = np.full((n, 64), -1, np.int64)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise CorruptImageError("JPEG scan before its frame")
            if metadata_only:
                break
            ns = body[0] if body else 0
            if ns < 1 or ns > 4 or len(body) < 4 + 2 * ns:
                raise CorruptImageError("bad SOS segment")
            ids = [c[0] for c in frame[2]]
            members = []
            for i in range(ns):
                cid, tables = body[1 + 2 * i], body[2 + 2 * i]
                if cid not in ids:
                    raise CorruptImageError("JPEG scan of an unknown component")
                ci = ids.index(cid)
                members.append((ci, tables >> 4, tables & 15))
                if ci not in latched and not lossless:  # lossless files have no DQT
                    tq = frame[2][ci][3]
                    if tq not in qt:
                        raise CorruptImageError(f"JPEG quantisation table {tq} is not defined")
                    latched[ci] = qt[tq].copy()
            ss, se, a = body[1 + 2 * ns : 4 + 2 * ns]
            ah, al = a >> 4, a & 15
            if not arithmetic:
                if not scans and not progressive and not lossless:
                    _standard_tables(huff)
                _check_tables(huff, members, progressive, lossless, ss, ah)
            if lossless:
                # jdlossls.c start_pass_lossless: a predictor 1-7, Pt below
                # the precision.
                if not 1 <= ss <= 7 or se or ah or al >= 8:
                    raise CorruptImageError(
                        f"bad lossless JPEG scan (Ss {ss}, Se {se}, Ah {ah}, Al {al})")
            elif progressive:
                _check_progression(ss, se, ah, al, ns)
                for ci, _, _ in members:
                    coef_bits[ci, ss : se + 1] = al
            else:
                # libjpeg only warns when a sequential scan's band is not
                # the whole block, and decodes it as one.
                ss, se, ah, al = 0, 63, 0, 0
            m = SEGMENT_END.search(data, pos)
            if m is None:
                raise TruncatedImageError("JPEG image data is truncated")
            scans.append((pos, m.start() - pos, restart, members, huff.copy(), (ss, se, ah, al),
                          dac.copy()))
            pos = m.start()
        # COM and the other segments: skipped.
    if frame is None:
        raise CorruptImageError("JPEG without a frame")
    width, height, comps = frame
    if len(comps) == 3:
        if jfif:
            color = 1
        elif adobe:
            color = int(transform != 0)
        else:
            # jdapimin.c: unknown ids are YCbCr in a DCT file, RGB in a
            # lossless one.
            color = int([c[0] for c in comps] != [82, 71, 66] and not lossless)
    elif len(comps) == 4:
        # jdapimin.c: Adobe transform 0 is CMYK, any other YCCK; no Adobe
        # marker, CMYK.
        color = 2 if adobe and transform != 0 else 0
    else:
        color = 0
    quant = np.stack([latched.get(i, np.zeros(64, np.uint16)) for i in range(len(comps))])
    smoothing = bool(scans) and progressive and _smoothing_ok(coef_bits, quant)
    return JpegFile(data, exif, width, height, comps, color, progressive, scans, quant, smoothing,
                    arithmetic, lossless, coef_bits[:, :10])


def _standard_tables(huff: np.ndarray) -> None:
    """libjpeg-turbo's jinit_huff_decoder (std_huff_tables): DC and AC
    tables 0 and 1 still undefined when a sequential frame starts
    decoding are Annex K's (Motion JPEG frames leave them out)."""
    from cybervision_tpu_torch.imageio.jpeg_encode import STD_HUFF

    for row, spec in zip((0, 4, 1, 5), STD_HUFF):
        if not huff[row, :16].any():
            huff[row] = 0
            huff[row, : len(spec)] = np.frombuffer(spec, np.uint8)


def _check_tables(huff: np.ndarray, members: list, progressive: bool, lossless: bool, ss: int,
                  ah: int) -> None:
    """jdhuff.c jpeg_make_d_derived_tbl's checks of the tables a Huffman
    scan reads (fatal in libjpeg): no code of all ones or past its
    length, DC symbols at most 15 (16 lossless)."""
    need_dc = not progressive or (ss == 0 and ah == 0)
    need_ac = not lossless and (not progressive or ss > 0)
    rows = {td for _, td, _ in members} if need_dc else set()
    rows |= {4 + ta for _, _, ta in members} if need_ac else set()
    if any(td > 3 or ta > 3 for _, td, ta in members) and rows:
        raise CorruptImageError("JPEG scan of a Huffman table past 3")
    for row in rows:
        counts = huff[row, :16].astype(np.int64)
        if not counts.any():
            continue  # not defined: the native decoder refuses the scan
        sizes = np.flatnonzero(counts) + 1
        code = 0
        for size in range(sizes[0], sizes[-1] + 1):
            code += int(counts[size - 1])
            if code >= 1 << size:
                raise CorruptImageError("Bogus Huffman table definition")
            code <<= 1
        if row < 4 and (huff[row, 16 : 16 + counts.sum()] > (16 if lossless else 15)).any():
            raise CorruptImageError("Bogus Huffman table definition")


def _check_progression(ss: int, se: int, ah: int, al: int, ns: int) -> None:
    """jdphuff.c start_pass_phuff_decoder's checks, which libjpeg treats
    as fatal (JERR_BAD_PROGRESSION)."""
    if ss == 0:
        bad = se != 0
    else:
        bad = ss > se or se > 63 or ns != 1
    if (ah != 0 and al != ah - 1) or al > 13 or bad:
        raise CorruptImageError(f"bad progressive JPEG scan (Ss {ss}, Se {se}, Ah {ah}, Al {al})")


# Natural positions of the DC and the first nine AC coefficients: the ones
# libjpeg-turbo's block smoothing looks at (SAVED_COEFS).
_SMOOTHED = _NATURAL[:10]


def _smoothing_ok(coef_bits: np.ndarray, quant: np.ndarray) -> bool:
    """libjpeg-turbo's jdcoefct.c smoothing_ok after the last scan: every
    component's DC at least partly known and its quantisers nonzero, and
    some component with one of AC 1-9 still unrefined (or never sent)."""
    if (quant[:, _SMOOTHED] == 0).any() or (coef_bits[:, 0] < 0).any():
        return False
    return bool((coef_bits[:, 1:10] != 0).any())


def decode(jpg: JpegFile, native, strict_restarts: bool = False) -> tuple[str, np.ndarray, None]:
    """(mode, pixels, None): "L" (H, W), "RGB" (H, W, 3) or "CMYK" (H, W, 4)
    uint8. `strict_restarts`: a restart marker that is not the next RSTn
    fails the decode (libjpeg's resync as libtiff's old-style JPEG codec
    sets it up) instead of being resynchronised."""
    px = _decode(jpg, native, 32 * strict_restarts)
    if jpg.mode == "CMYK":
        px = 255 - px  # Pillow reads every 4-component JPEG as "CMYK;I"
    return jpg.mode, px, None


def decode_raw(jpg: JpegFile, native, strict_restarts: bool = False) -> list[np.ndarray]:
    """Each component's samples at its own resolution over the whole MCU
    grid (rows, columns) uint8, neither upsampled nor colour converted:
    what libjpeg's jpeg_read_raw_data hands over (libtiff's old-style
    JPEG codec reads colour this way). `strict_restarts` as for decode."""
    if jpg.lossless:
        raise UnsupportedImageError("raw samples of a lossless JPEG are not supported: libjpeg"
                                    " gives none")
    return _decode(jpg, native, 16 | 32 * strict_restarts)


def _decode(jpg: JpegFile, native, flags: int):
    if native is None:
        raise native_missing("JPEG")
    if not jpg.scans:
        raise CorruptImageError("JPEG without a scan")
    if {ci for scan in jpg.scans for ci, _, _ in scan[3]} != set(range(len(jpg.components))):
        raise TruncatedImageError("JPEG whose scans leave a component out")
    if jpg.lossless and jpg.color:
        raise UnsupportedImageError(
            f"lossless JPEG in {'YCbCr' if jpg.color == 1 else 'YCCK'} is not supported:"
            " libjpeg-turbo, which Pillow decodes with, converts no colour space of a lossless"
            " file")
    coding = (int(jpg.progressive) | 2 * int(jpg.arithmetic) | 4 * int(jpg.lossless)
              | 8 * int(jpg.needs_smoothing) | flags)
    frame = [jpg.width, jpg.height, len(jpg.components), jpg.color, coding]
    for _, h, v, _ in jpg.components:
        frame += [h, v]
    frame += jpg.coef_bits.reshape(-1).tolist()
    scans = np.zeros((len(jpg.scans), 20), np.int32)
    for s, (off, n, ri, members, _, band, _) in enumerate(jpg.scans):
        scans[s, :8] = (off, n, ri, len(members), *band)
        for j, member in enumerate(members):
            scans[s, 8 + 3 * j : 11 + 3 * j] = member
    huff = np.stack([scan[4] for scan in jpg.scans])
    cond = np.stack([scan[6] for scan in jpg.scans])
    return native.jpeg_decode(jpg.data, np.asarray(frame, np.int32), jpg.quant, scans, huff,
                              cond, len(jpg.components))
