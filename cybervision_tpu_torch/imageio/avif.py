"""AVIF container, as Pillow's AvifImagePlugin opens and loads a file
through libavif 1.3 (avifDecoderParse, then avifDecoderNthImage(0) and
avifImageYUVToRGB), without Pillow.

Opening parses the ISOBMFF boxes as libavif's avifParse does: the ftyp
box first, with a compatible brand libavif takes (avif or avis), then
the top-level boxes up to the meta box an avif brand needs and the moov
box an avis brand needs, each read whole (a cut one is truncated data);
mdat is not read then. The meta box: hdlr (pict) first, pitm, iloc
(versions 0-2, construction methods 0 and 1 with idat; libavif fails
the parse on method 2), iinf with infe versions 2 and 3, iref (auxl,
cdsc) and iprp (ipco, ipma). A sequence whose major brand is avis is
read from its tracks (moov/trak/tkhd for the size, .../stbl: stsd av01,
stsz, stco or co64, stsc), as libavif's AUTO source does;
otherwise from the primary item, an av01 item or a grid derived item
(Grid: its ImageGrid payload and rows x cols av01 tiles named by dimg).
The alpha is the item (or track) that names the colour one through auxl
and carries the alpha auxC URN, an av01 or a grid item as well.
libavif's parse failures that Pillow's plugin raises as SyntaxError
(INVALID_FTYP, BMFF_PARSE_FAILED, TRUNCATED_DATA, NO_CONTENT) raise
NotThisFormat, so identify passes the file on as Image.open does; the
others raise.

Pillow's info["exif"] is the Exif item's payload after its 4-byte TIFF
header offset. Where the irot/imir orientation differs from the EXIF's
own, Pillow re-serialises the EXIF with the orientation set
(AvifImagePlugin.py:99-108); that keeps every other tag, the focal
length with them, so the focal length is read from the payload. Pillow
applies neither irot nor imir to the pixels, nor clap.

Loading decodes the first frame's AV1 OBUs in the native library
(av1obu.cpp and its siblings: a key frame of 8, 10 or 12 bits, with its
quantizer matrices, superres and film grain), scales a frame that is not
its item's ispe size (or its track's) to it as libavif does
(native.avif_scale: libyuv's box filter, each plane; a grid's tiles each
to their own item's), stitches a grid's tiles in YUV, and converts the
image once to 8-bit RGB, or RGBA where there is alpha, as
libavif does through libyuv or its own float path, by the colr (else the
AV1 sequence header's) matrix coefficients and colour primaries
(avifrgb.cpp); the depth is the AV1 stream's, whatever av1C and pixi say,
and the alpha's must be the colour's. A premultiplied alpha (a prem
reference) is divided out after the conversion, as libavif does for
Pillow's RGBA. Without the native library an AVIF raises
NativeDecoderError.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from cybervision_tpu_torch.imageio.errors import (
    CorruptImageError,
    NotThisFormat,
    TruncatedImageError,
    bomb_check,
    native_missing,
)

_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")


class _Syntax(Exception):
    """A libavif parse failure that Pillow's plugin raises as SyntaxError."""


@dataclasses.dataclass
class Grid:
    """A grid derived item (ImageGrid, HEIF 6.6.2.3): rows x cols tiles,
    each the (offset, length) extents of an av01 item and its ispe size,
    in its dimg order, cropped to the output size."""

    rows: int
    cols: int
    width: int
    height: int
    tiles: list  # [(extents, (width, height))]


@dataclasses.dataclass
class AvifFile:
    """What opening found: the size (the primary item's ispe), Pillow's
    mode, the first frame's colour and alpha payloads (lists of (offset,
    length) extents in `data`, or a Grid of them), and the metadata the
    CLI reads."""

    data: bytes
    size: tuple[int, int]
    mode: str
    color: list | Grid
    alpha: list | Grid | None
    exif: bytes | None = None
    nclx: tuple[int, int, int, int] | None = None
    premultiplied: bool = False
    timescale: int | None = None  # a sequence's


# -- boxes ------------------------------------------------------------------------


def _u16(b, o):
    return struct.unpack_from(">H", b, o)[0]


def _u32(b, o):
    return struct.unpack_from(">I", b, o)[0]


def _uint(b, o, n):
    return int.from_bytes(b[o:o + n], "big") if n else 0


def _boxes(b: bytes, start: int, end: int):
    """(type, content start, content end) of the boxes in b[start:end];
    a box that overruns its parent or a malformed header is a parse
    failure."""
    pos = start
    while pos < end:
        if end - pos < 8:
            raise _Syntax("box header cut")
        size, typ, hdr = _u32(b, pos), b[pos + 4:pos + 8], 8
        if size == 1:
            if end - pos < 16:
                raise _Syntax("box header cut")
            size, hdr = struct.unpack_from(">Q", b, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        if typ == b"uuid":
            hdr += 16
        if size < hdr or pos + size > end:
            raise _Syntax(f"box {typ!r} overruns its parent")
        yield typ, pos + hdr, pos + size
        pos += size


def _full(b, s, e):
    """(version, flags, content start) of a FullBox."""
    if e - s < 4:
        raise _Syntax("FullBox header cut")
    return b[s], _uint(b, s + 1, 3), s + 4


def _need(s, n, e):
    if s + n > e:
        raise _Syntax("box content cut")


# -- meta -------------------------------------------------------------------------


@dataclasses.dataclass
class _Item:
    id: int
    type: bytes = b""
    content_type: bytes = b""
    extents: list = dataclasses.field(default_factory=list)
    construction: int = 0
    props: list = dataclasses.field(default_factory=list)  # (type, start, end)
    refs: dict = dataclasses.field(default_factory=dict)    # type -> [to ids]


def _hdlr(b, s, e, handlers=(b"pict",)):
    """libavif's handler box checks: version 0, pre_defined 0, the
    handler, three reserved words and a terminated name."""
    v, _, p = _full(b, s, e)
    _need(p, 20, e)
    if v != 0 or _u32(b, p) != 0 or (handlers and b[p + 4:p + 8] not in handlers):
        raise _Syntax("hdlr is not version 0 with the expected handler")
    _cstring(b, p + 20, e)
    return b[p + 4:p + 8]


def _cstring(b, s, e):
    z = b.find(b"\0", s, e)
    if z < 0:
        raise _Syntax("string not terminated")
    return b[s:z], z + 1


def _parse_meta(b: bytes, s: int, e: int) -> tuple[dict, int | None, tuple | None]:
    """(items by id, primary item id, idat (start, end))."""
    v, _, s = _full(b, s, e)
    if v != 0:
        raise _Syntax("meta version")
    items: dict[int, _Item] = {}
    primary = idat = None
    props: list = []
    assoc: list = []
    first = True
    seen = set()
    for typ, cs, ce in _boxes(b, s, e):
        if first and typ != b"hdlr":
            raise _Syntax("meta does not start with hdlr")
        first = False
        if typ in seen and typ in (b"hdlr", b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref"):
            raise _Syntax(f"more than one {typ!r}")
        seen.add(typ)
        if typ == b"hdlr":
            _hdlr(b, cs, ce)
        elif typ == b"pitm":
            v, _, p = _full(b, cs, ce)
            _need(p, 2 if v == 0 else 4, ce)
            primary = _u16(b, p) if v == 0 else _u32(b, p)
        elif typ == b"idat":
            idat = (cs, ce)
        elif typ == b"iloc":
            _parse_iloc(b, cs, ce, items)
        elif typ == b"iinf":
            v, _, p = _full(b, cs, ce)
            _need(p, 2 if v == 0 else 4, ce)
            count = _u16(b, p) if v == 0 else _u32(b, p)
            p += 2 if v == 0 else 4
            entries = list(_boxes(b, p, ce))
            if len(entries) != count or any(t2 != b"infe" for t2, _, _ in entries):
                raise _Syntax("iinf's entries are not its count of infe boxes")
            for t2, s2, e2 in entries:
                iv, _, q = _full(b, s2, e2)
                if iv not in (2, 3):
                    raise _Syntax("infe version other than 2 or 3")
                _need(q, (2 if iv == 2 else 4) + 6, e2)
                iid = _u16(b, q) if iv == 2 else _u32(b, q)
                q += (2 if iv == 2 else 4) + 2
                item = items.setdefault(iid, _Item(iid))
                item.type = b[q:q + 4]
                q += 4
                _, q = _cstring(b, q, e2)
                if item.type == b"mime":
                    item.content_type, q = _cstring(b, q, e2)
        elif typ == b"iref":
            v, _, p = _full(b, cs, ce)
            if v > 1:
                continue  # libavif passes over an iref of a later version
            w = 2 if v == 0 else 4
            for t2, s2, e2 in _boxes(b, p, ce):
                _need(s2, w + 2, e2)
                frm, n = _uint(b, s2, w), _u16(b, s2 + w)
                if s2 + w + 2 + n * w != e2:
                    raise _Syntax(f"iref {t2!r} box does not hold its {n} references")
                tos = [_uint(b, s2 + w + 2 + k * w, w) for k in range(n)]
                items.setdefault(frm, _Item(frm)).refs.setdefault(t2, []).extend(tos)
        elif typ == b"iprp":
            for t2, s2, e2 in _boxes(b, cs, ce):
                if t2 == b"ipco":
                    props = list(_boxes(b, s2, e2))
                elif t2 == b"ipma":
                    assoc.append((s2, e2))
    for s2, e2 in assoc:
        v, flags, p = _full(b, s2, e2)
        _need(p, 4, e2)
        n, p = _u32(b, p), p + 4
        for _ in range(n):
            w = 2 if v < 1 else 4
            _need(p, w + 1, e2)
            iid, count = _uint(b, p, w), b[p + w]
            p += w + 1
            item = items.setdefault(iid, _Item(iid))
            for _ in range(count):
                big = flags & 1
                _need(p, 2 if big else 1, e2)
                raw = _u16(b, p) if big else b[p]
                p += 2 if big else 1
                index = raw & (0x7FFF if big else 0x7F)
                if index == 0:
                    continue
                if index > len(props):
                    raise _Syntax("property index past ipco")
                item.props.append(props[index - 1])
    return items, primary, idat


def _parse_iloc(b, s, e, items):
    v, _, p = _full(b, s, e)
    if v > 2:
        raise _Syntax("iloc version")
    _need(p, 2, e)
    off_size, len_size = b[p] >> 4, b[p] & 15
    base_size, index_size = b[p + 1] >> 4, (b[p + 1] & 15) if v in (1, 2) else 0
    p += 2
    for size in (off_size, len_size, base_size, index_size):
        if size not in (0, 4, 8):
            raise _Syntax("iloc field size")
    w = 2 if v < 2 else 4
    _need(p, w, e)
    count, p = _uint(b, p, w), p + w
    for _ in range(count):
        _need(p, w, e)
        iid, p = _uint(b, p, w), p + w
        method = 0
        if v in (1, 2):
            _need(p, 2, e)
            method, p = _u16(b, p) & 15, p + 2
            if method not in (0, 1):  # construction method 2, item offsets
                raise _Syntax(f"iloc construction method {method} (libavif: unsupported)")
        _need(p, 2 + base_size + 2, e)
        p += 2  # data_reference_index
        base, p = _uint(b, p, base_size), p + base_size
        n, p = _u16(b, p), p + 2
        item = items.setdefault(iid, _Item(iid))
        if item.extents:
            raise _Syntax("item located twice")
        item.construction = method
        for _ in range(n):
            _need(p, index_size + off_size + len_size, e)
            p += index_size
            off, p = _uint(b, p, off_size), p + off_size
            length, p = _uint(b, p, len_size), p + len_size
            item.extents.append((base + off, length))


def _prop(item: _Item, b: bytes, typ: bytes):
    for t, s, e in item.props:
        if t == typ:
            return s, e
    return None


# -- moov (an avis sequence's tracks) ---------------------------------------------------


@dataclasses.dataclass
class _Track:
    id: int = 0
    width: int = 0
    height: int = 0
    first_sample: tuple | None = None  # (offset, length)
    has_av01: bool = False
    auxl: list = dataclasses.field(default_factory=list)
    alpha: bool = False
    timescale: int = 0


def _child(b, s, e, path):
    for typ, cs, ce in _boxes(b, s, e):
        if typ == path[0]:
            return (cs, ce) if len(path) == 1 else _child(b, cs, ce, path[1:])
    return None


def _parse_trak(b: bytes, s: int, e: int) -> _Track:
    t = _Track()
    tkhd = _child(b, s, e, [b"tkhd"])
    if tkhd:
        v, _, p = _full(b, *tkhd)
        if v > 1:
            raise _Syntax("tkhd version")
        _need(p, 92 if v == 1 else 80, tkhd[1])
        t.id = _u32(b, p + (16 if v == 1 else 8))
        # The track's size (16.16), to which libavif scales its frames.
        t.width, t.height = (_u32(b, p + (84 if v == 1 else 72) + 4 * k) >> 16 for k in range(2))
    tref = _child(b, s, e, [b"tref"])
    if tref:
        for typ, cs, ce in _boxes(b, *tref):
            if typ == b"auxl":
                t.auxl += [_u32(b, q) for q in range(cs, ce - 3, 4)]
    edts = _child(b, s, e, [b"edts"])
    if edts is not None:  # libavif takes one edit list of one entry
        elst = _child(b, *edts, [b"elst"])
        if elst is None:
            raise _Syntax("edts without elst")
        v, _, p = _full(b, *elst)
        _need(p, 4, elst[1])
        if v > 1 or _u32(b, p) != 1:
            raise _Syntax("elst other than one entry")
        _need(p + 4, 20 if v == 1 else 12, elst[1])
    mdhd = _child(b, s, e, [b"mdia", b"mdhd"])
    if mdhd is not None:
        v, _, p = _full(b, *mdhd)
        if v > 1:
            raise _Syntax("mdhd version")
        _need(p, 20 if v == 1 else 12, mdhd[1])
        t.timescale = _u32(b, p + (16 if v == 1 else 8))
    hdlr = _child(b, s, e, [b"mdia", b"hdlr"])
    if hdlr is None:
        return t
    _hdlr(b, *hdlr, handlers=None)  # a track's handler may be any
    stbl = _child(b, s, e, [b"mdia", b"minf", b"stbl"])
    if stbl is None:
        return t
    for kind in (b"stts", b"stss"):  # version 0, entries within the box
        box = _child(b, *stbl, [kind])
        if box is not None:
            v, _, p = _full(b, *box)
            _need(p, 4, box[1])
            if v != 0:
                raise _Syntax(f"{kind.decode()} version")
            _need(p + 4, _u32(b, p) * (8 if kind == b"stts" else 4), box[1])
    stsd = _child(b, *stbl, [b"stsd"])
    if stsd:
        v, _, p = _full(b, *stsd)
        _need(p, 4, stsd[1])
        entries = list(_boxes(b, p + 4, stsd[1]))
        if v != 0 or _u32(b, p) != len(entries):
            raise _Syntax("stsd's count is not its entries'")
        for typ, cs, ce in entries:
            if typ == b"av01":
                t.has_av01 = True
                _need(cs, 78, ce)
                config = False
                for t2, s2, e2 in _boxes(b, cs + 78, ce):
                    if t2 == b"av1C":
                        config = e2 - s2 >= 4 and b[s2] == 0x81
                    if t2 == b"auxi" and b[s2 + 4:e2].rstrip(b"\0") in _ALPHA_URNS:
                        t.alpha = True
                if not config:
                    raise _Syntax("av01 sample entry without a valid av1C")
    t.first_sample = _samples(b, stbl)
    return t


def _samples(b: bytes, stbl) -> tuple | None:
    """The first sample's (offset, length), after every sample of the
    table is placed within the file, as libavif checks them against its
    size hint (a sample past the end is a parse failure)."""
    sizes = _child(b, *stbl, [b"stsz"])
    wide = _child(b, *stbl, [b"stco"]) is None
    offsets = _child(b, *stbl, [b"co64" if wide else b"stco"])
    chunks = _child(b, *stbl, [b"stsc"])
    if sizes is None or offsets is None or chunks is None:
        raise _Syntax("sample table without stsz, stco or stsc")
    v, _, p = _full(b, *sizes)
    _need(p, 8, sizes[1])
    fixed, count = _u32(b, p), _u32(b, p + 4)
    if not fixed:
        _need(p + 8, 4 * count, sizes[1])
    sample_sizes = [fixed] * count if fixed else [_u32(b, p + 8 + 4 * k) for k in range(count)]
    _, _, q = _full(b, *offsets)
    _need(q, 4, offsets[1])
    n_chunks = _u32(b, q)
    w = 8 if wide else 4
    _need(q + 4, w * n_chunks, offsets[1])
    chunk_offsets = [_uint(b, q + 4 + w * k, w) for k in range(n_chunks)]
    _, _, r = _full(b, *chunks)
    _need(r, 4, chunks[1])
    n_runs = _u32(b, r)
    _need(r + 4, 12 * n_runs, chunks[1])
    runs = [(_u32(b, r + 4 + 12 * k), _u32(b, r + 8 + 12 * k)) for k in range(n_runs)]
    placed = []
    sample = 0
    for k, (first_chunk, per_chunk) in enumerate(runs):
        last = runs[k + 1][0] - 1 if k + 1 < len(runs) else n_chunks
        if first_chunk < 1 or last > n_chunks:
            raise _Syntax("stsc names a chunk stco lacks")
        for chunk in range(first_chunk, last + 1):
            at = chunk_offsets[chunk - 1]
            for _ in range(per_chunk):
                if sample >= count:
                    raise _Syntax("stsc places more samples than stsz sizes")
                if at + sample_sizes[sample] > len(b):
                    raise _Syntax("a sample runs past the end of the file")
                placed.append((at, sample_sizes[sample]))
                at += sample_sizes[sample]
                sample += 1
    if sample != count or not placed:
        raise _Syntax("stsc and stsz disagree on the sample count")
    return placed[0]


# -- parse ----------------------------------------------------------------------------


def _brands(b, s, e):
    _need(s, 8, e)
    return b[s:s + 4], [b[q:q + 4] for q in range(s + 8, e - 3, 4)]


def parse(data: bytes) -> AvifFile:
    try:
        return _parse(data)
    except _Syntax as err:
        raise NotThisFormat(f"AVIF: {err}") from None
    except struct.error:
        raise NotThisFormat("AVIF: a box is cut") from None


def _parse(b: bytes) -> AvifFile:
    end = len(b)
    pos = 0
    major = None
    needs_meta = needs_moov = False
    meta = moov = None
    while pos < end:
        if end - pos < 8:
            raise _Syntax("truncated box header")
        size, typ, hdr = _u32(b, pos), b[pos + 4:pos + 8], 8
        if size == 1:
            if end - pos < 16:
                raise _Syntax("truncated box header")
            size, hdr = struct.unpack_from(">Q", b, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        if size < hdr:
            raise _Syntax("box size below its header")
        if major is None and typ != b"ftyp":
            raise _Syntax("the file does not start with ftyp")
        if typ in (b"ftyp", b"meta", b"moov") and pos + size > end:
            raise _Syntax("truncated data")
        cs, ce = pos + hdr, pos + size
        if typ == b"ftyp":
            major, compatible = _brands(b, cs, ce)
            brands = [major] + compatible
            if b"avif" not in brands and b"avis" not in brands:
                raise _Syntax("ftyp names neither avif nor avis")
            needs_meta, needs_moov = b"avif" in brands, b"avis" in brands
        elif typ == b"meta":
            meta = (cs, ce)
        elif typ == b"moov":
            moov = (cs, ce)
        pos += size
        if major is not None and (not needs_meta or meta) and (not needs_moov or moov):
            break
    if major is None:
        raise _Syntax("no ftyp")
    if (needs_meta and not meta) or (needs_moov and not moov):
        raise _Syntax("truncated data: the file ends before its meta or moov box")
    items, primary, idat = _parse_meta(b, *meta) if meta else ({}, None, None)
    tracks = [_parse_trak(b, s, e) for t, s, e in _boxes(b, *moov) if t == b"trak"] if moov else []
    f = AvifFile(data=b, size=(0, 0), mode="RGB", color=[], alpha=None)
    if major == b"avis":
        color = next((t for t in tracks if t.has_av01 and not t.auxl), None)
        if color is None or color.first_sample is None:
            raise _Syntax("no colour track with samples")
        alpha = next((t for t in tracks if color.id in t.auxl and t.first_sample), None)
        f.size = (color.width, color.height)
        f.color = [color.first_sample]
        f.alpha = [alpha.first_sample] if alpha else None
        # Pillow's load divides the first frame's times by the timescale.
        f.timescale = color.timescale
        # The meta box's items still give the metadata.
    elif primary is None or primary not in items:
        raise _Syntax("no primary item")
    if not f.color:
        item = items[primary]
        if item.type not in (b"av01", b"grid"):
            raise CorruptImageError(f"AVIF primary item of type {item.type!r}")
        f.color = _image(b, items, item, idat)
        f.size = _ispe(b, item)
        f.nclx = _nclx(b, item)
        for other in items.values():  # libavif skips an item with no data
            if (primary in other.refs.get(b"auxl", []) and other.type in (b"av01", b"grid")
                    and sum(n for _, n in other.extents)):
                aux = _prop(other, b, b"auxC")
                if aux and b[aux[0] + 4:aux[1]].split(b"\0")[0] in _ALPHA_URNS:
                    f.alpha = _image(b, items, other, idat)
                    if _ispe(b, other) != f.size:
                        raise CorruptImageError("AVIF alpha item of another size")
                    if primary in other.refs.get(b"prem", []) or other.id in items[
                            primary].refs.get(b"prem", []):
                        f.premultiplied = True
    f.mode = "RGBA" if f.alpha else "RGB"
    for item in items.values():
        if item.type == b"Exif" and primary in item.refs.get(b"cdsc", []):
            extents = _extents(b, item, idat)
            if any(o + n > len(b) for o, n in extents):
                raise _Syntax("truncated data: the Exif item runs past the end of the file")
            payload = b"".join(b[o:o + n] for o, n in extents)
            if len(payload) < 4:
                raise CorruptImageError("AVIF Exif payload shorter than its offset field")
            f.exif = payload[4:]
            break
    if major == b"avis":
        # Read from its tracks, a sequence's items need only their ispe.
        if primary in items:
            _ispe(b, items[primary])
    else:
        for item in items.values():  # the colour item and its alpha, and their tiles
            if item.id == primary or (primary in item.refs.get(b"auxl", [])
                                      and item.type in (b"av01", b"grid")):
                tiles = ([items[t] for t in item.refs.get(b"dimg", []) if t in items]
                         if item.type == b"grid" else [])
                _check_tile_configs(b, tiles)
                _check_properties(b, item, tiles[0] if tiles else item)
                for tile in tiles:
                    _check_properties(b, tile, tile)
    if f.size[0] <= 0 or f.size[1] <= 0:
        raise CorruptImageError("AVIF image of no size")
    bomb_check(f.size, "AVIF image")
    return f


def _image(b, items: dict, item: _Item, idat):
    """The payload of an av01 item (its extents) or a grid item (Grid)."""
    if item.type == b"grid":
        return _grid(b, items, item, idat)
    extents = _sized(b, item, idat)
    if not sum(n for _, n in extents):  # libavif's MISSING_IMAGE_ITEM
        raise CorruptImageError("AVIF: missing or empty image item")
    return extents


def _sized(b, item: _Item, idat) -> list:
    """An av01 item's extents, which libavif's parse holds to the file's
    size (its avifIO sizeHint) as a whole; an extent cut by the end of the
    file fails only the load."""
    extents = _extents(b, item, idat)
    if sum(n for _, n in extents) > len(b):
        raise _Syntax(f"item {item.id} is larger than the file")
    return extents


def _grid(b, items: dict, item: _Item, idat) -> Grid:
    """libavif's parse of a grid item: its ImageGrid payload (version 0;
    flags bit 0 for 32-bit output sizes; no byte left over; a non-zero
    output size), then rows x cols av01 tiles named by its dimg
    references, in their order. A fault is libavif's INVALID_IMAGE_GRID,
    which Pillow's open raises."""
    extents = _extents(b, item, idat)
    if any(o + n > len(b) for o, n in extents):
        raise _Syntax("truncated data: the grid item runs past the end of the file")
    p = b"".join(b[o:o + n] for o, n in extents)
    wide = len(p) >= 2 and p[1] & 1
    if len(p) != (12 if wide else 8) or p[0] != 0:
        raise CorruptImageError("AVIF: invalid image grid (its ImageGrid payload)")
    rows, cols = p[2] + 1, p[3] + 1
    width, height = struct.unpack_from(">II" if wide else ">HH", p, 4)
    if not width or not height:
        raise CorruptImageError("AVIF: invalid image grid of no size")
    ids = item.refs.get(b"dimg", [])
    if len(ids) != rows * cols:
        raise CorruptImageError(f"AVIF: invalid image grid: {rows}x{cols} tiles need"
                                f" {rows * cols} dimg references, not {len(ids)}")
    tiles = []
    for tid in ids:
        tile = items.get(tid)
        if tile is None or tile.type != b"av01":
            raise CorruptImageError(f"AVIF: invalid image grid: tile {tid} is not an av01 item")
        extents = _sized(b, tile, idat)
        if not sum(n for _, n in extents):  # every tile's sample has data
            raise _Syntax(f"grid tile {tid} is empty")
        size = _ispe(b, tile)
        if not size[0] or not size[1]:
            raise CorruptImageError(f"AVIF: grid tile {tid} of no size")
        tiles.append((extents, size))
    return Grid(rows, cols, width, height, tiles)


def _check_tile_configs(b, tiles: list) -> None:
    """libavif's check that a grid's tiles share one decoder configuration:
    every av1C field but the marker and version, as the first tile's."""
    props = (_prop(t, b, b"av1C") for t in tiles)
    if len({b[p[0] + 1:p[0] + 3] for p in props if p is not None}) > 1:
        raise _Syntax("grid tiles of different av1C configurations")


def _check_properties(b, item: _Item, config: _Item) -> None:
    """libavif's checks of an av01 or grid item's properties: av1C of an
    av01 item (its marker and version byte), ispe (version 0), irot and
    imir (reserved bits clear), colr nclx (reserved bits clear) and pixi
    (version 0; one to four channels of one depth, else not implemented;
    that depth av1C's, the first tile's for a grid)."""
    p = _prop(item, b, b"av1C")
    if item.type == b"av01" and (p is None or p[1] - p[0] < 4 or b[p[0]] != 0x81):
        raise _Syntax(f"item {item.id} has no valid av1C property")
    p = _prop(item, b, b"ispe")
    if p is not None and b[p[0]] != 0:
        raise _Syntax("ispe version")
    for kind, mask in ((b"irot", 0xFC), (b"imir", 0xFE)):
        p = _prop(item, b, kind)
        if p is not None and (p[1] <= p[0] or b[p[0]] & mask):
            raise _Syntax(f"{kind.decode()} with reserved bits set")
    p = _prop(item, b, b"colr")
    if p is not None and b[p[0]:p[0] + 4] == b"nclx" and (p[1] - p[0] < 11
                                                          or b[p[0] + 10] & 0x7F):
        raise _Syntax("colr nclx with reserved bits set")
    p = _prop(item, b, b"pixi")
    if p is not None:
        v, _, q = _full(b, *p)
        _need(q, 1, p[1])
        n = b[q]
        if v != 0:
            raise _Syntax("pixi version")
        if not 1 <= n <= 4:
            raise CorruptImageError(f"AVIF pixi of {n} channels (libavif: not implemented)")
        _need(q + 1, n, p[1])
        depths = set(b[q + 1:q + 1 + n])
        if len(depths) > 1:
            raise CorruptImageError("AVIF pixi of mixed channel depths (libavif: not implemented)")
        if depths != {_av1c_depth(b, config)}:
            raise _Syntax("pixi depth is not av1C's")


def _av1c_depth(b, item: _Item) -> int:
    """The bit depth av1C gives (high_bitdepth, twelve_bit)."""
    p = _prop(item, b, b"av1C")
    if p is None or p[1] - p[0] < 4:
        return 8
    return 12 if b[p[0] + 2] & 0x60 == 0x60 else 10 if b[p[0] + 2] & 0x40 else 8


def _ispe(b, item: _Item) -> tuple[int, int]:
    """An item's ispe size, within libavif's dimension limit (32768)."""
    p = _prop(item, b, b"ispe")
    if p is None:
        raise _Syntax(f"item {item.id} has no ispe property")
    _, _, q = _full(b, *p)
    _need(q, 8, p[1])
    w, h = _u32(b, q), _u32(b, q + 4)
    if w > 32768 or h > 32768:
        raise _Syntax(f"item {item.id} is {w}x{h}, past libavif's dimension limit")
    return w, h


def _nclx(b, item: _Item):
    p = _prop(item, b, b"colr")
    if p is None or b[p[0]:p[0] + 4] != b"nclx" or p[1] - p[0] < 11:
        return None
    q = p[0] + 4
    return _u16(b, q), _u16(b, q + 2), _u16(b, q + 4), b[q + 6] >> 7


def _extents(b, item: _Item, idat) -> list:
    if item.construction == 1:
        if idat is None:
            raise _Syntax("item in idat without an idat box")
        return [(idat[0] + o, n) for o, n in item.extents]
    return list(item.extents)


# -- load -----------------------------------------------------------------------------


def _payload(f: AvifFile, extents: list) -> bytes:
    out = []
    for off, n in extents:
        if off + n > len(f.data):
            raise TruncatedImageError("AVIF item data runs past the end of the file")
        out.append(f.data[off:off + n])
    return b"".join(out)


def _grid_planes(f: AvifFile, grid: Grid, native, alpha: bool) -> tuple[list, dict]:
    """The grid's tiles decoded and stitched in YUV, cropped to its output
    size, with the first tile's header fields, as libavif 1.3 fills a
    grid image (avifDecoderDataFillImageGrid): tiles of one size that
    cover the output without a wholly spare row or column, at least 64
    samples a side, even where chroma is subsampled (MIAF 7.3.11.4.2),
    decoded to one format, depth, range and CICP. A fault is INVALID_IMAGE_GRID,
    which Pillow's load raises."""
    (tw, th), w, h = grid.tiles[0][1], grid.width, grid.height
    if any(size != (tw, th) for _, size in grid.tiles):
        raise CorruptImageError("AVIF: invalid image grid: tiles of more than one size")
    if (tw * grid.cols < w or th * grid.rows < h or tw * (grid.cols - 1) >= w
            or th * (grid.rows - 1) >= h):
        raise CorruptImageError("AVIF: invalid image grid: the tiles do not cover the output"
                                " or leave a row or column out of it")
    if tw < 64 or th < 64:
        raise CorruptImageError("AVIF: invalid image grid: tiles under 64 samples a side")
    decoded = [_decoded(f, extents, size, native, alpha) for extents, size in grid.tiles]
    fields = decoded[0][1]
    kind = ("mono", "subsampling", "full_range", "matrix", "primaries", "depth")
    if any(any(fl[k] != fields[k] for k in kind) for _, fl in decoded):
        raise CorruptImageError("AVIF: invalid image grid: tiles of mismatched formats")
    sx, sy = (0, 0) if fields["mono"] else fields["subsampling"]
    if (sx and (w % 2 or tw % 2)) or (sy and (h % 2 or th % 2)):
        raise CorruptImageError("AVIF: invalid image grid: odd sizes where chroma is subsampled")
    planes = []
    for k, first in enumerate(decoded[0][0]):
        ph, pw = first.shape
        full = np.empty((ph * grid.rows, pw * grid.cols), first.dtype)
        for i, (tile, _) in enumerate(decoded):
            r, c = divmod(i, grid.cols)
            full[r * ph:(r + 1) * ph, c * pw:(c + 1) * pw] = tile[k]
        csx, csy = (sx, sy) if k else (0, 0)
        planes.append(full[:(h + csy) >> csy, :(w + csx) >> csx])
    return planes, fields


def _decoded(f: AvifFile, extents: list, size: tuple, native,
             alpha: bool) -> tuple[list, dict]:
    """An av01 item's frame, scaled to the item's ispe size where it has
    another (libavif's avifImageScaleWithLimit after the decode); an alpha
    frame of limited range is taken to full range before it is scaled."""
    planes, fields = native.av1_decode(_payload(f, extents), *size)
    if alpha and not fields["full_range"]:
        planes = [_limited_to_full(planes[0], fields["depth"])]
    sub = (0, 0) if fields["mono"] else fields["subsampling"]
    return native.avif_scale(planes, sub, *size), fields


def _planes(f: AvifFile, source, native, alpha: bool = False) -> tuple[list, dict]:
    if isinstance(source, Grid):
        return _grid_planes(f, source, native, alpha)
    return _decoded(f, source, f.size, native, alpha)


def _limited_to_full(a: np.ndarray, depth: int) -> np.ndarray:
    """libavif's avifLimitedToFullY of an alpha plane at its depth (16-235,
    64-940 or 256-3760 to the full range)."""
    lo, hi = 16 << (depth - 8), 235 << (depth - 8)
    top = (1 << depth) - 1
    v = ((a.astype(np.int64) - lo) * top + (hi - lo) // 2) // (hi - lo)
    return np.clip(v, 0, top).astype(a.dtype)


def decode(f: AvifFile, native) -> tuple[str, np.ndarray, None]:
    """(mode, pixels, palette) as imageio.ImageFile.decode gives them: the
    first frame as Pillow's RGB or RGBA. A grid is converted once, whole,
    so chroma is upsampled across its tiles' seams. Pillow reads the
    converted bytes as raw rows of its own size, the ispe's: a grid whose
    output size is another is read row on row from those bytes, or fails
    as truncated where they are too few."""
    if native is None:
        raise native_missing("AVIF")
    if f.timescale == 0:
        raise CorruptImageError("AVIF sequence of timescale 0 (Pillow's load divides by it)")
    planes, fields = _planes(f, f.color, native)
    depth = fields["depth"]
    primaries, _, matrix, full = f.nclx or (fields["primaries"], None, fields["matrix"],
                                            fields["full_range"])
    a = None
    if f.alpha:
        alpha, afields = _planes(f, f.alpha, native, alpha=True)
        a = alpha[0]
        if a.shape != planes[0].shape:
            raise CorruptImageError("AVIF alpha of another size than its colour image")
        if afields["depth"] != depth:  # libavif fails the alpha's decode
            raise CorruptImageError(f"AVIF alpha of {afields['depth']} bits, its colour image"
                                    f" of {depth}")
    out = native.avif_yuv_to_rgb(planes, fields["subsampling"], bool(full), matrix, primaries,
                                 4 if f.alpha else 3, depth, a)
    if f.premultiplied and f.alpha:
        native.avif_unpremultiply(out)
    w, h = f.size
    channels = out.shape[2]
    if out.shape[:2] != (h, w):
        need = w * h * channels
        if out.size < need:
            raise TruncatedImageError("AVIF grid of fewer pixels than its ispe size")
        out = out.reshape(-1)[:need].reshape(h, w, channels)
    return f.mode, out, None
