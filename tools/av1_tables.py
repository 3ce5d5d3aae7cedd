"""Regenerate, or check, cybervision_tpu_torch/native/av1tables.h: the AV1
tables of the key-frame decoder (native/av1*.cpp), found in the bytes of
the libavif that Pillow's wheel ships (libavif 1.3.0, which links dav1d
1.5.1 for decoding and libaom 3.12.1 for encoding, both statically).

Each table is found by an anchor, a run of its first values, and read at
its offset from the anchor. Every default CDF comes out in the AV1
specification's table shapes, with each row held inverted as libaom and
dav1d hold it (32768 - cdf): N - 1 values, the 0 of 32768, and the
adaptation counter. The mode CDFs come from dav1d's default context
(its block-size order turned into the specification's), the
coefficient CDFs from libaom's tables (already in the specification's
shapes), the quantiser lookups at 8, 10 and 12 bits from dav1d's (its 8-bit
ones held to libaom's), the smooth weights, directional derivatives,
filter-intra taps, cosines, sines and self-guided constants from
libaom's, the coefficient context offsets from dav1d's, the quantizer
matrices from libaom's held to dav1d's, the film grain Gaussian
sequence from dav1d's. The scan
orders are not tabled: the decoder generates them, and this script
checks that dav1d holds each of them (transposed, as dav1d stores its
coefficients).

Usage, from the repo root (needs Pillow's wheel installed, no build):
    python tools/av1_tables.py            # check the committed header
    python tools/av1_tables.py --write    # regenerate it
The build reads only the committed header.
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "cybervision_tpu_torch", "native", "av1tables.h")

NOTICE = """\
// AV1 tables for the key-frame decoder (av1obu.cpp, av1entropy.cpp,
// av1recon.cpp, av1filter.cpp). Generated by tools/av1_tables.py from the
// bytes of libavif 1.3.0 (dav1d 1.5.1 and libaom 3.12.1 linked in); do not
// edit. CDF rows are inverted (32768 - cdf): N - 1 values, 0, a counter.
//
// dav1d: Copyright (c) 2018-2024, VideoLAN and dav1d authors.
// libaom: Copyright (c) 2016-2024, Alliance for Open Media.
// Both under the BSD 2-Clause License:
//
// Redistribution and use in source and binary forms, with or without
// modification, are permitted provided that the following conditions are met:
//
// 1. Redistributions of source code must retain the above copyright notice,
//    this list of conditions and the following disclaimer.
//
// 2. Redistributions in binary form must reproduce the above copyright notice,
//    this list of conditions and the following disclaimer in the documentation
//    and/or other materials provided with the distribution.
//
// THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS "AS IS"
// AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT LIMITED TO, THE
// IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A PARTICULAR PURPOSE
// ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT OWNER OR CONTRIBUTORS BE
// LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL, SPECIAL, EXEMPLARY, OR
// CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO, PROCUREMENT OF
// SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR PROFITS; OR BUSINESS
// INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF LIABILITY, WHETHER IN
// CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING NEGLIGENCE OR OTHERWISE)
// ARISING IN ANY WAY OUT OF THE USE OF THIS SOFTWARE, EVEN IF ADVISED OF THE
// POSSIBILITY OF SUCH DAMAGE.
"""

# dav1d's block-size order (largest first) -> the specification's.
_SPEC_BS = ["4x4", "4x8", "8x4", "8x8", "8x16", "16x8", "16x16", "16x32", "32x16", "32x32",
            "32x64", "64x32", "64x64", "64x128", "128x64", "128x128", "4x16", "16x4", "8x32",
            "32x8", "16x64", "64x16"]
_DAV1D_BS = ["128x128", "128x64", "64x128", "64x64", "64x32", "64x16", "32x64", "32x32",
             "32x16", "32x8", "16x64", "16x32", "16x16", "16x8", "16x4", "8x32", "8x16", "8x8",
             "8x4", "4x16", "4x8", "4x4"]


def _library() -> bytes:
    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    found = glob.glob(os.path.join(libs, "libavif-*.so*"))
    if not found:
        raise SystemExit("no libavif in Pillow's wheel")
    with open(found[0], "rb") as fh:
        return fh.read()


class _Bytes:
    def __init__(self, data: bytes):
        self.data = data

    def find(self, values, dtype, nth=0) -> int:
        pat = np.asarray(values, dtype).tobytes()
        at = -1
        for _ in range(nth + 1):
            at = self.data.find(pat, at + 1)
            if at < 0:
                raise SystemExit(f"anchor {values[:6]} not found")
        return at

    def read(self, at: int, n: int, dtype) -> np.ndarray:
        dt = np.dtype(dtype)
        return np.frombuffer(self.data[at:at + n * dt.itemsize], dt).astype(np.int64)


def _inv(values):
    return [32768 - v for v in values]


def _rows(b: _Bytes, at: int, nrows: int, nsym: int, stride: int) -> np.ndarray:
    """nrows CDF rows of nsym symbols at `at`, stored `stride` u16 apart
    with nsym - 1 inverted values each, as (nrows, nsym + 1) rows of the
    specification's shape: the values, 0, and a zero counter."""
    raw = b.read(at, nrows * stride, "<u2").reshape(nrows, stride)
    vals = raw[:, :nsym - 1]
    if (vals <= 0).any() or (vals >= 32768).any() or (np.diff(vals, axis=1) > 0).any():
        raise SystemExit(f"not CDF rows at {at}")
    out = np.zeros((nrows, nsym + 1), np.int64)
    out[:, :nsym - 1] = vals
    return out


def extract() -> dict[str, tuple[str, np.ndarray]]:
    b = _Bytes(_library())
    t: dict[str, tuple[str, np.ndarray]] = {}

    # -- dav1d's default mode context, anchored on its key-frame y mode
    # table (rows of 16 u16) and read at fixed offsets from it.
    kf = b.find(_inv([15588, 17027, 19338, 20218, 20682, 21110, 21825, 23244, 24189, 28165,
                     29093, 30466]) + [0, 0, 0, 0], "<u2")
    ctx = kf - 6432  # start of dav1d's uv_mode table
    if b.read(ctx, 1, "<u2")[0] != 32768 - 22631:
        raise SystemExit("dav1d mode context moved")

    def dav(name, off, shape, nsym, stride):
        n = int(np.prod(shape))
        t[name] = ("uint16_t", _rows(b, ctx + off, n, nsym, stride).reshape(*shape, nsym + 1))

    dav("kCdfKfYMode", kf - ctx, (5, 5), 13, 16)
    dav("kCdfUvModeCflNotAllowed", 0, (13,), 13, 16)
    dav("kCdfUvModeCflAllowed", 13 * 32, (13,), 14, 16)
    dav("kCdfPartitionW128", 832, (4,), 8, 16)
    dav("kCdfPartitionW64", 832 + 128, (4,), 10, 16)
    dav("kCdfPartitionW32", 832 + 256, (4,), 10, 16)
    dav("kCdfPartitionW16", 832 + 384, (4,), 10, 16)
    dav("kCdfPartitionW8", 832 + 512, (4,), 4, 16)
    dav("kCdfCflAlpha", 1472, (6,), 16, 16)
    dav("kCdfIntraTxSet1", 1760, (2, 13), 7, 8)
    dav("kCdfIntraTxSet2", 2176, (3, 13), 5, 8)
    dav("kCdfCflSign", 2800, (), 8, 8)
    dav("kCdfAngleDelta", 2816, (8,), 7, 8)
    dav("kCdfFilterIntraMode", 2944, (), 5, 8)
    dav("kCdfSegmentId", 2960, (3,), 8, 8)
    dav("kCdfPaletteYSize", 3008, (7,), 7, 8)
    dav("kCdfPaletteUvSize", 3008 + 112, (7,), 7, 8)
    for plane, off in (("Y", 3232), ("Uv", 3792)):
        rows = []
        for n in range(2, 9):
            r = _rows(b, ctx + off + (n - 2) * 80, 5, n, 8)
            full = np.zeros((5, 9), np.int64)
            full[:, :n + 1] = r
            rows.append(full)
        t[f"kCdfPalette{plane}Color"] = ("uint16_t", np.stack(rows))
    dav("kCdfTx8x8", 4352, (3,), 2, 4)
    dav("kCdfTx16x16", 4376, (3,), 3, 4)
    dav("kCdfTx32x32", 4376 + 24, (3,), 3, 4)
    dav("kCdfTx64x64", 4376 + 48, (3,), 3, 4)
    dav("kCdfDeltaQ", 4448, (), 4, 4)
    dav("kCdfDeltaLf", 4456, (), 4, 4)
    dav("kCdfDeltaLfMulti", 4464, (4,), 4, 4)
    dav("kCdfRestorationType", 4496, (), 3, 4)
    dav("kCdfUseWiener", 4504, (), 2, 2)
    dav("kCdfUseSgrproj", 4508, (), 2, 2)
    fi = _rows(b, ctx + 4528, 22, 2, 2)
    t["kCdfUseFilterIntra"] = ("uint16_t", fi[[_DAV1D_BS.index(s) for s in _SPEC_BS]])
    dav("kCdfSkip", 4700, (3,), 2, 2)
    dav("kCdfPaletteYMode", 4712, (7, 3), 2, 2)
    dav("kCdfPaletteUvMode", 4796, (2,), 2, 2)
    dav("kCdfIntrabc", 4804, (), 2, 2)
    # What intra block copy needs: inter transform types, transform
    # splits and motion vectors (dav1d's one mv context serves both of
    # the specification's, which start equal).
    dav("kCdfInterTxSet1", 1664, (2,), 16, 16)
    dav("kCdfInterTxSet2", 1728, (), 12, 16)
    dav("kCdfInterTxSet3", 4512, (4,), 2, 2)
    dav("kCdfTxfmSplit", 4616, (21,), 2, 2)
    dav("kCdfMvClass", 6272, (), 11, 16)
    dav("kCdfMvSign", 6304, (), 2, 2)
    dav("kCdfMvClass0Bit", 6308, (), 2, 2)
    dav("kCdfMvBit", 6332, (10,), 2, 2)  # after class0_hp
    dav("kCdfMvJoint", 6400, (), 4, 4)
    per_set = b.find([9, 0, 3, 1, 2, 9, 0, 10, 11, 3, 1, 2], "u1")
    sets = b.read(per_set, 40, "u1")
    t["kTxTypeIntraInvSet2"] = ("uint8_t", sets[0:5])
    t["kTxTypeIntraInvSet1"] = ("uint8_t", sets[5:12])
    t["kTxTypeInterInvSet2"] = ("uint8_t", sets[12:24])
    t["kTxTypeInterInvSet1"] = ("uint8_t", sets[24:40])

    # -- libaom's coefficient CDFs (the specification's shapes, rows of
    # N + 1), anchored on its coeff_base table.
    base = b.find(_inv([4034, 8930, 12727]) + [0, 0] + _inv([18082, 29741, 31877]), "<u2")

    def aom(name, off, shape, nsym):
        n = int(np.prod(shape))
        raw = b.read(base + off, n * (nsym + 1), "<u2").reshape(n, nsym + 1)
        _rows(b, base + off, n, nsym, nsym + 1)  # the shape check
        if raw[:, nsym - 1:].any():
            raise SystemExit(f"{name}: rows do not end in 0, 0")
        t[name] = ("uint16_t", raw.reshape(*shape, nsym + 1))

    aom("kCdfCoeffBase", 0, (4, 5, 2, 42), 4)
    aom("kCdfCoeffBr", 16800, (4, 5, 2, 21), 4)
    aom("kCdfDcSign", 25216, (4, 2, 3), 2)
    aom("kCdfEobExtra", 25376, (4, 5, 2, 9), 2)
    aom("kCdfTxbSkip", 27552, (4, 5, 13), 2)
    aom("kCdfCoeffBaseEob", -1280, (4, 5, 2, 4), 3)
    for n, off in ((16, -1472), (32, -1696), (64, -1952), (128, -2240), (256, -2560)):
        aom(f"kCdfEobPt{n}", off, (4, 2, 2), {16: 5, 32: 6, 64: 7, 128: 8, 256: 9}[n])
    # 512 and 1024 carry libaom's unused context dimension; the first is kept.
    for n, off, nsym in ((512, -2912, 10), (1024, -3296, 11)):
        raw = b.read(base + off, 16 * (nsym + 1), "<u2").reshape(4, 2, 2, nsym + 1)
        _rows(b, base + off, 16, nsym, nsym + 1)
        t[f"kCdfEobPt{n}"] = ("uint16_t", raw[:, :, 0])

    # -- libaom's other tables.
    # The quantiser lookups at 8, 10 and 12 bits (Dc_Qlookup, Ac_Qlookup):
    # dav1d's dq_tbl, (DC, AC) pairs in three blocks of 256, whose 8-bit
    # block is libaom's dc_qlookup_QTX and ac_qlookup_QTX.
    dq = b.read(b.find([4, 4, 8, 8, 8, 9, 9, 10, 10, 11], "<u2"), 3 * 256 * 2,
                "<u2").reshape(3, 256, 2)
    dc = b.find([4, 8, 8, 9, 10, 11, 12, 12, 13, 14], "<i2")
    ac = b.find([4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18], "<i2")
    if not ((b.read(dc, 256, "<i2") == dq[0, :, 0]).all()
            and (b.read(ac, 256, "<i2") == dq[0, :, 1]).all()):
        raise SystemExit("dav1d's 8-bit quantiser lookups are not libaom's")
    t["kDcQLookup"] = ("int16_t", dq[:, :, 0])
    t["kAcQLookup"] = ("int16_t", dq[:, :, 1])
    sm = b.find([255, 149, 85, 64, 255, 197, 146, 105], "u1")
    t["kSmWeights"] = ("uint8_t", b.read(sm, 124, "u1"))
    dr = b.find([0, 0, 0, 1023, 0, 0, 547, 0, 0, 372], "<i2")
    t["kDrIntraDerivative"] = ("int16_t", b.read(dr, 90, "<i2"))
    fi = b.find([-6, 10, 0, 0, 0, 12, 0, 0, -5, 2, 10], "i1")
    t["kFilterIntraTaps"] = ("int8_t", b.read(fi, 320, "i1").reshape(5, 8, 8)[:, :, :7])
    xb = b.find([1, 128, 171, 192, 205], "<i4")
    t["kXByXPlus1"] = ("int32_t", b.read(xb, 256, "<i4"))
    ob = b.find([4096, 2048, 1365, 1024, 819], "<i4")
    t["kOneByX"] = ("int32_t", b.read(ob, 25, "<i4"))
    sg = b.find([2, 1, 140, 3236], "<i4")
    sgr = b.read(sg, 64, "<i4").reshape(16, 4)  # {r0, r1, s0, s1}
    t["kSgrParams"] = ("int32_t", sgr[:, [0, 2, 1, 3]])
    cs = b.find([4096, 4095, 4091, 4085, 4076], "<i4")
    t["kCos128"] = ("int32_t", b.read(cs, 65, "<i4")[:64])
    sp = b.find([0, 1321, 2482, 3344, 3803], "<i4")
    t["kSinpi"] = ("int32_t", b.read(sp, 5, "<i4"))
    # dav1d's three coefficient context offset patterns: square, then
    # those of its transposed layout's two rectangular shapes.
    lo = b.find([0, 1, 6, 6, 21, 1, 6, 6, 21, 21, 6, 6, 21, 21, 21], "u1")
    t["kCoeffBaseCtxOffset"] = ("uint8_t", b.read(lo, 75, "u1").reshape(3, 5, 5))
    _check_scans(b)
    # The quantizer matrices, levels 0-14 (15 is flat: no matrix), luma
    # and chroma, each level's sizes in the specification's order
    # (Qm_Offset), each matrix column by column as libaom and dav1d hold
    # their coefficients: libaom's iwt_matrix_ref, anchored on its 4x4
    # luma matrix of level 0, held to dav1d's copy (_check_qm).
    qm = b.find([32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110, 150, 200], "u1")
    iwt = b.read(qm, 15 * 2 * QM_TOTAL, "u1").reshape(15, 2, QM_TOTAL)
    _check_qm(b, iwt)
    t["kQuantizerMatrix"] = ("uint8_t", iwt)
    # dav1d's film grain Gaussian sequence (2048 values, 12-bit).
    gs = b.find([56, 568, -180, 172, 124, -84, 172, -64, -900, 24, 820, 224], "<i2")
    gauss = b.read(gs, 2048, "<i2")
    if gauss.min() < -2048 or gauss.max() >= 2048 or gauss[-4:].tolist() != [288, 944, 428, -484]:
        raise SystemExit("the Gaussian sequence moved")
    t["kGaussianSequence"] = ("int16_t", gauss)
    # dav1d's superres upscaling taps (dav1d_resize_filter, 64 phases of 8:
    # the specification's Upscale_Filter negated), held as the
    # specification's.
    rf = b.find([0, 0, 0, -128, 0, 0, 0, 0, 0, 0, 1, -128, -2, 1, 0, 0], "i1")
    up = -b.read(rf, 512, "i1").astype(np.int16).reshape(64, 8)
    if (up.sum(axis=1) != 128).any():
        raise SystemExit("the upscaling taps moved")
    t["kUpscaleFilter"] = ("int16_t", up)
    return t


# The quantizer matrix sizes (w, h) in the specification's order: the
# transform sizes that are their own adjusted size (64-sample sides take
# the 32-sample matrices).
QM_SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16), (16, 8), (16, 32),
            (32, 16), (4, 16), (16, 4), (8, 32), (32, 8)]
QM_TOTAL = sum(w * h for w, h in QM_SIZES)  # 3344


def _qm_block(iwt, level, plane, w, h):
    """The w x h matrix as (h, w) rows, from its columns."""
    at = sum(a * b for a, b in QM_SIZES[:QM_SIZES.index((w, h))])
    return iwt[level, plane, at:at + w * h].reshape(w, h).T


def _check_qm(b: _Bytes, iwt) -> None:
    """The extracted matrices against dav1d's: its 32x32 matrices are
    stored as lower triangles, level by level, luma then chroma, and its
    4x4, 8x8 and 16x16 ones are taken from them, every 8th, 4th and 2nd
    sample from (3, 3), (1, 1) and (0, 0); the square ones are symmetric,
    and no weight is 0."""
    m32 = [_qm_block(iwt, 0, 0, 32, 32)]
    tri = np.concatenate([m32[0][i, :i + 1] for i in range(32)])
    at = b.find(tri[:64].tolist(), "u1")
    tris = b.read(at, 15 * 2 * 528, "u1").reshape(15, 2, 528)
    rows, cols = np.tril_indices(32)
    for level in range(15):
        for plane in range(2):
            full = np.zeros((32, 32), np.int64)
            full[rows, cols] = tris[level, plane]
            full[cols, rows] = tris[level, plane]
            for n, step, start in ((32, 1, 0), (16, 2, 0), (8, 4, 1), (4, 8, 3)):
                if not np.array_equal(_qm_block(iwt, level, plane, n, n),
                                      full[start::step, start::step]):
                    raise SystemExit(f"quantizer matrix {n}x{n} of level {level} is not dav1d's")
            for w, h in QM_SIZES:
                m = _qm_block(iwt, level, plane, w, h)
                if m.min() == 0 or (w == h and not np.array_equal(m, m.T)):
                    raise SystemExit(f"quantizer matrix {w}x{h} of level {level} malformed")


def spec_scan(w: int, h: int) -> list[int]:
    """The specification's default scan of a w x h block (positions
    row * w + col): zig-zag for squares, diagonals otherwise."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]
        if (w == h and d % 2 == 0) or w > h:
            cells = cells[::-1]
        out += [r * w + c for r, c in cells]
    return out


def _check_scans(b: _Bytes) -> None:
    for w, h in ((4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16), (16, 8),
                 (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8)):
        s = spec_scan(w, h)
        b.find([(p % w) * h + p // w for p in s], "<u2")


def render(tables) -> str:
    out = [NOTICE, "#pragma once", "", "#include <cstdint>", "", "namespace av1 {", ""]
    for name, (ctype, arr) in tables.items():
        dims = "".join(f"[{d}]" for d in arr.shape)
        flat = arr.reshape(-1).tolist()
        width = arr.shape[-1] if arr.ndim else 1
        if width > 256:  # the quantizer matrices and the Gaussian sequence: 32 to a line
            width = 32
        lines = [", ".join(str(v) for v in flat[i:i + max(width, 1)])
                 for i in range(0, len(flat), max(width, 1))]
        body = ",\n    ".join(lines)
        out.append(f"alignas(16) inline const {ctype} {name}{dims} = {{\n    {body},\n}};\n")
    out.append("}  // namespace av1")
    return "\n".join(out) + "\n"


def main() -> None:
    text = render(extract())
    if "--write" in sys.argv:
        with open(HEADER, "w") as fh:
            fh.write(text)
        print(f"wrote {HEADER}")
        return
    with open(HEADER) as fh:
        same = fh.read() == text
    print("av1tables.h matches the library" if same else "av1tables.h DIFFERS from the library")
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
