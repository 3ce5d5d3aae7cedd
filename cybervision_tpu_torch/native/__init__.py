"""ctypes bindings for the native host library: the writers and meshers
(native.cpp), the image readers' pixel loops (imagedecode.cpp and, for
WebP, webpdecode.cpp, for block-compressed textures, bcndecode.cpp, for
JPEG 2000, j2kdecode.cpp, for AVIF, av1*.cpp, yuvscale.cpp and
avifrgb.cpp) and the
image writers' (imageencode.cpp and,
for JPEG 2000, j2kencode.cpp, for WebP, webpencode.cpp).

native.cpp is a copy of cybervision_tpu/native/native.cpp; every entry
point is bound here: the affine lanes' writers and meshers and the SFM
track merge. imagedecode.cpp is the port's own: PNG unfiltering, TIFF
PackBits, LZW, zstd and CCITT, BMP RLE, GIF LZW, TGA, SGI, PCX and ICNS
RLE, QOI, FLI frames, sequential, progressive and lossless JPEG, Huffman or arithmetic
coded (cybervision_tpu_torch.imageio);
webpdecode.cpp WebP's VP8L, VP8 and ALPH bitstreams; bcndecode.cpp the
BC1-BC7 blocks of DDS and FTEX and BLP's DXT blocks; j2kdecode.cpp a
JPEG 2000 tile, as OpenJPEG decodes it; av1obu.cpp, av1entropy.cpp,
av1recon.cpp, av1filter.cpp and av1grain.cpp (sharing av1.h and the
generated av1tables.h) an AVIF image's AV1 key frame, as dav1d decodes
it with superres and film grain, yuvscale.cpp its planes scaled to its
item's size, as libavif scales them through libyuv, and
avifrgb.cpp its YUV to RGB(A), as libavif converts it through libyuv
(imageio.avif); imageencode.cpp the
JPEG writer's scan (imageio.jpeg_encode), the QOI writer's ops
(imageio.rgba_encode), the PNG writer's row filters (imageio.png_encode),
Pillow's RGBA resampling (imageio.resample), its octree quantiser
(imageio.quantize) and its GIF LZW coder (imageio.gif_encode);
j2kencode.cpp a JPEG 2000 tile as OpenJPEG encodes Pillow's
(imageio.jpeg2000_encode); webpencode.cpp a WebP image's VP8 frame and
ALPH chunk as libwebp encodes Pillow's (imageio.webp_encode).
The shared library builds with make into this directory at its first
use, not at import: one object a source, compiled in parallel, then
linked, by one process at a time. `load` raises ImportError when it cannot be built or
loaded (no toolchain): callers ask `available()` and then take their
numpy paths, as the JAX package's callers do when its native module
fails to import (JPEG, LZW, zstd, CCITT, the RLE formats, QOI, GIF,
WebP, BCn blocks, JPEG 2000 and AVIF have none: the readers raise; the QOI,
GIF, ICO, ICNS, JPEG 2000 and WebP writers hand the file to Pillow).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

from cybervision_tpu_torch.errors import OutputError

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libcvtorch_native.so")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_DP = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_L = ctypes.c_long
_SIGNATURES = {
    "polygons_obstruct": ([_DP, _L, _L, _DP, _DP, _I32P, _L, _U8P], None),
    "rasterize_polygons_max": ([_DP, _L, _L, _DP, _U8P, _I32P, _L], None),
    "grid_mesh_triangles": ([_I32P, _L, _L, _I32P], _L),
    "ply_pack_vertices": ([_DP, _L, _DP, _U8P, ctypes.c_char_p], _L),
    "ply_pack_faces": ([_I32P, _L, ctypes.c_char_p], _L),
    "ply_write_grid": (
        [ctypes.c_char_p, _DP, _L, _DP, _I32P, _L, _U8P, _I32P, _L, _L], _L,
    ),
    "ply_write_corr_grid": ([ctypes.c_char_p, _I32P, _L, _L, _DP, _U8P, _I32P], _L),
    "ply_write_delta_grid": (
        [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16), _L, _L, _DP, _U8P, _I32P],
        _L,
    ),
    "format_obj_vertices": ([_DP, _L, _DP, ctypes.c_char_p], _L),
    "format_obj_faces": ([_I32P, _L, ctypes.c_char_p], _L),
    "format_obj_uvs": ([_DP, _L, ctypes.c_char_p], _L),
    "format_obj_faces_uv": ([_I32P, _I32P, _L, ctypes.c_char_p], _L),
    "delaunay_int": ([_I32P, _L, _I32P], _L),
    "merge_tracks_image": ([_I32P, _L, _L, _L, _L, _L, _L, _L, _I32P], _L),
    "png_unfilter": ([_U8P, _L, _L, _L, _U8P], _L),
    "tiff_packbits": ([_U8P, _L, _U8P, _L], _L),
    "tiff_lzw": ([_U8P, _L, _U8P, _L], _L),
    "tiff_ccitt": ([_U8P, _L, _L, _L, _L, _U8P], _L),
    "bmp_rle": ([_U8P, _L, _L, _L, _L, _L, _U8P], _L),
    "gif_lzw": ([_U8P, _L, _L, _L, _L, _L, _U8P], _L),
    "tga_rle": ([_U8P, _L, _L, _L, _L, _U8P], _L),
    "sgi_rle": ([_U8P, _L, _L, _L, _L, _L, _U8P], _L),
    "pcx_rle": ([_U8P, _L, _L, _L, _U8P], _L),
    "packbits_rows": ([_U8P, _L, _L, _L, _U8P], _L),
    "qoi_decode": ([_U8P, _L, _L, _L, _L, _U8P], _L),
    "fli_decode": ([_U8P, _L, _L, _L, _U8P, _I32P], _L),
    "sun_rle": ([_U8P, _L, _L, _U8P], _L),
    "msp_rle": ([_U8P, _L, _L, _L, _U8P], _L),
    "im_bits": ([_U8P, _L, _L, _L, _L, ctypes.POINTER(ctypes.c_float)], _L),
    "zstd_strip": ([_U8P, _L, _U8P, _L], _L),
    "zstd_frames": ([_U8P, _L, _U8P, _L], _L),
    "icns_rle": ([_U8P, _L, _L, _U8P], _L),
    "jpeg_decode": ([_U8P, _L, _I32P, _U16P, _I32P, _L, _U8P, _U8P, _U8P], _L),
    "jpeg_encode_scan": ([_U8P, _L, _L, _L, _U16P, _U8P, _U8P, _L], _L),
    "qoi_encode": ([_U8P, _L, _U8P], _L),
    "png_filter_rows": ([_U8P, _L, _L, _L, _U8P], _L),
    "resample_rgba": ([_U8P, _L, _L, _L, _L, _L, _U8P], _L),
    "octree_quantize": ([_U8P, _L, _L, _U8P, _U8P], _L),
    "gif_lzw_encode": ([_U8P, _L, _L, _L, _U8P, _L], _L),
    "webp_vp8l_decode": ([_U8P, _L, _L, _L, ctypes.POINTER(ctypes.c_uint32)], _L),
    "webp_vp8_decode": ([_U8P, _L, _L, _L, _U8P], _L),
    "webp_alph_decode": ([_U8P, _L, _L, _L, _U8P], _L),
    "bcn_decode": ([_U8P, _L, _L, _L, _L, _L, _U8P], _L),
    "blp_dxt": ([_U8P, _L, _L, _L, _L, _L, _U8P], _L),
    "j2k_decode_tile": ([_I32P, _U8P, _L, _I32P, _I32P, _L, _DP], _L),
    "j2k_encode_tile": ([_U8P, _L, _L, _L, _L, _U8P, _L], _L),
    "webp_vp8_encode": ([_U8P, _L, _L, _U8P, _L], _L),
    "webp_alph_encode": ([_U8P, _L, _L, _U8P, _L], _L),
    "av1_decode": ([_U8P, _L, _L, _I32P, _U8P, _U8P, _U8P], _L),
    "av1_error": ([], ctypes.c_char_p),
    "avif_yuv_to_rgb": ([_U8P, _U8P, _U8P, _U8P, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _U8P],
                        _L),
    "avif_unpremultiply": ([_U8P, _L], None),
    "avif_rgb_to_yuv": ([_U8P, _L, _L, _U8P, _U8P, _U8P], None),
    "av1_encode": ([_U8P, _U8P, _U8P, _L, _L, _L, _U8P, _L], _L),
    "yuv_scale_plane": ([_U8P, _L, _L, _U8P, _L, _L, _L], None),
}
_SOURCES = ("native.cpp", "imagedecode.cpp", "imageencode.cpp", "webpdecode.cpp", "webpencode.cpp",
            "webpcommon.h", "bcndecode.cpp", "j2kdecode.cpp", "j2kencode.cpp", "j2kcommon.h",
            "av1.h", "av1tables.h", "av1obu.cpp", "av1entropy.cpp", "av1recon.cpp",
            "av1filter.cpp", "av1grain.cpp", "avifrgb.cpp", "av1encode.cpp", "yuvscale.cpp",
            "Makefile")


def _stale() -> bool:
    return not os.path.exists(_SO) or os.path.getmtime(_SO) < max(
        os.path.getmtime(os.path.join(_DIR, n)) for n in _SOURCES)


def load() -> ctypes.CDLL:
    """The shared library, built with make when it is missing or older
    than its sources. Raises ImportError when it cannot be built or
    loaded."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            try:
                if _stale():
                    # One process builds at a time; the others wait for it,
                    # then find the library built.
                    with open(os.path.join(_DIR, ".build.lock"), "a") as lock:
                        fcntl.flock(lock, fcntl.LOCK_EX)
                        if _stale():
                            subprocess.run(
                                ["make", "-s", f"-j{os.cpu_count() or 1}",
                                 "libcvtorch_native.so"],
                                cwd=_DIR, check=True, capture_output=True,
                            )
                lib = ctypes.CDLL(_SO)
            except (OSError, subprocess.CalledProcessError) as err:
                raise ImportError(f"native library unavailable: {err}") from err
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the native library builds (or is built) and loads."""
    try:
        load()
    except ImportError:
        return False
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _image_ptr(image, shape=None):
    """(pointer, array kept alive) of an optional uint8 colour plane."""
    if image is None:
        return _U8P(), None
    image = np.ascontiguousarray(image, np.uint8)
    if shape is not None and image.shape != shape:
        raise ValueError(f"colour plane {image.shape} != grid {shape}")
    return _ptr(image, ctypes.c_uint8), image


def polygons_obstruct(buf, proj, depth, polys) -> np.ndarray:
    """(M,) bool: polygon hides a nearer z-buffer point (output.rs:320-354)."""
    buf = np.ascontiguousarray(buf, np.float64)
    proj = np.ascontiguousarray(proj, np.float64)
    depth = np.ascontiguousarray(depth, np.float64)
    polys = np.ascontiguousarray(polys, np.int32)
    out = np.zeros(len(polys), np.uint8)
    load().polygons_obstruct(
        _ptr(buf, ctypes.c_double), buf.shape[0], buf.shape[1],
        _ptr(proj, ctypes.c_double), _ptr(depth, ctypes.c_double),
        _ptr(polys, ctypes.c_int32), len(polys), _ptr(out, ctypes.c_uint8),
    )
    return out.astype(bool)


def rasterize_polygons_max(out, pts, valid, polys) -> None:
    """In-place max-combine polygon fill (output.rs:1088-1115).
    out: (H, W) C-contiguous float64; pts: (N, 3) (x, y, value);
    valid: (N,) bool."""
    if out.dtype != np.float64 or not out.flags.c_contiguous:
        raise ValueError("rasterize_polygons_max: out must be C-contiguous float64")
    pts = np.ascontiguousarray(pts, np.float64)
    valid_u8 = np.ascontiguousarray(valid, np.uint8)
    polys = np.ascontiguousarray(polys, np.int32)
    load().rasterize_polygons_max(
        _ptr(out, ctypes.c_double), out.shape[0], out.shape[1],
        _ptr(pts, ctypes.c_double), _ptr(valid_u8, ctypes.c_uint8),
        _ptr(polys, ctypes.c_int32), len(polys),
    )


def grid_mesh_triangles(idx: np.ndarray) -> np.ndarray:
    """Triangulate the valid 2x2 quads of a (h, w) int32 pixel-index grid
    (-1 = empty); canonical vertex rotation applied (output.rs:55-67)."""
    idx = np.ascontiguousarray(idx, np.int32)
    h, w = idx.shape
    out = np.empty((2 * max(h - 1, 0) * max(w - 1, 0), 3), np.int32)
    n = load().grid_mesh_triangles(
        _ptr(idx, ctypes.c_int32), h, w, _ptr(out, ctypes.c_int32)
    )
    return out[:n]


def ply_pack_vertices(points3d, out_scale, colors=None) -> bytes:
    """BE-binary PLY vertex records: (x*s0, -y*s1, z*s2) doubles
    (+ u8 RGB) per point (output.rs:738-742)."""
    pts = np.ascontiguousarray(points3d, np.float64)
    scale = np.ascontiguousarray(out_scale, np.float64)
    n = len(pts)
    buf = ctypes.create_string_buffer((27 if colors is not None else 24) * max(n, 1))
    cptr, _colors = _image_ptr(colors)
    written = load().ply_pack_vertices(
        _ptr(pts, ctypes.c_double), n, _ptr(scale, ctypes.c_double), cptr, buf
    )
    return buf.raw[:written]


def ply_pack_faces(faces) -> bytes:
    """BE-binary PLY face records: u8 3 + reversed BE i32 indices
    (output.rs:757-761). Pass unreversed (v0, v1, v2) triangles."""
    faces = np.ascontiguousarray(faces, np.int32)
    buf = ctypes.create_string_buffer(13 * max(len(faces), 1))
    written = load().ply_pack_faces(_ptr(faces, ctypes.c_int32), len(faces), buf)
    return buf.raw[:written]


def ply_write_grid(path, points3d, out_scale, tracks, grid_shape, image=None) -> int:
    """Fused grid-mesh PLY writer: the camera-0 track positions scattered
    into a pixel-index grid, then header, vertices (+ colours sampled
    from `image`) and grid-derived faces streamed to `path` in one call —
    byte-identical to the grid_mesh_triangles + ply_pack_* chain.
    Returns the face count."""
    pts = np.ascontiguousarray(points3d, np.float64)
    scale = np.ascontiguousarray(out_scale, np.float64)
    tracks = np.ascontiguousarray(tracks, np.int32)
    h, w = grid_shape
    iptr, _image = _image_ptr(image)
    idx = np.empty((h, w), np.int32)
    faces = load().ply_write_grid(
        path.encode(), _ptr(pts, ctypes.c_double), len(pts),
        _ptr(scale, ctypes.c_double), _ptr(tracks, ctypes.c_int32),
        tracks.shape[1], iptr, _ptr(idx, ctypes.c_int32), h, w,
    )
    if faces < 0:
        raise OutputError(f"ply_write_grid: cannot write {path}")
    return int(faces)


def ply_write_corr_grid(path: str, word: np.ndarray, out_scale, image=None) -> int:
    """Fused affine PLY writer from the (H, W) int32 compact correlation
    word (x2 | y2<<12 | valid<<24): vertices are the valid pixels in
    row-major order with z = hypot(x - x2, y - y2), faces the grid mesh,
    colours sampled from `image`. Returns the face count."""
    word = np.ascontiguousarray(word, np.int32)
    h, w = word.shape
    scale = np.ascontiguousarray(out_scale, np.float64)
    iptr, _image = _image_ptr(image, (h, w, 3))
    idx = np.empty((h, w), np.int32)
    faces = load().ply_write_corr_grid(
        path.encode(), _ptr(word, ctypes.c_int32), h, w,
        _ptr(scale, ctypes.c_double), iptr, _ptr(idx, ctypes.c_int32),
    )
    if faces < 0:
        raise OutputError(f"ply_write_corr_grid: cannot write {path}")
    return int(faces)


def ply_write_delta_grid(path: str, d16: np.ndarray, out_scale, image=None) -> int:
    """ply_write_corr_grid on the (H, W) uint16 delta plane
    (ops.correlation.pack_state_delta) — byte-identical PLY. The caller
    has checked that the overflow flag (bit 15) is clear. Returns the
    face count."""
    d16 = np.ascontiguousarray(d16, np.uint16)
    h, w = d16.shape
    scale = np.ascontiguousarray(out_scale, np.float64)
    iptr, _image = _image_ptr(image, (h, w, 3))
    idx = np.empty((h, w), np.int32)
    faces = load().ply_write_delta_grid(
        path.encode(), _ptr(d16, ctypes.c_uint16), h, w,
        _ptr(scale, ctypes.c_double), iptr, _ptr(idx, ctypes.c_int32),
    )
    if faces < 0:
        raise OutputError(f"ply_write_delta_grid: cannot write {path}")
    return int(faces)


def format_obj_vertices(verts, colors=None) -> str:
    """'v x y z[ r g b]\\n' lines, shortest-round-trip doubles."""
    verts = np.ascontiguousarray(verts, np.float64)
    n = len(verts)
    # A shortest-round-trip double is at most ~24 characters: 'v ', six
    # fields, separators and the newline fit in 176 bytes (96 without
    # colours).
    buf = ctypes.create_string_buffer((176 if colors is not None else 96) * max(n, 1))
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.float64)
        cptr = _ptr(colors, ctypes.c_double)
    else:
        cptr = _DP()
    written = load().format_obj_vertices(_ptr(verts, ctypes.c_double), n, cptr, buf)
    return buf.raw[:written].decode()


def format_obj_faces(faces) -> str:
    """'f a b c\\n' lines (pass 1-based, reversed indices)."""
    faces = np.ascontiguousarray(faces, np.int32)
    buf = ctypes.create_string_buffer(64 * max(len(faces), 1))
    written = load().format_obj_faces(_ptr(faces, ctypes.c_int32), len(faces), buf)
    return buf.raw[:written].decode()


def format_obj_uvs(uvs) -> str:
    """'vt u v\\n' lines from (N, 2) doubles, shortest-round-trip."""
    uvs = np.ascontiguousarray(uvs, np.float64)
    buf = ctypes.create_string_buffer(64 * max(len(uvs), 1))
    written = load().format_obj_uvs(_ptr(uvs, ctypes.c_double), len(uvs), buf)
    return buf.raw[:written].decode()


def format_obj_faces_uv(faces, uvs) -> str:
    """'f a/ua b/ub c/uc\\n' lines (pass 1-based, reversed vertex and UV
    index triples of equal shape)."""
    faces = np.ascontiguousarray(faces, np.int32)
    uvs = np.ascontiguousarray(uvs, np.int32)
    if faces.shape != uvs.shape:
        raise ValueError(f"faces {faces.shape} and uvs {uvs.shape} differ")
    buf = ctypes.create_string_buffer(96 * max(len(faces), 1))
    written = load().format_obj_faces_uv(
        _ptr(faces, ctypes.c_int32), _ptr(uvs, ctypes.c_int32), len(faces), buf
    )
    return buf.raw[:written].decode()


def delaunay_int(pts: np.ndarray) -> np.ndarray | None:
    """Exact-integer 2D Delaunay triangulation (Bowyer-Watson, int128
    in-circle). pts: (N, 2) integer coords, |coords| < 2^25, pairwise
    distinct. Returns (M, 3) int32 CCW triangles, or None when the input
    is out of contract (the caller falls back to Qhull)."""
    pts = np.ascontiguousarray(pts, np.int32)
    n = len(pts)
    if n < 3:
        return None
    out = np.empty((2 * (n + 1), 3), np.int32)
    m = load().delaunay_int(_ptr(pts, ctypes.c_int32), n, _ptr(out, ctypes.c_int32))
    if m < 0:
        return None
    return out[:m]


def merge_tracks_image(
    pts: np.ndarray, image_i: int, w: int, h: int, r: int, max_d2: int
) -> np.ndarray:
    """Per-image track merge (triangulation.rs:1421-1539); the exact
    native form of ops.sfm._merge_tracks_numpy. pts: (T, n_images, 2)
    int32 with -1 missing. Returns the merged (K, n_images, 2) int32
    tracks in row-major pixel order."""
    pts = np.ascontiguousarray(pts, np.int32)
    t_count, n_img = pts.shape[0], pts.shape[1]
    out = np.empty((h * w, n_img, 2), np.int32)
    k = load().merge_tracks_image(
        _ptr(pts, ctypes.c_int32), t_count, n_img, image_i, w, h, r, max_d2,
        _ptr(out, ctypes.c_int32),
    )
    return out[:k].copy()


def _bytes_ptr(data: bytes):
    """(pointer, array kept alive) to the bytes of `data`, read only."""
    arr = np.frombuffer(data, np.uint8)
    return _ptr(arr, ctypes.c_uint8), arr


def _decode_error(code: int, what: str) -> None:
    from cybervision_tpu_torch.imageio.errors import (
        CorruptImageError,
        TruncatedImageError,
        UnsupportedImageError,
    )

    kind = {-2: TruncatedImageError, -3: UnsupportedImageError}.get(code, CorruptImageError)
    raise kind(f"{what}: the native decoder refused the data (code {code})")


def png_unfilter(rows: np.ndarray, h: int, row_bytes: int, bpp: int, out: np.ndarray) -> int:
    """PNG rows (h, 1 + row_bytes) uint8 -> out (h, row_bytes) uint8, C
    contiguous; bpp: bytes per complete pixel. Returns 0, or -1 on a
    filter type above 4."""
    rows = np.ascontiguousarray(rows, np.uint8)
    if rows.shape != (h, row_bytes + 1) or out.shape != (h, row_bytes) \
            or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("png_unfilter: rows and out do not match")
    return int(load().png_unfilter(
        _ptr(rows, ctypes.c_uint8), h, row_bytes, bpp, _ptr(out, ctypes.c_uint8)))


def _strip(fn_name: str, src: bytes, size: int) -> bytes:
    sptr, _keep = _bytes_ptr(src)
    out = np.empty(max(size, 1), np.uint8)
    n = getattr(load(), fn_name)(sptr, len(src), _ptr(out, ctypes.c_uint8), size)
    if n < 0:
        _decode_error(n, fn_name)
    return out[:n].tobytes()


def tiff_packbits(src: bytes, size: int) -> bytes:
    """Up to `size` bytes of a PackBits-compressed TIFF strip."""
    return _strip("tiff_packbits", src, size)


def tiff_lzw(src: bytes, size: int) -> bytes:
    """Up to `size` bytes of an LZW-compressed TIFF strip."""
    return _strip("tiff_lzw", src, size)


def tiff_zstd(src: bytes, size: int) -> bytes:
    """Up to `size` bytes of a zstd-compressed TIFF strip, as libtiff reads
    it (imagedecode.cpp's zstd_strip): its first frame; fewer bytes when
    the frame ends first."""
    return _strip("zstd_strip", src, size)


def zstd_frames(data: bytes, limit: int) -> bytes:
    """Every frame of a zstd stream (imagedecode.cpp's zstd_frames),
    skippable frames skipped; raises on a broken or truncated frame or on
    more than `limit` bytes of content."""
    return _strip("zstd_frames", data, limit)


def tiff_ccitt(src: bytes, width: int, rows: int, mode: int) -> np.ndarray:
    """A CCITT-coded TIFF strip or tile (imagedecode.cpp's tiff_ccitt;
    mode 2, 3, 5 or 4): (rows, (width + 7) // 8) uint8, 1 bits for black,
    MSB first."""
    sptr, _keep = _bytes_ptr(src)
    out = np.zeros((rows, (width + 7) // 8), np.uint8)
    code = load().tiff_ccitt(sptr, len(src), width, rows, mode, _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "tiff_ccitt")
    return out


def bmp_rle(src: bytes, start: int, width: int, height: int, rle4: bool) -> tuple[np.ndarray, int]:
    """A BMP's RLE8 / RLE4 pixel data starting at file offset `start`
    (imagedecode.cpp's bmp_rle): ((height, width) uint8 indices, the file's
    first row first; the pixels the data filled)."""
    sptr, _keep = _bytes_ptr(src)
    out = np.zeros((height, width), np.uint8)
    n = load().bmp_rle(sptr, len(src), start, width, height, int(rle4), _ptr(out, ctypes.c_uint8))
    return out, int(n)


def gif_lzw(src: bytes, bits: int, interlace: bool, width: int, height: int) -> np.ndarray:
    """A GIF frame's LZW data, from the byte after its minimum code size
    `bits` to the file's end (imagedecode.cpp's gif_lzw): (height, width)
    uint8 indices, interlaced rows put in place."""
    sptr, _keep = _bytes_ptr(src)
    out = np.zeros((height, width), np.uint8)
    code = load().gif_lzw(sptr, len(src), bits, int(interlace), width, height,
                          _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "gif_lzw")
    return out


def tga_rle(src: bytes, depth: int, row_bytes: int, height: int) -> np.ndarray:
    """A TGA's RLE pixel data (imagedecode.cpp's tga_rle; `depth` bytes a
    pixel): (height, row_bytes) uint8 rows in the file's order."""
    sptr, _keep = _bytes_ptr(src)
    out = np.zeros((height, row_bytes), np.uint8)
    code = load().tga_rle(sptr, len(src), depth, row_bytes, height, _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "tga_rle")
    return out


def sgi_rle(data: bytes, xsize: int, ysize: int, zsize: int, bpc: int) -> np.ndarray:
    """An SGI RLE file's data after its 512-byte header (imagedecode.cpp's
    sgi_rle): (ysize, xsize * zsize * bpc) uint8, top row first, channels
    interleaved, 16-bit samples big-endian."""
    dptr, _keep = _bytes_ptr(data)
    out = np.zeros((ysize, xsize * zsize * bpc), np.uint8)
    code = load().sgi_rle(dptr, len(data), xsize, ysize, zsize, bpc, _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "sgi_rle")
    return out


def pcx_rle(src: bytes, line_bytes: int, height: int) -> np.ndarray:
    """A PCX's run-length coded lines (imagedecode.cpp's pcx_rle):
    (height, line_bytes) uint8."""
    sptr, _keep = _bytes_ptr(src)
    out = np.zeros((height, line_bytes), np.uint8)
    code = load().pcx_rle(sptr, len(src), line_bytes, height, _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "pcx_rle")
    return out


def packbits_rows(src: bytes, row_bytes: int, rows: int) -> np.ndarray:
    """PackBits rows as Pillow's packbits decoder reads them
    (imagedecode.cpp's packbits_rows): (rows, row_bytes) uint8."""
    sptr, _keep = _bytes_ptr(src)
    out = np.zeros((rows, row_bytes), np.uint8)
    code = load().packbits_rows(sptr, len(src), row_bytes, rows, _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "packbits_rows")
    return out


def sun_rle(src: bytes, total: int) -> np.ndarray:
    """A Sun raster's byte-encoded data (imagedecode.cpp's sun_rle): the
    first `total` bytes it decodes to, uint8."""
    sptr, _keep = _bytes_ptr(src)
    out = np.zeros(total, np.uint8)
    code = load().sun_rle(sptr, len(src), total, _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "sun_rle")
    return out


def msp_rle(src: bytes, row_bytes: int, height: int) -> np.ndarray:
    """A version 2 MSP's row map and rows after its header (imagedecode.cpp's
    msp_rle): (height, row_bytes) uint8."""
    sptr, _keep = _bytes_ptr(src)
    out = np.zeros((height, row_bytes), np.uint8)
    code = load().msp_rle(sptr, len(src), row_bytes, height, _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "msp_rle")
    return out


def im_bits(src: bytes, bits: int, width: int, height: int) -> np.ndarray:
    """An IM file's packed `bits`-bit samples (imagedecode.cpp's im_bits):
    (height, width) float32, top row first."""
    sptr, _keep = _bytes_ptr(src)
    out = np.zeros((height, width), np.float32)
    code = load().im_bits(sptr, len(src), bits, width, height, _ptr(out, ctypes.c_float))
    if code < 0:
        _decode_error(code, "im_bits")
    return out


def qoi_decode(src: bytes, width: int, height: int, channels: int) -> np.ndarray:
    """QOI ops from the byte after the header (imagedecode.cpp's
    qoi_decode): (height, width, channels) uint8."""
    sptr, _keep = _bytes_ptr(src)
    out = np.zeros((height, width, channels), np.uint8)
    code = load().qoi_decode(sptr, len(src), width, height, channels, _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "qoi_decode")
    return out


def fli_decode(src: bytes, out: np.ndarray) -> tuple[int, int]:
    """One call of Pillow's FLI decoder (imagedecode.cpp's fli_decode) on
    `src`, from a frame chunk's start, into `out`, the (height, width)
    uint8 "P" image kept between calls: (what the decoder returns: bytes
    consumed, or -1 at the frame's end; its error code, 0 for none)."""
    if out.dtype != np.uint8 or out.ndim != 2 or not out.flags.c_contiguous:
        raise ValueError("fli_decode: out must be (height, width) uint8, C contiguous")
    sptr, _keep = _bytes_ptr(src)
    status = np.zeros(1, np.int32)
    n = load().fli_decode(sptr, len(src), out.shape[1], out.shape[0], _ptr(out, ctypes.c_uint8),
                          _ptr(status, ctypes.c_int32))
    return int(n), int(status[0])


def icns_rle(src: bytes, size: int) -> np.ndarray:
    """An ICNS 24-bit icon's run-length code from its first packet to the
    file's end (imagedecode.cpp's icns_rle): (3, size) uint8, the red,
    green and blue planes."""
    sptr, _keep = _bytes_ptr(src)
    out = np.zeros((3, size), np.uint8)
    code = load().icns_rle(sptr, len(src), size, _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "icns_rle")
    return out


def jpeg_decode(data: bytes, frame: np.ndarray, quant: np.ndarray, scans: np.ndarray,
                huff: np.ndarray, cond: np.ndarray, channels: int) -> np.ndarray:
    """Pixels of a sequential, progressive or lossless JPEG, Huffman or
    arithmetic coded, whose markers imageio.jpeg parsed: (H, W) for one
    component, (H, W, 3) for three, (H, W, 4) for four; with the raw flag
    (16) in frame[4], a list of each component's plane over the whole
    MCU grid at its own resolution. frame, quant,
    scans, huff and cond (the arithmetic conditioning of each scan) as
    imagedecode.cpp's jpeg_decode takes them."""
    frame = np.ascontiguousarray(frame, np.int32)
    quant = np.ascontiguousarray(quant, np.uint16)
    scans = np.ascontiguousarray(scans, np.int32)
    huff = np.ascontiguousarray(huff, np.uint8)
    cond = np.ascontiguousarray(cond, np.uint8)
    if scans.ndim != 2 or scans.shape[1] != 20 or huff.shape != (len(scans), 8, 272) \
            or cond.shape != (len(scans), 48) or quant.shape != (frame[2], 64) \
            or channels != frame[2] or len(frame) != 5 + 12 * channels:
        raise ValueError("jpeg_decode: tables do not match the frame")
    w, h = int(frame[0]), int(frame[1])
    if frame[4] & 16:  # raw: every component's plane over the MCU grid
        sampling = frame[5 : 5 + 2 * channels].reshape(channels, 2)
        hmax, vmax = sampling.max(axis=0)
        mcux, mcuy = -(-w // (8 * int(hmax))), -(-h // (8 * int(vmax)))
        shapes = [(mcuy * int(v) * 8, mcux * int(hh) * 8) for hh, v in sampling]
        out = np.empty(sum(a * b for a, b in shapes), np.uint8)
    else:
        out = np.empty((h, w, channels) if channels > 1 else (h, w), np.uint8)
    dptr, _keep = _bytes_ptr(data)
    code = load().jpeg_decode(
        dptr, len(data), _ptr(frame, ctypes.c_int32), _ptr(quant, ctypes.c_uint16),
        _ptr(scans, ctypes.c_int32), len(scans), _ptr(huff, ctypes.c_uint8),
        _ptr(cond, ctypes.c_uint8), _ptr(out, ctypes.c_uint8),
    )
    if code < 0:
        _decode_error(code, "jpeg_decode")
    if frame[4] & 16:
        ends = np.cumsum([a * b for a, b in shapes])[:-1]
        return [p.reshape(shape) for p, shape in zip(np.split(out, ends), shapes)]
    return out


def jpeg_encode_scan(pixels: np.ndarray, quant: np.ndarray, huff: np.ndarray) -> bytes:
    """The entropy-coded segment of a baseline JPEG's one scan
    (imageencode.cpp): pixels (H, W) gray or (H, W, 3) RGB uint8, quant
    (2, 64) uint16 in natural order, huff (4, 272) DC0/AC0/DC1/AC1 specs."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    quant = np.ascontiguousarray(quant, np.uint16)
    huff = np.ascontiguousarray(huff, np.uint8)
    if pixels.ndim not in (2, 3) or (pixels.ndim == 3 and pixels.shape[2] != 3) \
            or quant.shape != (2, 64) or huff.shape != (4, 272):
        raise ValueError("jpeg_encode_scan: need (H, W) or (H, W, 3) pixels and the tables")
    h, w = pixels.shape[:2]
    channels = 1 if pixels.ndim == 2 else 3
    # At most 16 + 11 + 63 * 26 bits a block, doubled for byte stuffing.
    blocks = ((h + 15) // 16) * ((w + 15) // 16) * (4 + 2 if channels == 3 else 4)
    out = np.empty(blocks * 420 + 64, np.uint8)
    n = load().jpeg_encode_scan(
        _ptr(pixels, ctypes.c_uint8), h, w, channels, _ptr(quant, ctypes.c_uint16),
        _ptr(huff, ctypes.c_uint8), _ptr(out, ctypes.c_uint8), len(out))
    if n < 0:
        raise ValueError(f"jpeg_encode_scan refused the image (code {n})")
    return out[:n].tobytes()


def qoi_encode(rgba: np.ndarray) -> bytes:
    """The ops and end marker of Pillow's QOI writer for (H, W, 4) uint8
    RGBA (imageencode.cpp's qoi_encode)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    n = rgba.shape[0] * rgba.shape[1]
    out = np.empty(5 * n + 9, np.uint8)
    k = load().qoi_encode(_ptr(rgba, ctypes.c_uint8), n, _ptr(out, ctypes.c_uint8))
    return out[:k].tobytes()


def png_filter_rows(pixels: np.ndarray) -> bytes:
    """The filtered rows of an 8-bit (H, W, C) image, each its filter type
    and bytes, as Pillow's PNG encoder chooses the filters
    (imageencode.cpp's png_filter_rows)."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w, c = pixels.shape
    out = np.empty(h * (1 + w * c), np.uint8)
    load().png_filter_rows(_ptr(pixels, ctypes.c_uint8), h, w * c, c, _ptr(out, ctypes.c_uint8))
    return out.tobytes()


def resample_rgba(rgba: np.ndarray, size: tuple[int, int], lanczos: bool) -> np.ndarray:
    """Pillow's resize of (H, W, 4) uint8 RGBA to size (width, height) by
    the bicubic or the Lanczos filter (imageencode.cpp's resample_rgba)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"resample_rgba: need (H, W, 4) RGBA, got {rgba.shape}")
    w, h = size
    out = np.empty((h, w, 4), np.uint8)
    if load().resample_rgba(_ptr(rgba, ctypes.c_uint8), rgba.shape[0], rgba.shape[1], h, w,
                            int(lanczos), _ptr(out, ctypes.c_uint8)) < 0:
        raise ValueError(f"resample_rgba: cannot resize {rgba.shape[:2]} to {size}")
    return out


def octree_quantize(rgba: np.ndarray, colors: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """(index (H, W) uint8, palette (colors, 4) uint8) of Pillow's Fast
    Octree quantiser on (H, W, 4) uint8 RGBA (imageencode.cpp's
    octree_quantize)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"octree_quantize: need (H, W, 4) RGBA, got {rgba.shape}")
    index = np.empty(rgba.shape[:2], np.uint8)
    palette = np.empty((colors, 4), np.uint8)
    load().octree_quantize(_ptr(rgba, ctypes.c_uint8), index.size, colors,
                           _ptr(palette, ctypes.c_uint8), _ptr(index, ctypes.c_uint8))
    return index, palette


def gif_lzw_encode(index: np.ndarray, interlace: bool) -> bytes:
    """The LZW code stream of Pillow's GIF writer for (H, W) uint8 palette
    indices, 8-bit codes, rows interlaced or in order (imageencode.cpp's
    gif_lzw_encode)."""
    index = np.ascontiguousarray(index, np.uint8)
    h, w = index.shape
    # At most one 12-bit code a pixel, plus CLEAR, END and the CLEARs.
    cap = (h * w * 12 + 7) // 8 + (h * w) // 2048 + 16
    out = np.empty(cap, np.uint8)
    n = load().gif_lzw_encode(_ptr(index, ctypes.c_uint8), h, w, int(interlace),
                              _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise ValueError("gif_lzw_encode: the code stream overran its buffer")
    return out[:n].tobytes()


def webp_vp8l_decode(data: bytes, width: int, height: int) -> np.ndarray:
    """A VP8L bitstream, its header included (webpdecode.cpp's
    webp_vp8l_decode): (height, width) uint32 0xAARRGGBB."""
    dptr, _keep = _bytes_ptr(data)
    out = np.empty((height, width), np.uint32)
    code = load().webp_vp8l_decode(dptr, len(data), width, height, _ptr(out, ctypes.c_uint32))
    if code < 0:
        _decode_error(code, "webp_vp8l_decode")
    return out


def webp_vp8_decode(data: bytes, width: int, height: int) -> np.ndarray:
    """A VP8 key frame (webpdecode.cpp's webp_vp8_decode): (height, width,
    3) uint8 RGB as libwebp's RGBA output gives it."""
    dptr, _keep = _bytes_ptr(data)
    out = np.empty((height, width, 3), np.uint8)
    code = load().webp_vp8_decode(dptr, len(data), width, height, _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "webp_vp8_decode")
    return out


def webp_alph_decode(data: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH chunk's payload (webpdecode.cpp's webp_alph_decode):
    (height, width) uint8 alpha."""
    dptr, _keep = _bytes_ptr(data)
    out = np.empty((height, width), np.uint8)
    code = load().webp_alph_decode(dptr, len(data), width, height, _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "webp_alph_decode")
    return out


def av1_decode(data: bytes, width: int = 0, height: int = 0) -> tuple[list[np.ndarray], dict]:
    """The first frame of an AV1 stream (av1obu.cpp's av1_decode), a key
    frame of 8, 10 or 12 bits, at its own (upscaled) size, whatever
    width x height its container gives (the buffers' first size): ([Y] or
    [Y, U, V] planes, uint8 at 8 bits and uint16 above, the sequence
    header's colour fields, bit depth and profile, the frame's quantizer
    matrix levels and apply_grain, and under "frame" the frame header's
    base_q_idx, delta q and delta lf flags, quantizer matrix flag, tile
    counts, screen content tools and tx mode select)."""
    from cybervision_tpu_torch.imageio.errors import CorruptImageError, UnsupportedImageError

    lib = load()
    dptr, _keep = _bytes_ptr(data)
    info = np.zeros(24, np.int32)
    n = max(width * height, 1)  # room for 4:4:4 at 16 bits a sample
    while True:
        y, u, v = (np.empty(n, np.uint16) for _ in range(3))
        code = lib.av1_decode(dptr, len(data), n, _ptr(info, ctypes.c_int32),
                              _ptr(y, ctypes.c_uint8), _ptr(u, ctypes.c_uint8),
                              _ptr(v, ctypes.c_uint8))
        if code != -4:
            break
        n = int(info[0]) * int(info[1])  # a frame larger than its container's size
    if code < 0:
        why = lib.av1_error().decode("utf-8", "replace")
        raise (UnsupportedImageError if code == -3 else CorruptImageError)(f"AV1: {why}")
    fields = dict(mono=int(info[2]), subsampling=(int(info[3]), int(info[4])),
                  matrix=int(info[5]), full_range=int(info[6]), primaries=int(info[7]),
                  qm=tuple(int(q) for q in info[8:11]), grain=int(info[11]),
                  frame=dict(zip(("base_q_idx", "delta_q_present", "delta_lf_present",
                                  "using_qmatrix", "tile_cols", "tile_rows",
                                  "allow_screen_content_tools", "tx_mode_select"),
                                 (int(x) for x in info[12:20]))),
                  depth=int(info[20]), profile=int(info[21]))
    wide = fields["depth"] > 8
    width, height = int(info[0]), int(info[1])

    def plane(buf, w, h):
        return (buf if wide else buf.view(np.uint8))[: w * h].reshape(h, w)

    planes = [plane(y, width, height)]
    if not fields["mono"]:
        sx, sy = fields["subsampling"]
        cw, ch = (width + sx) >> sx, (height + sy) >> sy
        planes += [plane(u, cw, ch), plane(v, cw, ch)]
    return planes, fields


def avif_scale(planes: list[np.ndarray], subsampling: tuple[int, int], width: int,
               height: int) -> list[np.ndarray]:
    """A decoded frame's planes ([Y] or [Y, U, V], uint8 or uint16) scaled
    to width x height, chroma to its subsampled size, as libavif 1.3's
    avifImageScaleWithLimit does where a frame is not its item's ispe size
    (yuvscale.cpp: libyuv's ScalePlane / ScalePlane_12 at kFilterBox); the
    planes themselves at that size. A size libavif refuses raises
    CorruptImageError with its diagnostic, as Pillow's load fails."""
    from cybervision_tpu_torch.imageio.errors import CorruptImageError

    sh, sw = planes[0].shape
    if (sw, sh) == (width, height):
        return planes
    why = None
    if not width or not height:
        why = f"requested invalid dst dimensions [{width}x{height}]"
    elif (1 << 28) // height < width or max(width, height) > 32768:
        why = f"requested dst dimensions that are too large [{width}x{height}]"
    elif sw > 16384:
        why = f"requested invalid width scale for libyuv [{sw} -> {width}]"
    elif sh > 16384:
        why = f"requested invalid height scale for libyuv [{sh} -> {height}]"
    if why:
        raise CorruptImageError(f"AVIF: avifImageScaleWithLimit {why}")
    out = []
    for k, p in enumerate(planes):
        sx, sy = subsampling if k else (0, 0)
        w, h = (width + sx) >> sx, (height + sy) >> sy
        src = np.ascontiguousarray(p)
        dst = np.empty((h, w), src.dtype)
        load().yuv_scale_plane(_ptr(src, ctypes.c_uint8), src.shape[1], src.shape[0],
                               _ptr(dst, ctypes.c_uint8), w, h, int(src.dtype == np.uint16))
        out.append(dst)
    return out


def avif_yuv_to_rgb(planes: list[np.ndarray], subsampling: tuple[int, int], full_range: bool,
                    matrix: int, primaries: int, channels: int, depth: int = 8,
                    alpha: np.ndarray | None = None) -> np.ndarray:
    """YUV planes and an optional full-range alpha plane (uint8 at depth 8,
    uint16 at 10 or 12) to (H, W, channels) uint8 as libavif converts them
    for Pillow with the CICP matrix coefficients and colour primaries given
    (avifrgb.cpp); the alpha byte of RGBA is 255 without an alpha plane. A
    matrix libavif cannot convert raises CorruptImageError, as Pillow's
    load fails."""
    from cybervision_tpu_torch.imageio.errors import CorruptImageError

    dtype = np.uint16 if depth > 8 else np.uint8
    y = np.ascontiguousarray(planes[0], dtype)
    h, w = y.shape
    mono = len(planes) == 1
    u = y if mono else np.ascontiguousarray(planes[1], dtype)
    v = y if mono else np.ascontiguousarray(planes[2], dtype)
    a = None if alpha is None else np.ascontiguousarray(alpha, dtype)
    if a is not None and a.shape != y.shape:
        raise ValueError(f"alpha plane {a.shape} != luma {y.shape}")
    out = np.empty((h, w, channels), np.uint8)
    code = load().avif_yuv_to_rgb(_ptr(y, ctypes.c_uint8), _ptr(u, ctypes.c_uint8),
                                  _ptr(v, ctypes.c_uint8),
                                  _U8P() if a is None else _ptr(a, ctypes.c_uint8), w, h,
                                  subsampling[0], subsampling[1], int(mono),
                                  int(bool(full_range)), matrix, primaries, channels, depth,
                                  _ptr(out, ctypes.c_uint8))
    if code < 0:
        raise CorruptImageError(f"AVIF: libavif cannot convert matrix coefficients {matrix}"
                                f" at {'full' if full_range else 'limited'} range")
    return out


def avif_unpremultiply(rgba: np.ndarray) -> None:
    """(H, W, 4) uint8 premultiplied RGBA divided by its alpha in place,
    as libavif does for Pillow (avifrgb.cpp's avif_unpremultiply: libyuv's
    ARGBUnattenuate as its x86 SIMD rows compute it)."""
    if not (rgba.flags.c_contiguous and rgba.dtype == np.uint8 and rgba.shape[-1] == 4):
        raise ValueError("avif_unpremultiply takes C-contiguous uint8 RGBA")
    load().avif_unpremultiply(_ptr(rgba, ctypes.c_uint8), rgba.size // 4)


def avif_rgb_to_yuv(rgba: np.ndarray) -> list[np.ndarray]:
    """(H, W, 4) uint8 RGBA to the [Y, U, V] 4:2:0 planes libavif makes of
    it for Pillow's AVIF writer (avifrgb.cpp's avif_rgb_to_yuv: BT.601,
    full range, libyuv's fixed point)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    y = np.empty((h, w), np.uint8)
    u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = np.empty_like(u)
    load().avif_rgb_to_yuv(_ptr(rgba, ctypes.c_uint8), w, h, _ptr(y, ctypes.c_uint8),
                           _ptr(u, ctypes.c_uint8), _ptr(v, ctypes.c_uint8))
    return [y, u, v]


def av1_encode(planes: list[np.ndarray]) -> bytes:
    """An AV1 key frame (temporal delimiter, sequence header, frame OBU) of
    8-bit [Y] or 4:2:0 [Y, U, V] planes at base_q_idx 64 (av1encode.cpp's
    av1_encode)."""
    y = np.ascontiguousarray(planes[0], np.uint8)
    h, w = y.shape
    mono = len(planes) == 1
    u = y if mono else np.ascontiguousarray(planes[1], np.uint8)
    v = y if mono else np.ascontiguousarray(planes[2], np.uint8)
    cap = 4 * h * w + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = load().av1_encode(_ptr(y, ctypes.c_uint8), _ptr(u, ctypes.c_uint8), _ptr(v, ctypes.c_uint8),
                          w, h, int(mono), _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise ValueError(f"av1_encode: a {w}x{h} plane set is not one AV1 frame")
    return out[:n].tobytes()


def webp_vp8_encode(rgba: np.ndarray) -> bytes:
    """The VP8 key frame libwebp 1.6 writes for (H, W, 4) uint8 RGBA at
    quality 80, method 4 (webpencode.cpp's webp_vp8_encode), without its
    chunk header."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    cap = 8 * h * w + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = load().webp_vp8_encode(_ptr(rgba, ctypes.c_uint8), w, h, _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise ValueError(f"webp_vp8_encode: a {w}x{h} image is not one VP8 frame")
    return out[:n].tobytes()


def webp_alph_encode(alpha: np.ndarray) -> bytes | None:
    """The ALPH chunk's payload libwebp 1.6 writes for an (H, W) uint8
    alpha plane of 0s and 255s (webpencode.cpp's webp_alph_encode); None
    for a plane with other levels."""
    alpha = np.ascontiguousarray(alpha, np.uint8)
    h, w = alpha.shape
    cap = h * w + 1
    out = np.empty(cap, np.uint8)
    n = load().webp_alph_encode(_ptr(alpha, ctypes.c_uint8), w, h, _ptr(out, ctypes.c_uint8), cap)
    if n == -2:
        return None
    if n < 0:
        raise ValueError("webp_alph_encode: the chunk overran its buffer")
    return out[:n].tobytes()


def bcn_decode(data: bytes, width: int, height: int, kind: int, sign: bool = False) -> np.ndarray:
    """Pillow's "bcn" decoder on `data` (bcndecode.cpp's bcn_decode): blocks
    of BC`kind` (1-7; `sign`: BC4/BC5 signed bytes, BC6H signed halves) into
    (height, width, 4) RGBA for BC1-3 and BC7, (height, width) for BC4,
    (height, width, 3) RGB for BC5 and BC6H; raises where the data holds
    fewer blocks than the image."""
    dptr, _keep = _bytes_ptr(data)
    channels = {4: 1, 5: 3, 6: 3}.get(kind, 4)
    out = np.zeros((height, width, channels) if channels > 1 else (height, width), np.uint8)
    code = load().bcn_decode(dptr, len(data), width, height, kind, int(sign),
                             _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "bcn_decode")
    return out


def blp_dxt(data: bytes, blocks: int, block_rows: int, kind: int, alpha: bool) -> bytes:
    """BLP2's DXT`kind` (1, 3 or 5) blocks as BlpImagePlugin.py's
    decode_dxt* lay them out (bcndecode.cpp's blp_dxt): `block_rows` rows of
    `blocks` blocks, each four rows of 4 * blocks pixels of 3 bytes (DXT1
    without `alpha`) or 4, as one flat stream."""
    dptr, _keep = _bytes_ptr(data)
    bpp = 3 if kind == 1 and not alpha else 4
    out = np.empty(max(block_rows * 16 * blocks * bpp, 1), np.uint8)
    code = load().blp_dxt(dptr, len(data), blocks, block_rows, kind, int(alpha),
                          _ptr(out, ctypes.c_uint8))
    if code < 0:
        _decode_error(code, "blp_dxt")
    return out[:code].tobytes()


def j2k_decode_tile(params: np.ndarray, data: bytes, numcomps: int, samples: int,
                    stages: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """One JPEG 2000 tile (j2kdecode.cpp): `params` as imageio/jpeg2000.py
    lays them out, its tile-parts' data -> (each of the `numcomps`
    components' highest resolution among the tile's packets, int32; up to
    `samples` int32 of its components in turn at that resolution, as
    OpenJPEG gives them to Pillow). `stages` (4 float64, or None) gains
    the seconds of tier-2, tier-1 and dequantisation, the inverse DWT and
    the rest."""
    dptr, _keep = _bytes_ptr(data)
    params = np.ascontiguousarray(params, np.int32)
    resno = np.zeros(numcomps, np.int32)
    out = np.zeros(max(samples, 1), np.int32)
    code = load().j2k_decode_tile(_ptr(params, ctypes.c_int32), dptr, len(data),
                                  _ptr(resno, ctypes.c_int32), _ptr(out, ctypes.c_int32),
                                  out.size,
                                  _DP() if stages is None else _ptr(stages, ctypes.c_double))
    if code < 0:
        _decode_error(code, "j2k_decode_tile")
    return resno, out


def j2k_encode_tile(pixels: np.ndarray, levels: int) -> bytes:
    """The tile-part, SOT to EOC, of an (H, W, C) uint8 image coded as
    OpenJPEG codes Pillow's lossless JPEG 2000 with `levels`
    decomposition levels (j2kencode.cpp)."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w, c = pixels.shape
    cap = h * w * c + h * w // 2 + 4096
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        n = load().j2k_encode_tile(_ptr(pixels, ctypes.c_uint8), h, w, c, levels,
                                   _ptr(out, ctypes.c_uint8), cap)
        if n >= 0:
            return out[:n].tobytes()
        if n == -1:
            raise ValueError(f"j2k_encode_tile: cannot code a {w}x{h} tile at {levels} levels")
        cap = -n
    raise AssertionError("j2k_encode_tile: the tile grew between two runs")
