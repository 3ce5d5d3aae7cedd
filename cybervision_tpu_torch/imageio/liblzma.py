"""libtiff's LZMA strip decode (tif_lzma.c, LZMADecode), through the
liblzma that Python's own _lzma module loads, bound with ctypes (no
header and no build).

libtiff runs liblzma's .xz stream decoder (no memory limit, no flags)
with the whole strip in and the strip's size out, calls lzma_code until
the strip is full, stops at the stream's end and, on any other error,
keeps every byte liblzma wrote before it: a damaged stream whose strip
fills before liblzma finds the damage reads. Python's LZMADecompressor
drops the bytes of a call that fails, so it cannot give that strip.
"""

from __future__ import annotations

import ctypes
import functools

from cybervision_tpu_torch.imageio.errors import CorruptImageError, NativeDecoderError

_RUN = 0  # lzma_action LZMA_RUN
_OK, _STREAM_END = 0, 1
_ERRORS = {2: "LZMA_NO_CHECK", 3: "LZMA_UNSUPPORTED_CHECK", 4: "LZMA_GET_CHECK",
           5: "LZMA_MEM_ERROR", 6: "LZMA_MEMLIMIT_ERROR", 7: "LZMA_FORMAT_ERROR",
           8: "LZMA_OPTIONS_ERROR", 9: "LZMA_DATA_ERROR", 10: "LZMA_BUF_ERROR",
           11: "LZMA_PROG_ERROR"}


class _Stream(ctypes.Structure):
    """lzma_stream (lzma/base.h); zeroed, it is LZMA_STREAM_INIT."""

    _fields_ = [
        ("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t),
        ("total_in", ctypes.c_uint64),
        ("next_out", ctypes.c_void_p), ("avail_out", ctypes.c_size_t),
        ("total_out", ctypes.c_uint64),
        ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p),
        ("reserved_ptr", ctypes.c_void_p * 4),
        ("seek_pos", ctypes.c_uint64), ("reserved_int2", ctypes.c_uint64),
        ("reserved_int3", ctypes.c_size_t), ("reserved_int4", ctypes.c_size_t),
        ("reserved_enum", ctypes.c_int * 2),
    ]


def _library() -> ctypes.CDLL:
    try:
        import lzma  # noqa: F401 - Python built without it has no _lzma either
    except ImportError as err:
        raise NativeDecoderError("LZMA-compressed TIFF needs Python's lzma module, which this"
                                 " Python was built without") from err
    return _bind()


@functools.lru_cache(maxsize=1)
def _bind() -> ctypes.CDLL:
    import _lzma

    # _lzma's own handle resolves liblzma's symbols through its dependencies
    # (or its own, where liblzma is linked in and exported).
    try:
        lib = ctypes.CDLL(getattr(_lzma, "__file__", None))
        lib.lzma_code  # noqa: B018 - raises AttributeError where it is absent
    except (OSError, AttributeError) as err:
        raise NativeDecoderError("LZMA-compressed TIFF needs liblzma, which Python's lzma module"
                                 " does not expose to ctypes on this machine") from err
    lib.lzma_stream_decoder.argtypes = [ctypes.POINTER(_Stream), ctypes.c_uint64, ctypes.c_uint32]
    lib.lzma_code.argtypes = [ctypes.POINTER(_Stream), ctypes.c_int]
    lib.lzma_end.argtypes = [ctypes.POINTER(_Stream)]
    lib.lzma_end.restype = None
    lib.lzma_version_string.restype = ctypes.c_char_p
    return lib


def library() -> tuple[str, str]:
    """(the file liblzma's lzma_code was loaded from, liblzma's version)."""
    lib = _library()

    class _DlInfo(ctypes.Structure):
        _fields_ = [("fname", ctypes.c_char_p), ("fbase", ctypes.c_void_p),
                    ("sname", ctypes.c_char_p), ("saddr", ctypes.c_void_p)]

    info = _DlInfo()
    dladdr = ctypes.CDLL(None).dladdr
    dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(_DlInfo)]
    found = dladdr(ctypes.cast(lib.lzma_code, ctypes.c_void_p), ctypes.byref(info))
    path = info.fname.decode() if found and info.fname else "unknown"
    return path, lib.lzma_version_string().decode()


def decode_strip(raw: bytes, size: int) -> bytes:
    """Up to `size` bytes of an .xz stream, as libtiff's LZMADecode gives
    them: short where the stream ends first; CorruptImageError where
    liblzma fails before the strip is full."""
    lib = _library()
    stream = _Stream()
    ret = lib.lzma_stream_decoder(ctypes.byref(stream), 2**64 - 1, 0)
    if ret != _OK:
        raise CorruptImageError(f"TIFF LZMA strip: {_ERRORS.get(ret, ret)} from the decoder's"
                                " set-up")
    src = ctypes.create_string_buffer(raw, len(raw))
    out = ctypes.create_string_buffer(size)
    stream.next_in, stream.avail_in = ctypes.cast(src, ctypes.c_void_p), len(raw)
    stream.next_out, stream.avail_out = ctypes.cast(out, ctypes.c_void_p), size
    try:
        ret = _OK
        while stream.avail_out > 0:
            ret = lib.lzma_code(ctypes.byref(stream), _RUN)
            if ret != _OK:
                break
        written = size - stream.avail_out
    finally:
        lib.lzma_end(ctypes.byref(stream))
    if ret not in (_OK, _STREAM_END) and written < size:
        raise CorruptImageError(f"TIFF LZMA strip: {_ERRORS.get(ret, ret)}")
    return out.raw[:written]
