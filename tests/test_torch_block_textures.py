"""The port's readers of block-compressed and other game textures — DDS
(imageio/dds.py), BLP (imageio/blp.py) and FTEX (imageio/ftex.py), with
the native library's bcn_decode (Pillow's "bcn" decoder, BC1-BC7) and
blp_dxt (BlpImagePlugin.py's own DXT decoders) — against the JAX
package's, which reads through Pillow 12.1: for every file the same
read_metadata, the same SourceImage.load gray plane and metadata and the
same colour plane, bit for bit; where Pillow refuses a file the port
raises an ImageError without "yet"; where Pillow's plugin passes a file
on, both end at the same "cannot identify".

Files are made at test time from numpy seeds by chip_smoke.py's writers
(dds_file, bc1_colour_blocks, bc3_alpha_blocks, dxt5_blocks,
bc7_mode6_blocks, dds_masked, blp1_file, blp2_file, ftex_file, rgb_jpeg)
or hold seeded random blocks, nearly all of which are valid BC6H and
BC7 blocks, with Pillow as the reader of record.
"""

import hashlib
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as cs
from cybervision_tpu import images as jimages
from cybervision_tpu_torch import cli, imageio, native
from cybervision_tpu_torch import images as timages
from cybervision_tpu_torch.errors import ImageError
from cybervision_tpu_torch.imageio import NativeDecoderError, UnsupportedImageError

from .test_pipeline import _fast_cfg, _sem_pair
from .test_torch_images import _jax_load, _meta, _texture
from .test_torch_pipeline import SAME_F_DEPTH_BUDGET, _port_fast_cfg, _read_ply
from .test_torch_raster_formats import _assert_same, _write

torch.set_num_threads(2)

W, H = 22, 13  # neither a multiple of 4


def _blocks(rng, n: int, size: int, modes=None) -> bytes:
    """`n` seeded random blocks of `size` bytes; `modes`: BC7's mode byte
    cycled through modes 0-7 and the reserved mode (no bit set), or BC6H's
    mode bits through all 32 values."""
    data = bytearray(rng.bytes(n * size))
    for k in range(n):
        if modes == "bc7":
            m = k % 9
            data[k * size] = (data[k * size] & (0xFF << (m + 1)) & 0xFF) | (1 << m if m < 8 else 0)
        elif modes == "bc6":
            data[k * size] = (data[k * size] & 0xE0) | (k % 32)
    return bytes(data)


def _nblocks(w=W, h=H):
    return ((w + 3) // 4) * ((h + 3) // 4)


def _colour_order_blocks(rng, n: int, c0_gt_c1: bool, size: int) -> bytes:
    """Random BC1-BC3 blocks whose colour part has c0 > c1 or c0 <= c1
    (equal in every fourth block), every pixel's index 3 in every other."""
    data = bytearray(rng.bytes(n * size))
    for k in range(n):
        at = k * size + size - 8
        c0, c1 = struct.unpack_from("<HH", data, at)
        if k % 4 == 0:
            c1 = c0
        elif (c0 > c1) != c0_gt_c1:
            c0, c1 = c1, c0
        struct.pack_into("<HH", data, at, c0, c1)
        if k % 2:
            struct.pack_into("<I", data, at + 4, 0xFFFFFFFF)
    return bytes(data)


# -- DDS ---------------------------------------------------------------------------------


def _dds(kind, **opts):
    def build(path, rng):
        rgb, g, a = _texture(rng, H, W, 3), _texture(rng, H, W), _texture(rng, H, W)
        rgba = np.concatenate([rgb, a[:, :, None]], axis=2)
        n = _nblocks()
        if kind == "dxt1 encoder":
            data = cs.bc1_file(rgb)
        elif kind == "dxt5 encoder":
            data = cs.dds_file((W, H), cs.dxt5_blocks(rgba), fourcc=b"DXT5")
        elif kind == "bc7 encoder":
            data = cs.dds_file((W, H), cs.bc7_mode6_blocks(rgba), dxgi=98)
        elif kind == "bc4 encoder":
            data = cs.dds_file((W, H), cs.bc3_alpha_blocks(g).tobytes(), fourcc=b"ATI1")
        elif kind == "fourcc":
            size = 8 if opts["fourcc"] in (b"DXT1", b"BC4U", b"ATI1") else 16
            data = cs.dds_file((W, H), _blocks(rng, n, size), fourcc=opts["fourcc"])
        elif kind == "colour order":
            size = 8 if opts["fourcc"] == b"DXT1" else 16
            data = cs.dds_file((W, H), _colour_order_blocks(rng, n, opts["gt"], size),
                               fourcc=opts["fourcc"])
        elif kind == "dxgi":
            dxgi, w = opts["dxgi"], opts.get("w", W)
            size = 8 if dxgi in (70, 71, 79, 80) else 16
            modes = "bc7" if dxgi in (97, 98, 99) else "bc6" if dxgi in (95, 96) else None
            payload = rgba.tobytes() if dxgi in (27, 28, 29) \
                else _blocks(rng, _nblocks(w, H), size, modes)
            data = cs.dds_file((w, H), payload, dxgi=dxgi)
        elif kind == "masks":
            alpha = a if len(opts["masks"]) == 4 else None
            data = cs.dds_masked(rgb, opts["bits"], opts["masks"], alpha)
            data = data[: len(data) - opts.get("cut", 0)]
        elif kind == "L":
            data = cs.dds_file((W, H), g.tobytes() + b"tail", cs.DDPF_LUMINANCE, bitcount=8)
        elif kind == "LA":
            data = cs.dds_file((W, H), np.stack([g, a], axis=2).tobytes(),
                               cs.DDPF_LUMINANCE | cs.DDPF_ALPHAPIXELS, bitcount=16)
        else:  # "P"
            data = cs.dds_file((W, H), rng.bytes(1024) + g.tobytes(), cs.DDPF_PALETTE)
        _write(path, data)
    return build


DDS = {
    "dds dxt1 encoder": _dds("dxt1 encoder"),
    "dds dxt5 encoder": _dds("dxt5 encoder"),
    "dds bc7 mode 6 encoder": _dds("bc7 encoder"),
    "dds bc4 encoder": _dds("bc4 encoder"),
    **{f"dds {f.decode()} random blocks": _dds("fourcc", fourcc=f)
       for f in (b"DXT1", b"DXT3", b"DXT5", b"BC4U", b"ATI1", b"BC5S", b"BC5U", b"ATI2")},
    **{f"dds {f.decode()} c0 {'>' if gt else '<='} c1, index 3": _dds("colour order", fourcc=f,
                                                                      gt=gt)
       for f in (b"DXT1", b"DXT3", b"DXT5") for gt in (True, False)},
    **{f"dds dx10 dxgi {d}": _dds("dxgi", dxgi=d)
       for d in (70, 71, 73, 74, 76, 77, 79, 80, 82, 83, 84, 27, 28, 29)},
    # 18 x 4 blocks: every BC7 mode and the reserved one, every BC6H mode
    # value, more than once.
    **{f"dds dx10 dxgi {d}, every mode": _dds("dxgi", dxgi=d, w=70)
       for d in (95, 96, 97, 98, 99)},
    "dds masks 565": _dds("masks", bits=16, masks=(0xF800, 0x07E0, 0x001F)),
    "dds masks 1555": _dds("masks", bits=16, masks=(0x7C00, 0x03E0, 0x001F, 0x8000)),
    "dds masks 4444": _dds("masks", bits=16, masks=(0x0F00, 0x00F0, 0x000F, 0xF000)),
    "dds masks 332": _dds("masks", bits=8, masks=(0xE0, 0x1C, 0x03)),
    "dds masks 888": _dds("masks", bits=24, masks=(0xFF0000, 0xFF00, 0xFF)),
    "dds masks 8888": _dds("masks", bits=32, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "dds masks 10-10-10-2": _dds("masks", bits=32, masks=(0x3FF, 0xFFC00, 0x3FF00000,
                                                          0xC0000000)),
    "dds masks of 40 bits": _dds("masks", bits=40, masks=(0xFF00, 0xFF0000, 0xFF000000)),
    "dds masks, a zero mask": _dds("masks", bits=32, masks=(0xFF0000, 0, 0xFF)),
    "dds masks 565, the tail cut mid-pixel": _dds("masks", bits=16, cut=21,
                                                  masks=(0xF800, 0x07E0, 0x001F)),
    "dds masks 888, half the pixels cut": _dds("masks", bits=24, cut=W * H * 3 // 2,
                                               masks=(0xFF0000, 0xFF00, 0xFF)),
    "dds L, after the header": _dds("L"),
    "dds LA": _dds("LA"),
    "dds P, after its palette": _dds("P"),
}


# -- BLP ---------------------------------------------------------------------------------


def _split(jpeg: bytes) -> tuple[bytes, bytes]:
    sos = jpeg.index(b"\xff\xda")
    return jpeg[:sos], jpeg[sos:]


def _cmyk_jpeg(rng, transform: int) -> bytes:
    """Pillow's CMYK JPEG with its Adobe marker's transform set."""
    import io

    buf = io.BytesIO()
    Image.fromarray(_texture(rng, H, W, 4), "CMYK").save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    at = data.index(b"Adobe")
    data[at + 11] = transform
    return bytes(data)


def _blp(kind, alpha=False, w=W, h=H, **opts):
    def build(path, rng):
        rgb, g = _texture(rng, h, w, 3), _texture(rng, h, w)
        if kind == "jpeg":
            jpeg = {"rgb": lambda: cs.rgb_jpeg(rgb), "gray": lambda: _gray_jpeg(g),
                    "ycck": lambda: _cmyk_jpeg(rng, 2), "cmyk": lambda: _cmyk_jpeg(rng, 0)
                    }[opts.get("jpeg", "rgb")]()
            header, body = _split(jpeg)
            data = cs.blp1_file((w, h), body, alpha, jpeg_header=header)
            if opts.get("gap"):  # the data lies past the header: offsets[0] skips ahead
                at = 28 + 128 + 4 + len(header)
                data = data[:at] + bytes(9) + data[at:]
                data = data[:28] + struct.pack("<I", at + 9) + data[32:]
        elif kind == "blp1 palette":
            data = cs.blp1_file((w, h), rng.bytes(1024) + g.tobytes(), alpha,
                                encoding=opts["encoding"])
        elif kind == "blp2 palette":
            data = cs.blp2_file((w, h), g.tobytes(), 1, alpha, palette=rng.bytes(1024))
        else:  # DXT, alpha encoding 0, 1 or 7
            size = 8 if opts["enc"] == 0 else 16
            data = cs.blp2_file((w, h), _blocks(rng, _nblocks(w, h), size), 2, alpha,
                                opts["enc"])
        _write(path, data)
    return build


def _gray_jpeg(g) -> bytes:
    from cybervision_tpu_torch.imageio.jpeg_encode import quant_tables

    quant = quant_tables(90)
    coefs = cs.dct_coefficients([g], quant, [(1, 1)], g.shape[1], g.shape[0])
    return cs.huffman_jpeg(coefs, quant, g.shape[1], g.shape[0])[0]


BLP = {
    "blp1 jpeg, red and blue swapped": _blp("jpeg"),
    "blp1 jpeg with alpha": _blp("jpeg", True),
    "blp1 jpeg, data past the header": _blp("jpeg", gap=True),
    "blp1 jpeg gray": _blp("jpeg", jpeg="gray"),
    "blp1 jpeg CMYK": _blp("jpeg", jpeg="cmyk"),
    "blp1 jpeg YCCK, read as CMYK": _blp("jpeg", jpeg="ycck"),
    "blp1 palette encoding 4": _blp("blp1 palette", encoding=4),
    "blp1 palette encoding 5 with alpha": _blp("blp1 palette", True, encoding=5),
    "blp2 palette": _blp("blp2 palette"),
    "blp2 palette with alpha": _blp("blp2 palette", True),
    "blp2 dxt1, sheared at width 22": _blp("dxt", enc=0),
    "blp2 dxt1 with alpha": _blp("dxt", True, enc=0),
    "blp2 dxt1 at width 24": _blp("dxt", enc=0, w=24, h=16),
    "blp2 dxt3": _blp("dxt", True, enc=1),
    "blp2 dxt5": _blp("dxt", True, enc=7),
    "blp2 dxt5 without alpha, 4-byte pixels read as RGB": _blp("dxt", enc=7),
    "blp2 dxt3 without alpha": _blp("dxt", enc=1, w=16, h=8),
}


# -- FTEX --------------------------------------------------------------------------------


def _ftex(fmt, size_field=None, tail=b""):
    def build(path, rng):
        rgb = _texture(rng, H, W, 3)
        mip = cs.bc1_colour_blocks(rgb).tobytes() if fmt == 0 else rgb.tobytes()
        data = bytearray(cs.ftex_file((W, H), mip + tail, fmt))
        if size_field is not None:
            struct.pack_into("<i", data, 32, size_field)
        _write(path, bytes(data))
    return build


FTEX = {
    "ftex dxt1": _ftex(0),
    "ftex uncompressed": _ftex(1),
    "ftex uncompressed, mipmap size -1 (the rest)": _ftex(1, -1, b"trailing"),
    "ftex dxt1 with bytes past the mipmap": _ftex(0, tail=bytes(40)),
}

CASES = {**DDS, **BLP, **FTEX}


def _write_case(tmp_path, name: str) -> str:
    path = str(tmp_path / f"case.{'ftc' if name.startswith('ftex') else name[:3]}")
    CASES[name](path, np.random.RandomState(sorted(CASES).index(name)))
    return path


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_textures_match_jax(tmp_path, name):
    _assert_same(_write_case(tmp_path, name))


def test_every_block_kind_and_bc7_mode_is_held_to_pillow():
    """The seeded random blocks of the dx10 cases reach every BC7 mode and
    the reserved one, every BC6H mode value (the reserved ones too); the
    colour-order cases hold both of BC1-BC3's colour modes with index 3
    (BC1's transparent black, BC2 and BC3's fourth colour)."""
    rng = np.random.RandomState(0)
    bc7 = _blocks(rng, 36, 16, "bc7")
    assert {bc7[k * 16] & -bc7[k * 16] for k in range(36)} == {0, 1, 2, 4, 8, 16, 32, 64, 128}
    bc6 = _blocks(rng, 64, 16, "bc6")
    assert {bc6[k * 16] & 0x1F for k in range(64)} == set(range(32))
    for size in (8, 16):
        for gt in (True, False):
            data = _colour_order_blocks(rng, 8, gt, size)
            pairs = [struct.unpack_from("<HH", data, k * size + size - 8) for k in range(8)]
            assert all((c0 > c1) == gt for c0, c1 in pairs[1:4]) and pairs[0][0] == pairs[0][1]


def test_dds_dxt1_and_blp_dxt1_read_the_same_blocks_apart(tmp_path):
    """The same DXT1 blocks as a DDS (Pillow's C decoder: 5:6:5 widened by
    bit replication, blocks in place) and as a BLP2 (the plugin's Python
    decoder: a shift, rows of the blocks' width taken at the image's) give
    different planes at width 22, each the JAX package's."""
    rng = np.random.RandomState(11)
    blocks = _blocks(rng, _nblocks(), 8)
    dds, blp = str(tmp_path / "a.dds"), str(tmp_path / "a.blp")
    _write(dds, cs.dds_file((W, H), blocks, fourcc=b"DXT1"))
    _write(blp, cs.blp2_file((W, H), blocks, 2, False, 0))
    for p in (dds, blp):
        _assert_same(p)
    a, b = (timages.SourceImage.load(p).load_rgb_plane() for p in (dds, blp))
    assert not np.array_equal(a, b)
    same = cs.dds_file((24, 16), _blocks(rng, 24, 8), fourcc=b"DXT1")
    _write(dds, same)
    _write(blp, cs.blp2_file((24, 16), same[128:], 2, False, 0))
    a, b = (timages.SourceImage.load(p).load_rgb_plane().astype(int) for p in (dds, blp))
    assert 0 < np.abs(a - b).max() <= 7  # no shear at width 24: only the widening differs


def test_mask_scaling_truncates():
    """DdsRgbDecoder scales a field as int(v / max * 255) in float64: a
    5-bit 16 gives 131, where rounding would give 132."""
    data = cs.dds_file((4, 1), struct.pack("<4H", *([16 << 11] * 4)), cs.DDPF_RGB, bitcount=16,
                       masks=(0xF800, 0x07E0, 0x001F, 0))
    mode, got, _ = imageio.ImageFile(*imageio.identify(data)).decode()
    assert mode == "RGB" and got[0].tolist() == [[131, 0, 0]] * 4


def _refused(kind, path, rng):
    g = _texture(rng, H, W)
    rgb = _texture(rng, H, W, 3)
    n = _nblocks()
    if kind == "dds header size 100":
        data = bytearray(cs.bc1_file(rgb))
        data[4] = 100
    elif kind == "dds header cut short":
        data = cs.bc1_file(rgb)[:100]
    elif kind == "dds luminance of 16 bits without alpha":
        data = cs.dds_file((W, H), g.tobytes() * 2, cs.DDPF_LUMINANCE, bitcount=16)
    elif kind == "dds fourcc ABCD":
        data = cs.dds_file((W, H), _blocks(rng, n, 8), fourcc=b"ABCD")
    elif kind == "dds dxgi format 2":
        data = cs.dds_file((W, H), _blocks(rng, n, 16), dxgi=2)
    elif kind == "dds pixel format flags 2":
        data = cs.dds_file((W, H), _blocks(rng, n, 8), 0x2)
    elif kind == "dds dxt1 cut short":
        data = cs.bc1_file(rgb)[:-9]
    elif kind == "dds bc7 cut short":
        data = cs.dds_file((W, H), _blocks(rng, n, 16, "bc7"), dxgi=98)[:-1]
    elif kind == "dds L cut short":
        data = cs.dds_file((W, H), g.tobytes()[:-1], cs.DDPF_LUMINANCE, bitcount=8)
    elif kind == "dds P, palette cut short":
        data = cs.dds_file((W, H), rng.bytes(700), cs.DDPF_PALETTE)
    elif kind == "dds dx10 raw cut short":
        data = cs.dds_file((W, H), rng.bytes(W * H * 4 - 1), dxgi=28)
    elif kind == "blp1 encoding 3":
        data = cs.blp1_file((W, H), rng.bytes(1024) + g.tobytes(), encoding=3)
    elif kind == "blp1 compression 2":
        data = bytearray(cs.blp1_file((W, H), rng.bytes(1024) + g.tobytes()))
        data[4] = 2
    elif kind == "blp2 encoding 3 (raw BGRA)":
        data = cs.blp2_file((W, H), rng.bytes(W * H * 4), 3)
    elif kind == "blp2 compression 0 (JPEG)":
        data = bytearray(cs.blp2_file((W, H), g.tobytes(), 1))
        data[4] = 0
    elif kind == "blp2 alpha encoding 2":
        data = cs.blp2_file((W, H), _blocks(rng, n, 16), 2, alpha_encoding=2)
    elif kind == "blp2 dxt5 cut short":
        data = cs.blp2_file((W, H), _blocks(rng, n, 16), 2)[:-1]
    elif kind == "blp2 palette cut short":
        data = cs.blp2_file((W, H), b"", 2)[:700]
    elif kind == "blp1 palette indices short of the image":
        data = cs.blp1_file((W, H), rng.bytes(1024) + g.tobytes()[:-1])
    elif kind == "blp1 jpeg data not a JPEG":
        data = cs.blp1_file((W, H), rng.bytes(200), jpeg_header=b"\x00\x01")
    elif kind == "blp1 jpeg smaller than the image":
        header, body = _split(cs.rgb_jpeg(rgb[:, : W - 4]))
        data = cs.blp1_file((W, H), body, jpeg_header=header)
    elif kind == "blp offsets cut short":
        data = cs.blp2_file((W, H), b"", 2)[:60]
    elif kind == "ftex of 2 formats":
        data = bytearray(cs.ftex_file((W, H), rgb.tobytes(), 1))
        data[20] = 2
    elif kind == "ftex format 2":
        data = cs.ftex_file((W, H), rgb.tobytes(), 2)
    elif kind == "ftex mipmap at a negative offset":
        data = bytearray(cs.ftex_file((W, H), rgb.tobytes(), 1))
        struct.pack_into("<i", data, 28, -5)
    elif kind == "ftex of width 0, the file closed first":
        data = cs.ftex_file((0, H), rgb.tobytes(), 1)
    elif kind == "ftex mipmap size -5":
        data = bytearray(cs.ftex_file((W, H), rgb.tobytes(), 1))
        struct.pack_into("<i", data, 32, -5)
    elif kind == "ftex dxt1 mipmap short":
        data = cs.ftex_file((W, H), cs.bc1_colour_blocks(rgb).tobytes()[:-1], 0)
    else:  # "ftex uncompressed mipmap short"
        data = cs.ftex_file((W, H), rgb.tobytes()[:-1], 1)
    _write(path, bytes(data))


REFUSED = ["dds header size 100", "dds header cut short", "dds luminance of 16 bits without alpha",
           "dds fourcc ABCD", "dds dxgi format 2", "dds pixel format flags 2",
           "dds dxt1 cut short", "dds bc7 cut short", "dds L cut short",
           "dds P, palette cut short", "dds dx10 raw cut short", "blp1 encoding 3",
           "blp1 compression 2", "blp2 encoding 3 (raw BGRA)", "blp2 compression 0 (JPEG)",
           "blp2 alpha encoding 2", "blp2 dxt5 cut short", "blp2 palette cut short",
           "blp1 palette indices short of the image", "blp1 jpeg data not a JPEG",
           "blp1 jpeg smaller than the image", "blp offsets cut short", "ftex of 2 formats",
           "ftex format 2", "ftex mipmap at a negative offset", "ftex dxt1 mipmap short",
           "ftex uncompressed mipmap short", "ftex of width 0, the file closed first",
           "ftex mipmap size -5"]


@pytest.mark.parametrize("kind", REFUSED)
def test_kinds_pillow_refuses_are_refused(tmp_path, kind):
    """Files Pillow 12.1 does not read (a header or pixel format its plugin
    rejects, data short of the image): the JAX package's load raises, and
    so does the port's, with an ImageError without "yet"; the metadata
    agree."""
    path = str(tmp_path / "refused.bin")
    _refused(kind, path, np.random.RandomState(REFUSED.index(kind)))
    assert _meta(timages.read_metadata(path)) == _meta(jimages.read_metadata(path))
    assert isinstance(_jax_load(path), Exception)
    with pytest.raises(ImageError) as err:
        timages.SourceImage.load(path).load_rgb_plane()
    assert "yet" not in str(err.value)


PASSED_ON = {
    "dds of 6 bytes": b"DDS \x7c\x00",
    "dds ending in its dx10 extension": cs.dds_file((8, 8), b"", dxgi=98)[:130],
    "dds of width 0": cs.dds_file((0, 8), bytes(64), fourcc=b"DXT1"),
    "blp ending in its header": b"BLP2\x01\x00\x00\x00\x02",
    "blp of height 0": cs.blp2_file((8, 0), b"", 2),
    "ftex ending in its header": b"FTEX\x01\x00\x00\x00\x08\x00",
    "ftex mipmap size past the end": cs.ftex_file((8, 8), b"", 1)[:34],
}


@pytest.mark.parametrize("kind", sorted(PASSED_ON))
def test_files_pillows_plugin_passes_on_reach_no_reader(tmp_path, kind):
    """A header Pillow's plugin fails with struct.error (a file ending
    inside it) or a size of 0 passes the file on; no later plugin takes
    these files, so Pillow cannot identify them, and the port's refusal
    names every reader (the DDS one of 6 bytes was refused as "not
    supported yet" before the port read DDS)."""
    path = str(tmp_path / "passed.bin")
    _write(path, PASSED_ON[kind])
    with pytest.raises(Image.UnidentifiedImageError):
        Image.open(path)
    assert isinstance(_jax_load(path), Exception)
    with pytest.raises(UnsupportedImageError, match="nor any other Pillow plugin") as err:
        timages.SourceImage.load(path)
    assert "DDS, BLP, FTEX" in str(err.value)


def _damaged(data: bytes, rng, it) -> bytes:
    """`data` cut short, with bytes of its header overwritten, or with one
    of its header's words set to a value its plugin tests."""
    data = bytearray(data)
    if it % 3 == 0:
        return bytes(data[: rng.randint(0, len(data) + 1)])
    if it % 3 == 1:
        for _ in range(rng.randint(1, 4)):
            data[rng.randint(0, min(len(data), 160))] = rng.randint(256)
        return bytes(data)
    at = rng.randint(4, min(len(data), 156))
    data[at : at + 4] = struct.pack("<I", rng.choice(
        [0, 1, 2, 3, 7, 8, 16, 28, 32, 64, 98, 124, 0xFFFFFFFF, 0x80000000]))
    return bytes(data)


@pytest.mark.parametrize("name", [
    "dds dxt1 encoder", "dds dx10 dxgi 96, every mode", "dds masks 565", "dds P, after its palette",
    "blp1 jpeg, red and blue swapped", "blp1 palette encoding 4", "blp2 dxt5", "ftex dxt1"])
def test_seeded_damage_reads_where_pillow_reads(tmp_path, name):
    """Cut, overwritten or re-valued headers and data: where the JAX
    package reads the file the port gives its planes, where it fails the
    port raises an ImageError without "yet" (or names every reader where
    neither Pillow nor the port identifies it)."""
    rng = np.random.RandomState(sorted(CASES).index(name))
    with open(_write_case(tmp_path, name), "rb") as fh:
        data = fh.read()
    path = str(tmp_path / "damaged.bin")
    for it in range(24):
        _write(path, _damaged(data, rng, it))
        ref = _jax_load(path)
        if isinstance(ref, Exception):
            with pytest.raises(ImageError) as err:
                timages.SourceImage.load(path).load_rgb_plane()
            assert "yet" not in str(err.value), (it, err.value)
        else:
            src = timages.SourceImage.load(path)
            np.testing.assert_array_equal(src.img, ref[0].img, err_msg=str(it))
            np.testing.assert_array_equal(src.load_rgb_plane(), ref[1], err_msg=str(it))


def test_identify_gives_each_to_pillows_plugin(tmp_path):
    for name in ("dds dxt1 encoder", "dds masks 565", "blp1 jpeg with alpha", "blp2 dxt5",
                 "ftex dxt1"):
        path = _write_case(tmp_path, name)
        with Image.open(path) as im:
            assert imageio.open_image(path).format == im.format, name


def test_block_decoders_without_native_name_the_compiler(tmp_path, monkeypatch):
    """No fallback: without the native library block-compressed DDS, FTEX
    DXT1, BLP2 DXT and BLP1 JPEG raise an error that says what is missing;
    DDS of masks, luminance or a palette, raw FTEX and BLP palettes still
    read through numpy."""
    native_only = ["dds dxt1 encoder", "dds dx10 dxgi 98, every mode", "ftex dxt1",
                   "blp2 dxt5", "blp1 jpeg, red and blue swapped"]
    numpy_paths = ["dds masks 565", "dds LA", "dds P, after its palette", "dds dx10 dxgi 28",
                   "ftex uncompressed", "blp1 palette encoding 4", "blp2 palette with alpha"]
    paths = {}
    for k, name in enumerate(native_only + numpy_paths):
        (tmp_path / str(k)).mkdir()
        paths[name] = _write_case(tmp_path / str(k), name)
    planes = {n: timages.SourceImage.load(paths[n]).img for n in numpy_paths}

    def refuse():
        raise ImportError("no native library")

    monkeypatch.setattr(native, "load", refuse)
    for name in native_only:
        with pytest.raises(NativeDecoderError, match="C\\+\\+ compiler"):
            timages.SourceImage.load(paths[name])
    for name in numpy_paths:
        np.testing.assert_array_equal(timages.SourceImage.load(paths[name]).img, planes[name])


# -- the CLI from DDS files ------------------------------------------------------------------


def test_cli_cpu_bc1_dds_pair_ply_matches_jax(tmp_path, monkeypatch):
    """tests/test_pipeline.py's 160x160 SEM pair as DXT1 DDS files -> PLY:
    the port's cli.main, with every import of Pillow blocked in its
    process, writes the JAX CLI's PLY (counts, cells, depths within
    test_cli_cpu_ply_matches_jax's budget)."""
    from cybervision_tpu.config import MeshMode as JMeshMode
    from cybervision_tpu.reconstruction import reconstruct as jax_reconstruct

    img1, img2, _ = _sem_pair(np.random.RandomState(7))
    paths = [str(tmp_path / "sem0.dds"), str(tmp_path / "sem1.dds")]
    for p, img in zip(paths, (img1, img2)):
        _write(p, cs.bc1_file(np.repeat(img[:, :, None], 3, axis=2)))
    out_j, out_t = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jax_reconstruct(paths, out_j, _fast_cfg(mesh=JMeshMode.VERTEX_COLORS), quiet=True)
    monkeypatch.setattr(cli, "ReconstructionConfig", _port_fast_cfg)
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)  # any import of Pillow now raises
    rc = cli.main(["--mode=cpu", "--projection=parallel", "--mesh=vertex-colors", *paths, out_t])
    assert rc == 0
    nv_j, nf_j, cells_j = _read_ply(out_j)
    nv_t, nf_t, cells_t = _read_ply(out_t)
    assert nv_j > 3000 and (nv_t, nf_t) == (nv_j, nf_j)
    assert cells_t.keys() == cells_j.keys()
    zj = np.array([cells_j[k] for k in cells_j])
    zt = np.array([cells_t[k] for k in cells_j])
    assert np.abs(zt - zj).mean() / (zj.max() - zj.min()) < SAME_F_DEPTH_BUDGET


# -- phase 8 (p)'s files ---------------------------------------------------------------


def test_writers_here_give_pillow_their_pixels():
    """chip_smoke.py's writers give Pillow their pixels where the format is
    lossless (masks of 8 bits a channel, luminance, raw FTEX, BLP
    palettes) and within the block codecs' error where it is not, so a
    case that passes holds the port to a file of known content."""
    import io

    rng = np.random.RandomState(24)
    rgb, a = _texture(rng, 12, 16, 3), _texture(rng, 12, 16)
    rgba = np.concatenate([rgb, a[:, :, None]], axis=2)

    def pillow(data):
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im).astype(int)

    np.testing.assert_array_equal(
        pillow(cs.dds_masked(rgb, 32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), a)), rgba)
    np.testing.assert_array_equal(pillow(cs.ftex_file((16, 12), rgb.tobytes(), 1)), rgb)
    pal = (np.arange(1024) % 256).astype(np.uint8).tobytes()  # entry i: B, G, R, A = 4i ...
    blp = cs.blp2_file((16, 12), a.tobytes(), 1, False, palette=pal)
    np.testing.assert_array_equal(pillow(blp)[:, :, 0], (4 * a.astype(int) + 2) % 256)
    assert np.abs(pillow(cs.bc1_file(rgb))[:, :, :3] - rgb).mean() < 12
    assert np.abs(pillow(cs.dds_file((16, 12), cs.dxt5_blocks(rgba), fourcc=b"DXT5"))
                  - rgba).mean() < 12
    assert np.abs(pillow(cs.dds_file((16, 12), cs.bc7_mode6_blocks(rgba), dxgi=98))
                  - rgba).mean() < 12
    header, body = _split(cs.rgb_jpeg(rgb))
    assert np.abs(pillow(cs.blp1_file((16, 12), body, jpeg_header=header))[:, :, ::-1]
                  - rgb).mean() < 12


def test_phase8p_files_decode_to_the_committed_hashes(tmp_path):
    """chip_smoke.block_texture_files but its 4032x3024 BC7 plane (phase
    3's 1024x1024 SEM pair as DXT1 and BC7 DDS files, BASELINE #3's views
    as BLP2 DXT5, the decode-only files of every other kind): Pillow's L
    and RGB planes have the SHA-256 committed for phase 8 (p)
    (torch_formats_sha256.json, "block textures"), and so do the port's,
    read with every import of Pillow blocked."""
    with open(cs.FORMATS_SHA256) as fh:
        committed = json.load(fh)["block textures"]
    img1, img2, _ = cs.synth_sem_pair(cs.SIZE, cs.SIZE)
    files = cs.block_texture_files(str(tmp_path), img1, img2, large=False)
    paths = [p for ps in files.values() for p in ps]
    assert sorted(committed) == sorted([os.path.basename(p) for p in paths]
                                       + [cs.BLOCK_TEXTURE_LARGE])

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for p in paths:
        with Image.open(p) as im:
            assert {"l": sha(np.asarray(im.convert("L"))),
                    "rgb": sha(np.asarray(im.convert("RGB")))} == committed[os.path.basename(p)]
    with cs._NoPillow():
        for p in paths:
            src = timages.SourceImage.load(p)
            assert {"l": sha(src.img), "rgb": sha(src.load_rgb_plane())} \
                == committed[os.path.basename(p)], p
