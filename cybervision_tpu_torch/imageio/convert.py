"""Pillow's conversions to "L" and "RGB" (libImaging/Convert.c), bit for
bit, from the modes the readers return:
  * "L" from RGB: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16, also for
    a palette's entries and with RGBA's alpha dropped;
  * "L" and "RGB" from 16-bit gray ("I;16", "I;16L", "I;16B") clip to
    255;
  * "RGB" from gray repeats it, or, for an "L" image that carries a
    palette (a GIF frame, a gray TGA with a colour map), maps it; LA and
    RGBA drop their alpha; "PA" maps its index through the palette; a
    palette of RGBA entries (a DDS's) gives its RGB, for "L" too;
  * "1" (a 1-bit PNG, BMP or TIFF) is stored as 0 and 255, as Pillow's
    bit2l gives it;
  * "I" (32-bit signed) clips to 0-255 (i2l, i2rgb); "F" (float32)
    clips and truncates (f2l: at most 0 gives 0, at least 255 gives 255,
    NaN gives 0), and "RGB" from "F" goes through that "L";
  * "RGB" from "CMYK" is cmyk2rgb: each of C, M, Y as
    (255 - K) - C * (255 - K) / 255 with libImaging's MULDIV255 rounding;
    "L" from "CMYK" goes through that RGB (Pillow has no direct
    converter);
  * "LAB" (a Lab PSD) converts to neither: Pillow has no "L" from it,
    and its "RGB" goes through LittleCMS, which the port does not carry;
  * "L" from "YCbCr" is Y; "RGB" from "YCbCr" is ConvertYCbCr.c's
    ImagingConvertYCbCr2RGB: Y plus Cr's (R), Cb's and Cr's (G) and Cb's
    (B) entries of fixed-point tables of 6 fraction bits, each entry
    (int)(c * 64 * (v - 128) + 0.5) for ITU-R BT.601's c, the sum shifted
    right and clipped to 0-255.
"""

from __future__ import annotations

import numpy as np

from cybervision_tpu_torch.imageio.errors import UnsupportedImageError


def _luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., k].astype(np.uint32) for k in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _cmyk_rgb(px: np.ndarray) -> np.ndarray:
    x = px.astype(np.int32)
    nk = 255 - x[:, :, 3:]
    t = x[:, :, :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _ycc_table(c: float) -> np.ndarray:
    return np.trunc(c * 64 * (np.arange(256) - 128) + 0.5).astype(np.int32)


_R_CR, _G_CB, _G_CR, _B_CB = (_ycc_table(c) for c in (1.402, -0.34414, -0.71414, 1.772))


def _ycc_rgb(px: np.ndarray) -> np.ndarray:
    y, cb, cr = (px[:, :, k].astype(np.int32) for k in range(3))
    rgb = np.stack([y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6),
                    y + (_B_CB[cb] >> 6)], axis=2)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _gray(mode: str, px: np.ndarray) -> np.ndarray | None:
    if mode in ("L", "1"):
        return px
    if mode == "LA":
        return px[:, :, 0]
    if mode in ("I;16", "I;16L", "I;16B", "I"):
        return np.clip(px, 0, 255).astype(np.uint8)
    if mode == "F":
        out = np.zeros(px.shape, np.uint8)
        inside = px > 0  # False for NaN
        out[inside] = np.minimum(px[inside], 255).astype(np.uint8)
        return out
    return None


def to_l(mode: str, px: np.ndarray, palette: np.ndarray | None) -> np.ndarray:
    """(H, W) uint8: Pillow's convert("L")."""
    gray = _gray(mode, px)
    if gray is not None:
        return np.ascontiguousarray(gray)
    if mode in ("RGB", "RGBA"):
        return _luma(px)
    if mode in ("P", "PA"):
        return _luma(palette)[px if mode == "P" else px[:, :, 0]]
    if mode == "CMYK":
        return _luma(_cmyk_rgb(px))
    if mode == "YCbCr":
        return np.ascontiguousarray(px[:, :, 0])
    raise UnsupportedImageError(f"no conversion to L from {mode}")


def to_rgb(mode: str, px: np.ndarray, palette: np.ndarray | None) -> np.ndarray:
    """(H, W, 3) uint8: Pillow's convert("RGB")."""
    if mode == "L" and palette is not None:
        return palette[px]  # a GIF's "L" frame over a "P" image, a TGA's "L" with a map
    gray = _gray(mode, px)
    if gray is not None:
        return np.repeat(gray[:, :, None], 3, axis=2)
    if mode == "RGB":
        return px
    if mode == "RGBA":
        return np.ascontiguousarray(px[:, :, :3])
    if mode in ("P", "PA"):
        return np.ascontiguousarray(palette[px if mode == "P" else px[:, :, 0]][..., :3])
    if mode == "CMYK":
        return _cmyk_rgb(px)
    if mode == "YCbCr":
        return _ycc_rgb(px)
    if mode == "LAB":
        raise UnsupportedImageError(
            "conversion of LAB to RGB is not supported: Pillow converts it through LittleCMS's"
            " Lab -> sRGB transform (and cannot convert it to L, so no run reaches it)")
    raise UnsupportedImageError(f"no conversion to RGB from {mode}")
