"""Image loading and SEM/EXIF metadata (counterpart of cybervision_tpu.images).

Mirrors the reference's SourceImage (reconstruction.rs:23-186):
  * grayscale (luma8) and RGB loads with databar cropping
  * FEI/Phenom (TIFF tag 34683) and FEI Quanta (34682) SEM metadata:
    [Scan] PixelWidth/PixelHeight scale, [Stage] StageT tilt,
    [PrivateFei] DatabarHeight (reconstruction.rs:80-144)
  * EXIF FocalLengthIn35mmFilm (reconstruction.rs:138-142)

Files are read by the port's own readers (cybervision_tpu_torch.imageio:
PNG, TIFF, JPEG, BMP, GIF and WebP), not by Pillow, with the JAX package's
semantics (cybervision_tpu/images.py:36-112,180-207): the same metadata
and the same planes as Pillow's convert("L") and convert("RGB"). The
pyramid resize runs on the tensor device (ops.correlation.device_resize),
not here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cybervision_tpu_torch import imageio


@dataclasses.dataclass
class ImageMeta:
    scale: tuple[float, float] = (1.0, 1.0)
    tilt_angle: float | None = None
    databar_height: int = 0
    focal_length_35mm: int | None = None


def _parse_sem_metadata(data: str, meta: ImageMeta) -> None:
    """Parse the INI-style FEI metadata block (reconstruction.rs:107-136)."""

    def tag_value(line: str, cast):
        _, _, value = line.partition("=")
        try:
            return cast(value)
        except ValueError:
            return None

    section = ""
    scale_width: float | None = None
    scale_height: float | None = None
    for line in data.replace("\r", "\n").split("\n"):
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            section = line
            continue
        if section == "[Scan]":
            if line.startswith("PixelWidth"):
                scale_width = scale_width if scale_width is not None else tag_value(line, float)
            elif line.startswith("PixelHeight"):
                scale_height = scale_height if scale_height is not None else tag_value(line, float)
        elif section == "[Stage]":
            if line.startswith("StageT="):
                meta.tilt_angle = tag_value(line, float)
        elif section == "[PrivateFei]" and line.startswith("DatabarHeight="):
            value = tag_value(line, int)
            if value is not None:
                meta.databar_height = value
    meta.scale = (
        scale_width if scale_width is not None else 1.0,
        scale_height if scale_height is not None else 1.0,
    )


def _meta_from_file(f: imageio.ImageFile) -> ImageMeta:
    """SEM + EXIF metadata of a parsed file; silently defaults on failure
    (reconstruction.rs:62-73)."""
    meta = ImageMeta()
    try:
        raw = f.sem
        sem_data = None
        if raw is not None:
            if isinstance(raw, bytes):
                sem_data = raw.decode("utf-8", errors="ignore")
            else:
                sem_data = str(raw)
        if sem_data:
            _parse_sem_metadata(sem_data, meta)
        # A corrupt EXIF payload must not discard SEM metadata parsed
        # above (losing the databar crop would feed overlay text into
        # the reconstruction).
        try:
            focal = f.focal_length_35mm()
            if focal is not None:
                meta.focal_length_35mm = focal
        except Exception:
            pass
    except Exception:
        return meta
    return meta


def read_metadata(path: str) -> ImageMeta:
    """SEM + EXIF metadata of an image file; defaults on any failure
    (reconstruction.rs:62-73)."""
    try:
        return _meta_from_file(imageio.open_image(path, metadata_only=True))
    except Exception:
        return ImageMeta()


def _load(path: str, convert) -> tuple[ImageMeta, np.ndarray]:
    """The file's metadata and its plane through `convert` (imageio.to_l
    or to_rgb), databar cropped: one read and one decode of the file."""
    f = imageio.open_image(path)
    meta = _meta_from_file(f)
    img = convert(*f.decode())
    if meta.databar_height > 0:
        img = img[: img.shape[0] - meta.databar_height, :]
    return meta, np.ascontiguousarray(img)


class SourceImage:
    """A grayscale source image plus its SEM/EXIF metadata.

    Built by `load` from a file, or directly from an in-memory uint8
    array. The colour plane the vertex-colour writer samples comes from
    `filename` or, for an in-memory image, repeats the gray plane (what
    Pillow's convert("RGB") gives for an "L" image).
    """

    def __init__(
        self,
        img: np.ndarray,
        scale: tuple[float, float] = (1.0, 1.0),
        focal_length_35mm: int | None = None,
        tilt_angle: float | None = None,
        filename: str = "",
    ):
        if img.dtype != np.uint8 or img.ndim != 2:
            raise ValueError(
                f"SourceImage needs a 2-D uint8 array, got {img.dtype} {img.shape}"
            )
        self.img = img
        self.scale = scale
        self.focal_length_35mm = focal_length_35mm
        self.tilt_angle = tilt_angle
        self.filename = filename

    def calibration_matrix(self, focal_length_35mm: int | None = None) -> np.ndarray:
        """Intrinsics from the 35mm-equivalent focal length: f_img/f_35mm ==
        diagonal/diagonal(24x36mm) (reconstruction.rs:164-185). The
        argument (--focal-length) wins over the EXIF value; with neither
        the focal length is 1."""
        diagonal_35mm = float(np.hypot(24.0, 36.0))
        height, width = self.img.shape
        diagonal = float(np.hypot(float(width), float(height)))
        focal = focal_length_35mm
        if focal is None:
            focal = self.focal_length_35mm
        if focal is None:
            focal = 1
        focal_length = float(focal) * diagonal / diagonal_35mm
        return np.array(
            [
                [focal_length, 0.0, width / 2.0],
                [0.0, focal_length, height / 2.0],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float64,
        )

    @property
    def dimensions(self) -> tuple[int, int]:
        """(width, height) — matches the reference's GrayImage::dimensions."""
        return (self.img.shape[1], self.img.shape[0])

    @classmethod
    def load(cls, path: str) -> "SourceImage":
        """Load as luma8 and crop the SEM databar (reconstruction.rs:40-52)."""
        meta, img = _load(path, imageio.to_l)
        return cls(
            img,
            scale=meta.scale,
            focal_length_35mm=meta.focal_length_35mm,
            tilt_angle=meta.tilt_angle,
            filename=path,
        )

    def load_rgb_plane(self) -> np.ndarray:
        """(H, W, 3) uint8 colour plane, databar-cropped like the gray one
        (reconstruction.rs:54-60)."""
        if not self.filename:
            return np.repeat(self.img[:, :, None], 3, axis=2)
        return _load(self.filename, imageio.to_rgb)[1]
