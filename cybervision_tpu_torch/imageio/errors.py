"""Why a file could not be read. Every class is an ImageError, so the CLI
reports it as a failed reconstruction (exit code 1)."""

from cybervision_tpu_torch.errors import ImageError


class CorruptImageError(ImageError):
    """The file breaks its format."""


class TruncatedImageError(ImageError):
    """The file ends before its image data does."""


class UnsupportedImageError(ImageError):
    """A format or an encoding the readers do not support yet."""


class NotThisFormat(CorruptImageError):
    """The file fails a format's open checks where Pillow's plugin raises
    SyntaxError (or an error it takes as one), so Pillow tries the next
    plugin: imageio.identify does the same."""


class NativeDecoderError(ImageError):
    """The encoding is decoded only by the native library, which could not
    be built or loaded."""


def native_missing(what: str) -> NativeDecoderError:
    """The error for `what`, which only the native library decodes, when
    it could not be built."""
    return NativeDecoderError(
        f"{what} needs the native decoder, which could not be built"
        " (the native library needs make and a C++ compiler, g++)")


# Pillow's Image.open refuses an image of more than twice
# Image.MAX_IMAGE_PIXELS (its decompression-bomb check).
BOMB_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def bomb_check(size: tuple[int, int], what: str) -> None:
    """Raise where Pillow's decompression-bomb check refuses `size`."""
    if size[0] * size[1] > BOMB_PIXELS:
        raise CorruptImageError(f"{what} of {size[0]}x{size[1]} is past Pillow's"
                                " decompression-bomb limit")
