"""JPEG decoding through the port's host decoder (``csrc/image_decode.c``).

The decoder gives libjpeg-turbo's output as PIL decodes with it: the
integer IDCT, fancy upsampling and libjpeg's YCbCr -> RGB tables, and at
draft scales 1/2, 1/4 and 1/8 its reduced IDCTs. :func:`draft_scale` picks
the scale as ``PIL.JpegImageFile.draft`` does, under the JAX package's
condition for calling it.

Refused (``DatasetError`` naming the file and ROADMAP item 19): arithmetic
coding, 12-bit samples, lossless and hierarchical files, 4-component
(CMYK/YCCK) files and sampling factors above 2.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from lightly_train_tpu_torch import _native
from lightly_train_tpu_torch.errors import DatasetError

# csrc/image_decode.c's LT_E_* codes.
REASONS = {
    1: "truncated file",
    2: "corrupt JPEG data",
    3: "arithmetic-coded JPEG is not decoded by the port (ROADMAP item 19)",
    4: "12-bit JPEG is not decoded by the port (ROADMAP item 19)",
    5: "lossless JPEG is not decoded by the port (ROADMAP item 19)",
    6: "hierarchical JPEG is not decoded by the port (ROADMAP item 19)",
    7: "only 1- and 3-component JPEGs decode in the port; CMYK/YCCK waits "
       "for ROADMAP item 19",
    8: "JPEG sampling factors above 2 are not decoded by the port (ROADMAP "
       "item 19)",
    9: "out of memory",
    10: "bad argument",
    11: "bad PNG filter type",
}


# PIL refuses an image of more pixels as a decompression bomb (twice its
# Image.MAX_IMAGE_PIXELS); so does the port, before allocating.
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def check(err: int, path: str) -> None:
    if err:
        raise DatasetError(f"{path}: {REASONS.get(err, f'error {err}')}")


def check_size(width: int, height: int, path: str) -> None:
    if width * height > MAX_PIXELS:
        raise DatasetError(
            f"{path}: {width}x{height} is more than {MAX_PIXELS} pixels, "
            "which PIL refuses as a decompression bomb")


def jpeg_header(data: bytes, path: str) -> Tuple[int, int, int]:
    """(width, height, components) of a JPEG's frame."""
    info = np.zeros(3, dtype=np.int32)
    check(_native.host_function("image_decode", "lt_jpeg_header")(
        data, len(data), info.ctypes.data), path)
    return int(info[0]), int(info[1]), int(info[2])


def draft_scale(size: Tuple[int, int], canonical_hw: Tuple[int, int]) -> int:
    """The DCT scale PIL's ``draft("RGB", (cw, ch))`` takes for an image of
    ``size`` (width, height): the largest of 8, 4, 2, 1 at most
    ``min(W // cw, H // ch)``; 1 unless the image is at least twice the
    canonical size on both axes, where the JAX package calls ``draft``."""
    (w, h), (ch, cw) = size, canonical_hw
    if w < 2 * cw or h < 2 * ch:
        return 1
    ratio = min(w // cw, h // ch)
    return next(s for s in (8, 4, 2, 1) if ratio >= s)


def decode_jpeg(data: bytes, path: str, scale: int = 1) -> np.ndarray:
    """Decode at 1/``scale``: uint8 (H', W') for one component, (H', W', 3)
    for three, with H' = ceil(H / scale), W' likewise."""
    w, h, c = jpeg_header(data, path)
    check_size(w, h, path)
    ow, oh = -(-w // scale), -(-h // scale)
    out = np.empty((oh, ow, c), dtype=np.uint8)
    check(_native.host_function("image_decode", "lt_jpeg_decode")(
        data, len(data), scale, out.ctypes.data, ow, oh, c), path)
    return out[..., 0] if c == 1 else out
