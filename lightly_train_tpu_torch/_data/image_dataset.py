"""SSL image dataset: file listing + decode to canonical uint8 images.

Port of ``lightly_train_tpu/_data/image_dataset.py``: the dataset lists and
decodes images to a fixed canonical (H0, W0) uint8 array; all augmentation
runs on the device. PNG, JPEG and binary PPM/PGM (P6, P5) always decode
with the port's own decoders (``png.py``, ``jpeg.py``:
``csrc/image_decode.c`` built with the host compiler), chosen by the file's
magic bytes, whether or not PIL is installed, so the machines with the card,
which have no PIL, decode what the CPU tests check. They give the bytes the
JAX package's PIL path gives: ``convert("RGB")``'s rules, JPEG draft scales
chosen as PIL chooses them, then PIL's bilinear resize (its taps computed
here, its passes in the same C library, which releases the interpreter lock
so the loader's threads decode in parallel). Other formats decode through
PIL where it is installed and raise otherwise (ROADMAP item 19).

With ``mask_dir`` each image is paired by file stem with a region mask
(DetCon's dataset masks) and items become ``{"images", "masks"}``:
:func:`decode_mask` reads the samples the JAX package reads with PIL (a
palette index, a gray value, a 16-bit gray value; other kinds through
``convert("L")``'s luminance) and resizes them with PIL's NEAREST rule.
"""

from __future__ import annotations

import functools
import logging
import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from lightly_train_tpu_torch import _native
from lightly_train_tpu_torch._data.jpeg import check, decode_jpeg, \
    draft_scale, jpeg_header
from lightly_train_tpu_torch._data.png import SIGNATURE as PNG_SIGNATURE
from lightly_train_tpu_torch._data.png import decode_png
from lightly_train_tpu_torch.errors import DatasetError

logger = logging.getLogger("lightly_train_tpu_torch.data")

# The JAX package's extension list (everything PIL decodes).
IMAGE_EXTENSIONS = {
    ".bmp", ".dib", ".pcx", ".dds", ".gif", ".png", ".apng",
    ".jp2", ".j2k", ".jpc", ".jpf", ".jpx", ".j2c",
    ".icns", ".ico", ".im", ".jfif", ".jpe", ".jpg", ".jpeg",
    ".tif", ".tiff", ".pbm", ".pgm", ".ppm", ".pnm",
    ".bw", ".rgb", ".rgba", ".sgi", ".tga", ".icb", ".vda", ".vst",
    ".webp",
}


def list_image_files(data_dir: Path) -> List[str]:
    """Recursively list image files (sorted, deterministic across hosts)."""
    data_dir = Path(data_dir)
    if not data_dir.exists():
        raise DatasetError(f"Data directory does not exist: {data_dir}")
    files = sorted(
        str(p)
        for p in data_dir.rglob("*")
        if p.suffix.lower() in IMAGE_EXTENSIONS and p.is_file()
    )
    if not files:
        raise DatasetError(
            f"No images found under {data_dir} (extensions: "
            f"{sorted(IMAGE_EXTENSIONS)})"
        )
    return files


def _ppm_tokens(data: bytes, count: int) -> Tuple[List[bytes], int]:
    """The first ``count`` whitespace-separated header tokens of a PNM file
    (``#`` comments skipped) and the offset just past the last one's single
    trailing whitespace byte."""
    tokens: List[bytes] = []
    i = 0
    while len(tokens) < count:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i:i + 1] not in (b"\n", b"\r"):
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        if j == i:
            raise DatasetError("truncated PPM header")
        tokens.append(data[i:j])
        i = j
    return tokens, i + 1


# The extensions the port's own decoders take (by the file's magic bytes).
PORT_EXTENSIONS = {".ppm", ".pnm", ".png", ".jpg", ".jpeg", ".jpe", ".jfif"}


def read_ppm(path: str, data: Optional[bytes] = None) -> np.ndarray:
    """Decode a binary PPM (P6) to uint8 (H, W, 3) or PGM (P5) to uint8
    (H, W), maxval <= 255."""
    if data is None:
        data = Path(path).read_bytes()
    tokens, offset = _ppm_tokens(data, 4)
    if tokens[0] not in (b"P5", b"P6"):
        raise DatasetError(f"{path}: only binary PPM (P6) and PGM (P5) "
                           f"decode in the port, got {tokens[0]!r}")
    width, height, maxval = (int(t) for t in tokens[1:])
    if maxval > 255:
        raise DatasetError(f"{path}: 16-bit PPM does not decode in the "
                           "port (ROADMAP item 19)")
    channels = 3 if tokens[0] == b"P6" else 1
    n = width * height * channels
    if offset + n > len(data):
        raise DatasetError(f"{path}: truncated PPM")
    pixels = np.frombuffer(data, dtype=np.uint8, count=n, offset=offset)
    image = pixels.reshape(height, width, channels)[..., :channels]
    if channels == 1:
        image = image[..., 0]
    if maxval != 255:
        image = (image.astype(np.float32) * (255.0 / maxval)).round()
        image = image.astype(np.uint8)
    return image


# PIL's fixed point for 8-bit images (Resample.c: 32 - 8 - 2 fraction bits).
_PRECISION_BITS = 22


@functools.lru_cache(maxsize=64)
def _bilinear_taps(in_size: int, out_size: int) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """PIL's bilinear taps for one axis (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` of its Resample.c): (out, ksize) source
    indices and fixed-point weights, 0 past each output's window.

    The triangle's support grows with the downscale factor; each window's
    weights are normalised in double precision, then rounded to 22
    fraction bits. The arithmetic is PIL's, operation for operation, so
    the weights are its bits.
    """
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    index = np.zeros((out_size, ksize), dtype=np.int64)
    coeff = np.zeros((out_size, ksize), dtype=np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        weights = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            weights.append(1.0 - t if t < 1.0 else 0.0)
        total = 0.0
        for w in weights:
            total += w
        for x, w in enumerate(weights):
            k = w / total if total != 0.0 else w
            coeff[xx, x] = int(0.5 + k * (1 << _PRECISION_BITS))
            index[xx, x] = xmin + x
    return index, coeff


def _resample_axis(image: np.ndarray, in_size: int, out_size: int,
                   axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit resampling along ``axis`` of uint8 (H, W, C):
    a half unit plus the fixed-point sum of the taps, shifted back and
    clipped to uint8 (``lt_resample_axis`` of ``csrc/image_decode.c``,
    which releases the interpreter lock while it runs)."""
    index, coeff = _bilinear_taps(in_size, out_size)
    image = np.ascontiguousarray(image)
    shape = list(image.shape)
    shape[axis] = out_size
    out = np.empty(shape, dtype=np.uint8)
    outer = int(np.prod(image.shape[:axis]))
    inner = int(np.prod(image.shape[axis + 1:]))
    check(_native.host_function("image_decode", "lt_resample_axis")(
        image.ctypes.data, out.ctypes.data, outer, in_size, inner, out_size,
        index.ctypes.data, coeff.ctypes.data, index.shape[1]), "resize")
    return out


def resize_bilinear(image: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Resize uint8 (H, W, C) to ``hw`` as PIL's ``Image.resize(...,
    BILINEAR)`` does: the horizontal pass, then the vertical one, each
    skipped where that size is unchanged, with uint8 between them."""
    height, width = image.shape[:2]
    if width != hw[1]:
        image = _resample_axis(image, width, hw[1], axis=1)
    if height != hw[0]:
        image = _resample_axis(image, height, hw[0], axis=0)
    return image


def decode_port(path: str, canonical_hw: Tuple[int, int]) -> np.ndarray:
    """Decode a PNG, JPEG or PPM file with the port's decoders (chosen by
    its magic bytes) to uint8 (H0, W0, 3)."""
    data = Path(path).read_bytes()
    if data.startswith(PNG_SIGNATURE):
        image = decode_png(data, path)
    elif data.startswith(b"\xff\xd8"):
        width, height, _ = jpeg_header(data, path)
        image = decode_jpeg(data, path,
                            draft_scale((width, height), canonical_hw))
    elif data.startswith(b"P"):
        image = read_ppm(path, data)
    else:
        raise DatasetError(f"{path}: neither PNG, JPEG nor PPM data")
    image = resize_bilinear(image[..., None] if image.ndim == 2 else image,
                            canonical_hw)
    if image.shape[2] == 1:
        image = np.repeat(image, 3, axis=2)
    return image


def luminance(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> (H, W) as PIL's ``convert("L")``:
    (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    rgb = rgb.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output pixel of PIL's NEAREST resize along one
    axis: its coordinate starts at half a step and adds the step
    ``in / out`` once a pixel in double precision (Geometry.c's
    ``ImagingScaleAffine``), then truncates."""
    steps = np.full(out_size, in_size / out_size)
    steps[0] *= 0.5
    return np.minimum(np.cumsum(steps).astype(np.int64), in_size - 1)


def resize_nearest(mask: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) -> ``hw`` as PIL's ``Image.resize(..., NEAREST)``."""
    return mask[nearest_index(mask.shape[0], hw[0])][
        :, nearest_index(mask.shape[1], hw[1])]


def decode_mask(path: str, canonical_hw: Tuple[int, int]) -> np.ndarray:
    """A region mask as int32 (H0, W0), as the JAX package reads it with
    PIL: a palette image's indices, a gray image's values (16-bit ones
    too), any other image's ``convert("L")`` luminance; then PIL's NEAREST
    resize to the canonical size. PNG, JPEG and PPM decode with the port's
    decoders; other formats through PIL where it is installed."""
    if Path(path).suffix.lower() in PORT_EXTENSIONS:
        data = Path(path).read_bytes()
        if data.startswith(PNG_SIGNATURE):
            mask = decode_png(data, path, raw_samples=True)
        elif data.startswith(b"\xff\xd8"):
            mask = decode_jpeg(data, path)
        elif data.startswith(b"P"):
            mask = read_ppm(path, data)
        else:
            raise DatasetError(f"{path}: neither PNG, JPEG nor PPM data")
        if mask.ndim == 3:
            mask = luminance(mask)
        return resize_nearest(mask, canonical_hw).astype(np.int32)
    try:
        from PIL import Image
    except ImportError:
        raise DatasetError(
            f"{path}: PIL is not installed; without it only PNG, JPEG and "
            "binary PPM masks decode (other formats: ROADMAP item 19)."
        ) from None
    with Image.open(path) as m:
        if m.mode not in ("P", "L", "I", "I;16"):
            m = m.convert("L")
        m = m.resize((canonical_hw[1], canonical_hw[0]), Image.NEAREST)
        return np.asarray(m, dtype=np.int32)


def decode_image(path: str, canonical_hw: Tuple[int, int],
                 mode: str = "RGB") -> np.ndarray:
    """Decode one image to uint8 (H0, W0, 3)."""
    if Path(path).suffix.lower() in PORT_EXTENSIONS:
        return decode_port(path, canonical_hw)
    try:
        from PIL import Image
    except ImportError:
        raise DatasetError(
            f"{path}: PIL is not installed; without it only PNG, JPEG and "
            "binary PPM images decode (other formats: ROADMAP item 19)."
        ) from None
    with Image.open(path) as im:
        # JPEG draft mode: decode directly at a reduced DCT scale when the
        # image is at least twice the canonical size.
        if (mode == "RGB" and im.size[0] >= 2 * canonical_hw[1]
                and im.size[1] >= 2 * canonical_hw[0]):
            try:
                im.draft("RGB", (canonical_hw[1], canonical_hw[0]))
            except Exception:
                pass
        im = im.convert(mode)
        im = im.resize((canonical_hw[1], canonical_hw[0]), Image.BILINEAR)
        arr = np.asarray(im, dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


class ImageDataset:
    """Filename-backed dataset producing canonical uint8 images; with
    ``mask_dir``, ``{"images": uint8 (H0, W0, 3), "masks": int32 (H0,
    W0)}`` items, each image's mask found by its file stem (all zeros where
    none has it)."""

    def __init__(self, filenames: Sequence[str],
                 canonical_hw: Tuple[int, int] = (256, 256),
                 mode: Optional[str] = None,
                 mask_dir: Optional[Path] = None):
        if len(filenames) == 0:
            raise DatasetError("Empty dataset.")
        self.filenames = filenames
        self.canonical_hw = canonical_hw
        if mode is None:
            from lightly_train_tpu_torch._env import Env

            mode = Env.LIGHTLY_TRAIN_IMAGE_MODE.value
        if mode != "RGB":
            raise NotImplementedError(
                f"image mode {mode!r} is not ported yet (RGB only).")
        self.mode = mode
        self.mask_by_stem = None
        if mask_dir is not None:
            mask_dir = Path(mask_dir)
            self.mask_by_stem = {
                p.stem: p for p in sorted(mask_dir.rglob("*"))
                if p.suffix.lower() in IMAGE_EXTENSIONS
            }
            if not self.mask_by_stem:
                raise DatasetError(f"No masks under {mask_dir}")

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, index: int):
        image = decode_image(self.filenames[index], self.canonical_hw,
                             self.mode)
        if self.mask_by_stem is None:
            return image
        mask_path = self.mask_by_stem.get(Path(self.filenames[index]).stem)
        if mask_path is None:
            mask = np.zeros(self.canonical_hw, np.int32)
        else:
            mask = decode_mask(str(mask_path), self.canonical_hw)
        return {"images": image, "masks": mask}
