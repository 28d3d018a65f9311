"""SSL image dataset: file listing + decode to canonical uint8 images.

Port of ``lightly_train_tpu/_data/image_dataset.py``: the dataset lists and
decodes images to a fixed canonical (H0, W0) uint8 array; all augmentation
runs on the device. PIL decodes when it is installed, exactly as in the JAX
package. Where it is not (the GPU machines), binary PPM (P6) files decode
with numpy and resize with a numpy copy of PIL's bilinear resampling, which
gives PIL's bytes; other formats raise (PNG and JPEG: ROADMAP item 19).
"""

from __future__ import annotations

import functools
import logging
import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

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


def read_ppm(path: str) -> np.ndarray:
    """Decode a binary PPM (P6, maxval <= 255) to uint8 (H, W, 3)."""
    data = Path(path).read_bytes()
    tokens, offset = _ppm_tokens(data, 4)
    if tokens[0] != b"P6":
        raise DatasetError(f"{path}: only binary PPM (P6) decodes without "
                           f"PIL, got {tokens[0]!r}")
    width, height, maxval = (int(t) for t in tokens[1:])
    if maxval > 255:
        raise DatasetError(f"{path}: 16-bit PPM needs PIL")
    n = width * height * 3
    pixels = np.frombuffer(data, dtype=np.uint8, count=n, offset=offset)
    image = pixels.reshape(height, width, 3)
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
    clipped to uint8."""
    index, coeff = _bilinear_taps(in_size, out_size)
    acc = np.full(tuple(out_size if a == axis else n
                        for a, n in enumerate(image.shape)),
                  1 << (_PRECISION_BITS - 1), dtype=np.int64)
    shape = [1] * image.ndim
    shape[axis] = out_size
    for j in range(index.shape[1]):
        taps = np.take(image, index[:, j], axis=axis).astype(np.int64)
        acc += taps * coeff[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


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


def decode_image(path: str, canonical_hw: Tuple[int, int],
                 mode: str = "RGB") -> np.ndarray:
    """Decode one image to uint8 (H0, W0, 3)."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is None:
        if Path(path).suffix.lower() not in (".ppm", ".pnm"):
            raise DatasetError(
                f"{path}: PIL is not installed; without it only binary PPM "
                "(P6) images decode."
            )
        return resize_bilinear(read_ppm(path), canonical_hw)
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
    """Filename-backed dataset producing canonical uint8 images."""

    def __init__(self, filenames: Sequence[str],
                 canonical_hw: Tuple[int, int] = (256, 256),
                 mode: Optional[str] = None):
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

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, index: int) -> np.ndarray:
        return decode_image(self.filenames[index], self.canonical_hw,
                            self.mode)
