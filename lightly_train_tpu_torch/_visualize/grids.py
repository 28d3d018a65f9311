"""The grid of augmented views that pretraining writes at step 0, and the
first batch's label grid of a fine-tuning run.

Port of the parts of ``lightly_train_tpu/_visualize/grids.py`` that
``pretrain`` and the fine-tuning runs use. The GPU machines have no PIL,
which the JAX functions use, so the smaller views are resized with a numpy
copy of PIL's ``NEAREST`` sampling and the PNG is written with ``zlib`` and
``struct``.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from lightly_train_tpu_torch.ops.augment import IMAGENET_MEAN, IMAGENET_STD


def denormalize(images: np.ndarray) -> np.ndarray:
    """Normalized float (B, H, W, 3) -> uint8."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    out = (images.astype(np.float32) * std + mean) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def image_grid(images: np.ndarray, cols: int = 8, pad: int = 2) -> np.ndarray:
    """(N, H, W, 3) uint8 -> one grid image."""
    n, h, w, c = images.shape
    cols = min(cols, n)
    rows = -(-n // cols)
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad, c),
                    np.uint8)
    for i in range(n):
        r, cl = divmod(i, cols)
        grid[r * (h + pad):r * (h + pad) + h,
             cl * (w + pad):cl * (w + pad) + w] = images[i]
    return grid


def _nearest_taps(n_in: int, n_out: int) -> np.ndarray:
    """The source index of each output index under PIL's ``NEAREST``: the
    coordinate starts at half a step and adds one step (in / out, a double)
    per pixel, and is truncated; the running sum, not (i + 0.5) * step,
    gives PIL's bytes where it lands next to an integer."""
    step = n_in / n_out
    coord = step * 0.5
    taps = []
    for _ in range(n_out):
        taps.append(min(int(coord), n_in - 1))
        coord += step
    return np.asarray(taps, np.int64)


def resize_nearest(images: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(N, H, W, C) -> (N, hw[0], hw[1], C) with PIL's ``NEAREST``."""
    rows = _nearest_taps(images.shape[1], hw[0])
    return images[:, rows][:, :, _nearest_taps(images.shape[2], hw[1])]


def write_png(image: np.ndarray, path: Path) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image).reshape(h, w * 3)],
                          axis=1)  # filter type 0 before every row

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b""))


def save_augmentation_grid(views: Sequence[np.ndarray], out_path: Path,
                           max_images: int = 8) -> Optional[Path]:
    """One row per view of the first ``max_images`` samples (normalized
    in), the smaller views resized to the first one's size."""
    if not views:
        return None
    rows: List[np.ndarray] = []
    target_hw = views[0].shape[1:3]
    for v in views:
        imgs = denormalize(np.asarray(v[:max_images], np.float32))
        if imgs.shape[1:3] != target_hw:
            imgs = resize_nearest(imgs, target_hw)
        rows.append(image_grid(imgs, cols=max_images))
    width = max(r.shape[1] for r in rows)
    grid = np.concatenate(
        [np.pad(r, ((0, 0), (0, width - r.shape[1]), (0, 0))) for r in rows],
        axis=0)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    write_png(grid, out_path)
    return out_path


def colorize_mask(mask: np.ndarray, num_classes: int) -> np.ndarray:
    """(H, W) int mask -> RGB with a deterministic palette (black at ids
    of ``num_classes`` and above)."""
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 255, (max(num_classes, 1), 3), dtype=np.uint8)
    out = palette[np.clip(mask, 0, num_classes - 1)]
    out[mask >= num_classes] = 0
    return out


def save_label_grid(images: np.ndarray, out_path: Path,
                    masks: Optional[np.ndarray] = None,
                    max_images: int = 8) -> Path:
    """A grid of the first ``max_images`` normalized images of a batch, each
    blended with its colourized mask where ``masks`` are given (the task
    runs' ``first_batch_labels.png``)."""
    n = min(max_images, images.shape[0])
    tiles = denormalize(np.asarray(images[:n], np.float32))
    if masks is not None:
        num_classes = int(masks.max()) + 1 if masks.size else 1
        tiles = np.stack([
            (0.6 * tiles[i] + 0.4 * colorize_mask(
                masks[i], max(num_classes, 2))).astype(np.uint8)
            for i in range(n)])
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    write_png(image_grid(tiles), out_path)
    return out_path
