"""Tiled inference over images larger than the training resolution.

Port of ``lightly_train_tpu/tasks/tiling.py``: an image is split into a
fixed grid of overlapping tiles at the training size (stride two thirds of
a tile unless given, a last tile flush with the far edge), each tile runs
the normal forward, and the per-pixel logits are averaged back onto the
whole image.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch


def tile_grid(extent: int, tile: int, stride: int) -> List[int]:
    """Tile start offsets covering [0, extent) with a final flush tile."""
    if extent <= tile:
        return [0]
    ys = list(range(0, extent - tile + 1, stride))
    if ys[-1] + tile < extent:
        ys.append(extent - tile)
    return ys


def tiled_logits(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    images: torch.Tensor,
    num_out: int,
    tile_size: int,
    stride: Optional[int] = None,
) -> torch.Tensor:
    """The mean of ``logits_fn`` over the tile grid: ``logits_fn`` maps a
    (B, t, t, C) tile to (B, t, t, num_out) logits; returns float32 (B, H,
    W, num_out)."""
    B, H, W, _ = images.shape
    if H <= tile_size and W <= tile_size:
        return logits_fn(images)
    stride = stride or (tile_size * 2 // 3)
    total = torch.zeros((B, H, W, num_out), dtype=torch.float32,
                        device=images.device)
    counts = torch.zeros((B, H, W, 1), dtype=torch.float32,
                         device=images.device)
    th, tw = min(tile_size, H), min(tile_size, W)
    for y in tile_grid(H, tile_size, stride):
        for x in tile_grid(W, tile_size, stride):
            tile = images[:, y:y + th, x:x + tw]
            total[:, y:y + th, x:x + tw] += logits_fn(tile).float()
            counts[:, y:y + th, x:x + tw] += 1.0
    return total / torch.clamp(counts, min=1.0)


def n_tiles(hw: tuple, tile_size: int, stride: Optional[int] = None) -> int:
    """The number of tiles :func:`tiled_logits` runs on an (H, W) image."""
    H, W = hw
    if H <= tile_size and W <= tile_size:
        return 1
    stride = stride or (tile_size * 2 // 3)
    return len(tile_grid(H, tile_size, stride)) * len(
        tile_grid(W, tile_size, stride))
