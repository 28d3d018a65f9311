"""On-device iBOT block-mask generation with a fixed budget.

Port of ``lightly_train_tpu/ops/masking.py``: for each image chosen for
masking, ``num_blocks`` random rectangles cover a target fraction of the
patch grid. :func:`block_masks_from_params` builds the masks from sampled
parameters; :func:`random_block_masks` samples them from a generator.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def block_masks_from_params(
    selected: torch.Tensor,
    ratio: torch.Tensor,
    log_aspect: torch.Tensor,
    pos: torch.Tensor,
    grid_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masks from sampled parameters.

    selected: (B,) bool images to mask; ratio: (B,) target masked fraction;
    log_aspect: (B, nb) log of each block's h/w; pos: (B, nb, 2) uniform
    [0, 1) block positions. Returns ``mask`` (B, gh*gw) bool and
    ``mask_weight`` (B, gh*gw) float32 (1 / masked count at masked tokens).
    """
    gh, gw = grid_hw
    batch, num_blocks = log_aspect.shape
    n_tokens = gh * gw
    block_area = ratio * n_tokens / num_blocks
    aspect = torch.exp(log_aspect)
    bh = torch.sqrt(block_area[:, None] * aspect)
    bw = torch.sqrt(block_area[:, None] / aspect)
    bh = torch.clamp(torch.round(bh), 1, gh).to(torch.int32)
    bw = torch.clamp(torch.round(bw), 1, gw).to(torch.int32)
    y0 = (pos[..., 0] * (gh - bh + 1).float()).to(torch.int32)
    x0 = (pos[..., 1] * (gw - bw + 1).float()).to(torch.int32)
    rows = torch.arange(gh, device=pos.device)[None, None, :]
    cols = torch.arange(gw, device=pos.device)[None, None, :]
    in_y = (rows >= y0[..., None]) & (rows < (y0 + bh)[..., None])
    in_x = (cols >= x0[..., None]) & (cols < (x0 + bw)[..., None])
    blocks = in_y[:, :, :, None] & in_x[:, :, None, :]  # (B, nb, gh, gw)
    mask = blocks.any(dim=1).reshape(batch, n_tokens) & selected[:, None]
    n_masked = mask.float().sum(dim=1, keepdim=True)
    mask_weight = mask.float() / torch.clamp(n_masked, min=1.0)
    return mask, mask_weight


def random_block_masks(
    generator: torch.Generator,
    batch: int,
    grid_hw: Tuple[int, int],
    mask_prob: float = 0.5,
    mask_ratio: Tuple[float, float] = (0.1, 0.5),
    num_blocks: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample block masks over a (gh, gw) patch grid on the generator's
    device: blocks with log-uniform aspect in [0.3, 1/0.3], total area
    targeting a ratio uniform in ``mask_ratio``."""
    dev = generator.device

    def uniform(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    selected = uniform((batch,)) < mask_prob
    ratio = uniform((batch,), mask_ratio[0], mask_ratio[1])
    log_aspect = uniform((batch, num_blocks), math.log(0.3),
                         math.log(1.0 / 0.3))
    pos = uniform((batch, num_blocks, 2))
    return block_masks_from_params(selected, ratio, log_aspect, pos, grid_hw)
