"""Point sampling for the Mask2Former-style losses (PointRend sampling).

Port of ``lightly_train_tpu/ops/point_sampling.py``: instead of CE and dice
over full-resolution masks, the EoMT losses are taken at sampled points,
importance-sampled where the prediction is uncertain plus a uniform floor.
Coordinates are (y, x) in [0, 1] with ``grid_sample``'s
``align_corners=False`` convention (pixel centres at (i + 0.5) / size) and
zero padding outside the grid.

Every sampler here is the 4-tap bilinear gather; the JAX package's
tent-matrix products were a TPU workaround for gathers and compute the same
values. Candidates are ranked by an exact ``topk`` (the JAX package's CPU
path).

Every random draw of the EoMT stack goes through :func:`uniform`: from an
explicit ``torch.Generator`` on the tensor's device, or, where a test or a
check hands them in, from a queue of given uniforms (:func:`injected`).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import torch

# Uniforms handed in by :func:`injected`, consumed in draw order.
_QUEUE: List[torch.Tensor] = []


def uniform(generator: Optional[torch.Generator], shape: Sequence[int],
            device: torch.device) -> torch.Tensor:
    """Uniform [0, 1) float32 of ``shape`` on ``device``: the next injected
    draw where :func:`injected` has handed some in, else from
    ``generator``."""
    if _QUEUE:
        u = _QUEUE.pop(0)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"injected uniforms of shape {tuple(u.shape)} "
                             f"where the draw wants {tuple(shape)}")
        return u.to(device=device, dtype=torch.float32)
    gen_device = generator.device if generator is not None else device
    return torch.rand(tuple(shape), generator=generator,
                      device=gen_device).to(device)


@contextlib.contextmanager
def injected(draws: Sequence[torch.Tensor]) -> Iterator[List[torch.Tensor]]:
    """Within the block, :func:`uniform` returns ``draws`` in order; the
    block's end fails if any is left, so a draw the code no longer makes
    does not pass unseen."""
    _QUEUE[:] = list(draws)
    try:
        yield _QUEUE
        if _QUEUE:
            raise AssertionError(f"{len(_QUEUE)} injected draws unused")
    finally:
        _QUEUE.clear()


def _taps(coords: torch.Tensor, h: int, w: int):
    """The 4 bilinear taps of (..., 2) coords on an (h, w) grid: a list of
    (flat index (...,) int64, weight (...,) with 0 outside the grid)."""
    y = coords[..., 0] * h - 0.5
    x = coords[..., 1] * w - 0.5
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            wgt = (wy1 if dy else 1.0 - wy1) * (wx1 if dx else 1.0 - wx1)
            inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            lin = (yi.clamp(0, h - 1).long() * w
                   + xi.clamp(0, w - 1).long())
            taps.append((lin, wgt * inside))
    return taps


def bilinear_point_sample(grid: torch.Tensor,
                          coords: torch.Tensor) -> torch.Tensor:
    """Sample ``grid`` (B, C, gh, gw) at ``coords`` (B, P, 2): (B, C, P),
    bilinear with zero padding (torch ``point_sample``). The taps are read
    by advanced indexing, whose backward accumulates through a sorted
    ``index_put_`` and so is the same on every run on the card (``gather``'s
    backward adds with atomics there, in any order)."""
    B, C, gh, gw = grid.shape
    flat = grid.reshape(B, C, gh * gw)
    rows = torch.arange(B, device=grid.device)[:, None, None]
    chans = torch.arange(C, device=grid.device)[None, :, None]
    out = torch.zeros((B, C, coords.shape[1]), dtype=grid.dtype,
                      device=grid.device)
    for lin, wgt in _taps(coords, gh, gw):
        out = out + flat[rows, chans, lin[:, None, :]] * wgt[:, None, :].to(
            grid.dtype)
    return out


def bilinear_point_sample_rows(feats: torch.Tensor,
                               coords: torch.Tensor) -> torch.Tensor:
    """Sample a feature map ``feats`` (B, gh, gw, D) at ``coords`` (B, P,
    2): (B, P, D), whole D-rows per tap."""
    B, gh, gw, D = feats.shape
    flat = feats.reshape(B, gh * gw, D)
    out = torch.zeros(coords.shape[:-1] + (D,), dtype=feats.dtype,
                      device=feats.device)
    for lin, wgt in _taps(coords, gh, gw):
        g = flat.gather(1, lin[..., None].expand(-1, -1, D))
        out = out + g * wgt[..., None].to(feats.dtype)
    return out


def sample_id_indicator(id_map: torch.Tensor, coords: torch.Tensor,
                        num_slots: int,
                        slot_ids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Bilinear samples of each slot's indicator ``id_map == k`` (k <
    ``num_slots``; ids outside are background), or of ``id_map ==
    slot_ids[b, k]`` where the (B, K) ``slot_ids`` are given, at shared
    ``coords`` (B, P, 2): float32 (B, K, P), without (B, K, H, W) one-hot
    maps. With ``slot_ids`` the slot count is theirs and ``num_slots`` must
    agree with it."""
    B, H, W = id_map.shape
    if slot_ids is not None and slot_ids.shape[1] != num_slots:
        raise ValueError(f"num_slots {num_slots} disagrees with slot_ids' "
                         f"{slot_ids.shape[1]} slots")
    flat = id_map.reshape(B, H * W)
    targets = (slot_ids.to(id_map.dtype) if slot_ids is not None
               else torch.arange(num_slots, device=id_map.device,
                                 dtype=id_map.dtype)[None].expand(B, -1))
    out = torch.zeros((B, coords.shape[1], num_slots), dtype=torch.float32,
                      device=id_map.device)
    for lin, wgt in _taps(coords, H, W):
        ids = flat.gather(1, lin)
        hit = (ids[..., None] == targets[:, None, :]).float()
        out = out + hit * wgt[..., None]
    return out.transpose(1, 2)


def sample_slot_indicator(id_map: torch.Tensor, coords: torch.Tensor,
                          slot_ids: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``id_map == slot`` at per-slot coords (B, S, P,
    2); ``slot_ids`` (S,) the id of each slot row, or (B, S) per image:
    float32 (B, S, P)."""
    B, H, W = id_map.shape
    S, P = coords.shape[1], coords.shape[2]
    ids = (slot_ids[None, :] if slot_ids.ndim == 1 else slot_ids).to(
        id_map.dtype)
    flat = id_map.reshape(B, H * W)
    out = torch.zeros((B, S, P), dtype=torch.float32, device=id_map.device)
    for lin, wgt in _taps(coords, H, W):
        got = flat.gather(1, lin.reshape(B, S * P)).reshape(B, S, P)
        out = out + (got == ids[..., None]).float() * wgt
    return out


def uncertainty_point_coords(generator: Optional[torch.Generator],
                             pred_grid: torch.Tensor, num_points: int,
                             oversample_ratio: float,
                             importance_sample_ratio: float) -> torch.Tensor:
    """Importance plus uniform point coordinates per mask: (M, num_points,
    2) for the (M, gh, gw) mask logits ``pred_grid``. Draws
    ``num_points * oversample_ratio`` uniform candidates, keeps the
    ``importance_sample_ratio`` share with the highest uncertainty
    (-|logit|, exact top-k) and fills the rest with fresh uniform points
    (two draws of :func:`uniform`, the candidates' first)."""
    M = pred_grid.shape[0]
    n_over = int(num_points * oversample_ratio)
    n_unc = int(importance_sample_ratio * num_points)
    n_rand = num_points - n_unc
    device = pred_grid.device
    coords_o = uniform(generator, (M, n_over, 2), device)
    if n_unc > 0:
        logits_o = bilinear_point_sample(pred_grid[:, None],
                                         coords_o)[:, 0]
        uncertainty = -logits_o.float().abs()
        top = torch.topk(uncertainty, n_unc, dim=1).indices
        coords_unc = coords_o.gather(1, top[..., None].expand(-1, -1, 2))
    else:
        coords_unc = coords_o[:, :0]
    if n_rand > 0:
        coords_r = uniform(generator, (M, n_rand, 2), device)
        return torch.cat([coords_unc, coords_r], dim=1)
    return coords_unc
