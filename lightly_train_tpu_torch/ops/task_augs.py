"""On-device geometric augmentations of the fine-tuning tasks.

Port of ``lightly_train_tpu/ops/task_augs.py``. The staged uint8 batch stays
at one fixed size; the geometric chain (scale jitter and random crop, or
RandomResizedCrop, with the flips) is one crop box per sample, resampled by
two batched products. Unlike ``ops/augment.crop_resize_matmul`` the
resampling matrices here are not clipped: a box may reach beyond the image
(zoom-out), and the sampling mass that falls outside becomes the pad
``fill`` (albumentations' ``pad_if_needed`` with a constant fill; masks take
``ignore_index``).

As in ``ops/augment.py``, each random op is a sampler that takes an explicit
``torch.Generator`` and returns the sampled parameters, and an applier of
those parameters; the tests hand both packages the same parameters.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lightly_train_tpu_torch.ops.augment import _uniform

Boxes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _hat_matrix_unclipped(src: torch.Tensor, in_size: int) -> torch.Tensor:
    """(B, out) source coordinates -> (B, out, in) bilinear weights; a
    coordinate outside [-1, in] gets a row of zeros (its mass is the
    fill)."""
    idx = torch.arange(in_size, dtype=torch.float32, device=src.device)
    return torch.clamp(1.0 - torch.abs(src[..., None] - idx), 0.0, 1.0)


def _nearest_matrix_unclipped(src: torch.Tensor, in_size: int) -> torch.Tensor:
    """One-hot nearest weights; a coordinate out of range gets zeros."""
    idx = torch.arange(in_size, dtype=torch.float32, device=src.device)
    return (torch.abs(torch.round(src)[..., None] - idx) < 0.5).float()


def _source_coords(B: int, y0, x0, h, w, out_hw: Tuple[int, int],
                   hflip: Optional[torch.Tensor],
                   vflip: Optional[torch.Tensor], device):
    """(B, oh) and (B, ow) source coordinates of the output pixels, the
    flips folded into them."""
    oh, ow = out_hw
    t_y = ((torch.arange(oh, dtype=torch.float32, device=device) + 0.5)
           / oh)[None, :].expand(B, oh)
    t_x = ((torch.arange(ow, dtype=torch.float32, device=device) + 0.5)
           / ow)[None, :].expand(B, ow)
    if vflip is not None:
        t_y = torch.where(vflip[:, None], 1.0 - t_y, t_y)
    if hflip is not None:
        t_x = torch.where(hflip[:, None], 1.0 - t_x, t_x)
    sy = y0[:, None] + t_y * h[:, None] - 0.5
    sx = x0[:, None] + t_x * w[:, None] - 0.5
    return sy, sx


def padded_crop_resize(
    images: torch.Tensor,
    y0: torch.Tensor,
    x0: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    out_hw: Tuple[int, int],
    fill: float = 0.0,
    hflip: Optional[torch.Tensor] = None,
    vflip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched bilinear crop and resize of (B, H, W, C) images to float32
    (B, oh, ow, C), boxes (B,) in staged pixels that may leave the image;
    the missing sampling mass is ``fill``."""
    B, H, W, C = images.shape
    sy, sx = _source_coords(B, y0, x0, h, w, out_hw, hflip, vflip,
                            images.device)
    Ry = _hat_matrix_unclipped(sy, H)  # (B, oh, H)
    Rx = _hat_matrix_unclipped(sx, W)  # (B, ow, W)
    rows = torch.einsum("boh,bhwc->bowc", Ry, images.float())
    out = torch.einsum("bowc,bxw->boxc", rows, Rx)
    if fill != 0.0:
        mass = Ry.sum(-1)[:, :, None] * Rx.sum(-1)[:, None, :]
        out = out + (1.0 - mass)[..., None] * fill
    return out


def padded_crop_resize_nearest(
    maps: torch.Tensor,
    y0: torch.Tensor,
    x0: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    out_hw: Tuple[int, int],
    fill: int,
    hflip: Optional[torch.Tensor] = None,
    vflip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Nearest crop and resize of integer (B, H, W) id maps; out of bounds
    is ``fill`` (``ignore_index`` for semantic masks)."""
    B, H, W = maps.shape
    sy, sx = _source_coords(B, y0, x0, h, w, out_hw, hflip, vflip,
                            maps.device)
    Ry = _nearest_matrix_unclipped(sy, H)
    Rx = _nearest_matrix_unclipped(sx, W)
    rows = torch.einsum("boh,bhw->bow", Ry, maps.float())
    out = torch.einsum("bow,bxw->box", rows, Rx)
    mass = Ry.sum(-1)[:, :, None] * Rx.sum(-1)[:, None, :]
    out = torch.where(mass > 0.5, torch.round(out),
                      torch.full_like(out, float(fill)))
    return out.to(maps.dtype)


def sample_scale_jitter_crop(
    generator: torch.Generator,
    batch: int,
    in_hw: Tuple[int, int],
    out_hw: Tuple[int, int],
    min_scale: float,
    max_scale: float,
    num_scales: int,
    prob: float = 1.0,
    crop_prob: float = 1.0,
    pad_if_needed: bool = True,
) -> Boxes:
    """(y0, x0, h, w) boxes in staged pixels for scale jitter followed by a
    random crop with centre padding: the scale one of
    ``linspace(min_scale, max_scale, num_scales)``, applied with ``prob``
    (else a plain random crop of ``out_hw``); ``crop_prob`` < 1 keeps a
    sample's whole image; without ``pad_if_needed`` the window is clamped
    inside the image."""
    H, W = in_hw
    oh, ow = out_hw
    dev = generator.device
    scales = torch.tensor(
        np.linspace(min_scale, max_scale, max(num_scales, 1)),
        dtype=torch.float32, device=dev)
    s = scales[torch.randint(0, len(scales), (batch,), generator=generator,
                             device=dev)]
    applied = _uniform(generator, (batch,)) < prob
    u_y = _uniform(generator, (batch,))
    u_x = _uniform(generator, (batch,))
    skip = (_uniform(generator, (batch,)) >= crop_prob
            if crop_prob < 1.0 else None)
    return scale_jitter_crop_boxes(s, applied, u_y, u_x, skip, in_hw, out_hw,
                                   pad_if_needed)


def scale_jitter_crop_boxes(s, applied, u_y, u_x, skip, in_hw, out_hw,
                            pad_if_needed: bool = True) -> Boxes:
    """The boxes of :func:`sample_scale_jitter_crop` from its draws: the
    scale ``s``, whether it ``applied``, the crop's uniform offsets
    ``u_y``, ``u_x`` and the samples whose crop is skipped (``skip``,
    None for none)."""
    H, W = in_hw
    oh, ow = out_hw
    rh = torch.where(applied, s * oh, torch.full_like(s, float(H)))
    rw = torch.where(applied, s * ow, torch.full_like(s, float(W)))
    h = oh * H / rh
    w = ow * W / rw
    y0r = torch.where(rh >= oh, u_y * (rh - oh), -(oh - rh) / 2.0)
    x0r = torch.where(rw >= ow, u_x * (rw - ow), -(ow - rw) / 2.0)
    y0 = y0r * H / rh
    x0 = x0r * W / rw
    if not pad_if_needed:
        h = torch.clamp(h, max=float(H))
        w = torch.clamp(w, max=float(W))
        y0 = torch.minimum(torch.clamp(y0, min=0.0), H - h)
        x0 = torch.minimum(torch.clamp(x0, min=0.0), W - w)
    if skip is not None:
        y0 = torch.where(skip, torch.zeros_like(y0), y0)
        x0 = torch.where(skip, torch.zeros_like(x0), x0)
        h = torch.where(skip, torch.full_like(h, float(H)), h)
        w = torch.where(skip, torch.full_like(w, float(W)), w)
    return y0, x0, h, w


def sample_random_resized_crop(
    generator: torch.Generator,
    batch: int,
    in_hw: Tuple[int, int],
    min_scale: float,
    max_scale: float,
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Boxes:
    """RandomResizedCrop boxes: area fraction uniform in [min_scale,
    max_scale], aspect ratio log-uniform in ``ratio``, the box clamped
    inside the image."""
    area = _uniform(generator, (batch,), min_scale, max_scale)
    log_r = _uniform(generator, (batch,), float(np.log(ratio[0])),
                     float(np.log(ratio[1])))
    u_y = _uniform(generator, (batch,))
    u_x = _uniform(generator, (batch,))
    return random_resized_crop_boxes(area, log_r, u_y, u_x, in_hw)


def random_resized_crop_boxes(area_fraction, log_ratio, u_y, u_x,
                              in_hw: Tuple[int, int]) -> Boxes:
    """The boxes of :func:`sample_random_resized_crop` from its draws."""
    H, W = in_hw
    area = area_fraction * (H * W)
    r = torch.exp(log_ratio)
    w = torch.clamp(torch.sqrt(area * r), 1.0, float(W))
    h = torch.clamp(torch.sqrt(area / r), 1.0, float(H))
    return u_y * (H - h), u_x * (W - w), h, w


def sample_rot90(generator: torch.Generator, batch: int,
                 prob: float) -> torch.Tensor:
    """(B,) int64 quarter turns: uniform in {1, 2, 3} with ``prob``, else
    0 (albumentations' RandomRotate90)."""
    apply = _uniform(generator, (batch,)) < prob
    k = torch.randint(1, 4, (batch,), generator=generator,
                      device=generator.device)
    return torch.where(apply, k, torch.zeros_like(k))


def rot90_with(images: torch.Tensor, k: torch.Tensor,
               maps: Union[None, torch.Tensor, Sequence[torch.Tensor]] = None):
    """Rotate each sample of a square (B, H, W, ...) batch by ``k`` (B,)
    quarter turns counterclockwise (``jnp.rot90`` over the H, W axes);
    (B, H, W) ``maps`` (one or a list) follow their sample's ``k``. Returns
    (images, maps)."""
    H, W = images.shape[1:3]
    if H != W:
        raise ValueError(
            f"random_rot90 requires square staged images, got {(H, W)}")

    def rot(x: torch.Tensor) -> torch.Tensor:
        sel = k.reshape((-1,) + (1,) * (x.ndim - 1))
        out = x
        for turns in (1, 2, 3):
            out = torch.where(sel == turns, torch.rot90(x, turns, (1, 2)), out)
        return out

    if maps is None:
        return rot(images), None
    if isinstance(maps, (list, tuple)):
        return rot(images), [rot(m) for m in maps]
    return rot(images), rot(maps)


def rotate_maps_with(maps: Sequence[torch.Tensor], apply: torch.Tensor,
                     angle: torch.Tensor) -> List[torch.Tensor]:
    """Integer (B, H, W) id maps rotated about their centre by ``angle``
    (B,) radians where ``apply``, sampled nearest on the grid that
    ``ops/augment.random_rotate_with`` samples the images on (reflect-101
    border): the maps of the JAX ``random_rotate(..., maps=...)``."""
    B, H, W = maps[0].shape
    dev = maps[0].device
    cos, sin = torch.cos(angle), torch.sin(angle)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy = (torch.arange(H, dtype=torch.float32, device=dev) - cy)[:, None]
    xx = (torch.arange(W, dtype=torch.float32, device=dev) - cx)[None, :]
    sy = cos[:, None, None] * yy - sin[:, None, None] * xx + cy
    sx = sin[:, None, None] * yy + cos[:, None, None] * xx + cx

    def reflect101(v, n):
        period = 2.0 * (n - 1)
        v = torch.remainder(torch.abs(v), period)
        return torch.minimum(v, period - v)

    yn = torch.clamp(torch.round(reflect101(sy, H)).to(torch.int64), 0, H - 1)
    xn = torch.clamp(torch.round(reflect101(sx, W)).to(torch.int64), 0, W - 1)
    lin = (yn * W + xn).reshape(B, H * W)
    return [torch.where(apply[:, None, None],
                        torch.gather(m.reshape(B, H * W), 1, lin).reshape(
                            B, H, W), m) for m in maps]
