"""On-device detection augmentations: Mosaic, MixUp, zoom-out, rotate-90.

Port of the functions of ``lightly_train_tpu/ops/detection_augs.py`` that
``ObjectDetectionTrainModel.augment_batch`` calls (``mosaic``,
``detection_mixup``, ``random_zoom_out``, ``random_rotate90``,
``window_gate``). Each takes its random draws explicitly (uniforms in [0,
1), a Beta sample, rotation counts), so that the tests can hand over the
JAX package's; ``sample_*`` draws them from a generator. The partners of
Mosaic and MixUp are the batch rolled by 1, 2 and 3 (on one card the
whole batch). Boxes are (B, K, 4) normalized cxcywh with valid flags; the
composite ops concatenate the partners' targets (4K for Mosaic, 2K for
MixUp). ``random_iou_crop``, ``photometric_distort``, ``scale_jitter``,
``copy_blend`` and ``channel_shuffle`` have no caller in the JAX package
and are not ported.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from lightly_train_tpu_torch.ops.augment import crop_resize_matmul
from lightly_train_tpu_torch.tasks.semantic_segmentation_linear import (
    resize_bilinear,
)


def _roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Row ``b`` of the result is row ``(b + shift) % B``."""
    B = x.shape[0]
    idx = (torch.arange(B, device=x.device) + shift) % B
    return x[idx]


def mosaic(images: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor,
           valid: torch.Tensor, u_apply: torch.Tensor, prob: float = 1.0
           ) -> Tuple[torch.Tensor, ...]:
    """4-image mosaic where ``u_apply`` ((B,) uniforms) < ``prob``: a 2x2
    grid of the image and 3 rolled partners, each halved (antialiased
    bilinear); boxes move into their quadrants. Returns (images, boxes (B,
    4K, 4), labels (B, 4K), valid (B, 4K)); where not applied, the
    original targets padded with 3K empty slots."""
    B, H, W, C = images.shape
    imgs_f = images.float()
    half = resize_bilinear(imgs_f, (H // 2, W // 2))
    quads = [half] + [_roll(half, s) for s in (1, 2, 3)]
    grid = torch.cat([torch.cat([quads[0], quads[1]], 2),
                      torch.cat([quads[2], quads[3]], 2)], 1)
    offsets = [(0.0, 0.0), (0.0, 0.5), (0.5, 0.0), (0.5, 0.5)]  # (dy, dx)
    nb, nl, nv = [], [], []
    for q, (dy, dx) in enumerate(offsets):
        b = _roll(boxes, q) if q else boxes
        nl.append(_roll(labels, q) if q else labels)
        nv.append(_roll(valid, q) if q else valid)
        nb.append(torch.stack([b[..., 0] * 0.5 + dx, b[..., 1] * 0.5 + dy,
                               b[..., 2] * 0.5, b[..., 3] * 0.5], -1))
    m_boxes, m_labels, m_valid = (torch.cat(nb, 1), torch.cat(nl, 1),
                                  torch.cat(nv, 1))
    apply = u_apply < prob
    out_images = torch.where(apply[:, None, None, None], grid,
                             imgs_f).to(images.dtype)
    K = boxes.shape[1]
    pad_boxes = torch.cat([boxes, torch.zeros_like(m_boxes[:, :3 * K])], 1)
    pad_labels = torch.cat([labels, torch.zeros_like(m_labels[:, :3 * K])], 1)
    pad_valid = torch.cat([valid, torch.zeros_like(m_valid[:, :3 * K])], 1)
    a = apply[:, None]
    return (out_images, torch.where(a[..., None], m_boxes, pad_boxes),
            torch.where(a, m_labels, pad_labels),
            torch.where(a, m_valid, pad_valid))


def detection_mixup(images: torch.Tensor, boxes: torch.Tensor,
                    labels: torch.Tensor, valid: torch.Tensor,
                    u_apply: torch.Tensor, beta: torch.Tensor,
                    prob: float = 0.5) -> Tuple[torch.Tensor, ...]:
    """Blend with the batch rolled by 1 where ``u_apply`` < ``prob``, at
    ``lam = 0.25 + 0.5 beta`` (``beta``: (B,) Beta samples); the targets are
    the union of both, the partner's flagged only where applied. Returns
    (images, boxes (B, 2K, 4), labels (B, 2K), valid (B, 2K))."""
    lam = (beta * 0.5 + 0.25)[:, None, None, None]
    imgs_f = images.float()
    mixed = lam * imgs_f + (1.0 - lam) * _roll(imgs_f, 1)
    apply = u_apply < prob
    out_images = torch.where(apply[:, None, None, None], mixed,
                             imgs_f).to(images.dtype)
    return (out_images, torch.cat([boxes, _roll(boxes, 1)], 1),
            torch.cat([labels, _roll(labels, 1)], 1),
            torch.cat([valid, _roll(valid, 1) & apply[:, None]], 1))


def random_zoom_out(images: torch.Tensor, boxes: torch.Tensor,
                    u_apply: torch.Tensor, u_scale: torch.Tensor,
                    u_pos: torch.Tensor, prob: float = 0.5,
                    max_scale: float = 2.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where ``u_apply`` < ``prob``, the image shrinks by ``s = 1 + u_scale
    (max_scale - 1)`` into a canvas of 0.5 (114 for uint8) at the offset
    ``u_pos (1 - 1 / s)`` ((B, 2) as (y, x)); the boxes follow. The size is
    unchanged."""
    B, H, W, C = images.shape
    s = torch.clamp(u_scale * (max_scale - 1.0) + 1.0, min=1.0)
    frac = 1.0 / s
    off = u_pos * (1.0 - frac)[:, None]
    zoomed = crop_resize_matmul(images.float(), -off[:, 0] * s * H,
                                -off[:, 1] * s * W, s * H, s * W, (H, W))
    dev = images.device
    uy = (torch.arange(H, device=dev)[None, :] + 0.5) / H
    ux = (torch.arange(W, device=dev)[None, :] + 0.5) / W
    in_y = (uy >= off[:, 0:1]) & (uy <= off[:, 0:1] + frac[:, None])
    in_x = (ux >= off[:, 1:2]) & (ux <= off[:, 1:2] + frac[:, None])
    inside = in_y[:, :, None] & in_x[:, None, :]
    gray = 114.0 if images.dtype == torch.uint8 else 0.5
    zoomed = torch.where(inside[..., None], zoomed,
                         torch.tensor(gray, device=dev))
    new_boxes = torch.stack([
        boxes[..., 0] * frac[:, None] + off[:, 1:2],
        boxes[..., 1] * frac[:, None] + off[:, 0:1],
        boxes[..., 2] * frac[:, None], boxes[..., 3] * frac[:, None]], -1)
    apply = u_apply < prob
    out_images = torch.where(apply[:, None, None, None], zoomed,
                             images.float()).to(images.dtype)
    return out_images, torch.where(apply[:, None, None], new_boxes, boxes)


def random_rotate90(images: torch.Tensor, boxes: torch.Tensor,
                    u_apply: torch.Tensor, k_draw: torch.Tensor,
                    prob: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where ``u_apply`` < ``prob``, a counter-clockwise rotation by
    ``k_draw`` ((B,) in 0..3) quarter turns of the (square) image, with the
    boxes remapped exactly."""
    if images.shape[1] != images.shape[2]:
        raise ValueError("rotate90 needs square views")
    k = torch.where(u_apply < prob, k_draw.long(), 0)
    sel = k[:, None, None, None]
    out = images
    for turns in (1, 2, 3):
        out = torch.where(sel == turns, torch.rot90(images, turns, (1, 2)),
                          out)
    cx, cy, w, h = boxes.unbind(-1)
    variants = torch.stack([
        torch.stack([cx, cy, w, h], -1),
        torch.stack([cy, 1.0 - cx, h, w], -1),
        torch.stack([1.0 - cx, 1.0 - cy, w, h], -1),
        torch.stack([1.0 - cy, cx, h, w], -1)], 0)  # (4, B, K, 4)
    b = torch.arange(boxes.shape[0], device=boxes.device)
    return out, variants[k, b]


def window_gate(step: int, start: int, stop: int) -> float:
    """1.0 inside the activation window [start, stop), else 0.0."""
    return float(start <= step < stop)


def sample_uniform(generator: Optional[torch.Generator], shape,
                   device: torch.device) -> torch.Tensor:
    gen_device = generator.device if generator is not None else device
    return torch.rand(tuple(shape), generator=generator,
                      device=gen_device).to(device)


def sample_beta_half(generator: Optional[torch.Generator], n: int,
                     device: torch.device) -> torch.Tensor:
    """(n,) Beta(0.5, 0.5) samples: ``sin^2(pi u / 2)`` of uniforms (its
    inverse CDF)."""
    u = sample_uniform(generator, (n,), device)
    return torch.sin(0.5 * math.pi * u) ** 2


def sample_quarter_turns(generator: Optional[torch.Generator], n: int,
                         device: torch.device) -> torch.Tensor:
    gen_device = generator.device if generator is not None else device
    return torch.randint(0, 4, (n,), generator=generator,
                         device=gen_device).to(device)
