"""Box utilities: format conversion, IoU, GIoU.

Port of ``lightly_train_tpu/tasks/detection/box_utils.py``. Boxes are
normalized cxcywh in the models and xyxy for the IoU computations. The
clips are ``torch.maximum``/``torch.minimum`` against a tensor, whose
gradient splits at a tie as ``jnp.maximum``'s and ``jnp.clip``'s does
(torch's clamp passes all of it): a box clipped to exactly 0 or 1 by a
saturated sigmoid gets the JAX gradient.
"""

from __future__ import annotations

import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def at_least(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``, its gradient split at a tie."""
    return torch.maximum(x, x.new_tensor(lo))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, its gradient split at a tie."""
    return torch.minimum(at_least(x, lo), x.new_tensor(hi))


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (at_least(boxes[..., 2] - boxes[..., 0], 0.0)
            * at_least(boxes[..., 3] - boxes[..., 1], 0.0))


def _inter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = at_least(rb - lt, 0.0)
    return wh[..., 0] * wh[..., 1]


def _hull(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.minimum(a[..., :2], b[..., :2])
    rb = torch.maximum(a[..., 2:], b[..., 2:])
    wh = at_least(rb - lt, 0.0)
    return wh[..., 0] * wh[..., 1]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. a: (..., N, 4), b: (..., M, 4) xyxy -> (..., N, M)."""
    inter = _inter(a[..., :, None, :], b[..., None, :, :])
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / at_least(union, 1e-9)


def paired_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of aligned pairs. a, b: (..., 4) xyxy -> (...)."""
    inter = _inter(a, b)
    union = box_area(a) + box_area(b) - inter
    return inter / at_least(union, 1e-9)


def paired_generalized_box_iou(a: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU of aligned pairs (xyxy)."""
    iou = paired_box_iou(a, b)
    hull = _hull(a, b)
    union = box_area(a) + box_area(b) - _inter(a, b)
    return iou - (hull - union) / at_least(hull, 1e-9)


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU (xyxy)."""
    iou = box_iou(a, b)
    a2, b2 = a[..., :, None, :], b[..., None, :, :]
    hull = _hull(a2, b2)
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - _inter(
        a2, b2)
    return iou - (hull - union) / at_least(hull, 1e-9)
