"""D-FINE's distribution parameterization.

Port of ``lightly_train_tpu/tasks/detection/dfine_utils.py``: the
non-uniform weighting function W(n), the Integral expectation, the
anchor-to-box decode (:func:`distance2bbox`) and its inverse for the FGL
targets (:func:`bbox2distance`). W(n) is a constant numpy table.
"""

from __future__ import annotations

import numpy as np
import torch


def weighting_function(reg_max: int, up: float = 0.5,
                       reg_scale: float = 4.0) -> np.ndarray:
    """W(n): reg_max + 1 non-uniform bin values."""
    u1 = abs(up) * abs(reg_scale)
    u2 = u1 * 2
    step = (u1 + 1) ** (2 / (reg_max - 2))
    left = [-(step ** i) + 1 for i in range(reg_max // 2 - 1, 0, -1)]
    right = [step ** i - 1 for i in range(1, reg_max // 2)]
    return np.asarray([-u2] + left + [0.0] + right + [u2], np.float32)


def integral(corners: torch.Tensor, project: np.ndarray) -> torch.Tensor:
    """sum{Pr(n) W(n)} per edge: (..., 4, reg_max + 1) -> (..., 4)."""
    prob = torch.softmax(corners.float(), dim=-1)
    return torch.einsum("...n,n->...", prob,
                        torch.as_tensor(project, device=corners.device))


def distance2bbox(points: torch.Tensor, distance: torch.Tensor,
                  reg_scale: float = 4.0) -> torch.Tensor:
    """Anchor (cxcywh) plus per-edge distances -> the refined cxcywh box."""
    rs = abs(reg_scale)
    x1 = points[..., 0] - (0.5 * rs + distance[..., 0]) * (points[..., 2] / rs)
    y1 = points[..., 1] - (0.5 * rs + distance[..., 1]) * (points[..., 3] / rs)
    x2 = points[..., 0] + (0.5 * rs + distance[..., 2]) * (points[..., 2] / rs)
    y2 = points[..., 1] + (0.5 * rs + distance[..., 3]) * (points[..., 3] / rs)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def bbox2distance(points: torch.Tensor, bbox_xyxy: torch.Tensor,
                  reg_max: int, reg_scale: float = 4.0, up: float = 0.5,
                  eps: float = 0.1):
    """The FGL targets: the continuous edge distances of ``bbox_xyxy`` from
    the cxcywh anchors ``points`` as (left bin index, weight of the right
    bin, weight of the left bin), each (..., 4)."""
    rs = abs(reg_scale)
    wx = points[..., 2] / rs + 1e-16
    wy = points[..., 3] / rs + 1e-16
    left = (points[..., 0] - bbox_xyxy[..., 0]) / wx - 0.5 * rs
    top = (points[..., 1] - bbox_xyxy[..., 1]) / wy - 0.5 * rs
    right = (bbox_xyxy[..., 2] - points[..., 0]) / wx - 0.5 * rs
    bottom = (bbox_xyxy[..., 3] - points[..., 1]) / wy - 0.5 * rs
    gt = torch.stack([left, top, right, bottom], -1)
    fv = torch.as_tensor(weighting_function(reg_max, up, reg_scale),
                         device=gt.device)
    # The closest left bin: the number of W values <= gt, minus 1.
    idx = (fv <= gt[..., None]).sum(-1) - 1
    valid = (idx >= 0) & (idx < reg_max)
    safe = idx.clamp(0, reg_max - 1)
    lv, rv = fv[safe], fv[safe + 1]
    ld, rd = (gt - lv).abs(), (rv - gt).abs()
    w_right = torch.where(valid, ld / (ld + rd).clamp(min=1e-12), 0.0)
    w_right = torch.where(idx >= reg_max, 1.0, w_right)
    w_left = 1.0 - w_right
    out_idx = torch.where(idx < 0, 0.0, torch.where(
        idx >= reg_max, reg_max - 0.1, idx.float())).float()
    return out_idx.clamp(0.0, reg_max - eps), w_right, w_left
