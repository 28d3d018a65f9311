"""DINOv31: the DINOv2 objective plus PaKA, a dense patch-kernel alignment
of the student to the EMA teacher on a clean view.

Port of ``lightly_train_tpu/methods/dinov31.py``, the JAX package's
reconstruction of PaKA (its loss is rebuilt from the paper, not from the
reference's source; ``PARITY.md``), copied as it is:

- a clean global view (no flip and no photometric ops, crop scale
  0.6-1.0) is inserted as the third view; the DINOv2 loss runs on the
  others;
- the views' crop geometry, (B, 5) ``[y0, x0, h, w, hflipped]`` in source
  pixels, follows the views in the list (``needs_geometry``);
- the EMA teacher's patch grid of the clean view is resampled onto the
  first global view's crop (``crop_resize_matmul``, bilinear), mirrored
  where that view was flipped; a second student forward gives that view's
  patch grid;
- both grids go through the PaKA head (student trained, its teacher copy
  in the EMA tree), are l2-normalized, and the student's patch-similarity
  kernel is aligned to the teacher's by row-softmax cross-entropy over the
  patches whose centres the clean crop covers (``paka_overlap_validity``);
- the PaKA loss counts from step ``paka_start_step`` on.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch.methods.base import ViewSpec
from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
from lightly_train_tpu_torch.models.conv import frozen_buffers
from lightly_train_tpu_torch.models.vit import Linear
from lightly_train_tpu_torch.ops.augment import (
    ViewAugmentConfig,
    crop_resize_matmul,
)
from lightly_train_tpu_torch.ops.losses import l2_normalize


def paka_overlap_validity(y0: torch.Tensor, x0: torch.Tensor,
                          hh: torch.Tensor, ww: torch.Tensor,
                          flip: torch.Tensor, gs_hw: Tuple[int, int],
                          gt_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, gs_h, gs_w) bool: the student patches whose centres lie inside
    the teacher's clean crop. ``(y0, x0, hh, ww)`` is the student's crop
    in teacher-grid coordinates (the clean crop spans [0, gt_h] x [0,
    gt_w]); ``flip`` mirrors the columns as the student's grid is."""
    gs_h, gs_w = gs_hw
    gt_h, gt_w = gt_hw
    dev = y0.device
    ty = y0[:, None] + (torch.arange(gs_h, device=dev) + 0.5)[None, :] * (
        hh[:, None] / gs_h)
    tx = x0[:, None] + (torch.arange(gs_w, device=dev) + 0.5)[None, :] * (
        ww[:, None] / gs_w)
    vy = (ty >= 0) & (ty <= gt_h)
    vx = (tx >= 0) & (tx <= gt_w)
    vx = torch.where(flip[:, None] > 0.5, vx.flip(1), vx)
    return vy[:, :, None] & vx[:, None, :]


class PaKAHead(nn.Module):
    """embed -> hidden -> hidden -> bottleneck, exact GELU, no norm; fp32
    (the JAX head's Dense layers promote to their fp32 parameters)."""

    def __init__(self, in_dim: int, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, hidden_dim)
        self.fc3 = Linear(hidden_dim, bottleneck_dim)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        for layer in (self.fc1, self.fc2, self.fc3):
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc3(F.gelu(self.fc2(F.gelu(self.fc1(x)))))


def paka_loss(zs: torch.Tensor, zt: torch.Tensor, valid: torch.Tensor,
              temp: float) -> torch.Tensor:
    """Row-softmax CE of the teacher's (B, N, N) patch kernel against the
    student's, over rows and columns of ``valid`` (B, N) patches, from the
    l2-normalized (B, N, D) patch embeddings."""
    ks = torch.einsum("bnd,bmd->bnm", zs, zs) / temp
    kt = torch.einsum("bnd,bmd->bnm", zt, zt) / temp
    w = valid[:, :, None] & valid[:, None, :]
    neg = -1e9 * (1.0 - w.float())
    p_t = torch.softmax(kt + neg, dim=-1)
    logp_s = torch.log_softmax(ks + neg, dim=-1)
    ce = -(p_t * logp_s * w).sum(dim=-1)
    row_valid = valid.float()
    return (ce * row_valid).sum() / torch.clamp(row_valid.sum(), min=1.0)


@dataclasses.dataclass
class DINOv31Args(DINOv2Args):
    paka_weight: float = 1.0
    paka_temp: float = 0.25
    clean_crop_scale: Tuple[float, float] = (0.6, 1.0)
    paka_hidden_dim: int = 2048
    paka_bottleneck_dim: int = 256
    paka_start_step: int = 0


class DINOv31(DINOv2):
    name = "dinov31"
    needs_geometry = True

    def __init__(self, wrapped, args: DINOv31Args):
        super().__init__(wrapped, args)
        self.args: DINOv31Args = args

    def view_specs(self) -> List[ViewSpec]:
        a = self.args
        base = super().view_specs()
        g = a.global_image_size
        clean = ViewAugmentConfig(
            out_size=(g, g), crop_scale=a.clean_crop_scale, hflip_prob=0.0,
            cj_prob=0.0, gray_prob=0.0, blur_prob=0.0, solarize_prob=0.0)
        return base[:2] + [ViewSpec(clean, 1)] + base[2:]

    def init(self, generator, device):
        params, method_state = super().init(generator, device)
        a = self.args
        head = PaKAHead(self.wrapped.feature_dim, a.paka_hidden_dim,
                        a.paka_bottleneck_dim)
        head.reset_parameters(generator)
        params["paka_head"] = head.to(device)
        # The teacher's copy starts equal and rides the EMA with the rest.
        method_state["teacher"]["paka_head"] = copy.deepcopy(
            params["paka_head"]).requires_grad_(False)
        return params, method_state

    def _paka_loss(self, params, method_state, g1, geom_g1, clean,
                   geom_clean, generator=None) -> torch.Tensor:
        a = self.args
        teacher = method_state["teacher"]
        with torch.no_grad():
            ft = self.wrapped.forward_features(
                clean, None, train=False, module=teacher["student"]
            )["features"]
        with frozen_buffers(params["student"]):
            fs = self.wrapped.forward_features(
                g1, None, train=True, generator=generator,
                module=params["student"])["features"]
        B, gs_h, gs_w, D = fs.shape
        gt_h, gt_w = ft.shape[1], ft.shape[2]
        ys, xs, hs, ws, flip = (geom_g1[:, i] for i in range(5))
        yc, xc, hc, wc = (geom_clean[:, i] for i in range(4))
        # The student's crop in the teacher grid's coordinates.
        y0 = (ys - yc) / hc * gt_h
        x0 = (xs - xc) / wc * gt_w
        hh = hs / hc * gt_h
        ww = ws / wc * gt_w
        with torch.no_grad():
            ft_aligned = crop_resize_matmul(ft, y0, x0, hh, ww, (gs_h, gs_w))
            ft_aligned = torch.where(flip[:, None, None, None] > 0.5,
                                     ft_aligned.flip(2), ft_aligned)
        valid = paka_overlap_validity(y0, x0, hh, ww, flip, (gs_h, gs_w),
                                      (gt_h, gt_w)).reshape(B, gs_h * gs_w)
        n = gs_h * gs_w
        zs = l2_normalize(params["paka_head"](fs.reshape(B, n, D)).float())
        with torch.no_grad():
            zt = l2_normalize(teacher["paka_head"](
                ft_aligned.reshape(B, n, D)).float())
        return paka_loss(zs, zt, valid, a.paka_temp)

    def loss_fn(self, params, method_state, views, step, total_steps,
                generator=None, masks=None):
        """``views``: the view tensors (g1, g2, clean, locals...), then
        their geometry arrays in the same order. ``masks`` pins the DINOv2
        part's iBOT masks."""
        n = len(views) // 2
        view_arrs, geoms = views[:n], views[n:]
        dino_views = [view_arrs[0], view_arrs[1]] + list(view_arrs[3:])
        loss, (method_state, metrics) = super().loss_fn(
            params, method_state, dino_views, step, total_steps,
            generator=generator, masks=masks)
        paka = self._paka_loss(params, method_state, view_arrs[0], geoms[0],
                               view_arrs[2], geoms[2], generator)
        paka = paka * (1.0 if step >= self.args.paka_start_step else 0.0)
        total = loss + self.args.paka_weight * paka
        return total, (method_state, {**metrics, "paka_loss": paka.detach()})
