"""DetCon: contrast of region-pooled embeddings (DetCon-B with an EMA
teacher and a predictor, DetCon-S with two student forwards).

Port of ``lightly_train_tpu/methods/detcon.py``. Features are mean-pooled
per region, then projected: by a spatial grid of ``num_masks`` cells (a
perfect square) or, with ``use_dataset_masks`` and pretrain's ``mask_dir``,
by the dataset's region ids cropped with each view's geometry, downsampled
to the feature grid by a strided nearest pick and clipped to
``num_masks - 1``. Every region enters the loss (static shapes): a region
absent from a crop is left out of the negatives and its positive pair is
weighted 0, where the reference samples ``num_samples`` present regions.
DetCon-B (BYOL-like): the student's projector and predictor against the EMA
teacher's projector (momentum 0.996 -> 1.0 over backbone and projector),
LARS. DetCon-S (SimCLR-like): both views through the student and projector,
the cross-entropy symmetrized, no teacher.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch._optim import LARSArgs
from lightly_train_tpu_torch.methods.base import Method, MethodArgs, ViewSpec
from lightly_train_tpu_torch.models.heads import SimCLRProjectionHead
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.ops.augment import ViewAugmentConfig
from lightly_train_tpu_torch.ops.ema import cosine_schedule, ema_update
from lightly_train_tpu_torch.ops.losses import l2_normalize


@dataclasses.dataclass
class DetConBArgs(MethodArgs):
    image_size: int = 224
    num_masks: int = 16
    # The reference's count of present regions sampled per view; here every
    # region enters the loss and absent ones are masked out.
    num_samples: int = 5
    use_dataset_masks: bool = False
    temperature: float = 0.1
    momentum_start: float = 0.996
    momentum_end: float = 1.0
    hidden_dim: int = 2048
    output_dim: int = 128
    reference_batch_size: int = 1024
    lr_scale_method: str = "sqrt"


def grid_masks(hw: Tuple[int, int], num_masks: int,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """(h * w, num_masks) one-hot assignment of each pixel to a cell of a
    sqrt(num_masks)-square grid."""
    h, w = hw
    side = int(num_masks ** 0.5)
    if side * side != num_masks:
        raise ValueError(
            f"num_masks={num_masks} must be a perfect square in grid mode "
            "(dataset-mask mode accepts any count).")
    rows = torch.clamp(torch.arange(h, device=device) * side // h,
                       max=side - 1)
    cols = torch.clamp(torch.arange(w, device=device) * side // w,
                       max=side - 1)
    region = rows[:, None] * side + cols[None, :]
    return F.one_hot(region.reshape(-1), side * side).float()


def region_ce(x: torch.Tensor, y: torch.Tensor, pres_y: torch.Tensor,
              pair_w: torch.Tensor, temperature: float) -> torch.Tensor:
    """Cross-entropy of each region of ``x`` (B, M, D, l2-normalized)
    against all B M regions of ``y``, the same region of the same image the
    positive; absent regions of ``y`` left out (logit -1e9), pairs
    weighted by ``pair_w`` (B, M)."""
    B, M, _ = x.shape
    logits = torch.einsum("bmd,cnd->bmcn", x, y).reshape(B, M, B * M)
    logits = logits / temperature
    logits = torch.where(pres_y.reshape(1, 1, B * M), logits,
                         torch.full_like(logits, -1e9))
    labels = (torch.arange(B, device=x.device)[:, None] * M
              + torch.arange(M, device=x.device)[None, :])
    ce = -torch.gather(torch.log_softmax(logits, dim=-1), -1,
                       labels[..., None])[..., 0]
    return (ce * pair_w).sum() / torch.clamp(pair_w.sum(), min=1.0)


class DetConB(Method):
    name = "detconb"
    default_steps = 100_000
    default_batch_size = 1024
    ema_teacher = True

    def __init__(self, wrapped: WrappedModel, args: DetConBArgs):
        super().__init__(wrapped, args)
        self.args: DetConBArgs = args

    @property
    def needs_masks(self) -> bool:
        return self.args.use_dataset_masks

    def view_specs(self) -> List[ViewSpec]:
        s = self.args.image_size
        return [ViewSpec(ViewAugmentConfig(out_size=(s, s)), 2)]

    def _heads(self) -> Dict[str, nn.Module]:
        a = self.args
        return {
            "projector": SimCLRProjectionHead(self.wrapped.feature_dim,
                                              a.hidden_dim, a.output_dim),
            "predictor": SimCLRProjectionHead(a.output_dim,
                                              a.hidden_dim // 4, a.output_dim),
        }

    def _method_state(self, params: nn.ModuleDict) -> Dict[str, Any]:
        """The EMA teacher: copies of the backbone and the projector."""
        return {"teacher": nn.ModuleDict({
            "student": copy.deepcopy(params["student"]),
            "projector": copy.deepcopy(params["projector"]),
        }).requires_grad_(False)}

    def init(self, generator: torch.Generator, device: torch.device
             ) -> Tuple[nn.ModuleDict, Dict[str, Any]]:
        modules = {"student": self.wrapped.module, **self._heads()}
        for m in modules.values():
            m.reset_parameters(generator)
        params = nn.ModuleDict(modules).to(device)
        return params, self._method_state(params)

    def _views(self, views: List[torch.Tensor]):
        """(v0, v1, m0, m1): the mask crops where the dataset's masks are
        used and the runtime appended them, else None."""
        if self.args.use_dataset_masks and len(views) >= 4:
            return tuple(views[:4])
        return views[0], views[1], None, None

    def mask_pooled(self, modules: nn.ModuleDict, images: torch.Tensor,
                    train: bool, generator=None, use_predictor: bool = False,
                    region_masks: Optional[torch.Tensor] = None):
        """(embeddings (B, M, D'), presence (B, M) bool) of the regions."""
        out = self.wrapped.forward_features(images, None, train=train,
                                            generator=generator,
                                            module=modules["student"])
        feats = out["features"]
        B, h, w, D = feats.shape
        M = self.args.num_masks
        feats = feats.reshape(B, h * w, D).float()
        if region_masks is not None:
            mh = region_masks.shape[1] // h
            mw = region_masks.shape[2] // w
            grid_ids = region_masks[:, ::max(mh, 1), ::max(mw, 1)][:, :h, :w]
            onehot = F.one_hot(torch.clamp(grid_ids, 0, M - 1).long(),
                               M).float().reshape(B, h * w, M)
            counts = onehot.sum(dim=1)
            pooled = torch.einsum("bnd,bnm->bmd", feats, onehot) / torch.clamp(
                counts[:, :, None], min=1.0)
            presence = counts > 0
        else:
            masks = grid_masks((h, w), M, feats.device)
            pooled = torch.einsum("bnd,nm->bmd", feats, masks) / torch.clamp(
                masks.sum(dim=0)[None, :, None], min=1.0)
            presence = torch.ones((B, M), dtype=torch.bool,
                                  device=feats.device)
        z = modules["projector"](pooled)
        if use_predictor:
            z = modules["predictor"](z)
        return z, presence

    def loss_fn(self, params, method_state, views, step, total_steps,
                generator=None, masks=None):
        v0, v1, m0, m1 = self._views(views)
        z_s, pres_s = self.mask_pooled(params, v0, True, generator,
                                       use_predictor=True, region_masks=m0)
        with torch.no_grad():
            z_t, pres_t = self.mask_pooled(method_state["teacher"], v1, False,
                                           region_masks=m1)
        loss = region_ce(l2_normalize(z_s), l2_normalize(z_t), pres_t,
                         (pres_s & pres_t).float(), self.args.temperature)
        return loss, (method_state, {"detcon_loss": loss.detach()})

    def post_update(self, params, method_state, step, total_steps):
        a = self.args
        ema_update(dict(method_state["teacher"].named_parameters()),
                   dict(params.named_parameters()),
                   cosine_schedule(step, total_steps, a.momentum_start,
                                   a.momentum_end))
        return method_state

    @classmethod
    def default_optimizer_args(cls) -> LARSArgs:
        return LARSArgs(lr=0.3, momentum=0.9, weight_decay=1e-6)


class DetConS(DetConB):
    """Both views through the student and projector (two forwards of one
    student in a step), the region cross-entropy symmetrized; no teacher,
    no predictor."""

    name = "detcons"
    ema_teacher = False

    def _heads(self) -> Dict[str, nn.Module]:
        a = self.args
        return {"projector": SimCLRProjectionHead(
            self.wrapped.feature_dim, a.hidden_dim, a.output_dim)}

    def _method_state(self, params: nn.ModuleDict) -> Dict[str, Any]:
        return {}

    def loss_fn(self, params, method_state, views, step, total_steps,
                generator=None, masks=None):
        v0, v1, m0, m1 = self._views(views)
        z0, pres0 = self.mask_pooled(params, v0, True, generator,
                                     region_masks=m0)
        z1, pres1 = self.mask_pooled(params, v1, True, generator,
                                     region_masks=m1)
        za, zb = l2_normalize(z0), l2_normalize(z1)
        pair_w = (pres0 & pres1).float()
        t = self.args.temperature
        loss = 0.5 * (region_ce(za, zb, pres1, pair_w, t)
                      + region_ce(zb, za, pres0, pair_w, t))
        return loss, (method_state, {"detcon_loss": loss.detach()})

    def post_update(self, params, method_state, step, total_steps):
        return method_state
