"""LT-DETR instance segmentation: the detector and a mask head.

Port of ``lightly_train_tpu/tasks/detection/ltdetr_seg.py``. The LT-DETR
detector of ``ltdetr.py`` runs without denoising queries; a mask head
turns its queries into per-query mask logits:

- ``"edgecrafter"`` (the default, :class:`ECSegMaskHead`): the encoder's
  /8 level resized to image/4, refined by one cumulative
  :class:`_DepthwiseConvBlock` a decoder layer, projected and dotted with
  MLP-refined, projected query states, plus a learned scalar bias;
- ``"linear"`` (the legacy head): one projection of the final queries and
  one of the trunk's feature map, dotted and scaled by 1/sqrt(mask_dim).

Training adds a mask loss to the detection criterion: the final level is
matched again (the Hungarian matcher on the detection matching cost), and
the matched slots' masks are held by BCE and dice, at importance-sampled
points for the EdgeCrafter head (targets read from the slot-id map at the
nearest pixel) and at the head's grid for the linear one (targets by
``jax.image.resize``'s antialiased "linear" rule). Validation reports mask
mAP over the final queries' thresholded masks on the host.

The point draws go through ``ops/point_sampling.py::uniform`` (from the
step's generator, or handed in). The mask head's bilinear resize runs as
two products (``backbone_adapter._resize_bilinear``), whose backward
repeats bitwise on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.models.conv import Conv
from lightly_train_tpu_torch.models.vit import LayerNorm, Linear
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.ops import point_sampling as PS
from lightly_train_tpu_torch.tasks.base import TaskModule
from lightly_train_tpu_torch.tasks.detection.backbone_adapter import (
    _resize_bilinear,
)
from lightly_train_tpu_torch.tasks.detection.components import (
    reset_detr_parameters,
)
from lightly_train_tpu_torch.tasks.detection.criterion import (
    detection_criterion,
    match_levels,
)
from lightly_train_tpu_torch.tasks.detection.ltdetr import (
    ObjectDetectionArgs,
    ObjectDetectionTrainModel,
    _pad_logits,
)
from lightly_train_tpu_torch.tasks.eomt_instance_panoptic import resize_ids
from lightly_train_tpu_torch.tasks.eomt_semantic_segmentation import (
    _dice_loss,
    linear_resize_above_half,
)

NO_SEGMENT = 255


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class _DepthwiseConvBlock(nn.Module):
    """Residual 3x3 depthwise conv, LayerNorm (1e-6), Linear and exact
    GELU over (B, H, W, C)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dwconv = Conv(dim, dim, 3, 1, ((1, 1), (1, 1)), groups=dim,
                           dtype=dtype)
        self.norm = LayerNorm(dim, 1e-6, dtype)
        self.pwconv1 = Linear(dim, dim, True, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x + _gelu(self.pwconv1(self.norm(h)))


class ECSegMaskHead(nn.Module):
    """The EdgeCrafter mask head: the /8 level ``spatial`` (B, H8, W8, C)
    bilinearly resized to image/4, then for each of the first
    ``num_blocks`` decoder layers one more block, a 1x1 projection, and the
    dot product with that layer's refined, projected queries plus the
    scalar ``bias``: one (B, Q, H/4, W/4) fp32 logit map a layer."""

    def __init__(self, dim: int, num_blocks: int, downsample_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_blocks, self.downsample_ratio = num_blocks, downsample_ratio
        self.blocks = nn.ModuleList(_DepthwiseConvBlock(dim, dtype)
                                    for _ in range(num_blocks))
        self.spatial_proj = Conv(dim, dim, 1, 1, ((0, 0), (0, 0)),
                                 dtype=dtype)
        self.query_norm = LayerNorm(dim, 1e-5, dtype)
        self.query_fc1 = Linear(dim, 4 * dim, True, dtype)
        self.query_fc2 = Linear(4 * dim, dim, True, dtype)
        self.query_proj = Linear(dim, dim, True, dtype)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, spatial: torch.Tensor,
                query_states: Sequence[torch.Tensor],
                image_hw: Tuple[int, int],
                all_levels: bool = True) -> List[torch.Tensor]:
        """Each layer's logits, or with ``all_levels`` False the last
        layer's alone (the others' products are skipped; the blocks still
        run, since each refines the map the next one reads)."""
        th = image_hw[0] // self.downsample_ratio
        tw = image_hw[1] // self.downsample_ratio
        x = _resize_bilinear(spatial.float().permute(0, 3, 1, 2),
                             (th, tw)).permute(0, 2, 3, 1).to(spatial.dtype)
        n = min(self.num_blocks, len(query_states))
        out = []
        for i in range(n):
            x = self.blocks[i](x)
            if not all_levels and i < n - 1:
                continue
            sp = self.spatial_proj(x.permute(0, 3, 1, 2))
            q = query_states[i]
            qh = q + self.query_fc2(_gelu(self.query_fc1(
                self.query_norm(q))))
            qp = self.query_proj(qh)
            out.append(torch.einsum("bchw,bqc->bqhw", sp.float(), qp.float())
                       + self.bias[0])
        return out


class _LinearMaskHead(nn.Module):
    """The legacy head's two projections: queries and trunk features to
    ``mask_dim``."""

    def __init__(self, d_model: int, feat_dim: int, mask_dim: int):
        super().__init__()
        self.query_proj = Linear(d_model, mask_dim)
        self.pixel_proj = Linear(feat_dim, mask_dim)


@dataclasses.dataclass
class InstanceSegmentationLTDETRArgs(ObjectDetectionArgs):
    # "edgecrafter": the cumulative depthwise-refinement head; any other
    # value ("linear"): the legacy query/pixel projection head.
    mask_head_arch: str = "edgecrafter"
    mask_dim: int = 64
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    # Point-sampled mask loss budget: H W // ratio points, at least H.
    mask_point_sample_ratio: int = 16
    max_instances: int = 50
    mask_threshold: float = 0.5


class LTDETRInstanceSegmentationTrainModel(ObjectDetectionTrainModel):
    task = "instance_segmentation"

    def __init__(self, wrapped: WrappedModel,
                 args: InstanceSegmentationLTDETRArgs):
        super().__init__(wrapped, args)
        self.args: InstanceSegmentationLTDETRArgs = args
        if args.mask_head_arch == "edgecrafter" and \
                self.cfg.enc_dim != self.cfg.d_model:
            raise ValueError(
                "The EdgeCrafter mask head requires encoder and decoder "
                "widths to match (every reference seg preset does).")
        windows = {name: getattr(args, name) for name in (
            "mosaic_window", "mixup_window", "zoom_out_window")
            if getattr(args, name) is not None}
        if args.rotate90_prob:
            windows["rotate90_prob"] = args.rotate90_prob
        if windows:
            # The detection batch augmentations read "labels" and
            # "box_valid", which the instance datasets do not carry: the JAX
            # package fails at the first step with a KeyError.
            raise ConfigError(
                f"{sorted(windows)}: the detection batch augmentations are "
                "not supported for LT-DETR instance segmentation (its "
                "batches carry seg_labels/seg_valid, not labels/box_valid); "
                "leave mosaic_window, mixup_window and zoom_out_window at "
                "None and rotate90_prob at 0.")

    def init(self, generator, device) -> TaskModule:
        module = super().init(generator, device)
        D = self.cfg.d_model
        if self.args.mask_head_arch == "edgecrafter":
            head = ECSegMaskHead(D, self.cfg.num_decoder_layers,
                                 dtype=self.cfg.dtype)
        else:
            head = _LinearMaskHead(D, self.wrapped.feature_dim,
                                   self.args.mask_dim)
        reset_detr_parameters(head, generator)
        module.mask_head = head.to(device)
        return module

    def _apply(self, model, images, train: bool):
        """(outputs with the extra class column, the mask head's queries,
        its features): the detector without denoising queries."""
        outputs, _, taps = model.backbone(images, train=train)
        if self.args.mask_head_arch == "edgecrafter":
            queries, feats = taps["query_states"], taps["enc_p3"]
        else:
            queries, feats = taps["query_states"][-1], taps["trunk_features"]
        return _pad_logits(outputs), queries, feats

    def _mask_logits(self, model, feats, queries,
                     image_hw) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """The final layer's mask logits, flattened (B, Q, n) fp32, and
        their grid."""
        head = model.mask_head
        if self.args.mask_head_arch == "edgecrafter":
            final = head(feats, queries, image_hw, all_levels=False)[-1]
            B, Q, th, tw = final.shape
            return final.reshape(B, Q, th * tw), (th, tw)
        q_emb = head.query_proj(queries.float())
        p_emb = head.pixel_proj(feats.float())
        B, gh, gw, md = p_emb.shape
        masks = torch.einsum("bqd,bnd->bqn", q_emb,
                             p_emb.reshape(B, gh * gw, md)) / math.sqrt(md)
        return masks.float(), (gh, gw)

    def loss_fn(self, model, batch, generator, step):
        a = self.args
        labels, boxes, valid = (batch["seg_labels"], batch["boxes"],
                                batch["seg_valid"])
        images = batch["images"]
        outputs, queries, feats = self._apply(model, images, True)
        det_loss, metrics = detection_criterion(outputs, labels, boxes, valid)
        mask_logits, (gh, gw) = self._mask_logits(model, feats, queries,
                                                  images.shape[1:3])
        B, K = labels.shape
        # The final level matched again, for the masks.
        assignment = match_levels(outputs[-1:], labels, boxes, valid)[0]
        assigned = (assignment >= 0).float()
        rows = torch.arange(B, device=images.device)[:, None]
        # Advanced indexing: its backward accumulates in a fixed order.
        pred = mask_logits[rows, assignment.clamp(min=0)]  # (B, K, n)
        seg_map = batch["seg_map"].long()
        if a.mask_head_arch == "edgecrafter":
            P = max(gh, gh * gw // a.mask_point_sample_ratio)
            flat_pred = pred.reshape(B * K, gh, gw)
            coords = PS.uncertainty_point_coords(
                generator, flat_pred.detach().float(), P, 3.0, 0.75)
            pred_p = PS.bilinear_point_sample(
                flat_pred[:, None], coords).reshape(B, K, P).float()
            # The targets at the nearest pixel of the slot-id map
            # (round half to even, as jnp.round).
            H, W = seg_map.shape[1:3]
            c = coords.reshape(B, K * P, 2)
            yi = torch.round(c[..., 0] * H - 0.5).long().clamp(0, H - 1)
            xi = torch.round(c[..., 1] * W - 0.5).long().clamp(0, W - 1)
            ids = seg_map.reshape(B, H * W).gather(1, yi * W + xi).reshape(
                B, K, P)
            slots = torch.arange(K, device=ids.device)[None, :, None]
            targets = (ids == slots).float()
            pred_t = pred_p
        else:
            onehot = F.one_hot(torch.where(seg_map == NO_SEGMENT, K, seg_map),
                               K + 1)[..., :K].float()
            targets = linear_resize_above_half(onehot, (gh, gw)).float(
                ).permute(0, 3, 1, 2).reshape(B, K, gh * gw)
            pred_t = pred
        bce = (targets * F.softplus(-pred_t)
               + (1 - targets) * F.softplus(pred_t)).mean(-1)
        dice = _dice_loss(torch.sigmoid(pred_t), targets)
        denom = assigned.sum().clamp(min=1.0)
        mask_loss = (a.mask_weight * (bce * assigned).sum() / denom
                     + a.dice_weight * (dice * assigned).sum() / denom)
        metrics = {**metrics, "mask_loss": mask_loss}
        return det_loss + mask_loss, {k: v.detach() for k, v in
                                      metrics.items()}

    def val_step(self, model, batch) -> Dict[str, torch.Tensor]:
        images = batch["images"]
        outputs, queries, feats = self._apply(model, images, False)
        mask_logits, (gh, gw) = self._mask_logits(model, feats, queries,
                                                  images.shape[1:3])
        logits_f, _ = outputs[-1]
        scores = torch.sigmoid(logits_f[..., :self.args.num_classes])
        valid = batch.get("valid")
        return {
            "pred_masks": torch.sigmoid(mask_logits) > self.args.mask_threshold,
            "pred_scores": scores.max(-1).values,
            "pred_labels": scores.argmax(-1),
            "tgt_map": resize_ids(batch["seg_map"], (gh, gw)),
            "tgt_labels": batch["seg_labels"],
            "tgt_valid": batch["seg_valid"],
            "sample_valid": (valid if valid is not None else torch.ones(
                images.shape[0], dtype=torch.bool, device=images.device)),
        }

    def val_finalize(self, collected) -> Dict[str, float]:
        """Mask mAP of the valid samples' predictions (score > 0.05)
        against their valid target slots at the mask grid."""
        from lightly_train_tpu_torch.tasks.detection.metrics import (
            compute_map_generic,
        )

        predictions, targets = [], []
        for c in collected:
            c = {k: np.asarray(v) for k, v in c.items()}
            for b in range(c["pred_masks"].shape[0]):
                if not bool(c["sample_valid"][b]):
                    continue
                keep = c["pred_scores"][b] > 0.05
                predictions.append({
                    "masks": c["pred_masks"][b][keep],
                    "scores": c["pred_scores"][b][keep],
                    "labels": c["pred_labels"][b][keep],
                })
                K = c["tgt_labels"].shape[1]
                tmap = c["tgt_map"][b].reshape(-1)
                tv = c["tgt_valid"][b]
                masks = np.stack([tmap == k for k in range(K)], axis=0)[tv]
                targets.append({"masks": masks,
                                "labels": c["tgt_labels"][b][tv]})

        def mask_iou(a, b):
            inter = (a[:, None] & b[None, :]).sum(-1).astype(np.float64)
            union = (a[:, None] | b[None, :]).sum(-1).astype(np.float64)
            return inter / np.maximum(union, 1e-9)

        out = compute_map_generic(predictions, targets, mask_iou, key="masks")
        return {"val_mask_map": out["map"], "val_mask_map50": out["map50"]}

    def predict(self, model, images):
        """(xyxy normalized boxes, scores, labels, masks bool (B, k, mh,
        mw)) of the top detections, each mask its query's."""
        outputs, queries, feats = self._apply(model, images, False)
        boxes, scores, labels, q_idx = self._decode(outputs, return_q=True)
        mask_logits, (gh, gw) = self._mask_logits(model, feats, queries,
                                                  images.shape[1:3])
        rows = torch.arange(images.shape[0], device=images.device)[:, None]
        sel = mask_logits[rows, q_idx]
        B, k = sel.shape[:2]
        masks = torch.sigmoid(sel) > self.args.mask_threshold
        return boxes, scores, labels, masks.reshape(B, k, gh, gw)

    @property
    def watch_metric(self):
        return ("val_mask_map", "max")
