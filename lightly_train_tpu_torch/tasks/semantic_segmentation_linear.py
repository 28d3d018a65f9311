"""Linear semantic segmentation (a probe on a frozen backbone by default).

Port of ``lightly_train_tpu/tasks/semantic_segmentation_linear.py``: a
Dense layer (``head.seg_head``, a 1x1 convolution) on the backbone's
(B, h, w, D) feature map, its logits resized bilinearly to the image, a
per-pixel CE that skips ``ignore_index``, and mIoU from a float32
confusion matrix summed over the validation batches. Above the training
resolution validation runs tiled (``tasks/tiling.py``). The dataset pairs
``images/`` and ``masks/`` by file stem; masks decode with the port's
``decode_mask`` (PIL's rules, no PIL) and a class LUT maps raw ids to train
ids.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch._data.image_dataset import (
    IMAGE_EXTENSIONS,
    decode_image,
    decode_mask,
)
from lightly_train_tpu_torch.errors import DatasetError
from lightly_train_tpu_torch.models.vit import Linear
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.tasks.base import (
    TaskArgs,
    TaskModule,
    TaskTrainModel,
)
from lightly_train_tpu_torch.tasks.image_classification import confusion


@dataclasses.dataclass
class LinearSemanticSegmentationArgs(TaskArgs):
    num_classes: int = 21
    ignore_index: int = 255
    freeze_backbone: bool = True
    default_steps: int = 10_000
    default_batch_size: int = 16


class SegmentationHead(nn.Module):
    """``seg_head``: a Dense layer on the channel axis, in fp32."""

    def __init__(self, dim: int, num_classes: int):
        super().__init__()
        self.seg_head = Linear(dim, num_classes)

    def reset_parameters(self, generator) -> None:
        self.seg_head.reset_parameters(generator)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.seg_head(feats)


def resize_bilinear(logits: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, h, w, C) -> float32 (B, H, W, C) as ``jax.image.resize(...,
    "bilinear")``: half-pixel centres, and a triangle filter widened by the
    scale where an axis shrinks (antialiasing)."""
    h, w = logits.shape[1:3]
    x = logits.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                      antialias=h > hw[0] or w > hw[1])
    return x.permute(0, 2, 3, 1)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Per-pixel CE of (B, H, W, C) logits at the (B, H, W) labels (any
    value where not ``valid``)."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0]


def miou(cm: np.ndarray) -> float:
    """Mean IoU over the classes with a non-empty union."""
    tp = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - tp
    present = union > 0
    iou = np.where(present, tp / np.maximum(union, 1e-9), 0.0)
    return float(iou[present].mean()) if present.any() else 0.0


class LinearSemanticSegmentationTrainModel(TaskTrainModel):
    task = "semantic_segmentation"
    transform_kind = "semantic_segmentation"

    def __init__(self, wrapped: WrappedModel,
                 args: LinearSemanticSegmentationArgs):
        super().__init__(wrapped, args)
        self.args: LinearSemanticSegmentationArgs = args

    def _new_head(self) -> SegmentationHead:
        return SegmentationHead(self.wrapped.feature_dim,
                                self.args.num_classes)

    def init(self, generator, device) -> TaskModule:
        backbone = self.wrapped.module
        backbone.reset_parameters(generator)
        head = self._new_head()
        head.reset_parameters(generator)
        return self._frozen(TaskModule(backbone, head=head).to(device))

    def _feats(self, model: TaskModule, images: torch.Tensor, train: bool,
               generator=None) -> torch.Tensor:
        """The (B, h, w, D) feature map; the backbone trains only when it is
        not frozen (a frozen one runs in eval mode)."""
        return self.wrapped.forward_features(
            images, train=train and not self.freeze_backbone,
            generator=generator, module=model.backbone)["features"]

    def _logits(self, model, images, train: bool, generator=None):
        logits = model.head(self._feats(model, images, train, generator))
        return resize_bilinear(logits, images.shape[1:3])

    def _tiled(self, images: torch.Tensor, logits_fn,
               num_out: Optional[int] = None) -> torch.Tensor:
        """``logits_fn(images)``, tiled where the images exceed
        ``val_tile_size``; ``num_out`` logits a pixel (default: the
        classes)."""
        ts = self.val_tile_size
        H, W = images.shape[1:3]
        if ts is not None and (H > ts or W > ts):
            from lightly_train_tpu_torch.tasks.tiling import tiled_logits

            return tiled_logits(logits_fn, images,
                                num_out or self.args.num_classes, int(ts))
        return logits_fn(images)

    def _targets(self, batch):
        masks = batch["masks"]
        valid = masks != self.args.ignore_index
        return torch.where(valid, masks, torch.zeros_like(masks)), valid

    def loss_fn(self, model, batch, generator, step):
        labels, valid = self._targets(batch)
        logits = self._logits(model, batch["images"], True, generator)
        ce = masked_ce(logits, labels, valid)
        validf = valid.float()
        return (ce * validf).sum() / torch.clamp(validf.sum(), min=1.0), {}

    def _val_targets(self, batch):
        labels, valid = self._targets(batch)
        sample_valid = batch.get("valid")
        if sample_valid is not None:
            valid = valid & sample_valid[:, None, None]
        return torch.where(valid, labels, torch.zeros_like(labels)), valid

    def val_step(self, model, batch) -> Dict[str, torch.Tensor]:
        images = batch["images"]
        logits = self._tiled(images,
                             lambda t: self._logits(model, t, False))
        labels, valid = self._val_targets(batch)
        pred = torch.where(valid, logits.argmax(-1), torch.zeros_like(labels))
        validf = valid.float()
        return {
            "confusion": confusion(labels, pred, validf,
                                   self.args.num_classes),
            "sum_loss": (masked_ce(logits, labels, valid) * validf).sum(),
            "count": validf.sum(),
        }

    def val_finalize(self, stats) -> Dict[str, float]:
        n = max(float(stats["count"]), 1.0)
        return {"val_loss": float(stats["sum_loss"]) / n,
                "val_miou": miou(stats["confusion"].cpu().numpy())}

    def predict(self, model, images) -> torch.Tensor:
        """Per-pixel class ids (B, H, W)."""
        return self._logits(model, images, False).argmax(-1)

    @property
    def watch_metric(self):
        return ("val_miou", "max")


class MaskSemanticSegmentationDataset:
    """``images/*`` and ``masks/*`` paired by file stem: ``{"images": uint8
    (H, W, 3), "masks": int32 (H, W)}``; ``class_lut`` maps raw ids to train
    ids, a raw id beyond it to ``ignore_index``."""

    def __init__(
        self,
        images_dir: Path,
        masks_dir: Path,
        image_hw: Tuple[int, int] = (512, 512),
        class_lut: Optional[np.ndarray] = None,
        ignore_index: int = 255,
    ):
        self.class_lut = class_lut
        self.ignore_index = ignore_index
        images_dir, masks_dir = Path(images_dir), Path(masks_dir)
        mask_by_stem = {
            p.stem: p for p in sorted(masks_dir.rglob("*"))
            if p.suffix.lower() in IMAGE_EXTENSIONS
        }
        self.pairs: List[Tuple[str, str]] = [
            (str(p), str(mask_by_stem[p.stem]))
            for p in sorted(images_dir.rglob("*"))
            if p.suffix.lower() in IMAGE_EXTENSIONS and p.stem in mask_by_stem
        ]
        if not self.pairs:
            raise DatasetError(
                f"No image/mask pairs between {images_dir} and {masks_dir}")
        self.image_hw = image_hw

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        img_path, mask_path = self.pairs[index]
        image = decode_image(img_path, self.image_hw)
        mask = decode_mask(mask_path, self.image_hw)
        if self.class_lut is not None:
            lut = self.class_lut
            mask = np.where((mask >= 0) & (mask < len(lut)),
                            lut[np.clip(mask, 0, len(lut) - 1)],
                            self.ignore_index).astype(np.int32)
        return {"images": image, "masks": mask}
