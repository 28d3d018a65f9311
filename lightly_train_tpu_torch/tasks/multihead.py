"""Multihead task variants: several heads on one backbone in one run.

Port of ``lightly_train_tpu/tasks/multihead.py``: the heads
(``heads.<name>``, sorted by name) share one backbone forward, frozen by
default, and train at their own learning-rate multipliers through the
update's per-parameter lr scales (the backbone at 1). Validation reports
each head's metric and the best of them (``val_top1_best``,
``val_miou_best``), which picks ``exported_best``. Prediction uses the
first head.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch

from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.tasks.base import TaskModule
from lightly_train_tpu_torch.tasks.image_classification import (
    ImageClassificationArgs,
    ImageClassificationTrainModel,
    smoothed_ce,
)
from lightly_train_tpu_torch.tasks.semantic_segmentation_linear import (
    LinearSemanticSegmentationArgs,
    LinearSemanticSegmentationTrainModel,
    confusion,
    masked_ce,
    miou,
    resize_bilinear,
)

_DEFAULT_HEADS = {"head_1x": 1.0, "head_01x": 0.1}


class _MultiheadMixin:
    """Heads under ``heads.<name>`` and their lr scales."""

    def _init_heads(self, generator, device) -> TaskModule:
        backbone = self.wrapped.module
        backbone.reset_parameters(generator)
        heads = {}
        for name in self.head_names:
            heads[name] = self._new_head()
            heads[name].reset_parameters(generator)
        return self._frozen(TaskModule(backbone, heads=heads).to(device))

    def lr_scales(self, params: Mapping[str, torch.Tensor]
                  ) -> Dict[str, float]:
        """The head's multiplier for each of its parameters, 1 elsewhere."""
        mult = self.args.head_lr_multipliers
        return {n: float(mult[n.split(".")[1]]) if n.startswith("heads.")
                else 1.0 for n in params}


@dataclasses.dataclass
class ImageClassificationMultiheadArgs(ImageClassificationArgs):
    head_lr_multipliers: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(_DEFAULT_HEADS))
    freeze_backbone: bool = True


class ImageClassificationMultiheadTrainModel(_MultiheadMixin,
                                             ImageClassificationTrainModel):
    task = "image_classification_multihead"

    def __init__(self, wrapped: WrappedModel,
                 args: ImageClassificationMultiheadArgs):
        super().__init__(wrapped, args)
        self.args: ImageClassificationMultiheadArgs = args
        self.head_names = sorted(args.head_lr_multipliers)

    def init(self, generator, device) -> TaskModule:
        return self._init_heads(generator, device)

    def loss_fn(self, model, batch, generator, step):
        # A frozen probe backbone runs in eval mode: no BatchNorm updates
        # and no drop path inside the fixed feature extractor.
        pooled = self._pooled(model, batch["images"],
                              not self.freeze_backbone, generator)
        total = 0.0
        metrics = {}
        for name in self.head_names:
            logits = model.heads[name](pooled).float()
            ce = smoothed_ce(logits, batch["labels"],
                             float(self.args.label_smoothing or 0.0))
            total = total + ce
            metrics[f"loss_{name}"] = ce.detach()
        return total / len(self.head_names), metrics

    def val_step(self, model, batch) -> Dict[str, torch.Tensor]:
        labels = batch["labels"]
        pooled = self._pooled(model, batch["images"], False)
        valid = batch.get("valid")
        w = (valid.float() if valid is not None
             else torch.ones_like(labels, dtype=torch.float32))
        stats = {"count": w.sum()}
        for name in self.head_names:
            top1 = (model.heads[name](pooled).argmax(-1) == labels).float()
            stats[f"sum_top1_{name}"] = (top1 * w).sum()
        return stats

    def val_finalize(self, stats) -> Dict[str, float]:
        n = max(float(stats["count"]), 1.0)
        out = {f"val_top1_{name}": float(stats[f"sum_top1_{name}"]) / n
               for name in self.head_names}
        out["val_top1_best"] = max(out.values())
        return out

    def predict(self, model, images) -> torch.Tensor:
        """Class probabilities of the first head."""
        pooled = self._pooled(model, images, False)
        logits = model.heads[self.head_names[0]](pooled)
        return torch.softmax(logits.float(), dim=-1)

    @property
    def watch_metric(self):
        return ("val_top1_best", "max")


@dataclasses.dataclass
class SemanticSegmentationMultiheadArgs(LinearSemanticSegmentationArgs):
    head_lr_multipliers: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(_DEFAULT_HEADS))


class SemanticSegmentationMultiheadTrainModel(
        _MultiheadMixin, LinearSemanticSegmentationTrainModel):
    task = "semantic_segmentation_multihead"

    def __init__(self, wrapped: WrappedModel,
                 args: SemanticSegmentationMultiheadArgs):
        super().__init__(wrapped, args)
        self.args: SemanticSegmentationMultiheadArgs = args
        self.head_names = sorted(args.head_lr_multipliers)

    def init(self, generator, device) -> TaskModule:
        return self._init_heads(generator, device)

    def _head_logits(self, model, name: str, feats, out_hw):
        return resize_bilinear(model.heads[name](feats), out_hw)

    def loss_fn(self, model, batch, generator, step):
        if not self.freeze_backbone:
            raise NotImplementedError(
                "semantic_segmentation_multihead trains linear probes on a "
                "FROZEN backbone (reference semantics); freeze_backbone="
                "False is not supported here — use train_semantic_"
                "segmentation for backbone fine-tuning."
            )
        labels, valid = self._targets(batch)
        feats = self._feats(model, batch["images"], False)
        validf = valid.float()
        total = 0.0
        metrics = {}
        for name in self.head_names:
            logits = self._head_logits(model, name, feats,
                                       batch["masks"].shape[1:3])
            loss = ((masked_ce(logits, labels, valid) * validf).sum()
                    / torch.clamp(validf.sum(), min=1.0))
            total = total + loss
            metrics[f"loss_{name}"] = loss.detach()
        return total / len(self.head_names), metrics

    def val_step(self, model, batch) -> Dict[str, torch.Tensor]:
        nc = self.args.num_classes

        def all_heads(tile):
            # One backbone forward a tile for every head.
            feats = self._feats(model, tile, False)
            return torch.cat([self._head_logits(model, n, feats,
                                                tile.shape[1:3])
                              for n in self.head_names], dim=-1)

        logits = self._tiled(batch["images"], all_heads,
                             nc * len(self.head_names))
        labels, valid = self._val_targets(batch)
        stats = {}
        for i, name in enumerate(self.head_names):
            pred = logits[..., i * nc:(i + 1) * nc].argmax(-1)
            pred = torch.where(valid, pred, torch.zeros_like(labels))
            stats[f"confusion_{name}"] = confusion(labels, pred,
                                                   valid.float(), nc)
        return stats

    def val_finalize(self, stats) -> Dict[str, float]:
        out = {f"val_miou_{name}": miou(
            stats[f"confusion_{name}"].cpu().numpy())
            for name in self.head_names}
        out["val_miou_best"] = max(out.values())
        return out

    def predict(self, model, images) -> torch.Tensor:
        feats = self._feats(model, images, False)
        return self._head_logits(model, self.head_names[0], feats,
                                 images.shape[1:3]).argmax(-1)

    @property
    def watch_metric(self):
        return ("val_miou_best", "max")
