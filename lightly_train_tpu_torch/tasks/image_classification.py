"""Image classification fine-tuning.

Port of ``lightly_train_tpu/tasks/image_classification.py``: a backbone and
a linear head (``head.fc``) on its pooled features (the CLS token of a ViT,
the global average of a CNN's map), an optionally frozen backbone, CE with
label smoothing and ``train_acc``; validation sums CE, top-1, top-5 and a
float32 confusion matrix, and reduces them to ``val_loss``, ``val_top1``,
``val_top5`` and the macro ``val_f1``. The dataset is the class-folder
``_data/classification_dataset.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch.models.vit import Linear
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.tasks.base import (
    TaskArgs,
    TaskModule,
    TaskTrainModel,
)


@dataclasses.dataclass
class ImageClassificationArgs(TaskArgs):
    num_classes: int = 1000
    freeze_backbone: bool = False
    label_smoothing: float = 0.0
    default_steps: int = 20_000
    default_batch_size: int = 128


class ClassificationHead(nn.Module):
    """``fc``: a Dense layer computing in fp32 (the JAX head promotes a
    bf16 input to its fp32 kernel's dtype)."""

    def __init__(self, dim: int, num_classes: int):
        super().__init__()
        self.fc = Linear(dim, num_classes)

    def reset_parameters(self, generator) -> None:
        self.fc.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


def smoothed_ce(logits: torch.Tensor, labels: torch.Tensor,
                smoothing: float) -> torch.Tensor:
    """Mean CE of fp32 ``logits`` against one-hot ``labels`` smoothed by
    ``smoothing`` (``onehot * (1 - s) + s / C``)."""
    num_classes = logits.shape[-1]
    target = F.one_hot(labels.long(), num_classes).float()
    if smoothing > 0:
        target = target * (1.0 - smoothing) + smoothing / num_classes
    return -(target * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def confusion(labels: torch.Tensor, pred: torch.Tensor, weights: torch.Tensor,
              num_classes: int) -> torch.Tensor:
    """(C, C) float32 confusion matrix, rows the labels, each pair counted
    with its weight (``jnp.bincount`` with float32 weights)."""
    idx = (labels.long() * num_classes + pred.long()).reshape(-1)
    return torch.bincount(idx, weights=weights.reshape(-1).float(),
                          minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def macro_f1(cm: np.ndarray) -> float:
    """Mean F1 over the classes present among the labels."""
    tp = np.diag(cm)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    present = (tp + fn) > 0
    f1 = np.where(present, 2 * tp / np.maximum(2 * tp + fp + fn, 1e-9), 0.0)
    return float(f1[present].mean()) if present.any() else 0.0


class ImageClassificationTrainModel(TaskTrainModel):
    task = "image_classification"
    transform_kind = "image_classification"

    def __init__(self, wrapped: WrappedModel, args: ImageClassificationArgs):
        super().__init__(wrapped, args)
        self.args: ImageClassificationArgs = args

    def _new_head(self) -> ClassificationHead:
        return ClassificationHead(self.wrapped.feature_dim,
                                  self.args.num_classes)

    def init(self, generator, device) -> TaskModule:
        backbone = self.wrapped.module
        backbone.reset_parameters(generator)
        head = self._new_head()
        head.reset_parameters(generator)
        return self._frozen(TaskModule(backbone, head=head).to(device))

    def _pooled(self, model: TaskModule, images: torch.Tensor, train: bool,
                generator=None) -> torch.Tensor:
        out = self.wrapped.forward_features(images, train=train,
                                            generator=generator,
                                            module=model.backbone)
        return self.wrapped.forward_pool(out)

    def loss_fn(self, model, batch, generator, step):
        labels = batch["labels"]
        logits = model.head(self._pooled(model, batch["images"], True,
                                         generator)).float()
        loss = smoothed_ce(logits, labels, self.args.label_smoothing)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"train_acc": acc.detach()}

    def val_step(self, model, batch) -> Dict[str, torch.Tensor]:
        images, labels = batch["images"], batch["labels"].long()
        logits = model.head(self._pooled(model, images, False)).float()
        valid = batch.get("valid")
        w = (valid.float() if valid is not None
             else torch.ones_like(labels, dtype=torch.float32))
        logp = F.log_softmax(logits, dim=-1)
        ce = -logp.gather(1, labels[:, None])[:, 0]
        pred = logits.argmax(-1)
        top1 = (pred == labels).float()
        k = min(5, logits.shape[-1])
        topk = (logits.topk(k, dim=-1).indices == labels[:, None]).any(
            -1).float()
        return {
            "sum_loss": (ce * w).sum(),
            "sum_top1": (top1 * w).sum(),
            "sum_top5": (topk * w).sum(),
            "count": w.sum(),
            "confusion": confusion(labels, pred, w, logits.shape[-1]),
        }

    def val_finalize(self, stats) -> Dict[str, float]:
        n = max(float(stats["count"]), 1.0)
        return {
            "val_loss": float(stats["sum_loss"]) / n,
            "val_top1": float(stats["sum_top1"]) / n,
            "val_top5": float(stats["sum_top5"]) / n,
            "val_f1": macro_f1(stats["confusion"].cpu().numpy()),
        }

    def predict(self, model, images) -> torch.Tensor:
        """Class probabilities of preprocessed (B, H, W, 3) images."""
        logits = model.head(self._pooled(model, images, False))
        return torch.softmax(logits.float(), dim=-1)

    @property
    def watch_metric(self):
        return ("val_top1", "max")
