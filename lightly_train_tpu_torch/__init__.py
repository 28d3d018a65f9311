"""PyTorch + CUDA port of lightly_train_tpu for NVIDIA Hopper.

The JAX package ``lightly_train_tpu`` is the reference; this package imports
nothing of it (nor of JAX). Entry points run on the card unless the caller
asks for the CPU. The CLI is ``python -m lightly_train_tpu_torch``. Of the
fine-tuning entry points, image classification, semantic segmentation
(linear and EoMT), their multihead forms and EoMT instance and panoptic
segmentation run; object detection and LT-DETR instance segmentation
(ROADMAP item 14) raise ``NotImplementedError``.
"""

from lightly_train_tpu_torch._commands.embed import embed, embed_from_config
from lightly_train_tpu_torch._commands.eval_knn import evaluate_knn
from lightly_train_tpu_torch._commands.export import export
from lightly_train_tpu_torch._commands.train import (
    pretrain,
    pretrain_from_config,
)
from lightly_train_tpu_torch._commands.train_task import (
    train_image_classification,
    train_image_classification_multihead,
    train_instance_segmentation,
    train_object_detection,
    train_panoptic_segmentation,
    train_semantic_segmentation,
    train_semantic_segmentation_multihead,
)
from lightly_train_tpu_torch.methods.method_helpers import list_methods
from lightly_train_tpu_torch.models.package_registry import list_models
from lightly_train_tpu_torch.types import (
    EmbeddingFormat,
    ModelFormat,
    ModelPart,
)

# Deprecated alias, as in the JAX package (``train`` is ``pretrain``).
train = pretrain

__all__ = [
    "EmbeddingFormat",
    "ModelFormat",
    "ModelPart",
    "embed",
    "embed_from_config",
    "evaluate_knn",
    "export",
    "list_methods",
    "list_models",
    "pretrain",
    "pretrain_from_config",
    "train",
    "train_image_classification",
    "train_image_classification_multihead",
    "train_instance_segmentation",
    "train_object_detection",
    "train_panoptic_segmentation",
    "train_semantic_segmentation",
    "train_semantic_segmentation_multihead",
]

__version__ = "0.1.0"
