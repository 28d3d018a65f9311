"""PyTorch + CUDA port of lightly_train_tpu for NVIDIA Hopper.

The JAX package ``lightly_train_tpu`` is the reference; this package imports
nothing of it (nor of JAX). Entry points run on the card unless the caller
asks for the CPU. The CLI is ``python -m lightly_train_tpu_torch``.
"""

from lightly_train_tpu_torch._commands.embed import embed, embed_from_config
from lightly_train_tpu_torch._commands.eval_knn import evaluate_knn
from lightly_train_tpu_torch._commands.export import export
from lightly_train_tpu_torch._commands.train import (
    pretrain,
    pretrain_from_config,
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
]

__version__ = "0.1.0"
