"""``evaluate_knn``: weighted-kNN evaluation of a pretrained backbone.

Port of ``lightly_train_tpu/_commands/eval_knn.py``, the DINO eval protocol
behind the reference's headline pretraining metric: embed the train and val
splits (class folders) with the frozen backbone of an exported artifact,
then classify each val embedding by temperature-weighted cosine kNN votes
over the train embeddings (``utils/knn.py``). Images are normalised with
the ImageNet mean and std; every batch is padded to ``batch_size``. The
val split is pinned to the train split's classes. It runs on the card
unless ``accelerator="cpu"``; the embeddings stay on the device for the
vote. ``LIGHTLY_TRAIN_MATMUL_PRECISION`` is applied at the start, as
``pretrain`` applies it (TF32 in the fp32 GEMMs by default).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Literal, Optional, Tuple

import torch

from lightly_train_tpu_torch._checkpoint.checkpoint import load_exported_model
from lightly_train_tpu_torch._commands.embed import (
    embed_batches,
    exported_backbone,
)
from lightly_train_tpu_torch._commands.train import resolve_device
from lightly_train_tpu_torch._configs.config import Config
from lightly_train_tpu_torch._configs.validate import config_validate
from lightly_train_tpu_torch._data.classification_dataset import (
    ImageClassificationDataset,
)
from lightly_train_tpu_torch._logging import get_logger, set_up_console_logging
from lightly_train_tpu_torch._system import apply_matmul_precision
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.ops.augment import IMAGENET_MEAN, IMAGENET_STD
from lightly_train_tpu_torch.utils.knn import knn_accuracy

logger = get_logger("knn")


@dataclasses.dataclass
class EvalKnnConfig(Config):
    data: Dict[str, str]  # {"train": dir, "val": dir} class-folder roots
    checkpoint: str
    image_size: int = 224
    batch_size: int = 256
    k: int = 20
    temperature: float = 0.07
    precision: Literal["bf16", "fp32"] = "fp32"
    # Where it runs: the card unless the caller asks for the CPU.
    accelerator: Literal["cuda", "cpu"] = "cuda"


def embed_split(wrapped: WrappedModel, root: Path, image_size: int,
                batch_size: int, dtype: torch.dtype, device: torch.device,
                classes: Optional[List[str]] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, List[str]]:
    """(fp32 (N, D) embeddings and (N,) labels on ``device``, the classes)
    of the class folders under ``root``."""
    ds = ImageClassificationDataset(Path(root), (image_size, image_size),
                                    classes=classes)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    feats = torch.cat(list(embed_batches(
        wrapped, lambda i: ds[i]["images"], len(ds), image_size, batch_size,
        device, lambda u8: ((u8.float() / 255.0 - mean) / std).to(dtype))))
    labels = torch.tensor([label for _, label in ds.samples],
                          dtype=torch.int32, device=device)
    return feats, labels, ds.classes


def evaluate_knn(data: Dict[str, str], checkpoint: str,
                 **kwargs: Any) -> Dict[str, float]:
    """``{"knn_top1": ...}`` of the backbone of the artifact ``checkpoint``
    on ``data["train"]`` and ``data["val"]``."""
    config = config_validate(
        EvalKnnConfig, {"data": data, "checkpoint": checkpoint, **kwargs})
    set_up_console_logging()
    device = resolve_device(config.accelerator)
    apply_matmul_precision()
    dtype = torch.bfloat16 if config.precision == "bf16" else torch.float32
    wrapped = exported_backbone(load_exported_model(Path(config.checkpoint)),
                                dtype, device)
    args = (config.image_size, config.batch_size, dtype, device)
    train_z, train_y, classes = embed_split(wrapped, config.data["train"],
                                            *args)
    # The val split pinned to the train split's labels: a class folder
    # missing from val would otherwise shift every later index.
    val_z, val_y, _ = embed_split(wrapped, config.data["val"], *args,
                                  classes=classes)
    acc = knn_accuracy(val_z, val_y, train_z, train_y,
                       num_classes=len(classes), k=config.k,
                       temperature=config.temperature)
    logger.info("kNN top-1: %.4f (%d train, %d val, k=%d)", acc,
                train_z.shape[0], val_z.shape[0], config.k)
    return {"knn_top1": float(acc)}
