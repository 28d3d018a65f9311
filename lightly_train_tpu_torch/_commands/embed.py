"""``embed`` command: write embeddings for a directory of images.

Port of ``lightly_train_tpu/_commands/embed.py``: loads an exported
pretrain artifact (``exported_models/exported_last``), runs batched
inference on the card (or, when asked, the CPU) and writes one pooled
embedding per image in ``npz``, ``csv``, ``lightly_csv`` or ``torch``
format. Every batch is padded to ``batch_size``, so the model sees one
shape.
"""

from __future__ import annotations

import csv as csv_module
import dataclasses
from pathlib import Path
from typing import Any, List, Literal

import numpy as np
import torch

from lightly_train_tpu_torch._checkpoint.checkpoint import load_exported_model
from lightly_train_tpu_torch._commands.train import resolve_device
from lightly_train_tpu_torch._configs.config import Config
from lightly_train_tpu_torch._configs.validate import config_validate
from lightly_train_tpu_torch._data.image_dataset import (
    ImageDataset,
    list_image_files,
)
from lightly_train_tpu_torch._logging import get_logger, set_up_console_logging
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.models.vit import Linear
from lightly_train_tpu_torch.types import EmbeddingFormat

logger = get_logger("embed")


@dataclasses.dataclass
class EmbedConfig(Config):
    out: str
    data: str
    checkpoint: str
    format: EmbeddingFormat = EmbeddingFormat.NPZ
    image_size: int = 224
    batch_size: int = 128
    precision: Literal["bf16", "fp32"] = "fp32"
    # Where it runs: the card unless the caller asks for the CPU.
    accelerator: Literal["cuda", "cpu"] = "cuda"


def embed(out: str, data: str, checkpoint: str, **kwargs: Any) -> Path:
    """Embed the images under ``data`` with the artifact ``checkpoint``;
    returns the path written."""
    config = config_validate(
        EmbedConfig,
        {"out": out, "data": data, "checkpoint": checkpoint, **kwargs},
    )
    return embed_from_config(config)


def embed_from_config(config: EmbedConfig) -> Path:
    set_up_console_logging()
    device = resolve_device(config.accelerator)
    artifact = load_exported_model(Path(config.checkpoint))
    dtype = torch.bfloat16 if config.precision == "bf16" else torch.float32
    # Built on the meta device and given the artifact's tensors as its
    # parameters: nothing is allocated or initialised only to be
    # overwritten (a 7B export is 30 GiB).
    with torch.device("meta"):
        wrapped = get_wrapped_model(artifact["model_name"], dtype=dtype)
    model = wrapped.module
    model.load_state_dict(artifact["state_dict"], assign=True)
    model.to(device).eval()
    # The JAX command reports the run to its event tracker here; the port's
    # tracker waits for ROADMAP item 7.5.

    # An artifact pretrained with embed_dim carries its trained projection:
    # embeddings come out at that width.
    head = None
    if "embed_head" in artifact:
        head = Linear(wrapped.feature_dim, int(artifact["embed_dim"]),
                      dtype=dtype)
        head.load_state_dict(artifact["embed_head"])
        head.to(device).eval()

    files = list_image_files(Path(config.data))
    dataset = ImageDataset(files, (config.image_size, config.image_size))
    embeddings: List[np.ndarray] = []
    bs = config.batch_size
    for start in range(0, len(dataset), bs):
        idx = range(start, min(start + bs, len(dataset)))
        batch = np.zeros((bs, config.image_size, config.image_size, 3),
                         np.uint8)
        for row, i in enumerate(idx):
            batch[row] = dataset[i]
        images = torch.from_numpy(batch).to(device).to(dtype) / 255.0
        with torch.no_grad():
            pooled = wrapped.forward_pool(wrapped.forward_features(images))
            if head is not None:
                pooled = head(pooled)
        embeddings.append(pooled.float().cpu().numpy()[:len(idx)])
    emb = np.concatenate(embeddings, axis=0)

    out_path = Path(config.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fmt = config.format
    if fmt in (EmbeddingFormat.CSV, EmbeddingFormat.LIGHTLY_CSV):
        with open(out_path, "w", newline="") as f:
            writer = csv_module.writer(f)
            if fmt == EmbeddingFormat.LIGHTLY_CSV:
                writer.writerow(["filenames"] + [f"embedding_{i}"
                                                 for i in range(emb.shape[1])])
            for fn, row in zip(files, emb):
                writer.writerow([fn] + [f"{v:.8f}" for v in row])
    elif fmt == EmbeddingFormat.TORCH:
        torch.save({"embeddings": torch.from_numpy(emb), "filenames": files},
                   out_path)
    else:
        np.savez(out_path, embeddings=emb, filenames=np.asarray(files))
    logger.info("Wrote %d embeddings (dim %d) to %s", len(files), emb.shape[1],
                out_path)
    return out_path
