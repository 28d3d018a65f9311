"""``export`` command: re-export a trained backbone in another format.

Port of ``lightly_train_tpu/_commands/export.py``. It reads an exported
artifact (``exported_models/exported_last``) and writes:

- ``package_default``: the port's own artifact (``export_model``);
- ``numpy_state_dict``: a flat ``{path: array}`` ``.npz`` with the Flax
  names and layouts, the keys and arrays the JAX package writes
  (``models/convert.py::params_to_jax``);
- ``torch_state_dict``: a ``torch.save`` file; a DINOv2/DINOv3 ViT with
  Meta's names (so it loads as ``checkpoint=`` in either package), every
  other model with its Flax names joined by ``/``.

``part="embedding_model"`` adds the ``embed_dim`` head (``embed_head/kernel``
and ``embed_head/bias`` in the ``.npz``; ``embed_head.weight`` (out, in) and
``embed_head.bias`` in the torch file); an artifact without one raises
``ConfigError``. The JAX package's two state-dict formats write the
parameters only, so a CNN's BatchNorm statistics are in neither; the port
writes the same keys and leaves its buffers out too.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from lightly_train_tpu_torch._checkpoint.checkpoint import (
    export_model,
    load_exported_model,
)
from lightly_train_tpu_torch._configs.config import Config
from lightly_train_tpu_torch._configs.validate import config_validate
from lightly_train_tpu_torch._logging import get_logger, set_up_console_logging
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.models.convert import (
    convert_flax_vit_to_torch_state_dict,
    params_to_jax,
)
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.types import ModelFormat, ModelPart

logger = get_logger("export")


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A Flax tree as ``{"a/b/c": array}``."""
    flat: Dict[str, np.ndarray] = {}
    if isinstance(params, dict):
        for k, v in params.items():
            flat.update(flatten_params(v, f"{prefix}{k}/"))
    else:
        flat[prefix[:-1]] = np.asarray(params)
    return flat


@dataclasses.dataclass
class ExportConfig(Config):
    out: str
    checkpoint: str
    part: ModelPart = ModelPart.MODEL
    format: ModelFormat = ModelFormat.PACKAGE_DEFAULT


def export(out: str, checkpoint: str, **kwargs: Any) -> Path:
    """Export the artifact ``checkpoint`` to ``out``; returns ``out``."""
    config = config_validate(
        ExportConfig, {"out": out, "checkpoint": checkpoint, **kwargs})
    return export_from_config(config)


def _flax_params(artifact: Dict[str, Any]) -> Dict[str, Any]:
    """The artifact's backbone parameters as their Flax tree, without its
    buffers (a CNN's BatchNorm statistics): the model is built on the meta
    device to tell them apart."""
    with torch.device("meta"):
        module = get_wrapped_model(artifact["model_name"]).module
    names = dict(module.named_parameters())
    return params_to_jax({k: v for k, v in artifact["state_dict"].items()
                          if k in names})


def export_from_config(config: ExportConfig) -> Path:
    set_up_console_logging()
    artifact = load_exported_model(Path(config.checkpoint))
    out_path = Path(config.out)
    embed_head = artifact.get("embed_head")
    with_head = config.part == ModelPart.EMBEDDING_MODEL
    if with_head and embed_head is None:
        raise ConfigError(
            "The checkpoint has no embedding head: pretrain with embed_dim= "
            "to train one, or export part='model' (reference export part=, "
            "_commands/export.py)."
        )
    if config.format == ModelFormat.PACKAGE_DEFAULT:
        skip_meta = {"state_dict", "embed_head", "model_name"}
        if not with_head:
            # The head is dropped, so the metadata must not claim one.
            skip_meta.add("embed_dim")
        export_model(
            out_path, artifact["model_name"], artifact["state_dict"],
            extra_meta={k: v for k, v in artifact.items()
                        if k not in skip_meta},
            embed_head=embed_head if with_head else None)
        return out_path
    out_path.parent.mkdir(parents=True, exist_ok=True)
    params = _flax_params(artifact)
    head = ({name: t.detach().cpu().float().numpy()
             for name, t in embed_head.items()} if with_head else None)
    if config.format == ModelFormat.NUMPY_STATE_DICT:
        flat = flatten_params(params)
        if head is not None:
            flat["embed_head/bias"] = head["bias"]
            flat["embed_head/kernel"] = np.ascontiguousarray(head["weight"].T)
        np.savez(out_path, **flat)
    else:
        model_name = str(artifact["model_name"])
        if (model_name.startswith(("dinov2/", "dinov3/"))
                and "convnext" not in model_name and "block0" in params):
            # Meta's names, so the file loads into the reference's modules.
            depth = sum(1 for k in params
                        if k.startswith("block") and k[5:].isdigit())
            flat = convert_flax_vit_to_torch_state_dict(params, depth)
        else:
            flat = flatten_params(params)
        if head is not None:
            flat = {**flat, "embed_head.weight": head["weight"],
                    "embed_head.bias": head["bias"]}
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in flat.items()}, out_path)
    logger.info("Exported %s (%d tensors) to %s", config.format.value,
                len(flat), out_path)
    return out_path
