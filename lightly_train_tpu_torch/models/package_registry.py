"""Model name registry: ``pkg/model`` -> WrappedModel builder.

Port of ``lightly_train_tpu/models/package_registry.py`` for the ViTs of
the ``dinov2/*`` and ``dinov3/*`` names. Test-size models are registered but
hidden from ``list_models``. The 7B ViTs (``dinov2/vit7b14``,
``dinov3/vit7b16``: head dim 128) and the other packages (the
``dinov3/convnext-*`` ConvNeXts, resnet, timm, ...) wait for ROADMAP item
10.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Callable, Dict, List

import torch

from lightly_train_tpu_torch.errors import UnknownModelError
from lightly_train_tpu_torch.models.vit import (
    _DINOV3_SIZES,
    _SIZES,
    VisionTransformer,
    vit_config,
)
from lightly_train_tpu_torch.models.wrapper import WrappedModel


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    build: Callable[..., WrappedModel]
    hidden: bool = False  # test models excluded from list_models


_REGISTRY: Dict[str, ModelEntry] = {}


def register_model(
    name: str, build: Callable[..., WrappedModel], hidden: bool = False
) -> None:
    _REGISTRY[name] = ModelEntry(name=name, build=build, hidden=hidden)


def list_models() -> List[str]:
    """Public model names (test models hidden, like the reference)."""
    return sorted(n for n, e in _REGISTRY.items() if not e.hidden)


def get_wrapped_model(
    name: str, dtype: torch.dtype = torch.float32, **kwargs: Any
) -> WrappedModel:
    """Build a backbone (parameters not yet initialized) by ``pkg/model``."""
    entry = _REGISTRY.get(name)
    if entry is None and name in _CONVNEXT_NAMES:
        raise NotImplementedError(
            f"Model '{name}' (the DINOv3 ConvNeXt) is not ported yet "
            "(ROADMAP item 10).")
    if entry is None:
        match = difflib.get_close_matches(name, list(_REGISTRY), n=3)
        hint = f" Did you mean: {match}?" if match else ""
        raise UnknownModelError(
            f"Unknown model '{name}'.{hint} The port has the dinov2/* and "
            "dinov3/* ViTs so far (other packages: ROADMAP item 10)."
        )
    return entry.build(dtype=dtype, **kwargs)


# The JAX package's DINOv3 ConvNeXts, refused by name.
_CONVNEXT_NAMES = tuple(f"dinov3/convnext-{size}" for size in
                        ("tiny", "small", "base", "large", "test"))


def _build_vit(size: str, patch: int, dtype: torch.dtype,
               flavor: str = "dinov2", model_name: str = "",
               **kwargs: Any) -> WrappedModel:
    # The JAX ViT's activation checkpointing, off at its defaults (0, None).
    remat_every = kwargs.pop("remat_every", 0)
    remat_policy = kwargs.pop("remat_policy", None)
    if remat_every or remat_policy is not None:
        raise NotImplementedError(
            "model_args remat_every and remat_policy (activation "
            "checkpointing) are not ported yet (ROADMAP item 22)."
        )
    cfg = vit_config(size, patch, flavor=flavor, dtype=dtype, **kwargs)
    return WrappedModel(
        name=model_name or f"{flavor}/{size}{patch}",
        module=VisionTransformer(cfg),
        feature_dim=cfg.embed_dim,
        patch_size=patch,
        architecture="transformer",
        supports_mask=True,
    )


for _size in _SIZES:
    register_model(
        f"dinov2/{_size}14",
        (lambda size: lambda dtype=torch.float32, **kw: _build_vit(
            size, 14, dtype, **kw
        ))(_size),
        hidden=_size == "vittest",
    )

# DINOv3 hub naming: size key "vitsplus" -> model name "dinov3/vits16plus".
for _size in _DINOV3_SIZES:
    _base, _plus = ((_size[:-4], "plus") if _size.endswith("plus")
                    else (_size, ""))
    _name = f"dinov3/{_base}16{_plus}"
    register_model(
        _name,
        (lambda size, name: lambda dtype=torch.float32, **kw: _build_vit(
            size, 16, dtype, "dinov3", name, **kw
        ))(_size, _name),
        hidden=_size == "vittest",
    )
register_model(
    "dinov3/vitt32",
    lambda dtype=torch.float32, **kw: _build_vit("vitt", 32, dtype, "dinov3",
                                                 **kw),
)
