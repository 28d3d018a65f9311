"""Model name registry: ``pkg/model`` -> WrappedModel builder.

Port of ``lightly_train_tpu/models/package_registry.py`` for the ViTs of
the ``dinov2/*`` and ``dinov3/*`` names. Test-size models are registered but
hidden from ``list_models``. The 7B ViTs (``dinov2/vit7b14``,
``dinov3/vit7b16``: head dim 128) build everywhere and run forward only (a
frozen distillation teacher, ``embed``); pretraining one is refused
(:func:`refuse_pretraining`). The other packages (the
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


# Models the port runs forward only: their attention at head dim 128 has no
# backward kernel yet (ROADMAP queue 2 item 2b), and training one keeps four
# fp32 copies of its parameters, more than one card holds (FSDP, ROADMAP
# item 7.6).
FORWARD_ONLY = ("dinov2/vit7b14", "dinov3/vit7b16")


def refuse_pretraining(name: str) -> None:
    """Raises NotImplementedError, before anything is allocated, where
    ``pretrain`` is asked to train a model of :data:`FORWARD_ONLY`; its
    parameters are counted on the meta device."""
    if name not in FORWARD_ONLY:
        return
    with torch.device("meta"):
        n = sum(p.numel() for p in get_wrapped_model(name).module.parameters())
    raise NotImplementedError(
        f"model='{name}' runs forward only in the port (ROADMAP item 10): as "
        "a distillation teacher (method_args={'teacher': ...}) and in embed. "
        "Pretraining it waits for the attention backward at head dim 128 "
        "(ROADMAP queue 2 item 2b) and for FSDP (ROADMAP item 7.6): its "
        f"{n / 1e9:.2f} B parameters, their AdamW moments mu and nu and a "
        f"teacher of its size are four fp32 copies, about {16 * n / 1e9:.0f} "
        "GB, against an H100's 80 GB."
    )


# The JAX package's DINOv3 ConvNeXts, refused by name.
_CONVNEXT_NAMES = tuple(f"dinov3/convnext-{size}" for size in
                        ("tiny", "small", "base", "large", "test"))


def _build_vit(size: str, patch: int, dtype: torch.dtype,
               flavor: str = "dinov2", model_name: str = "",
               **kwargs: Any) -> WrappedModel:
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
