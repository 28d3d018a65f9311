"""Model name registry: ``pkg/model`` -> WrappedModel builder.

Port of ``lightly_train_tpu/models/package_registry.py``: the ``dinov2/*``
and ``dinov3/*`` ViTs, the DINOv3 ConvNeXts (``dinov3/convnext-*``), the
torchvision ResNets and ShuffleNetV2s (``torchvision/*``), RT-DETR's "vd"
ResNets (``rtdetr/*``), the ``timm/*`` names (the registered aliases, then
the JAX package's patterns onto the native families) and the ``rfdetr/*``
aliases of the DINOv2 ViTs. An alias builds its target, under the target's
name. Test-size models are registered but hidden from ``list_models``. The
7B ViTs (``dinov2/vit7b14``, ``dinov3/vit7b16``: head dim 128) build
everywhere; ``pretrain`` refuses a run whose state does not fit the card
(:func:`refuse_pretraining`). The JAX package's ECViT, ultralytics and
super_gradients names wait for ROADMAP item 10 and are refused by name.
"""

from __future__ import annotations

import dataclasses
import difflib
import re
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

from lightly_train_tpu_torch._optim.adamw8bit import AdamW8bitArgs, state_bytes
from lightly_train_tpu_torch._optim.optimizers import AdamWArgs
from lightly_train_tpu_torch.errors import UnknownModelError
from lightly_train_tpu_torch.models.convnext import (
    _CONVNEXT_SIZES,
    ConvNeXt,
    convnext_config,
)
from lightly_train_tpu_torch.models.resnet import (
    _RESNET_SIZES,
    ResNet,
    resnet_config,
    resnet_feature_dim,
)
from lightly_train_tpu_torch.models.shufflenet import (
    _SHUFFLENET_SIZES,
    ShuffleNetV2,
    shufflenet_config,
)
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
    """Build a backbone (parameters not yet initialized) by ``pkg/model``.
    A ``timm/*`` name that is not registered resolves by the JAX package's
    patterns; the port never wraps a live timm model, so any other raises
    as the JAX package does where timm is absent."""
    entry = _REGISTRY.get(name)
    if entry is None and name.startswith("timm/"):
        resolved = _resolve_timm(name, dtype)
        if resolved is not None:
            return resolved
    if entry is None and name in _UNPORTED_NAMES:
        raise NotImplementedError(
            f"Model '{name}' is not ported yet (ROADMAP item 10: ECViT, "
            "YOLO and YOLO-NAS).")
    if entry is None:
        match = difflib.get_close_matches(name, list(_REGISTRY), n=3)
        hint = f" Did you mean: {match}?" if match else ""
        raise UnknownModelError(
            f"Unknown model '{name}'.{hint} See list_models() for options."
        )
    return entry.build(dtype=dtype, **kwargs)


def _state_need(numels: List[int], optim_args: Any, ema_teacher: bool,
                n_teacher: int) -> int:
    """Bytes of a run's training state (see :func:`refuse_pretraining`)."""
    n = sum(numels)
    copies = 2 + int(ema_teacher)
    if isinstance(optim_args, AdamW8bitArgs):
        moments = state_bytes(numels)
    else:
        copies += (2 if isinstance(optim_args, AdamWArgs)
                   else int(optim_args.momentum > 0))
        moments = 0
    return 4 * (n * copies + n_teacher) + moments


def refuse_pretraining(name: str, optim_args: Any, ema_teacher: bool,
                       capacity: Optional[int],
                       teacher: Optional[str] = None) -> None:
    """Raises NotImplementedError, before anything is allocated, where the
    state a run of ``name`` must hold exceeds ``capacity`` bytes (the
    card's total memory; None: no limit). That state is the student's
    fp32 parameters and gradients, the optimizer's moments (AdamW 2 fp32
    copies, SGD and LARS 1 with momentum, else 0; AdamW8bit 2 int8 bytes a
    parameter and 2 fp32 scales a block of 256, per leaf) and, with
    ``ema_teacher``, a teacher the student's size; and a frozen
    ``teacher`` model (distillation's) once, at its own size. Parameters
    are counted on the meta device. Nothing else (activations,
    workspaces) is counted. The message offers ``optim='adamw8bit'`` only
    where the same run with it would fit."""
    if capacity is None:
        return

    def numels(model: str) -> List[int]:
        with torch.device("meta"):
            return [p.numel()
                    for p in get_wrapped_model(model).module.parameters()]

    leaves = numels(name)
    n = sum(leaves)
    n_teacher = 0 if teacher is None else sum(numels(teacher))
    need = _state_need(leaves, optim_args, ema_teacher, n_teacher)
    if need <= capacity:
        return
    int8 = isinstance(optim_args, AdamW8bitArgs)
    moments = 0 if int8 else (2 if isinstance(optim_args, AdamWArgs)
                              else int(optim_args.momentum > 0))
    held = ["parameters", "gradients"]
    held += {2: ["AdamW's mu and nu"], 1: ["the momentum trace"],
             0: []}[moments]
    held += ["an EMA teacher"] if ema_teacher else []
    copies = 2 + moments + int(ema_teacher)
    counted = (f"its {n / 1e9:.2f} B parameters as {copies} fp32 copies "
               f"({', '.join(held)})")
    if int8:
        counted += (f", AdamW8bit's int8 mu and nu with their block scales "
                    f"({state_bytes(leaves)} bytes)")
    if teacher is not None:
        counted += (f" and the frozen teacher '{teacher}' of "
                    f"{n_teacher / 1e9:.2f} B parameters as one")
    offer = ""
    if not int8:
        need8 = _state_need(leaves, AdamW8bitArgs(), ema_teacher, n_teacher)
        if need8 <= capacity:
            offer = (f" With optim='adamw8bit' (int8 moments) it would hold "
                     f"{need8} bytes ({need8 / 2 ** 30:.1f} GiB), which "
                     "fits.")
    raise NotImplementedError(
        f"model='{name}' does not fit the card: {counted} are {need} bytes "
        f"({need / 2 ** 30:.1f} GiB), more than the card's "
        f"{capacity / 2 ** 30:.1f} GiB. Such a run waits for FSDP over "
        f"several cards (ROADMAP item 7.6).{offer}"
    )


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


# ---------------------------------------------------------------------------
# The DINOv3 ConvNeXts, the torchvision ResNets and ShuffleNetV2s, and
# RT-DETR's "vd" ResNets: the native CNN families of the JAX package.
# ---------------------------------------------------------------------------


def _refuse_kwargs(kwargs: Mapping[str, Any]) -> None:
    if kwargs:
        raise ValueError(
            f"Unsupported model_args for this family: {sorted(kwargs)}")


def _build_convnext(size: str, dtype: torch.dtype, **kwargs: Any
                    ) -> WrappedModel:
    _refuse_kwargs(kwargs)
    cfg = convnext_config(size, dtype=dtype)
    return WrappedModel(
        name=f"dinov3/convnext-{size}",
        module=ConvNeXt(cfg),
        feature_dim=cfg.dims[-1],
        patch_size=None,
        architecture="conv",
        supports_mask=False,
    )


def _build_resnet(name: str, dtype: torch.dtype, **kwargs: Any
                  ) -> WrappedModel:
    _refuse_kwargs(kwargs)
    return WrappedModel(
        name=f"torchvision/{name}",
        module=ResNet(resnet_config(name, dtype=dtype)),
        feature_dim=resnet_feature_dim(name),
        patch_size=None,
        architecture="conv",
        supports_mask=False,
    )


def _build_shufflenet(name: str, dtype: torch.dtype, **kwargs: Any
                      ) -> WrappedModel:
    _refuse_kwargs(kwargs)
    cfg = shufflenet_config(name, dtype=dtype)
    return WrappedModel(
        name=f"torchvision/{name}",
        module=ShuffleNetV2(cfg),
        feature_dim=cfg.out_channels,
        patch_size=None,
        architecture="conv",
        supports_mask=False,
    )


for _size in _CONVNEXT_SIZES:
    register_model(
        f"dinov3/convnext-{_size}",
        (lambda size: lambda dtype=torch.float32, **kw: _build_convnext(
            size, dtype, **kw))(_size),
        hidden=_size == "test",
    )

for _name in _RESNET_SIZES:
    register_model(
        f"torchvision/{_name}",
        (lambda n: lambda dtype=torch.float32, **kw: _build_resnet(
            n, dtype, **kw))(_name),
        hidden=_name.startswith("resnettest") or _name.endswith("vd"),
    )

for _name in _SHUFFLENET_SIZES:
    register_model(
        f"torchvision/{_name}",
        (lambda n: lambda dtype=torch.float32, **kw: _build_shufflenet(
            n, dtype, **kw))(_name),
        hidden=_name == "shufflenettest",
    )

for _name in ("resnet18vd", "resnet34vd", "resnet50vd", "resnet101vd",
              "resnettestvd"):
    register_model(
        f"rtdetr/rtdetr_{_name.replace('resnet', 'r')}",
        (lambda n: lambda dtype=torch.float32, **kw: _build_resnet(
            n, dtype, **kw))(_name),
        hidden="test" in _name,
    )


# ---------------------------------------------------------------------------
# Aliases: the registered timm names and RF-DETR's DINOv2 encoders build
# their target, under the target's name. Unregistered timm names follow
# the JAX package's patterns onto the native families.
# ---------------------------------------------------------------------------

_TIMM_VIT_SIZES = {
    "tiny": "vitt", "small": "vits", "base": "vitb",
    "large": "vitl", "giant": "vitg",
}


def _resolve_timm(name: str, dtype: torch.dtype = torch.float32
                  ) -> Optional[WrappedModel]:
    """A ``timm/<model>`` name on a native family's build (None if unknown):
    ``vit_{size}_patch{P}[_{res}]`` as the DINOv2-flavoured ViT under the
    timm name, ``resnet*``, ``convnext_{size}`` and ``shufflenet_v2_*``."""
    model = name[len("timm/"):]
    m = re.fullmatch(r"vit_(\w+?)_patch(\d+)(?:_\d+)?", model)
    if m and m.group(1) in _TIMM_VIT_SIZES:
        return _build_vit(_TIMM_VIT_SIZES[m.group(1)], int(m.group(2)),
                          dtype, "dinov2", name)
    if model in _RESNET_SIZES:
        return _build_resnet(model, dtype)
    m = re.fullmatch(r"convnext_(\w+)", model)
    if m and m.group(1) in _CONVNEXT_SIZES:
        return _build_convnext(m.group(1), dtype)
    if model in _SHUFFLENET_SIZES:
        return _build_shufflenet(model, dtype)
    return None


for _alias, _target in {
    "timm/resnet18": "torchvision/resnet18",
    "timm/resnet50": "torchvision/resnet50",
    "timm/convnext_tiny": "dinov3/convnext-tiny",
    "timm/convnext_small": "dinov3/convnext-small",
    "timm/convnext_base": "dinov3/convnext-base",
    "timm/vit_base_patch16_224": "dinov3/vitb16",
    "timm/vit_small_patch16_224": "dinov3/vits16",
    "rfdetr/rf-detr-nano": "dinov2/vits14",
    "rfdetr/rf-detr-small": "dinov2/vits14",
    "rfdetr/rf-detr-base": "dinov2/vitb14",
    "rfdetr/rf-detr-medium": "dinov2/vitb14",
    "rfdetr/rf-detr-large": "dinov2/vitl14",
}.items():
    register_model(
        _alias,
        (lambda t: lambda dtype=torch.float32, **kw: get_wrapped_model(
            t, dtype=dtype, **kw))(_target),
    )


# The JAX package's ECViT, ultralytics and super_gradients names (ROADMAP
# item 10), refused by name.
_UNPORTED_NAMES = frozenset(
    [f"ecvit/{n}" for n in ("ecvitt", "ecvittplus", "ecvits", "ecvitsplus",
                            "ecvittest")]
    + [f"ultralytics/yolov8{s}{x}" for s in ("n", "s", "m", "l", "x", "test")
       for x in ("", ".pt", "-cls.pt", "-seg.pt")]
    + [f"ultralytics/{f}{s}{x}" for f in ("yolov5", "yolo11")
       for s in ("n", "s", "m", "l", "x", "test")
       for x in ("", ".pt", "u", "u.pt", "-cls.pt", "-seg.pt")]
    + [f"super_gradients/yolo_nas_{s}" for s in ("s", "m", "l", "test")])
