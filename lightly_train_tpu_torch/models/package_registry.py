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
(:func:`refuse_pretraining`). The ECViTs (``ecvit/*``), the ultralytics
YOLOv8, YOLOv5 and YOLO11 backbones (``ultralytics/*``, with the hidden
``.pt``, ``u``, ``-cls.pt`` and ``-seg.pt`` names of the same backbone)
and YOLO-NAS (``super_gradients/*``) complete the JAX package's list.

``get_wrapped_model`` also takes a model object: a ``WrappedModel`` as it
is, or any ``torch.nn.Module`` (``models/torch_module.py``); an unknown
``timm/*`` or ``ultralytics/*`` name wraps the live timm or ultralytics
model where that package is installed. :func:`resolve_model_name` registers
an object's wrapper under its name, hidden, so a run's config stays a name.
"""

from __future__ import annotations

import dataclasses
import difflib
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Set

import torch

from lightly_train_tpu_torch._optim.adamw8bit import AdamW8bitArgs, state_bytes
from lightly_train_tpu_torch._optim.optimizers import AdamWArgs
from lightly_train_tpu_torch.errors import UnknownModelError
from lightly_train_tpu_torch.models import torch_module
from lightly_train_tpu_torch.models.convnext import (
    _CONVNEXT_SIZES,
    ConvNeXt,
    convnext_config,
)
from lightly_train_tpu_torch.models.ecvit import (
    _ECVIT_SIZES,
    ECViT,
    ecvit_config,
    ecvit_feature_dim,
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
from lightly_train_tpu_torch.models.yolo import (
    _YOLO11_SIZES,
    _YOLOV5_SIZES,
    _YOLOV8_SIZES,
    yolo_backbone,
    yolo_config,
)
from lightly_train_tpu_torch.models.yolo_nas import (
    _YOLO_NAS_SIZES,
    YoloNASBackbone,
    yolo_nas_config,
)


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


# Names that :func:`resolve_model_name` registered for a model object.
_OBJECT_NAMES: Set[str] = set()


def resolve_model_name(model: Any) -> str:
    """A run's model name: a string as it is; a model object (see
    :func:`get_wrapped_model`) is wrapped and registered, hidden, under
    its wrapper's name (``torch/<class>`` for a torch module), and that
    name returned. An object replaces an earlier object of its name; a
    name registered otherwise (a built-in one) is left as it is, as in the
    JAX package, so the run builds that model afresh."""
    if isinstance(model, str):
        return model
    wrapped = get_wrapped_model(model)
    if wrapped.name not in _REGISTRY or wrapped.name in _OBJECT_NAMES:
        register_model(wrapped.name, lambda dtype=None, **kw: wrapped,
                       hidden=True)
        _OBJECT_NAMES.add(wrapped.name)
    return wrapped.name


def _is_flax_module(model: Any) -> bool:
    return any(c.__module__.split(".")[0] == "flax"
               for c in type(model).__mro__)


def get_wrapped_model(
    name: Any, dtype: torch.dtype = torch.float32, **kwargs: Any
) -> WrappedModel:
    """Build a backbone (parameters not yet initialized) by ``pkg/model``,
    or wrap a model object: a ``WrappedModel`` as it is, any
    ``torch.nn.Module`` as :func:`torch_module.wrap_torch_module` does.
    A ``timm/*`` name that is not registered resolves by the JAX
    package's patterns, else to the live timm model where timm is
    installed; an unregistered ``ultralytics/*`` name to the live
    ultralytics model where that package is; any other name raises as the
    JAX package does."""
    if isinstance(name, WrappedModel):
        return name
    if isinstance(name, torch.nn.Module):
        return torch_module.wrap_torch_module(name)
    if not isinstance(name, str):
        took = ("a Flax module, which the PyTorch port cannot run; "
                if _is_flax_module(name) else "")
        raise UnknownModelError(
            f"Model must be a name string, WrappedModel or torch module; "
            f"got {took}{type(name)!r}.")
    entry = _REGISTRY.get(name)
    if entry is None and name.startswith("timm/"):
        resolved = _resolve_timm(name, dtype)
        if resolved is not None:
            return resolved
        if torch_module.timm_available():
            return torch_module.wrap_timm_model(name[len("timm/"):],
                                                **kwargs)
    if (entry is None and name.startswith("ultralytics/")
            and torch_module.ultralytics_available()):
        return torch_module.wrap_ultralytics_model(
            name[len("ultralytics/"):], **kwargs)
    if entry is None:
        match = difflib.get_close_matches(name, list(_REGISTRY), n=3)
        hint = f" Did you mean: {match}?" if match else ""
        raise UnknownModelError(
            f"Unknown model '{name}'.{hint} See list_models() for options."
        )
    return entry.build(dtype=dtype, **kwargs)


# Device memory a run holds beyond the state :func:`refuse_pretraining`
# counts: the activations of a step (every block recomputed in the 7B
# runs), the update's leaf-sized temporaries and the caching allocator's
# slack. On an H100 80GB the 7B/16 students peaked 3.4 GiB above their
# counted state (LARS at momentum 0; AdamW8bit), and the one with LARS at
# momentum 0.9, 75.4 GiB counted, ran out of the card's 79.2 GiB with
# 74.8 GiB allocated and 3.5 GiB reserved unused (``chip_smoke.py
# --7b-lars``).
HEADROOM = 4 * 2 ** 30


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
    are counted on the meta device. Activations and workspaces are not
    counted one by one: the state must leave :data:`HEADROOM` of the card
    free for them. The message offers ``optim='adamw8bit'`` only where
    the same run with it would fit."""
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
    if need + HEADROOM <= capacity:
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
        if need8 + HEADROOM <= capacity:
            offer = (f" With optim='adamw8bit' (int8 moments) it would hold "
                     f"{need8} bytes ({need8 / 2 ** 30:.1f} GiB), which "
                     "fits.")
    raise NotImplementedError(
        f"model='{name}' does not fit the card: {counted} are {need} bytes "
        f"({need / 2 ** 30:.1f} GiB), which with "
        f"{HEADROOM / 2 ** 30:.1f} GiB for activations and workspaces is "
        f"more than the card's {capacity / 2 ** 30:.1f} GiB. Such a run "
        f"waits for FSDP over "
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


# ---------------------------------------------------------------------------
# ECViT (EdgeCrafter), the ultralytics YOLOv8/v5/11 backbones and YOLO-NAS
# (super_gradients), as the JAX package registers them.
# ---------------------------------------------------------------------------


def _build_ecvit(name: str, dtype: torch.dtype, **kwargs: Any
                 ) -> WrappedModel:
    _refuse_kwargs(kwargs)
    cfg = ecvit_config(name, dtype=dtype)
    return WrappedModel(
        name=f"ecvit/{name}",
        module=ECViT(cfg),
        feature_dim=ecvit_feature_dim(cfg),
        patch_size=16,
        architecture="hybrid",
        supports_mask=False,
    )


def _build_yolo(name: str, dtype: torch.dtype, **kwargs: Any
                ) -> WrappedModel:
    _refuse_kwargs(kwargs)
    cfg = yolo_config(name, dtype=dtype)
    return WrappedModel(
        name=f"ultralytics/{name}",
        module=yolo_backbone(name, cfg),
        feature_dim=cfg.ch(1024),
        patch_size=None,
        architecture="conv",
        supports_mask=False,
    )


def _build_yolo_nas(name: str, dtype: torch.dtype, **kwargs: Any
                    ) -> WrappedModel:
    _refuse_kwargs(kwargs)
    cfg = yolo_nas_config(name, dtype=dtype)
    return WrappedModel(
        name=f"super_gradients/{name}",
        module=YoloNASBackbone(cfg),
        feature_dim=cfg.stage_channels[-1],
        patch_size=None,
        architecture="conv",
        supports_mask=False,
    )


for _name in _ECVIT_SIZES:
    register_model(
        f"ecvit/{_name}",
        (lambda n: lambda dtype=torch.float32, **kw: _build_ecvit(
            n, dtype, **kw))(_name),
        hidden=_name == "ecvittest",
    )

for _names, _suffixes in ((_YOLOV8_SIZES, ("", ".pt", "-cls.pt", "-seg.pt")),
                          ({**_YOLOV5_SIZES, **_YOLO11_SIZES},
                           ("", ".pt", "u", "u.pt", "-cls.pt", "-seg.pt"))):
    for _name in _names:
        for _suffix in _suffixes:
            register_model(
                f"ultralytics/{_name}{_suffix}",
                (lambda n: lambda dtype=torch.float32, **kw: _build_yolo(
                    n, dtype, **kw))(_name),
                hidden="test" in _name or _suffix != "",
            )

for _name in _YOLO_NAS_SIZES:
    register_model(
        f"super_gradients/{_name}",
        (lambda n: lambda dtype=torch.float32, **kw: _build_yolo_nas(
            n, dtype, **kw))(_name),
        hidden=_name == "yolo_nas_test",
    )
