"""Method name -> (Method class, args class).

Port of ``lightly_train_tpu/methods/method_helpers.py``: every method of
the JAX package, the alias ``distillation`` of distillation v3, and the
methods hidden from :func:`list_methods` (DenseCL and DetCon, as the
reference hides them).
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Type

from lightly_train_tpu_torch.errors import UnknownMethodError
from lightly_train_tpu_torch.methods.base import Method, MethodArgs
from lightly_train_tpu_torch.methods.densecl import DenseCL, DenseCLArgs
from lightly_train_tpu_torch.methods.detcon import (
    DetConB,
    DetConBArgs,
    DetConS,
)
from lightly_train_tpu_torch.methods.dino import DINO, DINOArgs
from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
from lightly_train_tpu_torch.methods.dinov31 import DINOv31, DINOv31Args
from lightly_train_tpu_torch.methods.distillation_v1v2 import (
    DistillationV1,
    DistillationV1Args,
    DistillationV2,
    DistillationV2Args,
)
from lightly_train_tpu_torch.methods.distillationv3 import (
    DistillationV3,
    DistillationV3Args,
)
from lightly_train_tpu_torch.methods.simclr import SimCLR, SimCLRArgs

_METHODS: Dict[str, Tuple[Type[Method], Type[MethodArgs]]] = {
    "distillationv3": (DistillationV3, DistillationV3Args),
    "distillationv2": (DistillationV2, DistillationV2Args),
    "distillationv1": (DistillationV1, DistillationV1Args),
    "dinov2": (DINOv2, DINOv2Args),
    "dinov31": (DINOv31, DINOv31Args),
    "dino": (DINO, DINOArgs),
    "simclr": (SimCLR, SimCLRArgs),
    "densecl": (DenseCL, DenseCLArgs),
    "detconb": (DetConB, DetConBArgs),
    "detcons": (DetConS, DetConBArgs),
}
# "distillation" is the default method's name.
_ALIASES: Dict[str, str] = {"distillation": "distillationv3"}
_HIDDEN = {"densecl", "detconb", "detcons"}


def get_method_cls(name: str) -> Tuple[Type[Method], Type[MethodArgs]]:
    resolved = _ALIASES.get(name, name)
    if resolved not in _METHODS:
        raise UnknownMethodError(
            f"Unknown method '{name}'. Options: {list_methods()}")
    return _METHODS[resolved]


def list_methods() -> List[str]:
    """The public method names and aliases, sorted."""
    return sorted([n for n in _METHODS if n not in _HIDDEN] + list(_ALIASES))
