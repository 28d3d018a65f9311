"""Method name -> (Method class, args class).

Port of ``lightly_train_tpu/methods/method_helpers.py`` for the methods the
port has (DINOv2 and distillation v1, v2, v3, with the alias
``distillation`` of v3). The others raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Tuple, Type

from lightly_train_tpu_torch.errors import UnknownMethodError
from lightly_train_tpu_torch.methods.base import Method, MethodArgs
from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
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

_PORTED = {
    "distillationv3": (DistillationV3, DistillationV3Args),
    "distillationv2": (DistillationV2, DistillationV2Args),
    "distillationv1": (DistillationV1, DistillationV1Args),
    "dinov2": (DINOv2, DINOv2Args),
}
# "distillation" is the default method's name (the JAX package's alias).
_ALIASES = {"distillation": "distillationv3"}
# Methods of the JAX package not ported yet, with their ROADMAP item.
_PENDING = {
    "dino": 9, "simclr": 9, "dinov31": 9, "densecl": 9, "detconb": 9,
    "detcons": 9,
}


def get_method_cls(name: str) -> Tuple[Type[Method], Type[MethodArgs]]:
    name = _ALIASES.get(name, name)
    if name in _PORTED:
        return _PORTED[name]
    if name in _PENDING:
        raise NotImplementedError(
            f"Method '{name}' is not ported to PyTorch yet (ROADMAP item "
            f"{_PENDING[name]}). Ported: {sorted(_PORTED)}."
        )
    raise UnknownMethodError(
        f"Unknown method '{name}'. Ported: {sorted(_PORTED)}."
    )
