"""Method name -> (Method class, args class).

Port of ``lightly_train_tpu/methods/method_helpers.py`` for the methods the
port has. The others raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""

from __future__ import annotations

from typing import Tuple, Type

from lightly_train_tpu_torch.errors import UnknownMethodError
from lightly_train_tpu_torch.methods.base import Method, MethodArgs
from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args

_PORTED = {"dinov2": (DINOv2, DINOv2Args)}
# Methods of the JAX package not ported yet, with their ROADMAP item.
_PENDING = {
    "distillation": 8, "distillationv1": 8, "distillationv2": 8,
    "distillationv3": 8,
    "dino": 9, "simclr": 9, "dinov31": 9, "densecl": 9, "detconb": 9,
    "detcons": 9,
}


def get_method_cls(name: str) -> Tuple[Type[Method], Type[MethodArgs]]:
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
