"""Strict dataclass config base with "auto" resolution.

Port of ``lightly_train_tpu/_configs/config.py`` without pydantic, which the
GPU machines do not have: a config is a dataclass whose fields may hold the
literal ``"auto"``, filled in by ``resolve_auto(...)`` before training.
Unknown keys and values of the wrong type are errors
(:func:`lightly_train_tpu_torch._configs.validate.config_validate`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Literal

Auto = Literal["auto"]
AUTO: Auto = "auto"


@dataclasses.dataclass
class Config:
    """Base of the port's configs (the JAX package's ``PydanticConfig``)."""

    def dump(self) -> dict[str, Any]:
        """Plain-dict dump suitable for logging as hyperparams."""
        return dataclasses.asdict(self)
