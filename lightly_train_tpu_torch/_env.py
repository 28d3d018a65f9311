"""Typed environment-variable registry.

Copy of ``lightly_train_tpu/_env.py`` restricted to the variables the port
reads: every operational knob is declared once, with a type and default, and
accessed as ``Env.<VAR>.value``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Generic, TypeVar

T = TypeVar("T")


@dataclass(frozen=True)
class EnvVar(Generic[T]):
    name: str
    default: T
    parse: Callable[[str], T]

    @property
    def value(self) -> T:
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        return self.parse(raw)

    @property
    def is_set(self) -> bool:
        return self.name in os.environ


class Env:
    """All environment knobs. Access with ``Env.<NAME>.value``."""

    # Image decode mode: RGB (the only mode the port decodes so far).
    LIGHTLY_TRAIN_IMAGE_MODE: EnvVar[str] = EnvVar(
        "LIGHTLY_TRAIN_IMAGE_MODE", "RGB", str
    )
    # "1" turns a shape mismatch between a pretrained checkpoint and the
    # model into a warning (the leaf keeps its init) instead of an error.
    LIGHTLY_TRAIN_ALLOW_SHAPE_MISMATCH: EnvVar[str] = EnvVar(
        "LIGHTLY_TRAIN_ALLOW_SHAPE_MISMATCH", "0", str
    )
    # Verbosity of console logging (DEBUG/INFO/WARNING/ERROR).
    LIGHTLY_TRAIN_LOG_LEVEL: EnvVar[str] = EnvVar(
        "LIGHTLY_TRAIN_LOG_LEVEL", "INFO", str
    )
    # The float32 matmul precision ("default" | "high" | "highest"), which
    # pretrain applies to the CUDA backend at the start of every run
    # (``_system.py``: TF32 for the first two, IEEE fp32 for "highest").
    LIGHTLY_TRAIN_MATMUL_PRECISION: EnvVar[str] = EnvVar(
        "LIGHTLY_TRAIN_MATMUL_PRECISION", "default", str
    )
    # The attention kernels on the card ("0", "false" or "False" turns them
    # off, the JAX package's switch to its portable path, which the port
    # does not have: the ViT's unmasked attention on the card then raises).
    LIGHTLY_TRAIN_VMEM_ATTENTION: EnvVar[str] = EnvVar(
        "LIGHTLY_TRAIN_VMEM_ATTENTION", "1", str
    )
