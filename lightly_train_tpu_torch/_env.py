"""Typed environment-variable registry.

Copy of ``lightly_train_tpu/_env.py`` restricted to the variables the port
reads: every operational knob is declared once, with a type and default, and
accessed as ``Env.<VAR>.value``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
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


def _parse_bool(raw: str) -> bool:
    return raw.strip().lower() in {"1", "true", "yes", "on"}


def _default_cache_dir() -> Path:
    # Apart from the JAX package's, so the two never share a file list, a
    # reference count or a user id.
    return Path(os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache")) / (
        "lightly_train_tpu_torch"
    )


class Env:
    """All environment knobs. Access with ``Env.<NAME>.value``."""

    # Cache dir of the mmap file lists, the events file and the user id.
    LIGHTLY_TRAIN_CACHE_DIR: EnvVar[Path] = EnvVar(
        "LIGHTLY_TRAIN_CACHE_DIR", _default_cache_dir(), Path
    )
    # Keep the mmap file list of a data dir across runs (keyed by ``data``
    # instead of ``out``).
    LIGHTLY_TRAIN_MMAP_REUSE_FILE: EnvVar[bool] = EnvVar(
        "LIGHTLY_TRAIN_MMAP_REUSE_FILE", False, _parse_bool
    )
    # Usage events: disabled unless turned on; when on, appended to a local
    # JSONL file (``_events/tracker.py``), never sent anywhere.
    LIGHTLY_TRAIN_EVENTS_DISABLED: EnvVar[bool] = EnvVar(
        "LIGHTLY_TRAIN_EVENTS_DISABLED", True, _parse_bool
    )

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
    # The EoMT losses' matcher: "auto" (the exact Hungarian, scipy's
    # linear_sum_assignment on the host, on the card and on the CPU),
    # "hungarian" or "greedy" (the JAX package's device matcher).
    LIGHTLY_TRAIN_MATCHER: EnvVar[str] = EnvVar(
        "LIGHTLY_TRAIN_MATCHER", "auto", str
    )
