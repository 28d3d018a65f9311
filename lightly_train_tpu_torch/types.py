"""Shared typed structures for datasets and batches.

Copy of the parts of ``lightly_train_tpu/types.py`` the port uses. A batch is
a uint8 (B, H, W, 3) tensor at the canonical host size; multi-crop views are
stacked per resolution rather than kept as ragged lists. Images are
channels-last (NHWC), the JAX package's layout, kept at the port's public
functions so both packages take the same arrays.
"""

from __future__ import annotations

from enum import Enum
from pathlib import Path
from typing import Any, List, TypedDict, Union

import numpy as np

PathLike = Union[str, Path]


class DatasetItem(TypedDict, total=False):
    """One dataset item after decode, before device-side augmentation."""

    filename: str
    # Decoded image, uint8 HWC (canonical host size).
    image: np.ndarray
    # Optional class label.
    label: int


class RawBatch(TypedDict, total=False):
    """Host-collated batch fed to the device augmentation stage."""

    filenames: List[str]
    # uint8 (B, H, W, 3) canonical decode size.
    images: np.ndarray
    labels: np.ndarray


class ViewsBatch(TypedDict, total=False):
    """Device-side multi-crop output of the augmentation stage.

    ``global_views``: (G, B, Hg, Wg, 3) float32/bf16 normalized.
    ``local_views``:  (L, B, Hl, Wl, 3) or absent when the method uses 1-2 views.
    """

    global_views: Any
    local_views: Any
    labels: Any


class EmbeddingFormat(str, Enum):
    """Output formats of the ``embed`` command (``npz`` is the native array
    format, ``torch`` a ``torch.save`` file)."""

    CSV = "csv"
    LIGHTLY_CSV = "lightly_csv"
    NPZ = "npz"
    TORCH = "torch"


class ModelFormat(str, Enum):
    """Formats of the ``export`` command (not ported yet)."""

    PACKAGE_DEFAULT = "package_default"
    NUMPY_STATE_DICT = "numpy_state_dict"
    TORCH_STATE_DICT = "torch_state_dict"
