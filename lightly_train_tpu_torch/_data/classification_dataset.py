"""A class-folder dataset: ``root/<class_name>/<image>`` -> (image, label).

Port of ``ImageClassificationDataset`` of
``lightly_train_tpu/tasks/image_classification.py`` (the dataset that
``evaluate_knn`` reads; the rest of that module waits for ROADMAP item 12).
``classes`` pins the label mapping: a val split built with the train split's
list keeps its indices where it lacks a class, and a class folder that is
not in the list is a ``DatasetError``. Images decode as ``pretrain``'s do
(``_data/image_dataset.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from lightly_train_tpu_torch._data.image_dataset import (
    IMAGE_EXTENSIONS,
    decode_image,
)
from lightly_train_tpu_torch.errors import DatasetError


class ImageClassificationDataset:
    """``root/<class_name>/<image>`` -> ``{"images": uint8 (H, W, 3),
    "labels": int32}``."""

    def __init__(
        self,
        root: Path,
        image_hw: Tuple[int, int] = (224, 224),
        classes: Optional[List[str]] = None,
    ):
        root = Path(root)
        if not root.exists():
            raise DatasetError(f"Dataset root does not exist: {root}")
        present = sorted(d.name for d in root.iterdir() if d.is_dir())
        if not present:
            raise DatasetError(f"No class subdirectories under {root}")
        if classes is None:
            self.classes = present
        else:
            unknown = sorted(set(present) - set(classes))
            if unknown:
                raise DatasetError(
                    f"Classes {unknown} under {root} are not in the train "
                    f"split's class list {sorted(classes)}"
                )
            self.classes = list(classes)
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in [c for c in self.classes if c in present]:
            for p in sorted((root / c).rglob("*")):
                if p.suffix.lower() in IMAGE_EXTENSIONS and p.is_file():
                    self.samples.append((str(p), self.class_to_idx[c]))
        if not self.samples:
            raise DatasetError(f"No images under {root}")
        self.image_hw = image_hw

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        path, label = self.samples[index]
        return {
            "images": decode_image(path, self.image_hw),
            "labels": np.int32(label),
        }
