"""Detection datasets: YOLO and COCO boxes.

Port of ``lightly_train_tpu/tasks/detection/data.py``: both yield
fixed-shape items {images uint8 (H, W, 3), boxes (K, 4) normalized cxcywh,
labels (K,), box_valid (K,)}, padded to ``max_boxes``, with the JAX
package's errors. Images decode with the port's own decoder.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from lightly_train_tpu_torch._data.image_dataset import (
    IMAGE_EXTENSIONS,
    decode_image,
)
from lightly_train_tpu_torch._logging import get_logger
from lightly_train_tpu_torch.errors import DatasetError

logger = get_logger("detection_data")


def _empty(max_boxes: int):
    return (np.zeros((max_boxes, 4), np.float32),
            np.zeros((max_boxes,), np.int32), np.zeros((max_boxes,), bool))


class YOLOObjectDetectionDataset:
    """YOLO layout: ``images/**`` and ``labels/**/*.txt`` of ``class cx cy
    w h`` normalized rows, the label mirroring the image's subpath, or
    beside it under its stem."""

    def __init__(self, images_dir: Path, labels_dir: Path,
                 image_hw: Tuple[int, int] = (640, 640),
                 max_boxes: int = 100,
                 class_names: Optional[List[str]] = None):
        images_dir, labels_dir = Path(images_dir), Path(labels_dir)
        self.items: List[Tuple[str, Optional[str]]] = []
        n_labeled = 0
        for p in sorted(images_dir.rglob("*")):
            if p.suffix.lower() in IMAGE_EXTENSIONS:
                label = labels_dir / p.relative_to(images_dir).with_suffix(
                    ".txt")
                if not label.exists():
                    label = labels_dir / (p.stem + ".txt")
                have = label.exists()
                n_labeled += int(have)
                self.items.append((str(p), str(label) if have else None))
        if not self.items:
            raise DatasetError(f"No images under {images_dir}")
        if n_labeled == 0:
            raise DatasetError(
                f"No label .txt files under {labels_dir} match the images "
                f"under {images_dir} (checked mirrored subpaths and flat "
                "stems) — every image would train as background.")
        self.image_hw = image_hw
        self.max_boxes = max_boxes
        self.class_names = class_names

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        img_path, label_path = self.items[index]
        image = decode_image(img_path, self.image_hw)
        boxes, labels, valid = _empty(self.max_boxes)
        if label_path is not None:
            rows = [[float(x) for x in line.split()[:5]]
                    for line in Path(label_path).read_text().splitlines()
                    if len(line.split()) >= 5]
            for i, row in enumerate(rows[:self.max_boxes]):
                cls = int(row[0])
                if self.class_names is not None and not (
                        0 <= cls < len(self.class_names)):
                    raise DatasetError(
                        f"Label {label_path} row {i} has class id {cls}, "
                        f"outside [0, {len(self.class_names)}) — the class "
                        "list and labels disagree.")
                labels[i], boxes[i], valid[i] = cls, row[1:5], True
        return {"images": image, "boxes": boxes, "labels": labels,
                "box_valid": valid}


class COCOObjectDetectionDataset:
    """COCO JSON annotations and an image folder; ``iscrowd`` regions are
    left out (they are ignore regions, not targets)."""

    def __init__(self, images_dir: Path, annotations_json: Path,
                 image_hw: Tuple[int, int] = (640, 640), max_boxes: int = 100,
                 skip_if_annotations_missing: bool = True):
        images_dir = Path(images_dir)
        ann = json.loads(Path(annotations_json).read_text())
        cats = sorted(ann.get("categories", []), key=lambda c: c["id"])
        self.cat_to_idx = {c["id"]: i for i, c in enumerate(cats)}
        self.class_names = [c["name"] for c in cats]
        by_image: Dict[int, List[dict]] = {}
        n_crowd = 0
        for a in ann.get("annotations", []):
            if a.get("iscrowd"):
                n_crowd += 1
                continue
            if a.get("category_id") not in self.cat_to_idx:
                raise DatasetError(
                    f"Annotation {a.get('id')} has category_id "
                    f"{a.get('category_id')} not present in the categories "
                    f"list of {annotations_json}.")
            by_image.setdefault(a["image_id"], []).append(a)
        if n_crowd:
            logger.info("Ignoring %d iscrowd annotations", n_crowd)
        self.items = []
        for im in ann.get("images", []):
            path = images_dir / im["file_name"]
            if not path.exists():
                if skip_if_annotations_missing:
                    continue
                raise DatasetError(
                    f"Image '{im['file_name']}' listed in "
                    f"{annotations_json} is missing under {images_dir} "
                    "(set skip_if_annotations_missing=True to skip)")
            self.items.append((str(path), im["width"], im["height"],
                               by_image.get(im["id"], [])))
        if not self.items:
            raise DatasetError(
                f"No images from {annotations_json} found under {images_dir}")
        self.image_hw = image_hw
        self.max_boxes = max_boxes

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        path, W, H, anns = self.items[index]
        image = decode_image(path, self.image_hw)
        boxes, labels, valid = _empty(self.max_boxes)
        for i, a in enumerate(anns[:self.max_boxes]):
            x, y, w, h = a["bbox"]
            boxes[i] = [(x + w / 2) / W, (y + h / 2) / H, w / W, h / H]
            labels[i] = self.cat_to_idx[a["category_id"]]
            valid[i] = True
        return {"images": image, "boxes": boxes, "labels": labels,
                "box_valid": valid}
