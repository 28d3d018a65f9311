"""Detection datasets for the port's tests: YOLO box labels and a COCO
JSON over the same PNG images, written from a numpy seed (no test of its
own)."""

import json

import numpy as np

from lightly_train_tpu_torch._visualize.grids import write_png


def _boxes(rng, n):
    """n normalized cxcywh boxes inside the image."""
    wh = rng.uniform(0.1, 0.5, (n, 2))
    c = rng.uniform(wh / 2, 1 - wh / 2)
    return np.concatenate([c, wh], 1)


def write_detection(root, n=8, size=40, num_classes=3, boxes=(1, 4),
                    seed=0, fmt="yolo"):
    """``train`` and ``val`` splits of ``n`` images each, with 1-3 boxes
    an image (``boxes``: the range), as YOLO labels (``fmt`` "yolo") or a
    COCO JSON with one crowd annotation (``fmt`` "coco"); returns the
    ``data`` argument of ``train_object_detection``."""
    rng = np.random.default_rng(seed)
    data = {"format": fmt}
    if fmt == "yolo":
        data["num_classes"] = num_classes
    for split in ("train", "val"):
        img_dir = root / split / "images"
        img_dir.mkdir(parents=True)
        images, anns = [], []
        for i in range(n):
            write_png(rng.integers(0, 256, (size, size, 3), np.uint8),
                      img_dir / f"{i}.png")
            bx = _boxes(rng, int(rng.integers(*boxes)))
            cls = rng.integers(0, num_classes, len(bx))
            if fmt == "yolo":
                lbl = root / split / "labels"
                lbl.mkdir(parents=True, exist_ok=True)
                (lbl / f"{i}.txt").write_text("".join(
                    f"{c} {b[0]:.6f} {b[1]:.6f} {b[2]:.6f} {b[3]:.6f}\n"
                    for c, b in zip(cls, bx)))
                continue
            images.append({"id": i + 1, "file_name": f"{i}.png",
                           "width": size, "height": size})
            for c, b in zip(cls, bx):
                x, y = (b[0] - b[2] / 2) * size, (b[1] - b[3] / 2) * size
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": int(c) + 1, "iscrowd": 0,
                             "bbox": [x, y, b[2] * size, b[3] * size]})
        split_data = {"images": str(img_dir)}
        if fmt == "coco":
            anns.append({"id": len(anns) + 1, "image_id": 1,
                         "category_id": 1, "iscrowd": 1,
                         "bbox": [0.0, 0.0, 5.0, 5.0]})
            path = root / split / "annotations.json"
            path.write_text(json.dumps({
                "images": images, "annotations": anns,
                "categories": [{"id": c + 1, "name": f"class{c}"}
                               for c in range(num_classes)]}))
            split_data["annotations"] = str(path)
        else:
            split_data["labels"] = str(root / split / "labels")
        data[split] = split_data
    return data
