"""Instance and panoptic datasets for the port's EoMT tests (no test of
its own), written with the port's ``write_png`` from a numpy seed:

- a COCO instance JSON per split: polygons with fractional vertices, one
  overlapping another, a compressed RLE, a list-counts RLE, an iscrowd
  annotation, a degenerate polygon, and an annotation that a later one
  paints over whole (its slot ends empty);
- a YOLO-seg folder: triangles and quadrilaterals in normalized
  coordinates, a line of fewer than 3 points, one with an odd coordinate
  count, and an image without a label file;
- COCO panoptic: RGB id-encoded PNGs (id = R + 256 G + 256^2 B) with a
  crowd segment and void pixels.
"""

import json

import numpy as np

from lightly_train_tpu_torch._visualize.grids import write_png


def encode_rle(mask: np.ndarray) -> dict:
    """pycocotools' compressed RLE of a bool (h, w) mask: the list counts,
    the runs after the first two as deltas, 5 bits a character from ASCII
    48 with a continuation bit."""
    counts = rle_counts(mask)
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not c & 0x10) or (x == -1 and c & 0x10))
            out.append(chr((c | 0x20 if more else c) + 48))
    return {"size": list(mask.shape), "counts": "".join(out)}


def rle_counts(mask: np.ndarray) -> list:
    """The uncompressed (list) counts of a bool (h, w) mask."""
    flat = mask.T.reshape(-1)
    counts, current, run = [], False, 0
    for v in flat:
        if v != current:
            counts.append(run)
            current, run = v, 0
        run += 1
    counts.append(run)
    return counts


def _images(folder, n, size, seed):
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_png(rng.integers(0, 256, (size[0], size[1], 3), np.uint8),
                  folder / f"{i}.png")


def write_coco_instance(root, n=6, size=(40, 48), seed=0):
    """{"train": {"images", "annotations"}, "val": ...}: see the module."""
    rng = np.random.default_rng(seed)
    h, w = size
    data = {}
    for split in ("train", "val"):
        d = root / split
        _images(d, n, size, seed + (split == "val"))
        images, anns = [], []
        for i in range(n):
            images.append({"id": i, "file_name": f"{i}.png", "width": w,
                           "height": h})

            def add(seg, cat, crowd=0):
                anns.append({"id": len(anns), "image_id": i,
                             "category_id": cat, "segmentation": seg,
                             "iscrowd": crowd, "bbox": [2.0, 3.0, 10.0, 8.0],
                             "area": 1.0})

            x0, y0 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            add([[x0, y0, x0 + 15.3, y0 + 1.7, x0 + 9.6, y0 + 14.2]], 3)
            add([[x0 + 5.5, y0 + 4.5, x0 + 22.25, y0 + 6.5, x0 + 20.75,
                  y0 + 19.5, x0 + 7.5, y0 + 17.0]], 7)
            rle = np.zeros((h, w), bool)
            rle[h // 2:h // 2 + 9, w // 3:w // 3 + 11] = True
            add(encode_rle(rle), 5)
            block = np.zeros((h, w), bool)
            block[2:9, w - 12:w - 2] = True
            add({"size": [h, w], "counts": rle_counts(block)}, 3)
            add([[1, 1, 6, 1, 6, 6]], 7, crowd=1)
            add([[3.0, 3.0, 9.0, 3.0]], 5)  # fewer than 3 points
            if i % 2:
                # Painted over whole by the next one: an empty slot.
                add([[x0 + 1, y0 + 1, x0 + 3, y0 + 1, x0 + 3, y0 + 3]], 5)
                add([[x0, y0, x0 + 6, y0, x0 + 6, y0 + 6, x0, y0 + 6]], 3)
        (d / "ann.json").write_text(json.dumps({
            "images": images, "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in (3, 5, 7)]}))
        data[split] = {"images": str(d), "annotations": str(d / "ann.json")}
    return data


def write_yolo_instance(root, n=6, size=(40, 48), seed=1, num_classes=3):
    """{"format": "yolo", "num_classes", "train": {"images", "labels"},
    "val": ...}: see the module."""
    rng = np.random.default_rng(seed)
    data = {"format": "yolo", "num_classes": num_classes}
    for split in ("train", "val"):
        images, labels = root / split / "images", root / split / "labels"
        _images(images, n, size, seed + (split == "val"))
        labels.mkdir(parents=True)
        for i in range(n - 1):  # the last image has no label file
            lines = []
            for _ in range(3):
                k = int(rng.integers(3, 5))
                pts = rng.uniform(0.05, 0.95, 2 * k)
                lines.append(f"{int(rng.integers(0, num_classes))} "
                             + " ".join(f"{v:.4f}" for v in pts))
            lines.append("1 0.2 0.2 0.3 0.3")  # fewer than 3 points
            lines.append("2 0.5 0.5 0.9 0.5 0.7 0.9 0.4")  # odd count
            (labels / f"{i}.txt").write_text("\n".join(lines))
        data[split] = {"images": str(images), "labels": str(labels)}
    return data


def write_coco_panoptic(root, n=6, size=(40, 48), seed=2):
    """{"train": {"images", "panoptic", "annotations"}, "val": ...}: see
    the module."""
    rng = np.random.default_rng(seed)
    h, w = size
    data = {}
    for split in ("train", "val"):
        d = root / split
        _images(d / "images", n, size, seed + (split == "val"))
        (d / "panoptic").mkdir(parents=True)
        images, anns = [], []
        for i in range(n):
            ids = np.zeros((h, w), np.int64)  # 0: void
            segments = []
            for s in range(4):
                sid = int(rng.integers(1, 2 ** 24))
                y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
                ids[y:y + int(rng.integers(6, 20)),
                    x:x + int(rng.integers(6, 24))] = sid
                segments.append({"id": sid, "category_id": [1, 2, 4][s % 3],
                                 "iscrowd": int(s == 3)})
            rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1)
            write_png(rgb.astype(np.uint8), d / "panoptic" / f"{i}.png")
            images.append({"id": i, "file_name": f"{i}.png", "width": w,
                           "height": h})
            anns.append({"image_id": i, "file_name": f"{i}.png",
                         "segments_info": segments})
        (d / "ann.json").write_text(json.dumps({
            "images": images, "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in (1, 2, 4)]}))
        data[split] = {"images": str(d / "images"),
                       "panoptic": str(d / "panoptic"),
                       "annotations": str(d / "ann.json")}
    return data
