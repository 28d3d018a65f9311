"""EoMT instance and panoptic segmentation.

Port of ``lightly_train_tpu/tasks/eomt_instance_panoptic.py``: the EoMT
trunk and losses of ``eomt_semantic_segmentation.py`` with per-instance
(per-segment) targets. A batch carries its targets as a slot-id map
(``seg_map``, (H, W) int32, ``NO_SEGMENT`` where no slot) with each slot's
class (``seg_labels``) and flag (``seg_valid``). Validation collects each
batch's predictions on the host (``val_mode`` "collect"): instance
segmentation reduces them to mask mAP (``tasks/detection/metrics.py``),
panoptic segmentation merges the queries by a score-weighted per-pixel
argmax and reduces to PQ with the void rule.

The datasets read YOLO-seg label files, COCO instance JSON (polygons, RLE,
iscrowd left out) and COCO panoptic PNGs without PIL: the port's image
decoder, ``_data/polygon.py``'s rasterizer (PIL's rules) and
``_data/image_dataset.py::resize_nearest`` (PIL's NEAREST).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lightly_train_tpu_torch._data.image_dataset import (
    decode_image,
    resize_nearest,
)
from lightly_train_tpu_torch._data.png import decode_png
from lightly_train_tpu_torch._data.polygon import rasterize_polygons
from lightly_train_tpu_torch.errors import DatasetError
from lightly_train_tpu_torch.tasks.eomt_semantic_segmentation import (
    EoMTSemanticSegmentationArgs,
    EoMTSemanticSegmentationTrainModel,
    linear_resize_above_half,
)

NO_SEGMENT = 255


@dataclasses.dataclass
class EoMTInstanceSegmentationArgs(EoMTSemanticSegmentationArgs):
    max_instances: int = 50
    score_threshold: float = 0.5
    default_steps: int = 40_000


def resize_ids(maps: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) ids -> int32 (B, h, w) as ``jax.image.resize(...,
    "nearest")``: the source index ``floor((i + 0.5) * H / h)``, torch's
    "nearest-exact" (not its "nearest")."""
    return F.interpolate(maps[:, None].float(), size=tuple(hw),
                         mode="nearest-exact")[:, 0].int()


class EoMTInstanceSegmentationTrainModel(EoMTSemanticSegmentationTrainModel):
    task = "instance_segmentation"
    transform_kind = "instance_segmentation"
    val_mode = "collect"

    def _targets_from_ids(self, seg_map: torch.Tensor, labels: torch.Tensor,
                          slot_valid: torch.Tensor,
                          grid_hw: Tuple[int, int]):
        """The slots' (B, K, n) binary masks at the mask grid (the one-hot's
        antialiased linear resize thresholded at 0.5) and their flags."""
        K = labels.shape[1]
        m = seg_map.long()
        onehot = F.one_hot(
            torch.where(m == NO_SEGMENT, K, m), K + 1)[..., :K].float()
        t = linear_resize_above_half(onehot, grid_hw).float()
        return t.permute(0, 3, 1, 2).reshape(m.shape[0], K, -1), slot_valid

    def loss_fn(self, model, batch, generator, step):
        outputs, grid_hw = self._forward_train(model, batch["images"],
                                               generator, step)
        labels, valid = batch["seg_labels"], batch["seg_valid"]
        if self.args.use_point_sampling:
            # seg_map is the slot-id map (NO_SEGMENT: no slot).
            losses = self._loss_levels(outputs, grid_hw, generator,
                                       batch["seg_map"].int(), valid,
                                       labels)
        else:
            targets, valid = self._targets_from_ids(
                batch["seg_map"], labels, valid, grid_hw)
            losses = self._loss_levels(outputs, grid_hw, generator, None,
                                       valid, labels, targets=targets)
        return sum(losses), {}

    def _scores(self, cls_logits: torch.Tensor):
        scores = torch.softmax(cls_logits, dim=-1)[..., :self.args.num_classes]
        return scores.max(-1).values, scores.argmax(-1)

    def _targets_collected(self, batch, grid) -> Dict[str, torch.Tensor]:
        images = batch["images"]
        valid = batch.get("valid")
        return {
            "tgt_map": resize_ids(batch["seg_map"], grid),
            "tgt_labels": batch["seg_labels"],
            "tgt_valid": batch["seg_valid"],
            "sample_valid": (valid if valid is not None else torch.ones(
                images.shape[0], dtype=torch.bool, device=images.device)),
        }

    def val_step(self, model, batch) -> Dict[str, torch.Tensor]:
        cls_logits, mask_logits, grid = self._query_outputs(model,
                                                            batch["images"])
        best_score, best_label = self._scores(cls_logits)
        return {"pred_masks": torch.sigmoid(mask_logits) > 0.5,
                "pred_scores": best_score, "pred_labels": best_label,
                **self._targets_collected(batch, grid)}

    def val_finalize(self, collected) -> Dict[str, float]:
        """Mask mAP over the valid samples' predictions (score > 0.05) and
        targets at the mask grid; a target slot that the grid's nearest
        resize erased is dropped."""
        from lightly_train_tpu_torch.tasks.detection.metrics import (
            compute_map_generic,
        )

        predictions, targets = [], []
        for c in collected:
            c = {k: np.asarray(v) for k, v in c.items()}
            for b in range(c["pred_masks"].shape[0]):
                if not bool(c["sample_valid"][b]):
                    continue
                keep = c["pred_scores"][b] > 0.05
                predictions.append({
                    "masks": c["pred_masks"][b][keep],
                    "scores": c["pred_scores"][b][keep],
                    "labels": c["pred_labels"][b][keep],
                })
                K = c["tgt_labels"].shape[1]
                tmap = c["tgt_map"][b].reshape(-1)
                masks = np.stack([tmap == k for k in range(K)], axis=0)
                tv = c["tgt_valid"][b] & masks.any(1)
                targets.append({"masks": masks[tv],
                                "labels": c["tgt_labels"][b][tv]})

        def mask_iou(a, b):
            inter = (a[:, None] & b[None, :]).sum(-1).astype(np.float64)
            union = (a[:, None] | b[None, :]).sum(-1).astype(np.float64)
            return inter / np.maximum(union, 1e-9)

        out = compute_map_generic(predictions, targets, mask_iou, key="masks")
        return {"val_mask_map": out["map"], "val_mask_map50": out["map50"]}

    def predict(self, model, images):
        """(masks bool (B, Q, mh, mw), scores (B, Q), labels (B, Q))."""
        cls_logits, mask_logits, (mh, mw) = self._query_outputs(model,
                                                                images)
        best_score, best_label = self._scores(cls_logits)
        B, Q = best_score.shape
        return ((torch.sigmoid(mask_logits) > 0.5).reshape(B, Q, mh, mw),
                best_score, best_label)

    @property
    def watch_metric(self):
        return ("val_mask_map", "max")


@dataclasses.dataclass
class EoMTPanopticSegmentationArgs(EoMTInstanceSegmentationArgs):
    pass


class EoMTPanopticSegmentationTrainModel(EoMTInstanceSegmentationTrainModel):
    task = "panoptic_segmentation"
    transform_kind = "panoptic_segmentation"

    def _merged(self, cls_logits, mask_logits):
        """The winning query of each mask-grid pixel (the argmax of the
        mask probabilities weighted by each query's best class score), the
        scores and labels."""
        best_score, best_label = self._scores(cls_logits)
        weighted = torch.sigmoid(mask_logits) * best_score[..., None]
        return weighted.argmax(1), best_score, best_label

    def val_step(self, model, batch) -> Dict[str, torch.Tensor]:
        cls_logits, mask_logits, grid = self._query_outputs(model,
                                                            batch["images"])
        query_map, best_score, best_label = self._merged(cls_logits,
                                                         mask_logits)
        return {"pred_query_map": query_map, "pred_scores": best_score,
                "pred_labels": best_label,
                **self._targets_collected(batch, grid)}

    def val_finalize(self, collected) -> Dict[str, float]:
        """Panoptic quality: predicted segments (queries winning somewhere
        with a score above ``score_threshold``) matched to target segments
        of the same class at IoU > 0.5; an unmatched prediction lying
        mostly on void pixels is no false positive."""
        tp_iou = 0.0
        tp = fp = fn = 0
        for c in collected:
            c = {k: np.asarray(v) for k, v in c.items()}
            for b in range(c["pred_query_map"].shape[0]):
                if not bool(c["sample_valid"][b]):
                    continue
                qmap = c["pred_query_map"][b]
                scores, labels = c["pred_scores"][b], c["pred_labels"][b]
                tmap = c["tgt_map"][b].reshape(-1)
                tvalid, tlabels = c["tgt_valid"][b], c["tgt_labels"][b]
                pred_segs = [(q, labels[q], qmap == q)
                             for q in np.unique(qmap)
                             if scores[q] > self.args.score_threshold]
                gt_segs = [(k, tlabels[k], tmap == k)
                           for k in range(len(tvalid))
                           if tvalid[k] and (tmap == k).any()]
                matched_gt, matched_pred = set(), set()
                for pi, (_, pl, pm) in enumerate(pred_segs):
                    for gi, (_, gl, gm) in enumerate(gt_segs):
                        if gi in matched_gt or pl != gl:
                            continue
                        inter = float((pm & gm).sum())
                        union = float((pm | gm).sum())
                        iou = inter / max(union, 1e-9)
                        if iou > 0.5:
                            matched_gt.add(gi)
                            matched_pred.add(pi)
                            tp += 1
                            tp_iou += iou
                            break
                void = tmap == NO_SEGMENT
                for pi, (_, _, pm) in enumerate(pred_segs):
                    if pi in matched_pred:
                        continue
                    area = float(pm.sum())
                    if area > 0 and float((pm & void).sum()) / area > 0.5:
                        continue
                    fp += 1
                fn += len(gt_segs) - len(matched_gt)
        denom = tp + 0.5 * fp + 0.5 * fn
        return {"val_pq": float(tp_iou / denom if denom > 0 else 0.0)}

    def predict(self, model, images):
        """(segment map (B, mh, mw), labels (B, Q), scores (B, Q))."""
        cls_logits, mask_logits, (mh, mw) = self._query_outputs(model,
                                                                images)
        query_map, best_score, best_label = self._merged(cls_logits,
                                                         mask_logits)
        return query_map.reshape(-1, mh, mw), best_label, best_score

    @property
    def watch_metric(self):
        return ("val_pq", "max")


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


def _decode_rle_counts(s: str) -> List[int]:
    """pycocotools' compressed RLE counts string: 5 bits a character at
    ASCII 48 and up with a continuation bit, sign-extended, the runs after
    the first two delta-coded."""
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def decode_rle(segmentation: dict) -> np.ndarray:
    """A COCO RLE (compressed or list counts) as a bool (h, w) mask: runs
    in column-major order, starting with background."""
    h, w = segmentation["size"]
    counts = segmentation["counts"]
    if isinstance(counts, str):
        counts = _decode_rle_counts(counts)
    counts = np.asarray(counts, dtype=np.int64)
    values = np.zeros(len(counts), dtype=bool)
    values[1::2] = True
    flat = np.repeat(values, counts)
    flat = np.pad(flat, (0, max(0, h * w - flat.size)))[: h * w]
    return flat.reshape(w, h).T


_YOLO_IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def _empty_targets(hw: Tuple[int, int], slots: int) -> Dict[str, np.ndarray]:
    return {"seg_map": np.full(hw, NO_SEGMENT, np.int32),
            "seg_labels": np.zeros((slots,), np.int32),
            "seg_valid": np.zeros((slots,), bool)}


class YOLOInstanceSegmentationDataset:
    """YOLO segmentation labels (``class x1 y1 x2 y2 ...`` a line, the
    coordinates normalized to [0, 1], one ``.txt`` an image beside the
    images' tree) as slot-id map targets; a line of fewer than 3 points, or
    whose polygon covers no pixel, is skipped."""

    def __init__(self, images_dir: Path, labels_dir: Path, num_classes: int,
                 image_hw: Tuple[int, int] = (640, 640),
                 max_instances: int = 50):
        images_dir, labels_dir = Path(images_dir), Path(labels_dir)
        self.items = []
        for p in sorted(images_dir.rglob("*")):
            if p.suffix.lower() not in _YOLO_IMAGE_EXTENSIONS:
                continue
            label = labels_dir / p.relative_to(images_dir).with_suffix(".txt")
            self.items.append((str(p), str(label) if label.exists() else None))
        if not self.items:
            raise DatasetError(f"No images under {images_dir}")
        self.num_classes = num_classes
        self.image_hw = image_hw
        self.max_instances = max_instances

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        path, label_path = self.items[index]
        hw = self.image_hw
        out = {"images": decode_image(path, hw),
               **_empty_targets(hw, self.max_instances),
               "boxes": np.zeros((self.max_instances, 4), np.float32)}
        slot = 0
        lines = (Path(label_path).read_text().splitlines()
                 if label_path is not None else [])
        for line in lines:
            parts = line.split()
            if len(parts) < 7:  # class and at least 3 (x, y) points
                continue
            if slot >= self.max_instances:
                break
            coords = [float(v) for v in parts[1:]]
            if len(coords) % 2 == 1:
                coords = coords[:-1]
            poly = [c * (hw[1] if i % 2 == 0 else hw[0])
                    for i, c in enumerate(coords)]
            m = rasterize_polygons([poly], hw, (1.0, 1.0))
            if not m.any():
                continue
            out["seg_map"][m] = slot
            out["seg_labels"][slot] = int(float(parts[0]))
            out["seg_valid"][slot] = True
            xs, ys = coords[0::2], coords[1::2]
            x0, x1, y0, y1 = min(xs), max(xs), min(ys), max(ys)
            out["boxes"][slot] = [(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0,
                                  y1 - y0]
            slot += 1
        return out


class COCOInstanceSegmentationDataset:
    """COCO instance JSON (polygon or RLE segmentations) as slot-id map
    targets, annotations in file order, a later one painting over an
    earlier; iscrowd annotations are left out (their pixels stay
    ``NO_SEGMENT``), and a slot that ends with no pixel is not valid."""

    def __init__(self, images_dir: Path, annotations_json: Path,
                 image_hw: Tuple[int, int] = (640, 640),
                 max_instances: int = 50):
        images_dir = Path(images_dir)
        ann = json.loads(Path(annotations_json).read_text())
        cat_ids = sorted(c["id"] for c in ann.get("categories", []))
        self.cat_to_idx = {c: i for i, c in enumerate(cat_ids)}
        self.num_classes = len(cat_ids)
        by_image: Dict[int, List[dict]] = {}
        for a in ann.get("annotations", []):
            if a.get("segmentation") and not a.get("iscrowd", 0):
                by_image.setdefault(a["image_id"], []).append(a)
        self.items = []
        for im in ann.get("images", []):
            path = images_dir / im["file_name"]
            if path.exists():
                self.items.append((str(path), im["width"], im["height"],
                                   by_image.get(im["id"], [])))
        if not self.items:
            raise DatasetError(f"No images under {images_dir}")
        self.image_hw = image_hw
        self.max_instances = max_instances

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        path, W, H, anns = self.items[index]
        hw = self.image_hw
        out = {"images": decode_image(path, hw),
               **_empty_targets(hw, self.max_instances),
               "boxes": np.zeros((self.max_instances, 4), np.float32)}
        seg_map = out["seg_map"]
        sx, sy = hw[1] / W, hw[0] / H
        for slot, a in enumerate(anns[: self.max_instances]):
            seg = a["segmentation"]
            if isinstance(seg, list):
                m = rasterize_polygons(seg, hw, (sx, sy))
            elif isinstance(seg, dict) and "counts" in seg:
                m = resize_nearest(decode_rle(seg).astype(np.uint8), hw) > 0
            else:
                continue
            seg_map[m] = slot
            out["seg_labels"][slot] = self.cat_to_idx.get(a["category_id"], 0)
            out["seg_valid"][slot] = True
            if "bbox" in a:
                x, y, bw, bh = a["bbox"]
                out["boxes"][slot] = [(x + bw / 2) / W, (y + bh / 2) / H,
                                      bw / W, bh / H]
        present = np.bincount(seg_map[seg_map != NO_SEGMENT].ravel(),
                              minlength=self.max_instances)
        out["seg_valid"] &= present[: self.max_instances] > 0
        return out


class COCOPanopticSegmentationDataset:
    """COCO panoptic format: RGB id-encoded PNGs (id = R + 256 G + 256^2
    B) and the ``segments_info`` of each annotation; crowd segments are
    left out (their pixels stay ``NO_SEGMENT``)."""

    def __init__(self, images_dir: Path, panoptic_dir: Path,
                 annotations_json: Path,
                 image_hw: Tuple[int, int] = (640, 640),
                 max_segments: int = 50):
        images_dir, panoptic_dir = Path(images_dir), Path(panoptic_dir)
        ann = json.loads(Path(annotations_json).read_text())
        cat_ids = sorted(c["id"] for c in ann.get("categories", []))
        self.cat_to_idx = {c: i for i, c in enumerate(cat_ids)}
        self.num_classes = len(cat_ids)
        images_by_id = {im["id"]: im for im in ann.get("images", [])}
        self.items = []
        for a in ann.get("annotations", []):
            im = images_by_id.get(a["image_id"])
            if im is None:
                continue
            img_path = images_dir / im["file_name"]
            pan_path = panoptic_dir / a["file_name"]
            if img_path.exists() and pan_path.exists():
                self.items.append((str(img_path), str(pan_path),
                                   a["segments_info"]))
        if not self.items:
            raise DatasetError(f"No panoptic items under {images_dir}")
        self.image_hw = image_hw
        self.max_segments = max_segments

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        img_path, pan_path, segments = self.items[index]
        hw = self.image_hw
        rgb = decode_png(Path(pan_path).read_bytes(), pan_path)
        if rgb.ndim == 2:
            rgb = np.repeat(rgb[..., None], 3, axis=2)
        rgb = resize_nearest(rgb, hw).astype(np.int64)
        ids = rgb[..., 0] + 256 * rgb[..., 1] + 256 * 256 * rgb[..., 2]
        out = {"images": decode_image(img_path, hw),
               **_empty_targets(hw, self.max_segments)}
        slot = 0
        for s in segments:
            if s.get("iscrowd", 0):
                continue
            if slot >= self.max_segments:
                break
            out["seg_map"][ids == s["id"]] = slot
            out["seg_labels"][slot] = self.cat_to_idx.get(s["category_id"], 0)
            out["seg_valid"][slot] = True
            slot += 1
        return out
