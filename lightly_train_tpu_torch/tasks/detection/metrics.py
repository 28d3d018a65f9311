"""COCO-style mAP on the host (numpy).

Port of ``lightly_train_tpu/tasks/detection/metrics.py``, whole: the
COCOeval protocol (torchmetrics' MeanAveragePrecision with the pycocotools
backend): mAP@[.5:.95] with 101-point interpolated precision, per-class AP
averaged over the classes with ground truth, the per-image per-class
``maxDets`` cap, the area ranges (small < 32^2 <= medium < 96^2 <= large)
with pycocotools' ignore rules (a ground truth outside the range is
ignored; a detection matched to an ignored one, or unmatched and outside
the range, is no false positive), and the mean average recall (mar_1, 10,
100 and by area). Crowd regions are left out by the datasets, so the crowd
branch of COCOeval never applies.

Validation collects each image's regions (boxes, or masks for instance
segmentation through :func:`compute_map_generic`), scores and labels on
the host; this module reduces them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# pycocotools areaRng for 'all', 'small', 'medium', 'large'.
_AREA_RANGES: Tuple[Tuple[str, float, float], ...] = (
    ("all", 0.0, 1e10),
    ("small", 0.0, 32.0 ** 2),
    ("medium", 32.0 ** 2, 96.0 ** 2),
    ("large", 96.0 ** 2, 1e10),
)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a: (N, 4), b: (M, 4) xyxy -> (N, M)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None
    )
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None
    )
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _box_area(regions: np.ndarray) -> np.ndarray:
    r = np.asarray(regions, np.float64).reshape(len(regions), 4)
    return np.clip(r[:, 2] - r[:, 0], 0, None) * np.clip(
        r[:, 3] - r[:, 1], 0, None
    )


def _mask_area(regions: np.ndarray) -> np.ndarray:
    r = np.asarray(regions)
    return r.reshape(len(r), -1).astype(np.float64).sum(axis=1)


def compute_map(
    predictions: List[Dict[str, np.ndarray]],
    targets: List[Dict[str, np.ndarray]],
    iou_thresholds: np.ndarray | None = None,
) -> Dict[str, float]:
    """predictions[i]: {boxes (N,4) xyxy, scores (N,), labels (N,)};
    targets[i]: {boxes (M,4) xyxy, labels (M,)}. Returns the COCOeval
    summary dict (map, map_50, map_75, area + maxDets breakdowns)."""
    return compute_map_generic(
        predictions, targets, _iou_matrix, key="boxes",
        iou_thresholds=iou_thresholds,
    )


def _match_image(
    ious: Optional[np.ndarray],  # (n_dt_capped, n_gt) or None
    gt_ignore: np.ndarray,  # (n_gt,) bool — out of area range
    dt_out_of_range: np.ndarray,  # (n_dt_capped,) bool
    thr: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """COCOeval.evaluateImg matching for one (image, class, threshold,
    area-range): greedy over detections in score order; each detection takes
    the highest-IoU not-yet-matched GT above ``thr``, preferring non-ignored
    GTs (an ignored GT only matches once no eligible non-ignored GT remains).

    Returns (tp, ignore) flags per capped detection.
    """
    n_dt = len(dt_out_of_range)
    tp = np.zeros(n_dt, bool)
    dt_ig = np.zeros(n_dt, bool)
    if ious is None or ious.shape[1] == 0:
        dt_ig = dt_out_of_range.copy()
        return tp, dt_ig
    # GTs sorted ignored-last (stable) — COCOeval's `gtind` ordering.
    order = np.argsort(gt_ignore, kind="stable")
    gt_matched = np.zeros(ious.shape[1], bool)
    for d in range(n_dt):
        best = -1
        best_iou = min(thr, 1 - 1e-10)
        for g in order:
            if gt_matched[g]:
                continue
            # Ignored GTs come after every non-ignored one; once a real
            # match exists, stop before the ignored block.
            if best > -1 and not gt_ignore[best] and gt_ignore[g]:
                break
            if ious[d, g] < best_iou:
                continue
            best_iou = ious[d, g]
            best = g
        if best == -1:
            dt_ig[d] = dt_out_of_range[d]
            continue
        gt_matched[best] = True
        if gt_ignore[best]:
            dt_ig[d] = True
        else:
            tp[d] = True
    return tp, dt_ig


def compute_map_generic(
    predictions: List[Dict[str, np.ndarray]],
    targets: List[Dict[str, np.ndarray]],
    iou_fn,
    key: str = "boxes",
    iou_thresholds: np.ndarray | None = None,
    max_dets: Sequence[int] = (1, 10, 100),
    area_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> Dict[str, float]:
    """mAP over arbitrary region representations (boxes, binary masks, ...).

    ``iou_fn(a, b)`` computes a pairwise IoU matrix for stacked regions under
    ``predictions[i][key]`` / ``targets[i][key]`` (mask mAP for instance
    segmentation passes flattened bool masks). ``area_fn`` maps a stacked
    region array to per-region pixel areas for the area-range breakdown
    (default: box area for ``key="boxes"``, pixel count otherwise, matching
    pycocotools' use of the annotation/RLE area).
    """
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    iou_thresholds = np.asarray(iou_thresholds, np.float64)
    if area_fn is None:
        area_fn = _box_area if key == "boxes" else _mask_area
    max_dets = sorted(int(m) for m in max_dets)
    top_det = max_dets[-1]
    rec_thrs = np.linspace(0.0, 1.0, 101)

    classes = set()
    for t in targets:
        classes.update(np.unique(t["labels"]).tolist())
    zeros = {
        "map": 0.0, "map50": 0.0, "map_50": 0.0, "map_75": 0.0,
        "map_small": 0.0, "map_medium": 0.0, "map_large": 0.0,
        **{f"mar_{m}": 0.0 for m in max_dets},
        "mar_small": 0.0, "mar_medium": 0.0, "mar_large": 0.0,
    }
    if not classes:
        return zeros
    classes = sorted(classes)
    T, A, M, K = len(iou_thresholds), len(_AREA_RANGES), len(max_dets), len(classes)
    # -1 marks (class, area) cells with no ground truth — excluded from means
    # exactly as COCOeval.summarize does.
    ap = np.full((T, A, M, K), -1.0)
    ar = np.full((T, A, M, K), -1.0)

    for ci, c in enumerate(classes):
        # Per-image capped detections + GTs of class c.
        per_img = []  # (scores_sorted, ious, gt_areas, dt_areas)
        for p, t in zip(predictions, targets):
            sel = np.asarray(p["labels"]) == c
            scores = np.asarray(p["scores"])[sel]
            regions = np.asarray(p[key])[sel]
            order = np.argsort(-scores, kind="stable")[:top_det]
            scores, regions = scores[order], regions[order]
            gsel = np.asarray(t["labels"]) == c
            g_regions = np.asarray(t[key])[gsel]
            ious = (
                iou_fn(regions, g_regions)
                if len(regions) and len(g_regions)
                else None
            )
            per_img.append((
                scores,
                ious,
                area_fn(g_regions) if len(g_regions) else np.zeros(0),
                area_fn(regions) if len(regions) else np.zeros(0),
            ))

        for ai, (_, a0, a1) in enumerate(_AREA_RANGES):
            npig = sum(
                int(((ga >= a0) & (ga < a1)).sum())
                for (_, _, ga, _) in per_img
            )
            if npig == 0:
                continue
            for mi, md in enumerate(max_dets):
                for ti, thr in enumerate(iou_thresholds):
                    all_scores, all_tp, all_ig = [], [], []
                    for scores, ious, g_areas, d_areas in per_img:
                        n = min(len(scores), md)
                        if n == 0:
                            continue
                        gt_ig = ~((g_areas >= a0) & (g_areas < a1))
                        dt_oor = ~(
                            (d_areas[:n] >= a0) & (d_areas[:n] < a1)
                        )
                        tp, ig = _match_image(
                            ious[:n] if ious is not None else None,
                            gt_ig, dt_oor, float(thr),
                        )
                        all_scores.append(scores[:n])
                        all_tp.append(tp)
                        all_ig.append(ig)
                    if not all_scores:
                        ap[ti, ai, mi, ci] = 0.0
                        ar[ti, ai, mi, ci] = 0.0
                        continue
                    scores = np.concatenate(all_scores)
                    tp = np.concatenate(all_tp)
                    ig = np.concatenate(all_ig)
                    order = np.argsort(-scores, kind="stable")
                    tp, ig = tp[order], ig[order]
                    keep = ~ig
                    tps = np.cumsum(tp[keep].astype(np.float64))
                    fps = np.cumsum((~tp[keep]).astype(np.float64))
                    recall = tps / npig
                    precision = tps / np.maximum(tps + fps, 1e-12)
                    ar[ti, ai, mi, ci] = recall[-1] if len(recall) else 0.0
                    # Precision envelope + 101-point interpolation
                    # (COCOeval.accumulate).
                    for i in range(len(precision) - 1, 0, -1):
                        precision[i - 1] = max(precision[i - 1], precision[i])
                    idx = np.searchsorted(recall, rec_thrs, side="left")
                    q = np.where(
                        idx < len(precision),
                        precision[np.minimum(idx, max(len(precision) - 1, 0))]
                        if len(precision)
                        else 0.0,
                        0.0,
                    )
                    ap[ti, ai, mi, ci] = float(np.mean(q))

    def _mean(x: np.ndarray) -> float:
        # Cells with no ground truth stay -1 and are excluded; a summary
        # over only-empty cells is -1 like torchmetrics/pycocotools report.
        v = x[x > -1]
        return float(v.mean()) if v.size else -1.0

    i50 = int(np.argmin(np.abs(iou_thresholds - 0.5)))
    i75 = int(np.argmin(np.abs(iou_thresholds - 0.75)))
    mi_top = len(max_dets) - 1
    out = {
        "map": _mean(ap[:, 0, mi_top]),
        "map_50": _mean(ap[i50, 0, mi_top]),
        "map_75": _mean(ap[i75, 0, mi_top]),
        "map_small": _mean(ap[:, 1, mi_top]),
        "map_medium": _mean(ap[:, 2, mi_top]),
        "map_large": _mean(ap[:, 3, mi_top]),
        "mar_small": _mean(ar[:, 1, mi_top]),
        "mar_medium": _mean(ar[:, 2, mi_top]),
        "mar_large": _mean(ar[:, 3, mi_top]),
    }
    for mi, md in enumerate(max_dets):
        out[f"mar_{md}"] = _mean(ar[:, 0, mi])
    out["map50"] = out["map_50"]  # legacy key (r3 logger schema)
    return out
