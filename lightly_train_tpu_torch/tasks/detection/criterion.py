"""The DETR criterion: matching, the GO union, VFL + L1 + GIoU and D-FINE's
FGL/DDF losses.

Port of ``lightly_train_tpu/tasks/detection/criterion.py``. The matching
cost (focal class cost, L1, GIoU) is computed on the device; the
assignment is ``eomt_semantic_segmentation.py::hungarian_match`` (the exact
Hungarian on the host, or the JAX package's greedy device matcher with
``LIGHTLY_TRAIN_MATCHER=greedy``), and the GO union of every level's
matches runs on the host (:func:`go_union`) or, with the greedy matcher,
on the device (:func:`go_union_device`). Each host round trip is counted
in :data:`HOST_SYNCS`. Targets are fixed-shape (B, K) padded boxes with
valid flags.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lightly_train_tpu_torch._env import Env
from lightly_train_tpu_torch.tasks.detection.box_utils import (
    at_least,
    clip,
    cxcywh_to_xyxy,
    generalized_box_iou,
    paired_box_iou,
    paired_generalized_box_iou,
)
from lightly_train_tpu_torch.tasks.detection.dfine_utils import bbox2distance
from lightly_train_tpu_torch.tasks.eomt_semantic_segmentation import (
    hungarian_match,
)

# Host round trips of the criterion (the exact matcher's and the GO
# union's), counted for the runtime's report; reset it to 0 to count a
# window.
HOST_SYNCS = {"hungarian": 0, "go_union": 0}


def _uses_greedy() -> bool:
    return Env.LIGHTLY_TRAIN_MATCHER.value == "greedy"


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None], axis=1)``: x (B, Q, ...) at
    the (B, G) query indices."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return x.gather(1, flat.long())


def detection_matching_cost(logits: torch.Tensor, boxes: torch.Tensor,
                            tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                            alpha: float = 0.25,
                            gamma: float = 2.0) -> torch.Tensor:
    """(B, Q, K) cost of (B, Q, C + 1) logits and cxcywh boxes against the
    targets: 2 focal class cost + 5 L1 + 2 (-GIoU)."""
    prob = torch.sigmoid(logits[..., :-1])
    Q = prob.shape[1]
    p = prob.gather(2, tgt_labels.long()[:, None, :].expand(-1, Q, -1))
    neg_cost = (1 - alpha) * (p ** gamma) * (-torch.log(1 - p + 1e-8))
    pos_cost = alpha * ((1 - p) ** gamma) * (-torch.log(p + 1e-8))
    cost_class = pos_cost - neg_cost
    cost_l1 = (boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    cost_giou = -generalized_box_iou(cxcywh_to_xyxy(boxes),
                                     cxcywh_to_xyxy(tgt_boxes))
    return 2.0 * cost_class + 5.0 * cost_l1 + 2.0 * cost_giou


def go_union_host(assign_stack: np.ndarray, valid: np.ndarray, n_pairs: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The GO (global-optimal) union of (L, B, K) per-level assignments:
    every level's (query, target) matches, counted, sorted by count
    descending (stable, the unique pairs ascending first), one target kept
    per query; padded to ``n_pairs``."""
    L, B, K = assign_stack.shape
    out_q = np.zeros((B, n_pairs), np.int64)
    out_t = np.zeros((B, n_pairs), np.int64)
    out_v = np.zeros((B, n_pairs), bool)
    for b in range(B):
        pairs = [(int(assign_stack[li, b, k]), k) for li in range(L)
                 for k in range(K)
                 if valid[b, k] and assign_stack[li, b, k] >= 0]
        if not pairs:
            continue
        uniq, counts = np.unique(np.asarray(pairs, np.int64), axis=0,
                                 return_counts=True)
        seen: Dict[int, int] = {}
        for q, t in uniq[np.argsort(-counts, kind="stable")]:
            if int(q) not in seen:
                seen[int(q)] = int(t)
        for j, (q, t) in enumerate(list(seen.items())[:n_pairs]):
            out_q[b, j], out_t[b, j], out_v[b, j] = q, t, True
    return out_q, out_t, out_v


def go_union(assignments: torch.Tensor, valid: torch.Tensor, n_pairs: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(L, B, K) assignments -> ((B, G) query indices, (B, G) target
    indices, (B, G) flags), G = ``n_pairs``, by :func:`go_union_host`: one
    host round trip."""
    HOST_SYNCS["go_union"] += 1
    q, t, v = go_union_host(assignments.cpu().numpy(), valid.cpu().numpy(),
                            n_pairs)
    dev = assignments.device
    return (torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev),
            torch.from_numpy(v).to(dev))


def go_union_device(assignments: torch.Tensor, valid: torch.Tensor,
                    n_pairs: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's device GO union (the greedy matcher's): for each
    query index below ``n_pairs`` its most frequent target across the
    levels (the first of equal counts)."""
    ok = (assignments >= 0) & valid[None]
    Q = n_pairs
    q_idx = assignments.clamp(0, Q - 1)
    onehot = F.one_hot(q_idx.long(), Q).float() * ok[..., None].float()
    counts = onehot.sum(0).transpose(1, 2)  # (B, Q, K)
    best_t = counts.argmax(-1)
    has = counts.max(-1).values > 0
    B = valid.shape[0]
    go_q = torch.arange(Q, device=valid.device)[None].expand(B, Q)
    return go_q, torch.where(has, best_t, 0), has


def dfine_fgl_ddf_loss(dist: torch.Tensor, anchor: torch.Tensor,
                       pred_boxes: torch.Tensor,
                       teacher_dist: Optional[torch.Tensor],
                       teacher_logits: Optional[torch.Tensor],
                       tgt_boxes: torch.Tensor, go_q: torch.Tensor,
                       go_t: torch.Tensor, go_valid: torch.Tensor,
                       num_boxes_go: torch.Tensor, *, reg_scale: float = 4.0,
                       up: float = 0.5, T: float = 5.0,
                       is_final: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(FGL, DDF) of one level: FGL the distribution focal loss at the
    W(n)-bin targets, IoU-weighted per edge, summed over ``num_boxes_go``;
    DDF the KL distillation of this level's corner distributions from the
    final layer's, matched queries weighted by IoU, the others by the
    teacher's top class probability (0 on the final level)."""
    B, Q, _, nb = dist.shape
    reg_max = nb - 1
    g = go_valid.float()
    d_go = _rows(dist, go_q)  # (B, G, 4, nb)
    anchor_go, pred_go = _rows(anchor, go_q), _rows(pred_boxes, go_q)
    tgt_go = _rows(tgt_boxes, go_t)
    idx, w_r, w_l = bbox2distance(anchor_go, cxcywh_to_xyxy(tgt_go), reg_max,
                                  reg_scale, up)
    left = idx.long()
    right = (left + 1).clamp(0, reg_max)
    logp = F.log_softmax(d_go.float(), dim=-1)
    ce_l = -logp.gather(-1, left[..., None])[..., 0]
    ce_r = -logp.gather(-1, right[..., None])[..., 0]
    dfl = ce_l * w_l + ce_r * w_r
    iou = paired_box_iou(cxcywh_to_xyxy(pred_go),
                         cxcywh_to_xyxy(tgt_go)).detach()
    loss_fgl = (dfl * (iou * g)[..., None]).sum() / num_boxes_go
    if teacher_dist is None or is_final:
        return loss_fgl, torch.zeros((), device=dist.device)

    t_logp = F.log_softmax(teacher_dist.detach().float() / T, dim=-1)
    s_logp = F.log_softmax(dist.float() / T, dim=-1)
    kl = (t_logp.exp() * (t_logp - s_logp)).sum(-1)  # (B, Q, 4)
    w_local = torch.sigmoid(teacher_logits.detach()).max(-1).values
    target = torch.where(go_valid, go_q, Q).long()
    mask = torch.zeros((B, Q + 1), dtype=torch.bool, device=dist.device)
    mask.scatter_(1, target, True)
    w_local = torch.cat([w_local, w_local.new_zeros((B, 1))], 1).scatter(
        1, target, torch.where(go_valid, iou, 0.0))
    mask, w_local = mask[:, :Q], w_local[:, :Q]
    kl_w = kl * (T ** 2) * w_local[..., None]
    m4 = mask[..., None].expand(-1, -1, 4).float()
    batch_scale = 8.0 / B
    num_pos = torch.sqrt(m4.sum() * batch_scale)
    num_neg = torch.sqrt((1.0 - m4).sum() * batch_scale)
    pos_mean = (kl_w * m4).sum() / m4.sum().clamp(min=1.0)
    neg_mean = (kl_w * (1.0 - m4)).sum() / (1.0 - m4).sum().clamp(min=1.0)
    loss_ddf = (pos_mean * num_pos + neg_mean * num_neg) / (
        num_pos + num_neg).clamp(min=1e-9)
    return loss_fgl, loss_ddf


def box_losses_on_pairs(boxes: torch.Tensor, tgt_boxes: torch.Tensor,
                        q_idx: torch.Tensor, t_idx: torch.Tensor,
                        pair_valid: torch.Tensor, num: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L1, 1 - GIoU) summed over the given (query, target) pairs, over
    ``num``."""
    pred, tgt = _rows(boxes, q_idx), _rows(tgt_boxes, t_idx)
    v = pair_valid.float()
    l1 = (pred - tgt).abs().sum(-1)
    giou = paired_generalized_box_iou(cxcywh_to_xyxy(pred),
                                      cxcywh_to_xyxy(tgt))
    return (l1 * v).sum() / num, ((1.0 - giou) * v).sum() / num


def detection_loss_from_assignment(logits: torch.Tensor, boxes: torch.Tensor,
                                   tgt_labels: torch.Tensor,
                                   tgt_boxes: torch.Tensor,
                                   assignment: torch.Tensor,
                                   alpha: float = 0.75, gamma: float = 2.0
                                   ) -> Dict[str, torch.Tensor]:
    """Varifocal loss + L1 + GIoU for a known (B, K) target -> query
    assignment (-1: none); the matched and the denoising paths share it."""
    B, Q, C1 = logits.shape
    C = C1 - 1
    assigned = assignment >= 0
    safe_q = assignment.clamp(min=0)
    matched = _rows(boxes, safe_q)
    pair_iou = paired_box_iou(cxcywh_to_xyxy(matched),
                              cxcywh_to_xyxy(tgt_boxes)).detach() * assigned
    # The target score map (B, Q, C): the IoU at each matched (query,
    # class), and its one-hot (a zero-IoU match is still positive).
    flat = (torch.where(assigned, safe_q, Q) * C
            + torch.where(assigned, tgt_labels.long(), 0)).long()
    target_scores = torch.zeros((B, (Q + 1) * C), device=logits.device)
    target_scores.scatter_reduce_(1, flat, torch.where(assigned, pair_iou,
                                                       0.0), "amax")
    onehot = torch.zeros((B, (Q + 1) * C), device=logits.device)
    onehot.scatter_reduce_(1, flat, assigned.float(), "amax")
    target_scores = target_scores.reshape(B, Q + 1, C)[:, :Q]
    onehot = onehot.reshape(B, Q + 1, C)[:, :Q]
    x = logits[..., :C]
    prob = torch.sigmoid(x).detach()
    weight = alpha * (prob ** gamma) * (1 - onehot) + target_scores
    bce = (at_least(x, 0.0) - x * target_scores
           + torch.log1p(torch.exp(-x.abs())))
    n_matched = assigned.sum().float().clamp(min=1.0)
    loss_vfl = (bce * weight).sum() / n_matched
    l1 = (matched - tgt_boxes).abs().sum(-1)
    giou = paired_generalized_box_iou(cxcywh_to_xyxy(matched),
                                      cxcywh_to_xyxy(tgt_boxes))
    return {"loss_vfl": loss_vfl,
            "loss_l1": (l1 * assigned).sum() / n_matched,
            "loss_giou": ((1.0 - giou) * assigned).sum() / n_matched}


def match_levels(outputs: List[Tuple[torch.Tensor, torch.Tensor]],
                 tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                 tgt_valid: torch.Tensor) -> List[torch.Tensor]:
    """Each level's (B, K) assignment of its clamped boxes."""
    out = []
    for logits, boxes in outputs:
        cost = detection_matching_cost(logits, boxes, tgt_labels, tgt_boxes)
        if not _uses_greedy():
            HOST_SYNCS["hungarian"] += 1
        out.append(hungarian_match(cost.detach(), tgt_valid))
    return out


def detection_criterion(outputs: List[Tuple[torch.Tensor, torch.Tensor]],
                        tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                        tgt_valid: torch.Tensor,
                        weights: Optional[Dict[str, float]] = None,
                        dists: Optional[List] = None,
                        fgl_weight: float = 0.15, ddf_weight: float = 1.5,
                        reg_scale: float = 4.0, up: float = 0.5
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """D-FINE's criterion over all levels, summed: each level's own
    matching drives its VFL (over the target count); L1, GIoU and the
    FGL/DDF losses use the GO union of all levels' matches (over the GO
    pair count). ``dists``: per level (corner logits, anchor) or None; the
    last given one is the DDF teacher. Returns (loss, the last level's
    losses)."""
    if weights is None:
        weights = {"loss_vfl": 1.0, "loss_l1": 5.0, "loss_giou": 2.0}
    K = tgt_valid.shape[1]
    Q = outputs[0][0].shape[1]
    # Predicted boxes clamped to [0, 1] before every cost and loss (the
    # reference's sanitize_boxes); the clamp is in the gradient.
    outputs = [(lg, clip(bx, 0.0, 1.0)) for lg, bx in outputs]
    assignments = match_levels(outputs, tgt_labels, tgt_boxes, tgt_valid)
    stack = torch.stack(assignments)
    n_pairs = min(Q, len(outputs) * K)
    if _uses_greedy():
        go_q, go_t, go_valid = go_union_device(stack, tgt_valid, n_pairs)
    else:
        go_q, go_t, go_valid = go_union(stack, tgt_valid, n_pairs)
    num_go = go_valid.sum().float().clamp(min=1.0)
    teacher = None
    if dists is not None:
        teacher = next((d for d in reversed(dists) if d is not None), None)
    total = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    for li, (logits, boxes) in enumerate(outputs):
        losses = detection_loss_from_assignment(logits, boxes, tgt_labels,
                                                tgt_boxes, assignments[li])
        losses["loss_l1"], losses["loss_giou"] = box_losses_on_pairs(
            boxes, tgt_boxes, go_q, go_t, go_valid, num_go)
        level_total = sum(weights[k] * v for k, v in losses.items())
        if dists is not None and li < len(dists) and dists[li] is not None:
            dist_logits, anchor = dists[li]
            fgl, ddf = dfine_fgl_ddf_loss(
                dist_logits, anchor, boxes,
                teacher[0] if teacher is not None else None,
                outputs[-1][0], tgt_boxes, go_q, go_t, go_valid, num_go,
                reg_scale=reg_scale, up=up,
                is_final=li == len(outputs) - 1)
            level_total = level_total + fgl_weight * fgl + ddf_weight * ddf
            losses = {**losses, "loss_fgl": fgl, "loss_ddf": ddf}
        total = total + level_total
        if li == len(outputs) - 1:
            metrics.update(losses)
    return total, metrics
