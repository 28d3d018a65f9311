"""EoMT (Encoder-only Mask Transformer) semantic segmentation.

Port of ``lightly_train_tpu/tasks/eomt_semantic_segmentation.py``: learned
queries join the ViT's token stream for its last ``num_joint_blocks``
blocks; the shared heads (the backbone's final ``norm``, one ``class_head``
(D -> C+1), a 3-layer ``mask_head`` and two 2x upscaling blocks) predict
class and mask logits at the entry of each joint block and once after the
last, and the Mask2Former losses of these ``num_joint_blocks + 1`` levels
are summed. In training each joint block's query rows attend only to the
patches its level's mask predicts (the logits resized bilinearly to the
patch grid, thresholded at 0), each query released from that mask with
probability ``1 - mask_prob[j]``, annealed to 0 over the run, so inference
runs unmasked. The masked attention is the plain
``ops/kernels/attention.py::dot_product_attention`` (the JAX ViT runs XLA's
there); the plain blocks, and every block in inference, run the
flat-attention kernels on the card.

The trunk (:class:`EoMTTrunk`) is the port's ``VisionTransformer`` with the
queries, heads and upscaling blocks added, so its backbone names are the
ViT's and a pretrained export loads into it.

Matching (:func:`hungarian_match`): ``LIGHTLY_TRAIN_MATCHER`` "auto" and
"hungarian" run the exact Hungarian assignment (scipy's
``linear_sum_assignment`` on the host); "greedy" the JAX package's greedy
matcher, on the device. The JAX package's "auto" picks greedy on the TPU
and on a multi-device CPU; the port's picks the exact one everywhere.

Losses: the point-sampled Mask2Former loss by default (the matching costs
at shared uniform points, sampled from the mask logits' factors, CE and
dice of the matched masks at importance-sampled points, class CE with
``no_object_weight``), the full-mask one with ``use_point_sampling=False``.
Every random draw goes through ``ops/point_sampling.py::uniform``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch._env import Env
from lightly_train_tpu_torch._transforms.task_transforms import ids_present
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.models.vit import (
    LayerNorm,
    Linear,
    VisionTransformer,
    ViTConfig,
    lecun_normal_,
)
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.ops import point_sampling as PS
from lightly_train_tpu_torch.tasks.base import (
    TaskArgs,
    TaskModule,
    TaskTrainModel,
)
from lightly_train_tpu_torch.tasks.image_classification import confusion
from lightly_train_tpu_torch.tasks.semantic_segmentation_linear import miou


@dataclasses.dataclass
class EoMTSemanticSegmentationArgs(TaskArgs):
    num_classes: int = 150
    num_queries: int = 100
    # None: by depth, 3 for 12 blocks (t/s/b), 4 up to 24 (ViT-L), else 5.
    num_joint_blocks: Optional[int] = None
    num_upscale_blocks: int = 2
    ignore_index: int = 255
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    no_object_weight: float = 0.1
    attn_mask_annealing: bool = True
    # Per joint block [start, end) annealing windows; None: the run split
    # into num_joint_blocks + 2 equal phases, block j annealing over phase
    # j + 1.
    attn_mask_annealing_steps_start: Optional[List[int]] = None
    attn_mask_annealing_steps_end: Optional[List[int]] = None
    poly_power: float = 0.9
    # The heads' warmup, then the backbone's (``two_stage_warmup_poly``).
    lr_warmup_steps: Tuple[int, int] = (500, 1000)
    use_point_sampling: bool = True
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    # Supervise at most this many classes an image (those present, by
    # ascending id; classes beyond are dropped); None: every class slot.
    max_active_slots: Optional[int] = 32
    default_steps: int = 40_000
    default_batch_size: int = 16


class ScaleBlock(nn.Module):
    """2x upscaling of a channels-last map: ConvTranspose (k 2, s 2) ->
    exact GELU -> depthwise 3x3 convolution without bias -> LayerNorm (eps
    1e-5), computing in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = nn.ConvTranspose2d(dim, dim, 2, stride=2)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1, groups=dim,
                               bias=False)
        self.norm = LayerNorm(dim, 1e-5, dtype)
        self.dtype = dtype

    def reset_parameters(self, generator) -> None:
        """Flax's initializers: lecun-normal kernels (fan-in 4 D and 9),
        zero bias, LayerNorm 1 and 0."""
        w1 = self.conv1.weight
        lecun_normal_(w1.data, w1.shape[0] * 4, generator)
        self.conv1.bias.data.zero_()
        lecun_normal_(self.conv2.weight.data, 9, generator)
        self.norm.weight.data.fill_(1.0)
        self.norm.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        x = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(d),
                               self.conv1.weight.to(d),
                               self.conv1.bias.to(d), stride=2)
        x = F.gelu(x)
        x = F.conv2d(x, self.conv2.weight.to(d), padding=1,
                     groups=x.shape[1])
        return self.norm(x.permute(0, 2, 3, 1))


def resize_no_antialias(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, H, W) as ``jax.image.resize(...,
    "bilinear", antialias=False)``: half-pixel centres, the plain triangle
    filter either way."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=False)


def _linear_weights(m: int, n: int, device) -> torch.Tensor:
    """(m, n) float64 weights of ``jax.image.resize``'s "linear" rule along
    one axis of size m -> n (``compute_weight_mat``: half-pixel centres, the
    triangle widened by m / n where the axis shrinks, each column
    normalized, samples outside the input zeroed)."""
    inv = 1.0 / (n / m)
    f64 = dict(dtype=torch.float64, device=device)
    sample = (torch.arange(n, **f64) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(m, **f64)[:, None]).abs()
    w = (1.0 - x / max(inv, 1.0)).clamp(min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def linear_resize_above_half(x: torch.Tensor,
                             hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, K) 0/1 maps -> bool (B, h, w, K): ``jax.image.resize(...,
    "linear") > 0.5``, the cells of which more than half the weight is on.
    The sums run in float64 and a sum within 1e-9 of one half counts as a
    half (off): a target edge halfway across a cell makes an exact half,
    which JAX's float32 sums round to either side, by their order."""
    H, W = x.shape[1:3]
    t = torch.einsum("bhwk,hi,wj->bijk", x.double(),
                     _linear_weights(H, hw[0], x.device),
                     _linear_weights(W, hw[1], x.device))
    return t > 0.5 + 1e-9


class EoMTTrunk(VisionTransformer):
    """The ViT with EoMT's queries (``queries``), shared heads
    (``class_head``, ``mask_head0``-``mask_head2``) and upscaling blocks
    (``upscale0``, ``upscale1``); the backbone's parameters keep the ViT's
    names. The last ``num_joint_blocks`` blocks take the queries as extra
    prefix tokens (not rotated by RoPE)."""

    def __init__(self, cfg: ViTConfig, num_queries: int,
                 num_joint_blocks: int, num_classes: int,
                 num_upscale_blocks: int = 2):
        super().__init__(cfg)
        D = cfg.embed_dim
        self.num_queries = num_queries
        self.num_joint_blocks = num_joint_blocks
        self.num_upscale_blocks = num_upscale_blocks
        for block in self.blocks[cfg.depth - num_joint_blocks:]:
            block.attn.num_prefix_tokens = (num_queries
                                            + self.num_prefix_tokens)
        self.queries = nn.Parameter(torch.zeros(1, num_queries, D))
        self.class_head = Linear(D, num_classes + 1, dtype=cfg.dtype)
        for i in range(3):
            setattr(self, f"mask_head{i}", Linear(D, D, dtype=cfg.dtype))
        for i in range(num_upscale_blocks):
            setattr(self, f"upscale{i}", ScaleBlock(D, cfg.dtype))

    def reset_parameters(self, generator) -> None:
        super().reset_parameters(generator)
        self.queries.data.normal_(0.0, 0.02, generator=generator)
        for i in range(self.num_upscale_blocks):
            getattr(self, f"upscale{i}").reset_parameters(generator)

    def _predict(self, x: torch.Tensor, grid: Tuple[int, int],
                 factors: bool) -> tuple:
        """(class logits (B, Q, C+1), flat mask logits (B, Q, mh mw)) in
        fp32 from the tokens ``x`` through ``norm``, and with ``factors``
        the query embedding (B, Q, D) and the upscaled pixel map (B, mh,
        mw, D) whose product the mask logits are."""
        B, Q = x.shape[0], self.num_queries
        xn = self.norm(x)
        q_tok = xn[:, :Q]
        cls_logits = self.class_head(q_tok)
        q_emb = q_tok
        for i in range(3):
            q_emb = getattr(self, f"mask_head{i}")(q_emb)
            if i < 2:
                q_emb = F.gelu(q_emb)
        p = xn[:, Q + self.num_prefix_tokens:].reshape(B, *grid, -1)
        for i in range(self.num_upscale_blocks):
            p = getattr(self, f"upscale{i}")(p)
        mask_logits = torch.einsum("bqd,bhwd->bqhw", q_emb, p)
        out = (cls_logits.float(), mask_logits.float().reshape(B, Q, -1))
        if factors:
            out = out + (q_emb.float(), p.float())
        return out

    def forward(self, images: torch.Tensor, mask_probs=None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, return_factors: bool = False):
        """(per-level outputs, (mh, mw)): ``num_joint_blocks + 1`` tuples
        from :meth:`_predict`, the first at the entry of the first joint
        block, and the mask grid. In training each joint block's query rows
        are masked by the previous level's logits, each query released
        where its ``uniform`` draw exceeds ``mask_probs[j]``."""
        cfg = self.cfg
        x, rope, (gh, gw) = self.embed(images)
        B = x.shape[0]
        n_plain = cfg.depth - self.num_joint_blocks
        for block in self.blocks[:n_plain]:
            x = block(x, train, generator, rope=rope)
        Q = self.num_queries
        x = torch.cat([self.queries.to(x.dtype).expand(B, Q, -1), x], dim=1)
        n_prefix = Q + self.num_prefix_tokens
        n_total = x.shape[1]
        scale = 2 ** self.num_upscale_blocks
        mh, mw = gh * scale, gw * scale
        outputs = []
        for j, block in enumerate(self.blocks[n_plain:]):
            out = self._predict(x, (gh, gw), return_factors)
            outputs.append(out)
            attn_mask = None
            if train:
                interp = resize_no_antialias(out[1].reshape(B, Q, mh, mw),
                                             (gh, gw))
                allowed = (interp > 0).reshape(B, Q, gh * gw)
                u = PS.uniform(generator, (B, Q), x.device)
                allowed = allowed | (u > float(mask_probs[j]))[..., None]
                top = torch.cat([torch.ones((B, Q, n_prefix), dtype=torch.bool,
                                            device=x.device), allowed], dim=2)
                rest = torch.ones((B, n_total - Q, n_total),
                                  dtype=torch.bool, device=x.device)
                attn_mask = torch.cat([top, rest], dim=1)[:, None]
            x = block(x, train, generator, attn_mask=attn_mask, rope=rope)
        outputs.append(self._predict(x, (gh, gw), return_factors))
        return outputs, (mh, mw)


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------


def hungarian_host(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """(B, K) int64 optimal assignment of (B, Q, K) costs: for each valid
    target the query it takes, -1 for the others. NaN costs count as 1e6,
    infinities as +-1e6."""
    from scipy.optimize import linear_sum_assignment

    B, _, K = cost.shape
    out = np.full((B, K), -1, dtype=np.int64)
    for b in range(B):
        cols = np.where(valid[b])[0]
        if len(cols) == 0:
            continue
        sub = np.nan_to_num(cost[b][:, cols], nan=1e6, posinf=1e6,
                            neginf=-1e6)
        rows, col_idx = linear_sum_assignment(sub)
        out[b, cols[col_idx]] = rows
    return out


_BIG = 1e9


def greedy_match(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The JAX package's device matcher: ``min(Q, K)`` times, each image's
    cheapest remaining (query, target) pair (the first of equal minima in
    the flattened (Q, K) order) is assigned and its row and column
    closed. (B, K) int64, -1 where unassigned."""
    B, Q, K = cost.shape
    c = torch.where(valid[:, None, :], cost.float(),
                    torch.full_like(cost, _BIG, dtype=torch.float32))
    assign = torch.full((B, K), -1, dtype=torch.int64, device=cost.device)
    rows = torch.arange(B, device=cost.device)
    for _ in range(min(Q, K)):
        flat = c.reshape(B, Q * K)
        idx = torch.argmin(flat, dim=1)
        q, k = idx // K, idx % K
        ok = flat[rows, idx] < _BIG / 2
        assign[rows, k] = torch.where(ok, q, assign[rows, k])
        closed_q = torch.zeros((B, Q), dtype=torch.bool, device=cost.device)
        closed_k = torch.zeros((B, K), dtype=torch.bool, device=cost.device)
        closed_q[rows, q] = ok
        closed_k[rows, k] = ok
        c = c.masked_fill(closed_q[:, :, None] | closed_k[:, None, :], _BIG)
    return assign


def hungarian_match(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, K) assignment of the (B, Q, K) ``cost`` over the valid targets,
    by ``LIGHTLY_TRAIN_MATCHER``: "auto" and "hungarian" the exact one
    (:func:`hungarian_host`), "greedy" :func:`greedy_match`."""
    choice = Env.LIGHTLY_TRAIN_MATCHER.value
    if choice == "greedy":
        return greedy_match(cost, valid)
    if choice not in ("auto", "hungarian"):
        raise ConfigError(f"LIGHTLY_TRAIN_MATCHER={choice!r}: expected "
                          "'auto', 'hungarian' or 'greedy'")
    out = hungarian_host(cost.detach().float().cpu().numpy(),
                         valid.cpu().numpy())
    return torch.from_numpy(out).to(cost.device)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _dice_loss(pred_sigmoid: torch.Tensor,
               target: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (...) dice loss."""
    num = 2.0 * (pred_sigmoid * target).sum(-1)
    den = pred_sigmoid.sum(-1) + target.sum(-1)
    return 1.0 - (num + 1.0) / (den + 1.0)


def _class_cost(cls_logits: torch.Tensor,
                tgt_classes: torch.Tensor) -> torch.Tensor:
    """(B, Q, K): minus each query's probability of each target's class."""
    prob = torch.softmax(cls_logits.float(), dim=-1)
    Q = prob.shape[1]
    return -prob.gather(2, tgt_classes.long()[:, None, :].expand(
        -1, Q, -1))


def _mask_costs(pred: torch.Tensor, targets: torch.Tensor,
                n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BCE cost, dice cost), each (B, Q, K), of (B, Q, n) logits against
    (B, K, n) targets."""
    pos, neg = F.softplus(-pred), F.softplus(pred)
    cost_bce = (torch.einsum("bqn,bkn->bqk", pos, targets)
                + torch.einsum("bqn,bkn->bqk", neg, 1.0 - targets)) / n
    sig = torch.sigmoid(pred)
    inter = torch.einsum("bqn,bkn->bqk", sig, targets)
    sums = sig.sum(-1)[:, :, None] + targets.sum(-1)[:, None, :]
    return cost_bce, 1.0 - (2 * inter + 1.0) / (sums + 1.0)


def _class_loss(cls_logits: torch.Tensor, assignment: torch.Tensor,
                tgt_classes: torch.Tensor, num_classes: int,
                no_object_weight: float) -> torch.Tensor:
    """CE of every query against its matched target's class, or the
    no-object class (weighted ``no_object_weight``) where unmatched."""
    B, Q = cls_logits.shape[:2]
    assigned = assignment >= 0
    matched = torch.full((B, Q + 1), num_classes, dtype=torch.int64,
                         device=cls_logits.device)
    matched.scatter_(1, torch.where(assigned, assignment, Q),
                     torch.where(assigned, tgt_classes.long(), num_classes))
    matched = matched[:, :Q]
    logp = F.log_softmax(cls_logits.float(), dim=-1)
    ce = -logp.gather(2, matched[..., None])[..., 0]
    w = torch.where(matched == num_classes,
                    torch.full_like(ce, no_object_weight),
                    torch.ones_like(ce))
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def mask_classification_loss(cls_logits, mask_logits, targets, valid,
                             tgt_classes, *, num_classes: int,
                             class_weight: float, mask_weight: float,
                             dice_weight: float,
                             no_object_weight: float) -> torch.Tensor:
    """The Hungarian-matched Mask2Former loss on full masks: (B, Q, C+1)
    class and (B, Q, N) mask logits against (B, K, N) binary ``targets``
    of the ``valid`` (B, K) slots and their classes."""
    B, Q, N = mask_logits.shape
    with torch.no_grad():
        cost_bce, cost_dice = _mask_costs(mask_logits, targets, N)
        cost = (class_weight * _class_cost(cls_logits, tgt_classes)
                + mask_weight * cost_bce + dice_weight * cost_dice)
        assignment = hungarian_match(cost, valid)
    assigned = assignment >= 0
    loss_class = _class_loss(cls_logits, assignment, tgt_classes,
                             num_classes, no_object_weight)
    pred = mask_logits.gather(1, assignment.clamp(min=0)[..., None].expand(
        -1, -1, N))
    bce = (targets * F.softplus(-pred)
           + (1.0 - targets) * F.softplus(pred)).mean(-1)
    dice = _dice_loss(torch.sigmoid(pred), targets)
    use = assigned.float()
    denom = torch.clamp(use.sum(), min=1.0)
    return (class_weight * loss_class
            + mask_weight * (bce * use).sum() / denom
            + dice_weight * (dice * use).sum() / denom)


def point_sampled_mask_loss(
    cls_logits: torch.Tensor,
    mask_logits: torch.Tensor,
    grid_hw: Tuple[int, int],
    id_map: torch.Tensor,
    valid: torch.Tensor,
    tgt_classes: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    num_classes: int,
    class_weight: float,
    mask_weight: float,
    dice_weight: float,
    no_object_weight: float,
    num_points: int = 12544,
    oversample_ratio: float = 3.0,
    importance_sample_ratio: float = 0.75,
    factors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    slot_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The point-sampled Mask2Former loss of one level.

    The matching costs are taken at ``num_points`` uniform points an image
    (one draw of ``uniform``), the mask logits there sampled from their
    ``factors`` (query embedding, pixel map: the pixel rows sampled, then
    the product) where given; the assignment of the detached costs; the
    class CE; the CE and dice of each matched mask at its importance and
    uniform points (``uncertainty_point_coords``: two draws, over every
    (image, slot) at once), the targets sampled from the (B, H, W) id map.
    Slot k supervises ``id_map == k``, or ``== slot_ids[b, k]`` with the
    (B, K) ``slot_ids`` of active-slot compaction. Nothing of (B, Q, H, W)
    size is formed."""
    B, Q, _ = mask_logits.shape
    gh, gw = grid_hw
    K = valid.shape[1]
    P = num_points
    with torch.no_grad():
        coords_m = PS.uniform(generator, (B, P, 2), mask_logits.device)
        if factors is not None:
            q_emb, pixels = factors
            pix = PS.bilinear_point_sample_rows(pixels, coords_m)
            pred_pts = torch.einsum("bqd,bpd->bqp", q_emb, pix)
        else:
            pred_pts = PS.bilinear_point_sample(
                mask_logits.reshape(B, Q, gh, gw), coords_m)
        tgt_pts = PS.sample_id_indicator(id_map, coords_m, K,
                                         slot_ids=slot_ids)
        cost_bce, cost_dice = _mask_costs(pred_pts.float(), tgt_pts, P)
        cost = (class_weight * _class_cost(cls_logits, tgt_classes)
                + mask_weight * cost_bce + dice_weight * cost_dice)
        assignment = hungarian_match(cost, valid)
    assigned = assignment >= 0
    loss_class = _class_loss(cls_logits, assignment, tgt_classes,
                             num_classes, no_object_weight)

    flat_pred = mask_logits.gather(
        1, assignment.clamp(min=0)[..., None].expand(
            -1, -1, mask_logits.shape[2])).reshape(B * K, gh, gw)
    coords = PS.uncertainty_point_coords(
        generator, flat_pred.detach().float(), P, oversample_ratio,
        importance_sample_ratio).reshape(B, K, P, 2)
    slots = (torch.arange(K, device=id_map.device) if slot_ids is None
             else slot_ids)
    tgt = PS.sample_slot_indicator(id_map, coords, slots)
    pred = PS.bilinear_point_sample(
        flat_pred[:, None], coords.reshape(B * K, P, 2)).reshape(
        B, K, P).float()
    bce = (tgt * F.softplus(-pred) + (1.0 - tgt) * F.softplus(pred)).mean(-1)
    dice = _dice_loss(torch.sigmoid(pred), tgt)
    use = (assigned & valid).float()
    denom = torch.clamp(use.sum(), min=1.0)
    return (class_weight * loss_class
            + mask_weight * (bce * use).sum() / denom
            + dice_weight * (dice * use).sum() / denom)


# ---------------------------------------------------------------------------
# The task
# ---------------------------------------------------------------------------

_VIT_TOP = ("blocks", "patch_embed", "pos_embed", "cls_token",
            "register_tokens", "mask_token", "norm")
_PRE_BLOCK = ("patch_embed", "pos_embed", "cls_token", "register_tokens",
              "mask_token")
LLRD = 0.8


def _top(name: str) -> List[str]:
    """A parameter's name parts under the ``backbone.`` root."""
    return name.split(".")[1:]


class EoMTSemanticSegmentationTrainModel(TaskTrainModel):
    task = "semantic_segmentation"
    transform_kind = "semantic_segmentation"

    def __init__(self, wrapped: WrappedModel,
                 args: EoMTSemanticSegmentationArgs):
        super().__init__(wrapped, args)
        if not isinstance(wrapped.module, VisionTransformer):
            raise ConfigError(
                f"EoMT needs a ViT backbone; '{wrapped.name}' is not one.")
        cfg: ViTConfig = wrapped.module.cfg
        self.cfg = cfg
        if args.num_joint_blocks is None:
            auto = 3 if cfg.depth <= 12 else (4 if cfg.depth <= 24 else 5)
            args = dataclasses.replace(args,
                                       num_joint_blocks=min(auto, cfg.depth))
        self.args: EoMTSemanticSegmentationArgs = args
        # The annealing horizon: the run's resolved steps, set by the
        # runtime (``default_steps`` where the model runs alone).
        self.total_steps: Optional[int] = None

    def init(self, generator, device) -> TaskModule:
        a = self.args
        trunk = EoMTTrunk(self.cfg, a.num_queries, a.num_joint_blocks,
                          a.num_classes, a.num_upscale_blocks)
        trunk.reset_parameters(generator)
        return TaskModule(trunk).to(device)

    # -- annealing ----------------------------------------------------------
    def _anneal_windows(self, total_steps: int) -> Tuple[np.ndarray,
                                                         np.ndarray]:
        a = self.args
        if (a.attn_mask_annealing_steps_start is not None
                and a.attn_mask_annealing_steps_end is not None):
            return (np.asarray(a.attn_mask_annealing_steps_start, np.float32),
                    np.asarray(a.attn_mask_annealing_steps_end, np.float32))
        n_phases = a.num_joint_blocks + 2
        phases = [round(i * total_steps / n_phases)
                  for i in range(n_phases + 1)]
        return (np.asarray(phases[1:-2], np.float32),
                np.asarray(phases[2:-1], np.float32))

    def _mask_probs(self, step: int, total_steps: int) -> np.ndarray:
        """float32 (num_joint_blocks,): the probabilities used at state
        step ``step``, those the reference recomputes at the end of the
        step before (``anneal(step - 1)``): 1 before a block's window, 0
        from its end, ``(1 - progress) ** poly_power`` inside."""
        a = self.args
        if not a.attn_mask_annealing:
            return np.zeros((a.num_joint_blocks,), np.float32)
        starts, ends = self._anneal_windows(total_steps)
        cur = np.float32(step) - np.float32(1.0)
        progress = (cur - starts) / np.maximum(ends - starts,
                                               np.float32(1.0))
        inside = (np.float32(1.0) - np.clip(progress, np.float32(0.0),
                                            np.float32(1.0))
                  ) ** np.float32(a.poly_power)
        return np.where(cur < starts, np.float32(1.0),
                        np.where(cur >= ends, np.float32(0.0),
                                 inside)).astype(np.float32)

    # -- targets ------------------------------------------------------------
    def _targets_from_mask(self, masks: torch.Tensor,
                           grid_hw: Tuple[int, int]):
        """(B, H, W) labels -> ((B, K, n) binary targets at the mask grid,
        by the one-hot's antialiased linear resize thresholded at 0.5, and
        the (B, K) presence flags), K = num_classes."""
        K = self.args.num_classes
        onehot = self._onehot(masks)
        t = linear_resize_above_half(onehot, grid_hw).float()
        B = masks.shape[0]
        return (t.permute(0, 3, 1, 2).reshape(B, K, -1),
                self._class_presence(masks))

    def _class_ids(self, masks: torch.Tensor) -> torch.Tensor:
        """int64 labels with ignored pixels and labels outside [0, K) at K
        (no class)."""
        K = self.args.num_classes
        m = masks.long()
        inside = (m >= 0) & (m < K) & (m != self.args.ignore_index)
        return torch.where(inside, m, K)

    def _onehot(self, masks: torch.Tensor) -> torch.Tensor:
        """(B, H, W, K) float one-hot of the labels."""
        K = self.args.num_classes
        return F.one_hot(self._class_ids(masks), K + 1)[..., :K].float()

    def _class_presence(self, masks: torch.Tensor) -> torch.Tensor:
        """(B, H, W) labels -> (B, K) presence flags."""
        return ids_present(self._class_ids(masks), self.args.num_classes)

    def _loss_levels(self, outputs, grid_hw, generator, id_map, valid,
                     tgt_classes, slot_ids=None, targets=None) -> list:
        """The loss of each level (point-sampled, or on full masks where
        ``targets`` are given)."""
        a = self.args
        weights = dict(num_classes=a.num_classes, class_weight=a.class_weight,
                       mask_weight=a.mask_weight, dice_weight=a.dice_weight,
                       no_object_weight=a.no_object_weight)
        losses = []
        for out in outputs:
            if targets is not None:
                losses.append(mask_classification_loss(
                    out[0], out[1], targets, valid, tgt_classes, **weights))
                continue
            losses.append(point_sampled_mask_loss(
                out[0], out[1], grid_hw, id_map, valid, tgt_classes,
                generator, **weights, num_points=a.num_points,
                oversample_ratio=a.oversample_ratio,
                importance_sample_ratio=a.importance_sample_ratio,
                factors=out[2:] if len(out) > 2 else None,
                slot_ids=slot_ids))
        return losses

    def _forward_train(self, model, images, generator, step):
        a = self.args
        mask_probs = self._mask_probs(step,
                                      self.total_steps or a.default_steps)
        return model.backbone(images, mask_probs, generator, train=True,
                              return_factors=a.use_point_sampling)

    def loss_fn(self, model, batch, generator, step):
        a = self.args
        images, masks = batch["images"], batch["masks"]
        outputs, grid_hw = self._forward_train(model, images, generator,
                                               step)
        B = images.shape[0]
        tgt_classes = torch.arange(a.num_classes, device=images.device)[
            None].expand(B, -1)
        slot_ids = targets = id_map = None
        if a.use_point_sampling:
            id_map = torch.where(masks == a.ignore_index,
                                 torch.full_like(masks, -1), masks).int()
            valid = self._class_presence(masks)
            K = a.num_classes
            Kc = K if a.max_active_slots is None else min(a.max_active_slots,
                                                          K)
            if Kc < K:
                # The present classes by ascending id, padded with absent
                # ones flagged invalid (classes beyond Kc are dropped).
                ids = torch.arange(K, dtype=torch.float32,
                                   device=images.device)[None]
                score = torch.where(valid, 2.0 * K - ids, -ids)
                vals, slot_ids = torch.topk(score, Kc, dim=1)
                valid = vals > float(K)
                tgt_classes = slot_ids
        else:
            targets, valid = self._targets_from_mask(masks, grid_hw)
        losses = self._loss_levels(outputs, grid_hw, generator, id_map,
                                   valid, tgt_classes, slot_ids, targets)
        # The levels' losses are summed.
        return sum(losses), {"loss_final": losses[-1].detach()}

    # -- inference ----------------------------------------------------------
    def _query_outputs(self, model, images):
        outputs, grid = model.backbone(images, train=False)
        return outputs[-1][0], outputs[-1][1], grid

    def _semantic_logits(self, model, images) -> torch.Tensor:
        """(B, H, W, C) per-pixel class scores: the mask logits resized
        bilinearly to the image, their sigmoid against the classes' softmax
        over C+1, the no-object column dropped."""
        cls_logits, mask_logits, (mh, mw) = self._query_outputs(model,
                                                                images)
        B, Q = cls_logits.shape[:2]
        H, W = images.shape[1:3]
        mask_up = resize_no_antialias(mask_logits.reshape(B, Q, mh, mw),
                                      (H, W))
        prob = torch.softmax(cls_logits, dim=-1)
        sem = torch.einsum("bqhw,bqc->bhwc", torch.sigmoid(mask_up), prob)
        return sem[..., :self.args.num_classes]

    def _val_semantic_logits(self, model, images) -> torch.Tensor:
        ts = self.val_tile_size
        H, W = images.shape[1:3]
        if ts is not None and (H > ts or W > ts):
            from lightly_train_tpu_torch.tasks.tiling import tiled_logits

            return tiled_logits(lambda t: self._semantic_logits(model, t),
                                images, self.args.num_classes, int(ts))
        return self._semantic_logits(model, images)

    def val_step(self, model, batch) -> Dict[str, torch.Tensor]:
        masks = batch["masks"]
        pred = self._val_semantic_logits(model, batch["images"]).argmax(-1)
        valid = masks != self.args.ignore_index
        if batch.get("valid") is not None:
            valid = valid & batch["valid"][:, None, None]
        zeros = torch.zeros_like(masks)
        return {"confusion": confusion(
            torch.where(valid, masks, zeros),
            torch.where(valid, pred.to(masks.dtype), zeros), valid.float(),
            self.args.num_classes)}

    def val_finalize(self, stats) -> Dict[str, float]:
        return {"val_miou": miou(stats["confusion"].cpu().numpy())}

    def predict(self, model, images) -> torch.Tensor:
        """Per-pixel class ids (B, H, W)."""
        return self._semantic_logits(model, images).argmax(-1)

    def predict_tiled(self, model, images: torch.Tensor,
                      tile_size: int = 512,
                      stride: Optional[int] = None) -> torch.Tensor:
        """Per-pixel class ids of images larger than the training size:
        the logits averaged over overlapping ``tile_size`` tiles."""
        from lightly_train_tpu_torch.tasks.tiling import tiled_logits

        return tiled_logits(lambda t: self._semantic_logits(model, t),
                            images, self.args.num_classes, tile_size,
                            stride).argmax(-1)

    # -- optimization -------------------------------------------------------
    def grad_clip_norm(self):
        return 0.01

    def scaled_lr(self, base_lr: float, global_batch_size: int) -> float:
        return base_lr * math.sqrt(global_batch_size
                                   / self.args.default_batch_size)

    def _schedules(self, base_lr: float, total_steps: int):
        from lightly_train_tpu_torch._optim.schedules import (
            two_stage_warmup_poly,
        )

        return two_stage_warmup_poly(base_lr, total_steps,
                                     self.args.lr_warmup_steps,
                                     self.args.poly_power)

    def lr_schedule(self, base_lr: float, total_steps: int):
        """The heads' schedule (the one logged); the backbone's rides
        :meth:`lr_schedule_groups`."""
        return self._schedules(base_lr, total_steps)[1]

    @staticmethod
    def _is_vit_param(name: str) -> bool:
        return _top(name)[0] in _VIT_TOP

    def lr_schedule_groups(self, base_lr: float, total_steps: int, params):
        """([backbone schedule, heads' schedule], {name: 0 for the ViT's
        parameters, 1 for EoMT's})."""
        groups = {n: 0 if self._is_vit_param(n) else 1 for n in params}
        return list(self._schedules(base_lr, total_steps)), groups

    def lr_scales(self, params) -> Dict[str, float]:
        """Layer-wise decay 0.8: block i ``0.8 ** (depth - 1 - i)``, the
        parameters before the blocks the first block's, the rest 1."""
        depth = self.cfg.depth
        scales = {}
        for name in params:
            parts = _top(name)
            if parts[0] == "blocks":
                scales[name] = LLRD ** (depth - 1 - int(parts[1]))
            elif parts[0] in _PRE_BLOCK:
                scales[name] = LLRD ** (depth - 1)
            else:
                scales[name] = 1.0
        return scales

    @property
    def watch_metric(self):
        return ("val_miou", "max")
