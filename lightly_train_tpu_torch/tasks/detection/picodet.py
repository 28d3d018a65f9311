"""PicoDet: ESNet backbone, CSP-PAN neck and a GFL head with SimOTA
assignment.

Port of ``lightly_train_tpu/tasks/detection/picodet.py`` (all but the zoo
loader, ``load_torch_picodet_zoo``), module for module under the Flax
names, so that ``models/from_jax.py`` carries a JAX tree (with its
BatchNorm ``batch_stats``) over by name:

- :class:`PDConv`, :class:`PDDWSep`, :class:`PDSE`, :class:`_EIR`,
  :class:`_EIRDS` and :class:`ESNet` (C3/C4/C5 at strides 8, 16, 32);
- :class:`_DarknetBottleneck`, :class:`_CSPLayer` and :class:`CSPPAN`
  (four levels, the fourth the two-conv P6);
- :class:`PicoDetHead` (per level: stacked depthwise-separable convs and
  one 1x1 conv to ``num_classes + 4 (reg_max + 1)`` channels);
- :func:`integral_decode`, :func:`simota_assign` and
  :class:`PicoDetTrainModel` (VarifocalLoss, GIoU and DFL on SimOTA's
  dynamic-k assignment).

Everything runs in fp32 in every precision, as in the JAX package. The
BatchNorms are Flax's default (momentum 0.99). Feature maps are NCHW
inside the modules; the head returns (B, H, W, C) as the JAX one does.
CSP-PAN's upsampling is ``jax.image.resize``'s "nearest" (half-pixel
centres): torch's ``nearest-exact``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch.models.conv import (
    BatchNorm,
    Conv,
    max_pool,
    reset_cnn_parameters,
)
from lightly_train_tpu_torch.tasks.base import TaskArgs, TaskModule
from lightly_train_tpu_torch.tasks.detection.backbone_adapter import (
    _UnfoldConv,
)
from lightly_train_tpu_torch.tasks.detection.box_utils import cxcywh_to_xyxy
from lightly_train_tpu_torch.tasks.detection.components import (
    stable_topk_indices,
)
from lightly_train_tpu_torch.tasks.detection.ltdetr import (
    ObjectDetectionTrainModel,
)

_INF = 1e8


@dataclasses.dataclass
class PicoDetArgs(TaskArgs):
    num_classes: int = 80
    # "s": ESNet x0.75, neck and head 96, 2 head convs; "l": ESNet x1.25,
    # neck and head 128, 3 head convs; "test": a small CPU size.
    model_size: str = "s"
    reg_max: int = 7
    center_radius: float = 2.5
    candidate_topk: int = 10
    iou_cost_weight: float = 6.0
    cls_cost_weight: float = 1.0
    loss_vfl_weight: float = 1.0
    loss_giou_weight: float = 2.0
    loss_dfl_weight: float = 0.25
    max_detections: int = 100
    score_threshold: float = 0.0
    default_steps: int = 60_000
    default_batch_size: int = 64


def _make_divisible(v: float, divisor: int, min_value=None) -> int:
    """ESNet's channel rounding."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# ESNet's width scale and per-block mid-channel ratios by size.
_ESNET_SETTINGS: Dict[str, Tuple[float, Tuple[float, ...]]] = {
    "s": (0.75, (0.875, 0.5, 0.5, 0.5, 0.625, 0.5, 0.625, 0.5, 0.5, 0.5,
                 0.5, 0.5, 0.5)),
    "m": (1.0, (0.875, 0.5, 1.0, 0.625, 0.5, 0.75, 0.625, 0.625, 0.5,
                0.625, 1.0, 0.625, 0.75)),
    "l": (1.25, (0.875, 0.5, 1.0, 0.625, 0.5, 0.75, 0.625, 0.625, 0.5,
                 0.625, 1.0, 0.625, 0.75)),
    "test": (0.125, (0.5,) * 13),
}
_ESNET_STAGE_REPEATS = (3, 7, 3)

# Neck channels, head channels and stacked head convs by size.
_PICODET_PRESETS: Dict[str, Tuple[int, int, int]] = {
    "s": (96, 96, 2),
    "l": (128, 128, 3),
    "test": (16, 16, 1),
}


def esnet_stage_channels(model_size: str) -> Tuple[int, ...]:
    scale, _ = _ESNET_SETTINGS[model_size]
    return (24, _make_divisible(128 * scale, 16),
            _make_divisible(256 * scale, 16),
            _make_divisible(512 * scale, 16))


def _pad(kernel: int):
    p = kernel // 2
    return ((p, p), (p, p))


class PDConv(nn.Module):
    """conv (no bias, padding k // 2) + BatchNorm + ReLU or identity."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride, _pad(kernel), groups,
                         bias=False)
        self.bn = BatchNorm(out_ch)
        self.act = act

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.bn(self.conv(x), train)
        return F.relu(x) if self.act else x


class PDDWSep(nn.Module):
    """Depthwise conv + pointwise conv (both without bias) + one
    BatchNorm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 5,
                 stride: int = 1):
        super().__init__()
        self.depthwise = Conv(in_ch, in_ch, kernel, stride, _pad(kernel),
                              groups=in_ch, bias=False)
        self.pointwise = Conv(in_ch, out_ch, 1, 1, ((0, 0), (0, 0)),
                              bias=False)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.relu(self.bn(self.pointwise(self.depthwise(x)), train))


class PDSE(nn.Module):
    """Squeeze-and-excitation: the spatial mean through 1x1 convs with
    bias, ReLU then a sigmoid gate."""

    def __init__(self, ch: int, reduction: int = 4):
        super().__init__()
        self.fc1 = Conv(ch, ch // reduction, 1, 1, ((0, 0), (0, 0)))
        self.fc2 = Conv(ch // reduction, ch, 1, 1, ((0, 0), (0, 0)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


def _channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """The channel shuffle of NCHW ``x``: channel g * (C / groups) + i goes
    to i * groups + g."""
    B, C, H, W = x.shape
    return x.reshape(B, groups, C // groups, H, W).transpose(1, 2).reshape(
        B, C, H, W)


class _EIR(nn.Module):
    """The stride-1 inverted residual: half the channels through a ghost
    branch (pw, dw, concat), SE and a linear pw; concat and shuffle."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        half_mid = mid_ch // 2
        self.conv_pw = PDConv(in_ch // 2, half_mid, 1)
        self.conv_dw = PDConv(half_mid, half_mid, 3, groups=half_mid,
                              act=False)
        self.se = PDSE(mid_ch)
        self.conv_linear = PDConv(mid_ch, out_ch // 2, 1)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x1, x2 = x.chunk(2, dim=1)
        x2 = self.conv_pw(x2, train)
        x3 = torch.cat([x2, self.conv_dw(x2, train)], 1)
        x3 = self.conv_linear(self.se(x3), train)
        return _channel_shuffle(torch.cat([x1, x3], 1))


class _EIRDS(nn.Module):
    """The stride-2 inverted residual: two downsampling branches and a
    depthwise / pointwise tail."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        half_mid = mid_ch // 2
        self.conv_dw_1 = PDConv(in_ch, in_ch, 3, 2, groups=in_ch, act=False)
        self.conv_linear_1 = PDConv(in_ch, out_ch // 2, 1)
        self.conv_pw_2 = PDConv(in_ch, half_mid, 1)
        self.conv_dw_2 = PDConv(half_mid, half_mid, 3, 2, groups=half_mid,
                                act=False)
        self.se = PDSE(half_mid)
        self.conv_linear_2 = PDConv(half_mid, out_ch // 2, 1)
        self.conv_dw_mv1 = PDConv(out_ch, out_ch, 3, groups=out_ch)
        self.conv_pw_mv1 = PDConv(out_ch, out_ch, 1)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x1 = self.conv_linear_1(self.conv_dw_1(x, train), train)
        x2 = self.conv_dw_2(self.conv_pw_2(x, train), train)
        x2 = self.conv_linear_2(self.se(x2), train)
        out = self.conv_dw_mv1(torch.cat([x1, x2], 1), train)
        return self.conv_pw_mv1(out, train)


class ESNet(nn.Module):
    """ESNet; the outputs of blocks ``out_indices`` (C3, C4, C5 at strides
    8, 16, 32)."""

    def __init__(self, model_size: str = "s",
                 out_indices: Tuple[int, ...] = (2, 9, 12)):
        super().__init__()
        _, ratios = _ESNET_SETTINGS[model_size]
        stage_ch = esnet_stage_channels(model_size)
        self.out_indices = tuple(out_indices)
        self.conv1 = PDConv(3, stage_ch[0], 3, 2)
        # The stem by unfold and product: cuDNN's weight gradient of this
        # strided convolution does not repeat bitwise on the card.
        self.conv1.conv = _UnfoldConv(3, stage_ch[0], 3, 2, _pad(3),
                                      bias=False)
        blocks, in_ch, idx = [], stage_ch[0], 0
        for stage_id, repeats in enumerate(_ESNET_STAGE_REPEATS):
            out_ch = stage_ch[stage_id + 1]
            for i in range(repeats):
                mid_ch = _make_divisible(out_ch * ratios[idx], 8)
                blocks.append((_EIRDS if i == 0 else _EIR)(in_ch, mid_ch,
                                                           out_ch))
                in_ch, idx = out_ch, idx + 1
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, train: bool) -> List[torch.Tensor]:
        x = max_pool(self.conv1(x, train), 3, 2, ((1, 1), (1, 1)))
        feats = []
        for i, block in enumerate(self.blocks):
            x = block(x, train)
            if i in self.out_indices:
                feats.append(x)
        return feats


class _DarknetBottleneck(nn.Module):
    """1x1 PDConv, then a depthwise-separable conv; the identity is never
    added (``add_identity`` is off in every CSP layer)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 5,
                 expansion: float = 0.5):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.conv1 = PDConv(in_ch, hidden, 1)
        self.conv2 = PDDWSep(hidden, out_ch, kernel)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.conv2(self.conv1(x, train), train)


class _CSPLayer(nn.Module):
    """A short 1x1 branch, a main 1x1 branch through the bottlenecks, both
    concatenated into a final 1x1."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 5,
                 expansion: float = 0.5, num_blocks: int = 1):
        super().__init__()
        mid = int(out_ch * expansion)
        self.short_conv = PDConv(in_ch, mid, 1)
        self.main_conv = PDConv(in_ch, mid, 1)
        for j in range(num_blocks):
            setattr(self, f"blocks{j}",
                    _DarknetBottleneck(mid, mid, kernel, expansion))
        self.num_blocks = num_blocks
        self.final_conv = PDConv(2 * mid, out_ch, 1)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        short = self.short_conv(x, train)
        main = self.main_conv(x, train)
        for j in range(self.num_blocks):
            main = getattr(self, f"blocks{j}")(main, train)
        return self.final_conv(torch.cat([main, short], 1), train)


def _resize_nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` of NCHW ``x``: the source index
    ``floor((i + 0.5) * in / out)``."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


class CSPPAN(nn.Module):
    """Per-level 1x1 transforms, top-down and bottom-up CSP layers, and
    the P6 of two depthwise-separable stride-2 convs summed."""

    def __init__(self, in_channels: Sequence[int], out_ch: int,
                 kernel: int = 5, expansion: float = 1.0,
                 num_csp_blocks: int = 1):
        super().__init__()
        n = len(in_channels)
        self.n = n
        for i, c in enumerate(in_channels):
            setattr(self, f"transforms{i}", PDConv(c, out_ch, 1))
        for i in range(n - 1):
            setattr(self, f"top_down_blocks{i}", _CSPLayer(
                2 * out_ch, out_ch, kernel, expansion, num_csp_blocks))
            setattr(self, f"downsamples{i}",
                    PDDWSep(out_ch, out_ch, kernel, 2))
            setattr(self, f"bottom_up_blocks{i}", _CSPLayer(
                2 * out_ch, out_ch, kernel, expansion, num_csp_blocks))
        self.first_top_conv = PDDWSep(out_ch, out_ch, kernel, 2)
        self.second_top_conv = PDDWSep(out_ch, out_ch, kernel, 2)

    def forward(self, feats: Sequence[torch.Tensor],
                train: bool) -> List[torch.Tensor]:
        n = self.n
        inputs = [getattr(self, f"transforms{i}")(f, train)
                  for i, f in enumerate(feats)]
        inner = [inputs[-1]]
        for idx in range(n - 1, 0, -1):
            up = _resize_nearest(inner[0], inputs[idx - 1].shape[2:])
            inner.insert(0, getattr(self, f"top_down_blocks{n - 1 - idx}")(
                torch.cat([up, inputs[idx - 1]], 1), train))
        outs = [inner[0]]
        for idx in range(n - 1):
            down = getattr(self, f"downsamples{idx}")(outs[-1], train)
            outs.append(getattr(self, f"bottom_up_blocks{idx}")(
                torch.cat([down, inner[idx + 1]], 1), train))
        p6 = (self.first_top_conv(inputs[-1], train)
              + self.second_top_conv(outs[-1], train))
        return outs + [p6]


class PicoDetHead(nn.Module):
    """The shared-branch GFL head: per level ``stacked_convs``
    depthwise-separable k5 convs and a 1x1 conv; (class logits, box
    distribution logits) a level, each (B, H, W, C)."""

    def __init__(self, num_classes: int, in_ch: int, feat_ch: int,
                 stacked_convs: int, reg_max: int, levels: int = 4):
        super().__init__()
        self.num_classes, self.levels = num_classes, levels
        self.stacked_convs = stacked_convs
        out = num_classes + 4 * (reg_max + 1)
        for li in range(levels):
            ch = in_ch
            for i in range(stacked_convs):
                setattr(self, f"cls_convs{li}_{i}", PDDWSep(ch, feat_ch, 5))
                ch = feat_ch
            setattr(self, f"gfl_cls{li}", Conv(ch, out, 1, 1,
                                               ((0, 0), (0, 0))))

    def forward(self, levels: Sequence[torch.Tensor], train: bool):
        cls_outs, reg_outs = [], []
        for li, h in enumerate(levels):
            for i in range(self.stacked_convs):
                h = getattr(self, f"cls_convs{li}_{i}")(h, train)
            out = getattr(self, f"gfl_cls{li}")(h).permute(0, 2, 3, 1)
            cls_outs.append(out[..., :self.num_classes])
            reg_outs.append(out[..., self.num_classes:])
        return cls_outs, reg_outs


class PicoDetModule(nn.Module):
    """ESNet (``backbone``), CSP-PAN (``neck``) and the head (``head``) of
    one size preset, in fp32."""

    def __init__(self, args: PicoDetArgs):
        super().__init__()
        size = args.model_size
        neck_ch, head_ch, stacked = _PICODET_PRESETS.get(
            size, _PICODET_PRESETS["s"])
        self.backbone = ESNet(size)
        self.neck = CSPPAN(esnet_stage_channels(size)[1:], neck_ch)
        self.head = PicoDetHead(args.num_classes, neck_ch, head_ch, stacked,
                                args.reg_max)

    def forward(self, images: torch.Tensor, train: bool = False):
        """(B, H, W, 3) images -> (class logits, box logits) per level."""
        x = images.float().permute(0, 3, 1, 2)
        return self.head(self.neck(self.backbone(x, train), train), train)


_STRIDES = (8, 16, 32, 64)


def integral_decode(reg: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(..., 4 (reg_max + 1)) distribution logits -> (..., 4) expected
    distances in [0, reg_max]."""
    bins = reg.reshape(*reg.shape[:-1], 4, reg_max + 1)
    probs = torch.softmax(bins.float(), dim=-1)
    project = torch.arange(reg_max + 1, dtype=torch.float32,
                           device=reg.device)
    return torch.einsum("...kb,b->...k", probs, project)


def _iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) and (..., K, 4) xyxy boxes: (..., N,
    K)."""
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0)
              * (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0)
              * (b[..., 3] - b[..., 1]).clamp(min=0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :]
                    - inter).clamp(min=1e-9)


def _aligned_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The diagonal of :func:`_iou_xyxy` for aligned (..., N, 4) boxes,
    the same operations element for element, without the (N, N)
    matrix."""
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0)
              * (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0)
              * (b[..., 3] - b[..., 1]).clamp(min=0))
    wh = (torch.minimum(a[..., 2:], b[..., 2:])
          - torch.maximum(a[..., :2], b[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a + area_b - inter).clamp(min=1e-9)


def _giou_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Aligned GIoU of (..., N, 4) and (..., N, 4) xyxy boxes: (...,
    N)."""
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0)
              * (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0)
              * (b[..., 3] - b[..., 1]).clamp(min=0))
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = (area_a + area_b - inter).clamp(min=1e-9)
    iou = inter / union
    ewh = (torch.maximum(a[..., 2:], b[..., 2:])
           - torch.minimum(a[..., :2], b[..., :2])).clamp(min=0)
    enclose = (ewh[..., 0] * ewh[..., 1]).clamp(min=1e-9)
    return iou - (enclose - union) / enclose


def simota_assign(scores: torch.Tensor, points: torch.Tensor,
                  strides: torch.Tensor, decoded: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                  gt_valid: torch.Tensor, center_radius: float,
                  candidate_topk: int, iou_weight: float,
                  cls_weight: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SimOTA over a batch: ``scores`` (B, N, C) sigmoid scores,
    ``points`` (N, 2) prior centres and ``strides`` (N,) in pixels,
    ``decoded`` (B, N, 4) xyxy boxes, the ground truths (B, K, 4) xyxy,
    (B, K) labels and flags. Each ground truth takes the priors whose cost
    is at most its ``dynamic_k``-th smallest (``dynamic_k`` the floor of
    its ``candidate_topk`` largest IoUs' sum, at least 1), a prior taken
    by several the cheapest (the first of equal costs). Returns (is_pos
    (B, N), assigned gt (B, N), that pair's IoU (B, N), 0 where not
    positive)."""
    N = points.shape[0]
    px, py = points[:, 0][None, :, None], points[:, 1][None, :, None]
    gx0, gy0 = gt_boxes[..., 0][:, None], gt_boxes[..., 1][:, None]
    gx1, gy1 = gt_boxes[..., 2][:, None], gt_boxes[..., 3][:, None]
    in_gt = (px > gx0) & (px < gx1) & (py > gy0) & (py < gy1)
    cxg = (gt_boxes[..., 0] + gt_boxes[..., 2])[:, None] / 2
    cyg = (gt_boxes[..., 1] + gt_boxes[..., 3])[:, None] / 2
    r = center_radius * strides[None, :, None]
    in_center = ((px > cxg - r) & (px < cxg + r)
                 & (py > cyg - r) & (py < cyg + r))
    gv = gt_valid[:, None, :]
    candidate = (in_gt | in_center) & gv
    strong = in_gt & in_center & gv
    valid_prior = candidate.any(2)  # (B, N)

    iou = _iou_xyxy(decoded, gt_boxes)  # (B, N, K)
    iou_valid = torch.where(valid_prior[..., None] & gv, iou, 0.0)

    area_p = ((decoded[..., 2] - decoded[..., 0]).clamp(min=0)
              * (decoded[..., 3] - decoded[..., 1]).clamp(min=0))
    area_g = ((gt_boxes[..., 2] - gt_boxes[..., 0]).clamp(min=0)
              * (gt_boxes[..., 3] - gt_boxes[..., 1]).clamp(min=0))
    lt = torch.maximum(decoded[:, :, None, :2], gt_boxes[:, None, :, :2])
    rb = torch.minimum(decoded[:, :, None, 2:], gt_boxes[:, None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = (area_p[:, :, None] + area_g[:, None, :] - inter).clamp(min=1e-9)
    elt = torch.minimum(decoded[:, :, None, :2], gt_boxes[:, None, :, :2])
    erb = torch.maximum(decoded[:, :, None, 2:], gt_boxes[:, None, :, 2:])
    ewh = (erb - elt).clamp(min=0)
    enclose = (ewh[..., 0] * ewh[..., 1]).clamp(min=1e-9)
    giou_cost = 1.0 - (inter / union - (enclose - union) / enclose)

    # The varifocal cost of each (prior, gt) pair: the gt-class term plus
    # the all-negative sum less the gt class's negative term.
    alpha, gamma = 0.75, 2.0
    p = scores.clamp(1e-7, 1 - 1e-7)  # (B, N, C)
    t = iou
    p_at = p.gather(2, gt_labels.long()[:, None, :].expand(-1, N, -1))
    pos_term = (-(t * torch.log(p_at) + (1 - t) * torch.log(1 - p_at))
                * torch.where(t > 0, t, alpha * (p_at - t).abs() ** gamma))
    neg_all = (alpha * p ** gamma) * (-torch.log(1 - p))
    neg_at = neg_all.gather(2, gt_labels.long()[:, None, :].expand(-1, N, -1))
    vfl_cost = pos_term + (neg_all.sum(2)[..., None] - neg_at)

    zero = torch.zeros((), device=scores.device)
    inf = torch.full((), _INF, device=scores.device)
    cost = (cls_weight * vfl_cost + iou_weight * giou_cost
            + torch.where(strong, zero, inf)
            + torch.where(valid_prior[..., None], zero, inf))

    k_cand = min(candidate_topk, N)
    # topk for its values only: their order among ties does not matter.
    top_ious = torch.topk(iou_valid.transpose(1, 2), k_cand, dim=-1).values
    dynamic_k = top_ious.sum(-1).floor().long().clamp(1, k_cand)  # (B, K)
    sorted_cost = -torch.topk(-cost.transpose(1, 2), k_cand, dim=-1).values
    thresh = sorted_cost.gather(2, (dynamic_k - 1)[..., None])[..., 0]
    matched = (cost <= thresh[:, None, :]) & (cost < _INF / 2)

    best_gt = torch.where(matched, cost, torch.full_like(
        cost, float("inf"))).argmin(2)  # (B, N)
    is_pos = matched.any(2)
    pair_iou = iou.gather(2, best_gt[..., None])[..., 0]
    return is_pos, best_gt, torch.where(is_pos, pair_iou, 0.0)


def optax_sigmoid_bce(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits (the log-sum-exp form of optax)."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


class PicoDetTrainModel(ObjectDetectionTrainModel):
    """PicoDet on the detection runtime: LT-DETR's validation (mAP on the
    host), schedule, clipping, EMA and batch augmentations, its own
    module, loss and decode, and SGD by default."""

    task = "object_detection"
    val_mode = "collect"

    def __init__(self, wrapped, args: PicoDetArgs):
        # PicoDet owns its backbone (ESNet, trained from scratch);
        # ``wrapped`` is None.
        self.wrapped = wrapped
        self.args = args

    def init(self, generator, device) -> TaskModule:
        module = PicoDetModule(self.args)
        reset_cnn_parameters(module, generator)
        return TaskModule(module).to(device)

    def augment_batch(self, batch, generator, step):
        """PicoDet has no batch augmentation windows (its arguments carry
        none, so the JAX runtime's LT-DETR augmentations pass its batches
        unchanged)."""
        return batch

    def _forward(self, model, images, train: bool):
        return model.backbone(images, train)

    def _flatten(self, cls_outs, reg_outs):
        """The levels flattened: (B, N, C) class logits, (B, N, 4 R) box
        logits, (N, 2) prior centres (x, y) and (N,) strides in pixels."""
        a = self.args
        cls_flat, reg_flat, pts, sts = [], [], [], []
        for lvl, (c, rg) in enumerate(zip(cls_outs, reg_outs)):
            B, H, W, C = c.shape
            s = float(_STRIDES[lvl])
            cls_flat.append(c.reshape(B, H * W, C))
            reg_flat.append(rg.reshape(B, H * W, 4 * (a.reg_max + 1)))
            f32 = dict(dtype=torch.float32, device=c.device)
            ys = (torch.arange(H, **f32) + 0.5) * s
            xs = (torch.arange(W, **f32) + 0.5) * s
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
            sts.append(torch.full((H * W,), s, **f32))
        return (torch.cat(cls_flat, 1), torch.cat(reg_flat, 1),
                torch.cat(pts), torch.cat(sts))

    def _decode_boxes(self, reg, pts, strides):
        """(B, N, 4 R) distributions -> (B, N, 4) xyxy boxes in pixels."""
        dist = integral_decode(reg, self.args.reg_max) * strides[None, :,
                                                                 None]
        return torch.stack([pts[None, :, 0] - dist[..., 0],
                            pts[None, :, 1] - dist[..., 1],
                            pts[None, :, 0] + dist[..., 2],
                            pts[None, :, 1] + dist[..., 3]], -1)

    def loss_fn(self, model, batch, generator, step):
        a = self.args
        images = batch["images"]
        H, W = images.shape[1:3]
        cls_outs, reg_outs = self._forward(model, images, True)
        cls, reg, pts, strides = self._flatten(cls_outs, reg_outs)
        cls, reg = cls.float(), reg.float()
        boxes_px = self._decode_boxes(reg, pts, strides)
        B, N, C = cls.shape
        scale = torch.tensor([W, H, W, H], dtype=torch.float32,
                             device=cls.device)
        gt_xyxy = cxcywh_to_xyxy(batch["boxes"].float()) * scale
        gt_valid, gt_labels = batch["box_valid"], batch["labels"].long()

        scores_sg = torch.sigmoid(cls).detach()
        is_pos, assigned_gt, _ = simota_assign(
            scores_sg, pts, strides, boxes_px.detach(), gt_xyxy, gt_labels,
            gt_valid, a.center_radius, a.candidate_topk, a.iou_cost_weight,
            a.cls_cost_weight)
        tgt_boxes = gt_xyxy.gather(1, assigned_gt[..., None].expand(-1, -1,
                                                                    4))
        tgt_cls = gt_labels.gather(1, assigned_gt)

        su = strides[None, :, None]
        pred_feat = boxes_px / su
        gt_feat = tgt_boxes / su
        pos_iou = _aligned_iou(pred_feat.detach(), gt_feat).clamp(min=1e-6)

        vfl_target = (F.one_hot(tgt_cls, C).float()
                      * (pos_iou * is_pos)[..., None])
        p = torch.sigmoid(cls)
        focal_w = torch.where(vfl_target > 0, vfl_target,
                              0.75 * (p - vfl_target).abs() ** 2.0)
        vfl = (optax_sigmoid_bce(cls, vfl_target) * focal_w).sum(-1)

        weight_t = scores_sg.max(-1).values * is_pos
        n_pos = is_pos.sum(1)
        num_pos_avg = n_pos.clamp(min=1).sum().clamp(min=1)
        weight_sum_avg = weight_t.sum().clamp(min=1)
        loss_vfl = vfl.sum() / num_pos_avg

        giou = _giou_pair(pred_feat, gt_feat.detach())
        loss_giou = ((1.0 - giou) * weight_t).sum() / weight_sum_avg

        # DFL: the cross entropy to the two bins around each distance.
        centers = pts[None] / su
        gt_dist = torch.stack([centers[..., 0] - gt_feat[..., 0],
                               centers[..., 1] - gt_feat[..., 1],
                               gt_feat[..., 2] - centers[..., 0],
                               gt_feat[..., 3] - centers[..., 1]], -1)
        gt_dist = gt_dist.clamp(0.0, a.reg_max - 0.01)
        lo = gt_dist.floor().long()
        hi = lo + 1
        w_lo = hi.float() - gt_dist
        w_hi = gt_dist - lo.float()
        logp = torch.log_softmax(reg.reshape(B, N, 4, a.reg_max + 1), -1)
        ce = -(logp.gather(-1, lo[..., None])[..., 0] * w_lo
               + logp.gather(-1, hi[..., None])[..., 0] * w_hi)
        dfl = ce.sum(-1) / 4.0
        loss_dfl = (dfl * weight_t).sum() / weight_sum_avg

        loss = (a.loss_vfl_weight * loss_vfl + a.loss_giou_weight * loss_giou
                + a.loss_dfl_weight * loss_dfl)
        metrics = {"loss_vfl": loss_vfl, "loss_giou": loss_giou,
                   "loss_dfl": loss_dfl, "num_pos": n_pos.sum().float()}
        return loss, {k: v.detach() for k, v in metrics.items()}

    def _decode_flat(self, cls, boxes, image_hw):
        """The top ``max_detections`` (prior, class) pairs of each image:
        (xyxy boxes normalized to the image, scores, labels); equal scores
        in index order, as ``jax.lax.top_k``."""
        C = cls.shape[-1]
        scores = torch.sigmoid(cls.float())
        B, N, _ = scores.shape
        flat = scores.reshape(B, N * C)
        k = min(self.args.max_detections, N * C)
        top_idx = stable_topk_indices(flat, k)
        top_scores = flat.gather(1, top_idx)
        p_idx, labels = top_idx // C, top_idx % C
        sel = boxes.gather(1, p_idx[..., None].expand(-1, -1, 4))
        norm = torch.tensor([image_hw[1], image_hw[0], image_hw[1],
                             image_hw[0]], dtype=torch.float32,
                            device=boxes.device)
        return sel / norm, top_scores, labels

    def _predictions(self, model, images):
        cls_outs, reg_outs = self._forward(model, images, False)
        cls, reg, pts, strides = self._flatten(cls_outs, reg_outs)
        boxes = self._decode_boxes(reg.float(), pts, strides)
        return self._decode_flat(cls, boxes, images.shape[1:3])

    def val_step(self, model, batch) -> Dict[str, torch.Tensor]:
        images = batch["images"]
        boxes, scores, labels = self._predictions(model, images)
        valid = batch.get("valid")
        return {
            "pred_boxes": boxes, "pred_scores": scores,
            "pred_labels": labels,
            "tgt_boxes": cxcywh_to_xyxy(batch["boxes"]),
            "tgt_labels": batch["labels"], "tgt_valid": batch["box_valid"],
            "sample_valid": (valid if valid is not None else torch.ones(
                images.shape[0], dtype=torch.bool, device=images.device)),
        }

    def predict(self, model, images):
        """(xyxy normalized boxes, scores, labels) of the top
        detections."""
        return self._predictions(model, images)

    def default_optimizer_args(self):
        from lightly_train_tpu_torch._optim import SGDArgs

        return SGDArgs(lr=0.1, momentum=0.9, weight_decay=4e-5)
