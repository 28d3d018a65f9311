"""LT-DETR object detection.

Port of ``lightly_train_tpu/tasks/detection/ltdetr.py``: the backbone's
feature pyramid (a ViT's three final-norm taps through DINOSTAs, or a
pyramid backbone's last three ``stage_features``), the HybridEncoder, the
DETR decoder (D-FINE or RT-DETRv2) with denoising groups, the criterion,
and the step-windowed Mosaic / MixUp / zoom-out / rotate-90 of
``augment_batch``. The trunk runs in eval mode (no drop path, a CNN's
BatchNorm on its running statistics) and trains; the detection head runs
in fp32 in every precision, as in the JAX package. Validation collects
each batch's top-k detections on the host (``val_mode`` "collect") for
``metrics.py::compute_map``; the runtime validates and exports the EMA of
the parameters (``use_ema``).

The samplers take their draws explicitly: :meth:`dn_draws` and
:meth:`aug_draws` draw them from the step's generator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch.models.vit import VisionTransformer
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.ops import detection_augs as DA
from lightly_train_tpu_torch.tasks.base import (
    TaskArgs,
    TaskModule,
    TaskTrainModel,
)
from lightly_train_tpu_torch.tasks.detection.backbone_adapter import (
    DINOSTAs,
    resolve_vit_adapter,
)
from lightly_train_tpu_torch.tasks.detection.box_utils import (
    clip,
    cxcywh_to_xyxy,
)
from lightly_train_tpu_torch.tasks.detection.components import (
    DETRDecoder,
    DetrConfig,
    HybridEncoder,
    reset_detr_parameters,
    stable_topk_indices,
)
from lightly_train_tpu_torch.tasks.detection.criterion import (
    detection_criterion,
    detection_loss_from_assignment,
    dfine_fgl_ddf_loss,
)
from lightly_train_tpu_torch.tasks.detection.metrics import compute_map


@dataclasses.dataclass
class ObjectDetectionArgs(TaskArgs):
    num_classes: int = 80
    num_queries: int = 300
    d_model: int = 256
    # The HybridEncoder's width and FFN where they differ from the
    # decoder's; None: d_model / dim_feedforward.
    enc_d_model: Optional[int] = None
    enc_dim_feedforward: Optional[int] = None
    expansion: float = 1.0
    csp_blocks: int = 3
    upsample: bool = True
    num_decoder_layers: int = 3
    num_heads: int = 8
    dim_feedforward: int = 1024
    max_detections: int = 100
    score_threshold: float = 0.0
    # Step windows [start, stop) of the batch augmentations, or None.
    mosaic_window: Optional[Tuple[int, int]] = None
    mosaic_prob: float = 0.5
    mixup_window: Optional[Tuple[int, int]] = None
    mixup_prob: float = 0.5
    zoom_out_window: Optional[Tuple[int, int]] = None
    zoom_out_prob: float = 0.3
    rotate90_prob: float = 0.0
    # Denoising groups of noised targets before the queries (0: none).
    dn_groups: int = 2
    dn_box_noise: float = 0.4
    dn_label_noise: float = 0.25
    decoder: str = "dfine"  # or "rtdetrv2"
    num_points: Tuple[int, int, int] = (4, 4, 4)
    dfine_bins: int = 33
    # The ViT adapter's taps and STA width; None: by model size.
    interaction_indexes: Optional[Tuple[int, int, int]] = None
    use_sta: bool = True
    conv_inplane: Optional[int] = None
    default_steps: int = 60_000
    default_batch_size: int = 16


def _trunk_forward(trunk: nn.Module, images: torch.Tensor,
                   tap_indices: Optional[Tuple[int, ...]]):
    if isinstance(trunk, VisionTransformer) and tap_indices is not None:
        return trunk(images, train=False, tap_indices=tap_indices)
    return trunk(images, train=False)


class LTDETRModule(nn.Module):
    """The trunk, the ViT adapter (``backbone_sta``), the encoder and the
    decoder, under the JAX module's names."""

    def __init__(self, trunk: nn.Module, feature_dim: int, cfg: DetrConfig,
                 interaction_indexes: Optional[Tuple[int, int, int]],
                 use_sta: bool, conv_inplane: int):
        super().__init__()
        self.cfg = cfg
        self.trunk = trunk
        self.tap_indices = (tuple(interaction_indexes)
                            if interaction_indexes is not None else None)
        probe = self._probe(trunk)
        self.pyramid = probe is not None
        if self.pyramid:
            in_channels = probe
        else:
            self.backbone_sta = DINOSTAs(feature_dim, cfg.enc_dim, use_sta,
                                         conv_inplane, cfg.dtype)
            in_channels = [cfg.enc_dim] * 3
        self.encoder = HybridEncoder(cfg, in_channels)
        self.decoder = DETRDecoder(cfg, [cfg.enc_dim] * 3)

    @staticmethod
    def _probe(trunk: nn.Module) -> Optional[List[int]]:
        """The channels of a pyramid backbone's last three stage features
        (ECViT's from its config; a CNN's from one small forward, which
        runs no attention), None for a ViT."""
        if isinstance(trunk, VisionTransformer):
            return None
        if hasattr(trunk, "stage_channels"):
            return trunk.stage_channels()
        device = next(trunk.parameters()).device
        with torch.no_grad():
            out = trunk(torch.zeros(1, 64, 64, 3, device=device), train=False)
        feats = out.get("stage_features")
        if feats is None or len(feats) < 3:
            return None
        return [int(f.shape[-1]) for f in feats[-3:]]

    def forward(self, images: torch.Tensor, train: bool = False,
                dn_labels: Optional[torch.Tensor] = None,
                dn_boxes: Optional[torch.Tensor] = None,
                dn_group_size: int = 0):
        """(outputs, dists, taps): the decoder's levels and D-FINE's corner
        distributions (``DETRDecoder.forward``), and what the JAX module
        sows for the instance-segmentation head: ``query_states`` (each
        decoder layer's queries), ``trunk_features`` (the trunk's final
        feature map, (B, h, w, C)) and ``enc_p3`` (the encoder's finest
        level, (B, H/8, W/8, enc_dim))."""
        out = _trunk_forward(self.trunk, images, self.tap_indices)
        if self.pyramid:
            feats = out["stage_features"][-3:]
        else:
            taps = out.get("taps")
            if taps is None:
                f = out["features"]
                taps = [f, f, f]
            feats = self.backbone_sta(images, taps, train)
        levels = self.encoder(feats, train)
        outputs, dists, query_states = self.decoder(
            levels, train, dn_labels=dn_labels, dn_boxes=dn_boxes,
            dn_group_size=dn_group_size)
        return outputs, dists, {"query_states": query_states,
                                "trunk_features": out["features"],
                                "enc_p3": levels[0]}


def _pad_logits(outputs):
    """The criterion's and ``_decode``'s contract: one extra ignored class
    column."""
    return [(F.pad(lg, (0, 1)), bx) for lg, bx in outputs]


class ObjectDetectionTrainModel(TaskTrainModel):
    task = "object_detection"
    val_mode = "collect"

    def __init__(self, wrapped: WrappedModel, args: ObjectDetectionArgs):
        super().__init__(wrapped, args)
        self.args: ObjectDetectionArgs = args
        self.cfg = DetrConfig(
            d_model=args.d_model, enc_d_model=args.enc_d_model,
            num_heads=args.num_heads, num_queries=args.num_queries,
            num_decoder_layers=args.num_decoder_layers,
            dim_feedforward=args.dim_feedforward,
            enc_dim_feedforward=(args.enc_dim_feedforward
                                 or args.dim_feedforward),
            expansion=args.expansion, csp_blocks=args.csp_blocks,
            upsample=args.upsample, num_classes=args.num_classes,
            use_dfine=args.decoder == "dfine",
            num_points=tuple(args.num_points), dfine_bins=args.dfine_bins)
        indexes, inplane = args.interaction_indexes, args.conv_inplane
        trunk_cfg = getattr(wrapped.module, "cfg", None)
        if trunk_cfg is not None and hasattr(trunk_cfg, "depth"):
            auto_idx, factor = resolve_vit_adapter(trunk_cfg.embed_dim,
                                                   trunk_cfg.depth)
            if indexes is None:
                indexes = auto_idx
            if inplane is None:
                inplane = factor * getattr(trunk_cfg, "patch_size", 16)
        self.interaction_indexes = (tuple(indexes) if indexes is not None
                                    else None)
        self.conv_inplane = inplane if inplane is not None else 32

    def init(self, generator, device) -> TaskModule:
        trunk = self.wrapped.module
        trunk.reset_parameters(generator)
        module = LTDETRModule(trunk, self.wrapped.feature_dim, self.cfg,
                              self.interaction_indexes, self.args.use_sta,
                              self.conv_inplane)
        for name, child in module.named_children():
            if name != "trunk":
                reset_detr_parameters(child, generator)
        return TaskModule(module).to(device)

    def wrap_pretrained(self, state):
        """The backbone's weights sit under ``trunk``."""
        return {f"trunk.{k}": v for k, v in state.items()}

    # -- draws ----------------------------------------------------------------
    def dn_draws(self, generator, shape: Tuple[int, int],
                 device) -> Tuple[torch.Tensor, ...]:
        """The denoising queries' draws for (B, G K) slots: centre and size
        uniforms (B, G K, 2) each, random labels (B, G K) and the flip
        uniforms (B, G K)."""
        u = lambda s: DA.sample_uniform(generator, s, device)  # noqa: E731
        gen_device = generator.device if generator is not None else device
        u_box, u_size = u(shape + (2,)), u(shape + (2,))
        rand_label = torch.randint(0, self.args.num_classes, shape,
                                   generator=generator,
                                   device=gen_device).to(device)
        return u_box, u_size, rand_label, u(shape)

    def aug_draws(self, generator, B: int, device) -> Dict[str, Any]:
        """The draws of :meth:`augment_batch`'s enabled augmentations."""
        a = self.args
        u = lambda *s: DA.sample_uniform(generator, s, device)  # noqa: E731
        d: Dict[str, Any] = {}
        if a.rotate90_prob > 0:
            d["rot90"] = (u(B), DA.sample_quarter_turns(generator, B, device))
        if a.zoom_out_window is not None:
            d["zoom"] = (u(B), u(B), u(B, 2))
        if a.mosaic_window is not None:
            d["mosaic"] = (u(B),)
        if a.mixup_window is not None:
            d["mixup"] = (u(B), DA.sample_beta_half(generator, B, device))
        return d

    # -- augmentations --------------------------------------------------------
    def augment_batch(self, batch: Dict[str, torch.Tensor], generator,
                      step: int) -> Dict[str, torch.Tensor]:
        """Rotate-90, then zoom-out, Mosaic and MixUp, each at its
        probability inside its step window (gated to 0 outside it); a batch
        with none enabled passes unchanged."""
        a = self.args
        if not (a.mosaic_window or a.mixup_window or a.zoom_out_window
                or a.rotate90_prob):
            return batch
        images, boxes = batch["images"], batch["boxes"]
        labels, valid = batch["labels"], batch["box_valid"]
        d = self.aug_draws(generator, images.shape[0], images.device)
        if a.rotate90_prob > 0:
            images, boxes = DA.random_rotate90(images, boxes, *d["rot90"],
                                               prob=a.rotate90_prob)
        if a.zoom_out_window is not None:
            p = DA.window_gate(step, *a.zoom_out_window) * a.zoom_out_prob
            images, boxes = DA.random_zoom_out(images, boxes, *d["zoom"],
                                               prob=p)
        if a.mosaic_window is not None:
            p = DA.window_gate(step, *a.mosaic_window) * a.mosaic_prob
            images, boxes, labels, valid = DA.mosaic(
                images, boxes, labels, valid, *d["mosaic"], prob=p)
        if a.mixup_window is not None:
            p = DA.window_gate(step, *a.mixup_window) * a.mixup_prob
            images, boxes, labels, valid = DA.detection_mixup(
                images, boxes, labels, valid, *d["mixup"], prob=p)
        return {**batch, "images": images, "boxes": boxes, "labels": labels,
                "box_valid": valid}

    # -- loss -----------------------------------------------------------------
    def make_dn_queries(self, labels, boxes, valid, draws):
        """Noised target queries in ``dn_groups`` groups: centres jittered
        within +-0.5 wh noise, sizes scaled in [1 - noise, 1 + noise], labels
        replaced at the label-noise rate; invalid slots take the no-object
        embedding. Returns (labels, boxes, target labels, target boxes,
        target flags)."""
        a = self.args
        G = a.dn_groups
        u_box, u_size, rand_label, u_flip = draws
        t_labels = labels.repeat(1, G)
        t_boxes = boxes.repeat(1, G, 1)
        t_valid = valid.repeat(1, G)
        wh = t_boxes[..., 2:]
        c_noise = (u_box - 0.5) * wh * a.dn_box_noise
        s_noise = 1.0 + (u_size - 0.5) * 2.0 * a.dn_box_noise
        noised_boxes = torch.cat([t_boxes[..., :2] + c_noise, wh * s_noise],
                                 -1).clamp(1e-4, 1.0)
        noised = torch.where(u_flip < a.dn_label_noise, rand_label.to(
            t_labels.dtype), t_labels)
        noised = torch.where(t_valid, noised,
                             torch.full_like(noised, a.num_classes))
        return noised, noised_boxes, t_labels, t_boxes, t_valid

    def loss_fn(self, model, batch, generator, step):
        a = self.args
        labels, boxes, valid = (batch["labels"], batch["boxes"],
                                batch["box_valid"])
        dn_kwargs: Dict[str, Any] = {}
        if a.dn_groups > 0:
            B, K = labels.shape
            draws = self.dn_draws(generator, (B, a.dn_groups * K),
                                  labels.device)
            (dn_labels, dn_boxes, dn_tgt_labels, dn_tgt_boxes,
             dn_tgt_valid) = self.make_dn_queries(labels, boxes, valid, draws)
            dn_kwargs = dict(dn_labels=dn_labels, dn_boxes=dn_boxes,
                             dn_group_size=K)
        outputs, raw, _ = model.backbone(batch["images"], train=True,
                                         **dn_kwargs)
        outputs = _pad_logits(outputs)
        dfine_dists = [None, None] + list(raw) if raw else None
        if dn_kwargs:
            n_dn = dn_kwargs["dn_labels"].shape[1]
            match_outputs = [outputs[0]] + [(lg[:, n_dn:], bx[:, n_dn:])
                                            for lg, bx in outputs[1:]]
            dn_outputs = [(lg[:, :n_dn], bx[:, :n_dn])
                          for lg, bx in outputs[1:]]
            if dfine_dists is not None:
                dfine_dists = [None, None] + [(d[:, n_dn:], b[:, n_dn:])
                                              for d, b in raw]
        else:
            match_outputs, dn_outputs = outputs, []
        loss, metrics = detection_criterion(match_outputs, labels, boxes,
                                            valid, dists=dfine_dists)
        if dn_outputs:
            dn_total = self._dn_loss(dn_outputs, raw, n_dn, dn_tgt_labels,
                                     dn_tgt_boxes, dn_tgt_valid)
            metrics = {**metrics, "dn_loss": dn_total}
            loss = loss + dn_total
        return loss, {k: v.detach() for k, v in metrics.items()}

    def _dn_loss(self, dn_outputs, raw, n_dn, tgt_labels, tgt_boxes,
                 tgt_valid) -> torch.Tensor:
        """The denoising levels' losses, summed: the assignment is the
        identity onto the dn slots, normalized by targets x groups."""
        B = tgt_valid.shape[0]
        ids = torch.arange(n_dn, device=tgt_valid.device)
        identity = torch.where(tgt_valid, ids[None], -1)
        dn_num = tgt_valid.sum().float().clamp(min=1.0)
        dn_q = ids[None].expand(B, -1)
        dn_dists = ([None] + [(d[:, :n_dn], b[:, :n_dn]) for d, b in raw]
                    if raw else None)
        teacher = dn_dists[-1] if dn_dists else None
        total = 0.0
        for lv, (lg, bx) in enumerate(dn_outputs):
            bx = clip(bx, 0.0, 1.0)
            losses = detection_loss_from_assignment(lg, bx, tgt_labels,
                                                    tgt_boxes, identity)
            lvl = (losses["loss_vfl"] + 5.0 * losses["loss_l1"]
                   + 2.0 * losses["loss_giou"])
            if dn_dists is not None and dn_dists[lv] is not None:
                fgl, ddf = dfine_fgl_ddf_loss(
                    dn_dists[lv][0], dn_dists[lv][1], bx, teacher[0],
                    dn_outputs[-1][0], tgt_boxes, dn_q, dn_q, tgt_valid,
                    dn_num, is_final=lv == len(dn_outputs) - 1)
                lvl = lvl + 0.15 * fgl + 1.5 * ddf
            total = total + lvl
        return total

    # -- inference ------------------------------------------------------------
    def _decode(self, outputs, return_q: bool = False):
        """The last level's top ``max_detections`` (query, class) pairs:
        (xyxy boxes, scores, labels), and with ``return_q`` their query
        indices."""
        logits, boxes = outputs[-1]
        C = self.args.num_classes
        scores = torch.sigmoid(logits[..., :C])
        B, Q, _ = scores.shape
        flat = scores.reshape(B, Q * C)
        k = min(self.args.max_detections, Q * C)
        top_idx = stable_topk_indices(flat, k)
        top_scores = flat.gather(1, top_idx)
        q_idx, cls_idx = top_idx // C, top_idx % C
        sel = boxes.gather(1, q_idx[..., None].expand(-1, -1, 4))
        if return_q:
            return cxcywh_to_xyxy(sel), top_scores, cls_idx, q_idx
        return cxcywh_to_xyxy(sel), top_scores, cls_idx

    def _outputs(self, model, images):
        outputs, _, _ = model.backbone(images, train=False)
        return _pad_logits(outputs)

    def val_step(self, model, batch) -> Dict[str, torch.Tensor]:
        images = batch["images"]
        boxes, scores, labels = self._decode(self._outputs(model, images))
        valid = batch.get("valid")
        return {
            "pred_boxes": boxes, "pred_scores": scores,
            "pred_labels": labels,
            "tgt_boxes": cxcywh_to_xyxy(batch["boxes"]),
            "tgt_labels": batch["labels"], "tgt_valid": batch["box_valid"],
            "sample_valid": (valid if valid is not None else torch.ones(
                images.shape[0], dtype=torch.bool, device=images.device)),
        }

    def val_finalize(self, collected: List[Dict[str, np.ndarray]]
                     ) -> Dict[str, float]:
        predictions, targets = [], []
        for c in collected:
            c = {k: np.asarray(v) for k, v in c.items()}
            for b in range(c["pred_boxes"].shape[0]):
                if not bool(c["sample_valid"][b]):
                    continue
                keep = c["pred_scores"][b] > self.args.score_threshold
                predictions.append({"boxes": c["pred_boxes"][b][keep],
                                    "scores": c["pred_scores"][b][keep],
                                    "labels": c["pred_labels"][b][keep]})
                tv = c["tgt_valid"][b]
                targets.append({"boxes": c["tgt_boxes"][b][tv],
                                "labels": c["tgt_labels"][b][tv]})
        out = compute_map(predictions, targets)
        return {"val_map": out["map"], "val_map50": out["map50"]}

    def predict(self, model, images):
        """(xyxy normalized boxes, scores, labels) of the top detections."""
        return self._decode(self._outputs(model, images))

    # -- optimization ---------------------------------------------------------
    def default_optimizer_args(self):
        from lightly_train_tpu_torch._optim import AdamWArgs

        return AdamWArgs(lr=2e-4, weight_decay=1e-4)

    def grad_clip_norm(self):
        return 0.1

    def lr_schedule(self, base_lr: float, total_steps: int):
        from lightly_train_tpu_torch._optim.schedules import flat_cosine

        return flat_cosine(base_lr, total_steps,
                           warmup_steps=int(0.02 * total_steps))

    def use_ema(self) -> bool:
        return True

    @property
    def watch_metric(self):
        return ("val_map", "max")
