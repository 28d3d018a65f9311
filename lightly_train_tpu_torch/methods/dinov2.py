"""DINOv2 pretraining method (EMA teacher, DINO + iBOT + KoLeo).

Port of ``lightly_train_tpu/methods/dinov2.py``: 2 global views and N local
views; an EMA teacher (backbone + DINO head + iBOT head) with cosine momentum
0.992 -> 1.0; DINO CLS cross-entropy across view pairs, iBOT masked-patch CE
on the global views with a fixed mask budget, KoLeo (weight 0.1);
softmax centering (EMA centers) or Sinkhorn-Knopp centering
(``center_method="sinkhorn"``); teacher temperature warmup 0.04 -> 0.07,
weight decay cosine 0.04 -> 0.4, layerwise LR decay 0.9 with patch-embed
multiplier 0.2, grad clip 3.0, prototype layers frozen for the first 1250
steps.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Literal, Mapping, Optional, Tuple

import torch
from torch import nn

from lightly_train_tpu_torch._optim import AdamWArgs, layerwise_lr_scales
from lightly_train_tpu_torch._optim.optimizers import dinov2_wd_mask
from lightly_train_tpu_torch.methods.base import Method, MethodArgs, ViewSpec
from lightly_train_tpu_torch.models.heads import DINOHead
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.ops import losses as L
from lightly_train_tpu_torch.ops.augment import ViewAugmentConfig
from lightly_train_tpu_torch.ops.ema import cosine_schedule, ema_update
from lightly_train_tpu_torch.ops.masking import random_block_masks


@dataclasses.dataclass
class DINOv2Args(MethodArgs):
    hidden_dim: int = 2048
    bottleneck_dim: int = 256
    output_dim: int = 65536
    ibot_separate_head: bool = True
    local_view_count: int = 8
    global_image_size: int = 224
    local_image_size: int = 96
    global_crop_scale: Tuple[float, float] = (0.32, 1.0)
    local_crop_scale: Tuple[float, float] = (0.05, 0.32)
    student_temp: float = 0.1
    teacher_temp_start: float = 0.04
    teacher_temp_end: float = 0.07
    teacher_temp_warmup_fraction: float = 0.3
    center_method: Literal["softmax", "sinkhorn"] = "softmax"
    center_momentum: float = 0.9
    mask_prob: float = 0.5
    mask_ratio: Tuple[float, float] = (0.1, 0.5)
    koleo_weight: float = 0.1
    ibot_weight: float = 1.0
    dino_weight: float = 1.0
    momentum_start: float = 0.992
    momentum_end: float = 1.0
    freeze_last_layer_steps: int = 1250
    layerwise_decay: float = 0.9
    patch_embed_lr_mult: float = 0.2
    weight_decay_start: float = 0.04
    weight_decay_end: float = 0.4
    reference_batch_size: int = 1024
    lr_scale_method: str = "sqrt"


def _gather_tokens(tokens: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, D) tokens at (B, M) indices -> (B, M, D)."""
    return torch.gather(tokens, 1,
                        idx[:, :, None].expand(-1, -1, tokens.shape[-1]))


class DINOv2(Method):
    name = "dinov2"
    default_steps = 125_000
    default_batch_size = 1024
    ema_teacher = True

    def __init__(self, wrapped: WrappedModel, args: DINOv2Args):
        super().__init__(wrapped, args)
        self.args: DINOv2Args = args
        # Heads follow the backbone compute dtype, as in the JAX package.
        self.head_dtype = getattr(getattr(wrapped.module, "cfg", None),
                                  "dtype", torch.float32)

    # -- views --------------------------------------------------------------
    def view_specs(self) -> List[ViewSpec]:
        a = self.args
        g, l = a.global_image_size, a.local_image_size
        g1 = ViewAugmentConfig(out_size=(g, g), crop_scale=a.global_crop_scale,
                               blur_prob=1.0)
        g2 = ViewAugmentConfig(out_size=(g, g), crop_scale=a.global_crop_scale,
                               blur_prob=0.1, solarize_prob=0.2)
        loc = ViewAugmentConfig(out_size=(l, l), crop_scale=a.local_crop_scale,
                                blur_prob=0.5)
        return [ViewSpec(g1, 1), ViewSpec(g2, 1),
                ViewSpec(loc, a.local_view_count)]

    # -- init ---------------------------------------------------------------
    def _head(self) -> DINOHead:
        a = self.args
        return DINOHead(self.wrapped.feature_dim, a.output_dim, a.hidden_dim,
                        a.bottleneck_dim, dtype=self.head_dtype)

    def init(self, generator: torch.Generator, device: torch.device
             ) -> Tuple[nn.ModuleDict, Dict[str, Any]]:
        a = self.args
        modules = {"student": self.wrapped.module, "dino_head": self._head()}
        if a.ibot_separate_head:
            modules["ibot_head"] = self._head()
        for m in modules.values():
            m.reset_parameters(generator)
        params = nn.ModuleDict(modules).to(device)
        # The teacher starts as an exact copy of the student.
        teacher = copy.deepcopy(params).requires_grad_(False)
        method_state = {
            "teacher": teacher,
            "dino_center": torch.zeros(a.output_dim, device=device),
            "ibot_center": torch.zeros(a.output_dim, device=device),
        }
        return params, method_state

    def _teacher_temp(self, step: int, total_steps: int) -> float:
        a = self.args
        warmup = max(int(a.teacher_temp_warmup_fraction * total_steps), 1)
        frac = min(max(step / warmup, 0.0), 1.0)
        return a.teacher_temp_start + frac * (
            a.teacher_temp_end - a.teacher_temp_start)

    # -- loss ---------------------------------------------------------------
    def loss_fn(self, params, method_state, views, step, total_steps,
                generator=None, masks=None):
        a = self.args
        g1, g2 = views[0], views[1]
        locals_list = views[2:]
        B = g1.shape[0]
        globals_cat = torch.cat([g1, g2], dim=0)  # (2B, H, W, 3)
        patch = self.wrapped.patch_size or 16
        gh, gw = g1.shape[1] // patch, g1.shape[2] // patch
        n_tokens = gh * gw

        # iBOT masks for the student's global views (fixed budget).
        if masks is None:
            masks, _ = random_block_masks(generator, 2 * B, (gh, gw),
                                          a.mask_prob, a.mask_ratio)
        mask = masks.to(globals_cat.device)
        # Fixed-budget masked-token gather: the iBOT heads see only the (at
        # most) n_tokens/2 masked positions, masked tokens first.
        budget = max(n_tokens // 2, 1)
        order = torch.argsort((~mask).to(torch.int32), dim=1, stable=True)
        sel_idx = order[:, :budget]
        sel_mask = torch.gather(mask, 1, sel_idx)
        n_sel = sel_mask.float().sum(dim=1, keepdim=True)
        sel_weight = sel_mask.float() / torch.clamp(n_sel, min=1.0)

        teacher = method_state["teacher"]
        teacher_temp = self._teacher_temp(step, total_steps)
        ibot_key = "ibot_head" if a.ibot_separate_head else "dino_head"

        # ---- teacher forward (no grad, no mask) ----
        with torch.no_grad():
            t_out = self.wrapped.forward_features(
                globals_cat, None, train=False, module=teacher["student"])
            t_dino_logits = teacher["dino_head"](t_out["cls_token"])
            t_ibot_logits = teacher[ibot_key](
                _gather_tokens(t_out["patch_tokens"], sel_idx))
            t_ibot_flat = t_ibot_logits.reshape(-1, a.output_dim)
            if a.center_method == "softmax":
                t_dino_probs = L.softmax_center_teacher(
                    t_dino_logits, method_state["dino_center"], teacher_temp)
                t_ibot_probs = L.softmax_center_teacher(
                    t_ibot_flat, method_state["ibot_center"], teacher_temp)
                new_dino_center = L.update_center(
                    method_state["dino_center"], t_dino_logits,
                    a.center_momentum)
                new_ibot_center = L.update_center(
                    method_state["ibot_center"], t_ibot_flat,
                    a.center_momentum, sample_weights=sel_mask.reshape(-1))
            else:
                # As the JAX package: at the starting temperature, over the
                # masked patches only for iBOT; the centers stay.
                t_dino_probs = L.sinkhorn_knopp_teacher(
                    t_dino_logits, a.teacher_temp_start)
                t_ibot_probs = L.sinkhorn_knopp_teacher(
                    t_ibot_flat, a.teacher_temp_start,
                    sample_weights=sel_mask.reshape(-1))
                new_dino_center = method_state["dino_center"]
                new_ibot_center = method_state["ibot_center"]
            t_ibot_probs = t_ibot_probs.reshape(2 * B, budget, a.output_dim)

        # ---- student forward ----
        s_out_g = self.wrapped.forward_features(
            globals_cat, mask, train=True, generator=generator,
            module=params["student"])
        s_cls_g = s_out_g["cls_token"]
        s_dino_g = params["dino_head"](s_cls_g)
        s_ibot = params[ibot_key](
            _gather_tokens(s_out_g["patch_tokens"], sel_idx))
        s_out_l = self.wrapped.forward_features(
            torch.cat(locals_list, dim=0), None, train=True,
            generator=generator, module=params["student"])
        s_dino_l = params["dino_head"](s_out_l["cls_token"])

        # ---- DINO CE over view pairs ----
        n_local = len(locals_list)
        t_probs = t_dino_probs.reshape(2, B, -1)
        s_g = s_dino_g.reshape(2, B, -1)
        s_l = s_dino_l.reshape(n_local, B, -1)
        dino_terms = []
        for ti in range(2):
            dino_terms.append(
                L.dino_cross_entropy(t_probs[ti], s_g[1 - ti], a.student_temp))
            for li in range(n_local):
                dino_terms.append(
                    L.dino_cross_entropy(t_probs[ti], s_l[li], a.student_temp))
        dino_loss = torch.stack(dino_terms).mean()

        ibot_loss = L.ibot_patch_loss(t_ibot_probs, s_ibot, sel_mask,
                                      sel_weight, a.student_temp)
        # KoLeo on student global CLS features, summed over the two views;
        # one process, so one nearest-neighbour group.
        koleo = L.koleo_loss(s_cls_g[:B]) + L.koleo_loss(s_cls_g[B:])

        loss = (a.dino_weight * dino_loss + a.ibot_weight * ibot_loss
                + a.koleo_weight * koleo)
        new_method_state = {**method_state, "dino_center": new_dino_center,
                            "ibot_center": new_ibot_center}
        metrics = {"dino_loss": dino_loss.detach(),
                   "ibot_loss": ibot_loss.detach(),
                   "koleo_loss": koleo.detach(),
                   "teacher_temp": teacher_temp}
        return loss, (new_method_state, metrics)

    # -- optimization -------------------------------------------------------
    @classmethod
    def default_optimizer_args(cls) -> AdamWArgs:
        return AdamWArgs(lr=4e-3, betas=(0.9, 0.999), weight_decay=0.04)

    def grad_clip_norm(self) -> float:
        return 3.0

    def lr_scales(self, params: Mapping[str, torch.Tensor]
                  ) -> Optional[Dict[str, float]]:
        a = self.args
        depth = getattr(getattr(self.wrapped.module, "cfg", None), "depth", None)
        if depth is None:
            return None
        scales = {name: 1.0 for name in params}
        prefix = "student."
        student = {n[len(prefix):]: p for n, p in params.items()
                   if n.startswith(prefix)}
        for name, s in layerwise_lr_scales(
            student, a.layerwise_decay, depth, a.patch_embed_lr_mult
        ).items():
            scales[prefix + name] = s
        return scales

    def weight_decay_schedule(self, total_steps: int):
        a = self.args
        return lambda step: cosine_schedule(
            step, total_steps, a.weight_decay_start, a.weight_decay_end)

    def wd_mask(self, params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
        """The reference rule: only bias/norm/gamma are exempt."""
        return dinov2_wd_mask(params)

    def post_update(self, params, method_state, step, total_steps):
        """The EMA teacher after an unfused update (SGD, LARS)."""
        ema_update(dict(method_state["teacher"].named_parameters()),
                   dict(params.named_parameters()),
                   self.fused_ema_momentum(step, total_steps))
        return method_state

    def mask_updates(self, updates, step):
        """Freeze the prototype layers early (the unfused path's
        :meth:`update_scales`)."""
        scales = self.update_scales(updates, step)
        return {name: u * scales[name] for name, u in updates.items()}

    def fused_ema_momentum(self, step: int, total_steps: int) -> float:
        a = self.args
        return cosine_schedule(step, total_steps, a.momentum_start,
                               a.momentum_end)

    def update_scales(self, params: Mapping[str, torch.Tensor], step: int
                      ) -> Dict[str, float]:
        """Freeze the prototype (weight-normed last) layers early."""
        live = 1.0 if step >= self.args.freeze_last_layer_steps else 0.0
        return {name: live if "prototypes" in name.split(".") else 1.0
                for name in params}
