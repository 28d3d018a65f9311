"""Classic DINO: an EMA teacher, multi-crop, the DINO head and the
softmax-centered teacher cross-entropy.

Port of ``lightly_train_tpu/methods/dino.py``: 2 global views at 224^2
(scale 0.14-1.0) and 6 local views at 96^2 (scale 0.05-0.14), the
DINO head on the pooled features, CE between the centered teacher targets of
each global view and the student's other global and local views; teacher
temperature warmup 0.04 -> 0.07, the center's EMA 0.9, the teacher's EMA
over the backbone and the head from ``momentum_start`` (by dataset size
when "auto", ``resolve_auto``) to 1.0, grad clip 3.0, prototypes frozen for
the first 1250 steps. AdamW takes the fused AdamW+EMA update.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Tuple, Union

import torch
from torch import nn

from lightly_train_tpu_torch._configs.config import AUTO, Auto
from lightly_train_tpu_torch._optim import AdamWArgs
from lightly_train_tpu_torch._scaling import (
    IMAGENET_SIZE,
    ScalingInfo,
    interpolate,
)
from lightly_train_tpu_torch.methods.base import Method, MethodArgs
from lightly_train_tpu_torch.methods.dinov2 import DINOv2
from lightly_train_tpu_torch.models.heads import DINOHead
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.ops import losses as L
from lightly_train_tpu_torch.ops.ema import cosine_schedule


@dataclasses.dataclass
class DINOArgs(MethodArgs):
    hidden_dim: int = 2048
    bottleneck_dim: int = 256
    output_dim: int = 65536
    local_view_count: int = 6
    global_image_size: int = 224
    local_image_size: int = 96
    global_crop_scale: Tuple[float, float] = (0.14, 1.0)
    local_crop_scale: Tuple[float, float] = (0.05, 0.14)
    student_temp: float = 0.1
    teacher_temp_start: float = 0.04
    teacher_temp_end: float = 0.07
    teacher_temp_warmup_fraction: float = 0.3
    center_momentum: float = 0.9
    momentum_start: Union[float, Auto] = AUTO
    momentum_end: float = 1.0
    freeze_last_layer_steps: int = 1250
    reference_batch_size: int = 1024
    lr_scale_method: str = "sqrt"

    def resolve_auto(self, scaling_info: ScalingInfo) -> None:
        if self.momentum_start == AUTO:
            # Smaller datasets start the teacher's EMA lower.
            self.momentum_start = interpolate(
                scaling_info.dataset_size, input_start=20_000,
                input_end=IMAGENET_SIZE, value_start=0.99, value_end=0.996,
                round_ndigits=4)


class DINO(Method):
    name = "dino"
    default_steps = 125_000
    default_batch_size = 1024
    ema_teacher = True

    def __init__(self, wrapped: WrappedModel, args: DINOArgs):
        super().__init__(wrapped, args)
        self.args: DINOArgs = args
        # The head follows the backbone's compute dtype.
        self.head_dtype = getattr(getattr(wrapped.module, "cfg", None),
                                  "dtype", torch.float32)

    def init(self, generator: torch.Generator, device: torch.device
             ) -> Tuple[nn.ModuleDict, Dict[str, Any]]:
        a = self.args
        modules = {"student": self.wrapped.module,
                   "head": DINOHead(self.wrapped.feature_dim, a.output_dim,
                                    a.hidden_dim, a.bottleneck_dim,
                                    dtype=self.head_dtype)}
        for m in modules.values():
            m.reset_parameters(generator)
        params = nn.ModuleDict(modules).to(device)
        return params, {
            "teacher": copy.deepcopy(params).requires_grad_(False),
            "center": torch.zeros(a.output_dim, device=device),
        }

    def _pooled(self, module: nn.Module, images: torch.Tensor, train: bool,
                generator=None) -> torch.Tensor:
        out = self.wrapped.forward_features(images, None, train=train,
                                            generator=generator, module=module)
        return self.wrapped.forward_pool(out)

    def loss_fn(self, params, method_state, views, step, total_steps,
                generator=None, masks=None):
        a = self.args
        g1, g2 = views[0], views[1]
        locals_list = views[2:]
        B = g1.shape[0]
        globals_cat = torch.cat([g1, g2], dim=0)
        teacher = method_state["teacher"]
        with torch.no_grad():
            t_logits = teacher["head"](
                self._pooled(teacher["student"], globals_cat, False))
            t_probs = L.softmax_center_teacher(
                t_logits, method_state["center"],
                self._teacher_temp(step, total_steps)).reshape(2, B, -1)
            new_center = L.update_center(method_state["center"], t_logits,
                                         a.center_momentum)
        s_g = params["head"](self._pooled(
            params["student"], globals_cat, True, generator)).reshape(2, B, -1)
        s_l = params["head"](self._pooled(
            params["student"], torch.cat(locals_list, dim=0), True,
            generator)).reshape(len(locals_list), B, -1)
        terms = []
        for ti in range(2):
            terms.append(L.dino_cross_entropy(t_probs[ti], s_g[1 - ti],
                                              a.student_temp))
            for li in range(len(locals_list)):
                terms.append(L.dino_cross_entropy(t_probs[ti], s_l[li],
                                                  a.student_temp))
        loss = torch.stack(terms).mean()
        return loss, ({**method_state, "center": new_center},
                      {"dino_loss": loss.detach()})

    @classmethod
    def default_optimizer_args(cls) -> AdamWArgs:
        return AdamWArgs(lr=5e-4 * 1024 / 256, weight_decay=0.04)

    def grad_clip_norm(self) -> float:
        return 3.0

    def fused_ema_momentum(self, step: int, total_steps: int) -> float:
        a = self.args
        m_start = a.momentum_start if a.momentum_start != AUTO else 0.996
        return cosine_schedule(step, total_steps, m_start, a.momentum_end)

    # As DINOv2's: the multi-crop views (their sizes and scales from the
    # args), the teacher temperature warmup, the whole-tree EMA after an
    # unfused update, and the prototype layer frozen early.
    view_specs = DINOv2.view_specs
    _teacher_temp = DINOv2._teacher_temp
    post_update = DINOv2.post_update
    update_scales = DINOv2.update_scales
    mask_updates = DINOv2.mask_updates
