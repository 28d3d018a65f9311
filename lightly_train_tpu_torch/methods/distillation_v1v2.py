"""Distillation v1 (feature MSE) and v2 (global queue similarity CE).

Port of ``lightly_train_tpu/methods/distillation_v1v2.py``. Both share the
frozen teacher, the single view and the heads of
:class:`~lightly_train_tpu_torch.methods.distillationv3.DistillationV3`.
"""

from __future__ import annotations

import dataclasses

from lightly_train_tpu_torch._optim import AdamWArgs
from lightly_train_tpu_torch.methods.distillationv3 import (
    DistillationV3,
    DistillationV3Args,
)
from lightly_train_tpu_torch.ops.losses import mse_feature_loss


@dataclasses.dataclass
class DistillationV1Args(DistillationV3Args):
    mixup_prob: float = 0.0


class DistillationV1(DistillationV3):
    """Feature-MSE distillation of the global embedding and the patch grid;
    no mixup draw and no queue."""

    name = "distillationv1"

    def loss_fn(self, params, method_state, views, step, total_steps,
                generator=None, masks=None):
        t_global, t_local, z_global, z_local = self.forward_pair(
            params, method_state, views[0], generator)
        loss_global = mse_feature_loss(z_global, t_global)
        loss_local = mse_feature_loss(z_local, t_local)
        loss = loss_global + self.args.lambda_local * loss_local
        return loss, (method_state, {"loss_global": loss_global.detach(),
                                     "loss_local": loss_local.detach()})

    def default_optimizer_args(self) -> AdamWArgs:
        return AdamWArgs(lr=1e-3, weight_decay=1e-5)


@dataclasses.dataclass
class DistillationV2Args(DistillationV3Args):
    pass


class DistillationV2(DistillationV3):
    """Queue-based distillation, global term only."""

    name = "distillationv2"

    def loss_fn(self, params, method_state, views, step, total_steps,
                generator=None, masks=None):
        loss_global, _, new_method_state = self.queue_losses(
            params, method_state, views, generator, masks)
        return loss_global, (new_method_state,
                             {"loss_global": loss_global.detach()})
