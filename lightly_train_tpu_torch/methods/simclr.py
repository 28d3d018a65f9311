"""SimCLR: NT-Xent over two views.

Port of ``lightly_train_tpu/methods/simclr.py``: two views of one view
config, one student forward over both views concatenated, the two-layer
projection head and NT-Xent over the (2B, 2B) similarity; LARS by default.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from lightly_train_tpu_torch._optim import LARSArgs
from lightly_train_tpu_torch.methods.base import Method, MethodArgs, ViewSpec
from lightly_train_tpu_torch.models.heads import SimCLRProjectionHead
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.ops.augment import ViewAugmentConfig
from lightly_train_tpu_torch.ops.losses import ntxent_loss


@dataclasses.dataclass
class SimCLRArgs(MethodArgs):
    image_size: int = 224
    temperature: float = 0.5
    hidden_dim: int = 2048
    output_dim: int = 128
    reference_batch_size: int = 256
    lr_scale_method: str = "sqrt"


class SimCLR(Method):
    name = "simclr"
    default_steps = 100_000
    default_batch_size = 256

    def __init__(self, wrapped: WrappedModel, args: SimCLRArgs):
        super().__init__(wrapped, args)
        self.args: SimCLRArgs = args

    def view_specs(self) -> List[ViewSpec]:
        s = self.args.image_size
        return [ViewSpec(ViewAugmentConfig(out_size=(s, s)), 2)]

    def init(self, generator: torch.Generator, device: torch.device
             ) -> Tuple[nn.ModuleDict, Dict[str, Any]]:
        a = self.args
        modules = {"student": self.wrapped.module,
                   "head": SimCLRProjectionHead(self.wrapped.feature_dim,
                                                a.hidden_dim, a.output_dim)}
        for m in modules.values():
            m.reset_parameters(generator)
        return nn.ModuleDict(modules).to(device), {}

    def loss_fn(self, params, method_state, views, step, total_steps,
                generator=None, masks=None):
        v0, v1 = views[0], views[1]
        B = v0.shape[0]
        out = self.wrapped.forward_features(
            torch.cat([v0, v1], dim=0), None, train=True,
            generator=generator, module=params["student"])
        z = params["head"](self.wrapped.forward_pool(out))
        loss = ntxent_loss(z[:B], z[B:], self.args.temperature)
        return loss, (method_state, {"ntxent_loss": loss.detach()})

    @classmethod
    def default_optimizer_args(cls) -> LARSArgs:
        return LARSArgs(lr=0.3, momentum=0.9, weight_decay=1e-6)
