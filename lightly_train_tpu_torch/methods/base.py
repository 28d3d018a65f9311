"""SSL method protocol + train state.

Port of ``lightly_train_tpu/methods/base.py``. A Method owns its view
configs, parameter and state initialization and a ``loss_fn`` that the
runtime differentiates. The JAX package threads immutable trees through a
jitted step; here the state is mutable and owned by :class:`TrainState`:

- ``params``: trainable ``nn.ModuleDict`` (student backbone + heads);
- ``method_state``: method-owned buffers and host numbers (DINOv2's EMA
  teacher and centers, distillation's frozen teacher and queue), never
  differentiated;
- ``updater``: the fused AdamW+EMA updater (``_optim/fused_update.py``) or
  the unfused chain (``_optim/update.py``), holding the optimizer state.

The unfused path calls the method's :meth:`Method.mask_updates` and
:meth:`Method.post_update` around the update, as the JAX step does; the
fused one folds both into its kernel (:meth:`Method.fused_ema_momentum`,
:meth:`Method.update_scales`).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from lightly_train_tpu_torch._configs.config import Config
from lightly_train_tpu_torch._scaling import ScalingInfo
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.ops.augment import ViewAugmentConfig


@dataclasses.dataclass
class MethodArgs(Config):
    """Base method hyperparameters."""

    reference_batch_size: int = 1024
    lr_scale_method: str = "sqrt"  # linear | sqrt

    def resolve_auto(self, scaling_info: ScalingInfo) -> None:
        """Fill "auto" fields from dataset scale. Override per method."""


@dataclasses.dataclass
class TrainState:
    """Everything a train step reads and updates."""

    step: int
    params: nn.ModuleDict
    method_state: Dict[str, Any]
    updater: Any = None


@dataclasses.dataclass(frozen=True)
class ViewSpec:
    """How many views of each config a method consumes per step."""

    config: ViewAugmentConfig
    count: int


class Method(abc.ABC):
    """A pretraining objective."""

    name: str = "method"
    default_steps: int = 125_000
    default_batch_size: int = 1024
    # Whether the method keeps an EMA teacher of the student's size (its
    # parameters a further fp32 copy of the student's).
    ema_teacher: bool = False

    def __init__(self, wrapped: WrappedModel, args: MethodArgs):
        self.wrapped = wrapped
        self.args = args

    @abc.abstractmethod
    def view_specs(self) -> List[ViewSpec]:
        """Augmentation configs; the runtime stacks same-shape views."""

    @abc.abstractmethod
    def init(
        self, generator: torch.Generator, device: torch.device
    ) -> Tuple[nn.ModuleDict, Dict[str, Any]]:
        """Returns (params, method_state) on ``device``."""

    @abc.abstractmethod
    def loss_fn(
        self,
        params: nn.ModuleDict,
        method_state: Dict[str, Any],
        views: List[torch.Tensor],
        step: int,
        total_steps: int,
        generator: Optional[torch.Generator] = None,
        masks: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Tuple[Dict[str, Any], Dict[str, Any]]]:
        """Returns (loss, (new_method_state, metrics)). ``generator`` drives
        the method's own randomness; ``masks`` pins that draw instead (the
        iBOT masks of DINOv2, mixup's ``(lam, apply)`` of distillation)."""

    def post_update(self, params: nn.ModuleDict, method_state: Dict[str, Any],
                    step: int, total_steps: int) -> Dict[str, Any]:
        """After the unfused update (the EMA teacher). Default: no-op."""
        return method_state

    def mask_updates(self, updates: Dict[str, torch.Tensor], step: int
                     ) -> Dict[str, torch.Tensor]:
        """Step-conditional masking of the unfused updates (the frozen
        prototype warmup). Default: unchanged."""
        return updates

    @classmethod
    def default_optimizer_args(cls) -> Any:
        from lightly_train_tpu_torch._optim import AdamWArgs

        return AdamWArgs(lr=1e-3)

    def learning_rate_for(self, global_batch_size: int, base_lr: float) -> float:
        from lightly_train_tpu_torch._optim import scale_lr_for_batch_size

        return scale_lr_for_batch_size(
            base_lr,
            global_batch_size,
            self.args.reference_batch_size,
            self.args.lr_scale_method,
        )

    def grad_clip_norm(self) -> Optional[float]:
        return None

    def lr_scales(self, params: Mapping[str, torch.Tensor]
                  ) -> Optional[Dict[str, float]]:
        """Per-parameter LR multipliers; None = uniform."""
        return None

    def wd_mask(self, params: Mapping[str, torch.Tensor]
                ) -> Optional[Dict[str, bool]]:
        """Weight-decay mask; None = the generic no-decay default."""
        return None

    def weight_decay_schedule(self, total_steps: int) -> Optional[Any]:
        return None

    def fused_ema_momentum(self, step: int, total_steps: int
                           ) -> Optional[float]:
        """EMA momentum IF the method's post-update is exactly the teacher
        EMA ``t <- m*t + (1-m)*p`` (opts into the fused AdamW+EMA update)."""
        return None

    def update_scales(self, params: Mapping[str, torch.Tensor], step: int
                      ) -> Optional[Dict[str, float]]:
        """Per-parameter multipliers on the final update (freezing)."""
        return None


def enqueue_rows(queue: torch.Tensor, ptr: int, rows: torch.Tensor
                 ) -> torch.Tensor:
    """A ring queue with ``rows`` written from slot ``ptr`` on: slot
    ``(ptr + j) % Q`` takes row j. Where B > Q several rows map to one
    slot and the last one written stays, as on the JAX package's CPU path,
    so only the last ``min(B, Q)`` rows are written, each to its own slot
    (a scatter with repeated indices has no defined order on the card).
    Returns a new tensor."""
    Q, B = queue.shape[0], rows.shape[0]
    n = min(B, Q)
    idx = torch.arange(B - n, B, device=queue.device).add_(ptr).remainder_(Q)
    return queue.index_copy(0, idx, rows[B - n:].float())
