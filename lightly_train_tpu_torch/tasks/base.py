"""Fine-tuning task protocol and train state.

Port of ``lightly_train_tpu/tasks/base.py``. A :class:`TaskTrainModel` owns
the step math of one task: it builds the task's parameters (an
``nn.Module`` holding the backbone as ``backbone`` and the task's head or
heads), its loss and metrics, the per-batch validation statistics, their
reduction and the inference path. Where the JAX package threads
``params`` and ``model_state`` trees through pure functions, here the
module owns both: a CNN backbone's BatchNorm statistics are its buffers,
updated in place by train-mode forwards.

A frozen backbone's parameters do not require gradients, so its backward
(and K2 with it) does not run; the update still sees them, with zero
gradients, as the JAX chain sees the ``stop_gradient`` zeros.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from lightly_train_tpu_torch._configs.config import Config
from lightly_train_tpu_torch.models.wrapper import WrappedModel


@dataclasses.dataclass
class TaskArgs(Config):
    """Base per-task hyperparameters."""

    default_steps: int = 10_000
    default_batch_size: int = 16


@dataclasses.dataclass
class TaskTrainState:
    """What a fine-tuning step reads and updates: the task model's
    parameters and buffers, the updater with its optimizer state. The
    fields are those ``CheckpointManager`` saves (a task has no method
    state)."""

    step: int
    params: nn.Module
    updater: Any = None
    method_state: Dict[str, Any] = dataclasses.field(default_factory=dict)


class TaskModule(nn.Module):
    """A backbone and the task's head (``head``) or heads (``heads``)."""

    def __init__(self, backbone: nn.Module, head: Optional[nn.Module] = None,
                 heads: Optional[Mapping[str, nn.Module]] = None):
        super().__init__()
        self.backbone = backbone
        if head is not None:
            self.head = head
        if heads is not None:
            self.heads = nn.ModuleDict(dict(heads))


class TaskTrainModel(abc.ABC):
    """A fine-tuning architecture and objective."""

    task: str = "task"
    # The train-transform schema in ``_transforms/task_transforms.py``.
    transform_kind: Optional[str] = None
    # Set by the runtime: the training resolution, above which validation
    # runs tiled (``tasks/tiling.py``).
    val_tile_size: Optional[int] = None
    # "sum": the runtime sums ``val_step``'s statistics over the batches;
    # "collect": it hands ``val_finalize`` the list of each batch's
    # statistics on the host.
    val_mode: str = "sum"

    def __init__(self, wrapped: WrappedModel, args: TaskArgs):
        self.wrapped = wrapped
        self.args = args

    @property
    def freeze_backbone(self) -> bool:
        return bool(getattr(self.args, "freeze_backbone", False))

    @abc.abstractmethod
    def init(self, generator: torch.Generator,
             device: torch.device) -> TaskModule:
        """The task's parameters on ``device``, drawn from ``generator``;
        a frozen backbone's set not to require gradients."""

    @abc.abstractmethod
    def loss_fn(self, model: TaskModule, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator], step: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of one (micro)batch."""

    @abc.abstractmethod
    def val_step(self, model: TaskModule, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Per-batch validation statistics (summable across batches)."""

    @abc.abstractmethod
    def val_finalize(self, stats: Any) -> Dict[str, float]:
        """Reduce the validation statistics (summed, or the host list of
        ``val_mode`` "collect") to the final metrics."""

    @abc.abstractmethod
    def predict(self, model: TaskModule, images: torch.Tensor) -> torch.Tensor:
        """Inference on preprocessed (B, H, W, 3) images."""

    def wrap_pretrained(self, state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """A pretrained backbone's state dict under the names it has in
        ``TaskModule.backbone``; as it is by default."""
        return state

    def augment_batch(self, batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator],
                      step: int) -> Dict[str, torch.Tensor]:
        """The task's own batch augmentations, after the shared transform,
        on a generator stream of their own; the identity by default."""
        return batch

    def use_ema(self) -> bool:
        """Whether the runtime keeps an EMA of the parameters, which
        validation and the exports use."""
        return False

    def _frozen(self, module: TaskModule) -> TaskModule:
        if self.freeze_backbone:
            module.backbone.requires_grad_(False)
        return module

    # -- optimization defaults ---------------------------------------------
    def default_optimizer_args(self) -> Any:
        from lightly_train_tpu_torch._optim import AdamWArgs

        return AdamWArgs(lr=1e-4, weight_decay=0.05)

    def grad_clip_norm(self) -> Optional[float]:
        return None

    def lr_scales(self, params: Mapping[str, torch.Tensor]
                  ) -> Optional[Dict[str, float]]:
        return None

    def lr_schedule(self, base_lr: float, total_steps: int):
        from lightly_train_tpu_torch._optim import cosine_warmup

        return cosine_warmup(base_lr, total_steps, int(0.05 * total_steps))

    def lr_schedule_groups(self, base_lr: float, total_steps: int,
                           params: Mapping[str, torch.Tensor]):
        """(schedules, {name: index into them}) where groups of parameters
        run on schedules of their own (EoMT's two clocks); None keeps the
        one schedule of :meth:`lr_schedule`."""
        return None

    def scaled_lr(self, base_lr: float, global_batch_size: int) -> float:
        return base_lr

    @property
    def watch_metric(self) -> Tuple[str, str]:
        """(metric name, 'max'|'min') that picks ``exported_best``."""
        return ("val_loss", "min")
