"""DistillationV3: queue-based distillation from a frozen teacher (the
default method).

Port of ``lightly_train_tpu/methods/distillationv3.py``:

- a frozen teacher backbone (default ``dinov3/vitb16``), held in
  ``method_state`` with ``requires_grad=False`` and run under
  ``torch.no_grad()``, never in ``params``. It computes in fp32 whatever the
  run's precision, as the JAX package builds it at its default dtype, and so
  do the two projection heads;
- one augmented view, with batch mixup (each image blended with its
  neighbour in the batch);
- two linear heads on the student: global (CLS) and local (the patch grid,
  resampled to the teacher's grid as ``jax.image.resize(..., "bilinear")``
  does it, with antialiasing where it downsamples);
- similarity cross-entropy against a ring buffer of past teacher global
  embeddings (size bucketed by dataset size, 16 -> 8192), for the global and
  the local term; while the queue is empty the batch's own teacher
  embeddings stand in for it;
- the batch's teacher embeddings enqueued after the loss.

``queue_ptr`` and ``queue_filled`` depend only on the batch and queue sizes,
so they are host integers: the branch on an empty queue reads nothing from
the device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from lightly_train_tpu_torch._checkpoint.checkpoint import (
    resolve_pretrained_source,
)
from lightly_train_tpu_torch._configs.config import AUTO, Auto
from lightly_train_tpu_torch._optim import LARSArgs
from lightly_train_tpu_torch._scaling import ScalingInfo, get_bucket_value
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.methods.base import Method, MethodArgs, ViewSpec
from lightly_train_tpu_torch.models.heads import ProjectionHead
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.ops.augment import ViewAugmentConfig
from lightly_train_tpu_torch.ops.losses import similarity_queue_ce


@dataclasses.dataclass
class DistillationV3Args(MethodArgs):
    teacher: str = "dinov3/vitb16"
    # A torch checkpoint file (Meta/timm naming) or an exported_models
    # artifact folder; None: a random teacher.
    teacher_weights: Optional[str] = None
    queue_size: Union[int, Auto] = AUTO
    temperature: float = 0.07
    mixup_prob: float = 0.5
    image_size: int = 224
    lambda_local: float = 1.0
    reference_batch_size: int = 1536
    lr_scale_method: str = "linear"

    def resolve_auto(self, scaling_info: ScalingInfo) -> None:
        if self.queue_size == AUTO:
            self.queue_size = get_bucket_value(
                scaling_info.dataset_size,
                [(1_000, 16), (10_000, 128), (100_000, 1024),
                 (1_000_000, 4096), (float("inf"), 8192)],
            )


def load_teacher_weights(path: str, teacher: str) -> Dict[str, torch.Tensor]:
    """The teacher's state dict: a torch checkpoint file converted for
    ``teacher``, or an exported artifact folder, which must have been
    exported for ``teacher``."""
    state, model_name, _ = resolve_pretrained_source(path, teacher)
    if model_name != teacher:
        raise ConfigError(
            f"teacher_weights was exported for model '{model_name}' but the "
            f"teacher is '{teacher}'. Pass method_args teacher="
            f"'{model_name}' or matching weights."
        )
    return state


def mixup(images: torch.Tensor, lam: torch.Tensor,
          apply: torch.Tensor) -> torch.Tensor:
    """Blend each image with the one before it in the batch (the batch
    rolled by one) by ``lam`` where ``apply``; (B, 1, 1, 1) each."""
    mixed = lam * images + (1.0 - lam) * torch.roll(images, 1, dims=0)
    return torch.where(apply, mixed, images)


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis (its ``compute_weight_mat``): a triangle kernel at the
    output pixels' centres, widened by in / out where it downsamples (the
    antialiasing), each output's weights normalized to sum 1."""
    f32 = np.float32
    inv_scale = in_size / out_size
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).T.astype(f32)


# (in, out, device) -> resize_weights on the device.
_RESIZE_WEIGHTS: Dict[tuple, torch.Tensor] = {}


def resample_grid(z: torch.Tensor, grid_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, D) -> (B, gh, gw, D) as ``jax.image.resize(...,
    "bilinear")``: one product with :func:`resize_weights` along each axis
    (float32). ``F.interpolate(..., antialias=True)`` gives the same values
    within rounding, but its backward on the card accumulates with atomic
    adds, so two runs of one step differ; these products do not."""
    if tuple(z.shape[1:3]) == tuple(grid_hw):
        return z
    ry, rx = (_RESIZE_WEIGHTS.setdefault(
        (n, m, z.device),
        torch.from_numpy(resize_weights(n, m)).to(z.device))
        for n, m in zip(z.shape[1:3], grid_hw))
    z = torch.einsum("xw,bhwd->bhxd", rx, z.float())
    return torch.einsum("oh,bhxd->boxd", ry, z)


def enqueue(method_state: Dict[str, Any],
            t_global: torch.Tensor) -> Dict[str, Any]:
    """Ring-buffer enqueue of the batch's teacher embeddings. Slot
    ``(ptr + j) % Q`` takes row j; where B > Q several rows map to one
    slot and the last one written stays, as on the JAX package's CPU
    path, so only the last ``min(B, Q)`` rows are written, each to its
    own slot (a scatter with repeated indices has no defined order on
    the card)."""
    queue = method_state["queue"]
    Q, B = queue.shape[0], t_global.shape[0]
    ptr, n = method_state["queue_ptr"], min(B, Q)
    idx = torch.arange(B - n, B, device=queue.device).add_(ptr).remainder_(Q)
    return {
        **method_state,
        "queue": queue.index_copy(0, idx, t_global[B - n:].float()),
        "queue_ptr": (ptr + B) % Q,
        "queue_filled": min(method_state["queue_filled"] + B, Q),
    }


class DistillationV3(Method):
    name = "distillationv3"
    default_steps = 100_000
    default_batch_size = 1536

    def __init__(self, wrapped: WrappedModel, args: DistillationV3Args):
        super().__init__(wrapped, args)
        self.args: DistillationV3Args = args
        self.teacher = get_wrapped_model(args.teacher)
        self._teacher_state = (
            None if args.teacher_weights is None
            else load_teacher_weights(args.teacher_weights, args.teacher))
        d_t = self.teacher.feature_dim
        self.global_head = ProjectionHead(wrapped.feature_dim, d_t)
        self.local_head = ProjectionHead(wrapped.feature_dim, d_t)

    def view_specs(self) -> List[ViewSpec]:
        s = self.args.image_size
        return [ViewSpec(ViewAugmentConfig(out_size=(s, s)), count=1)]

    def init(self, generator: torch.Generator, device: torch.device
             ) -> Tuple[nn.ModuleDict, Dict[str, Any]]:
        modules = {"student": self.wrapped.module,
                   "global_head": self.global_head,
                   "local_head": self.local_head}
        # The student, its heads and the teacher are allocated on the device
        # and drawn leaf by leaf from the CPU generator: the values of an
        # init on the CPU, without the whole model standing on the host
        # first (a 7B one is 25 GiB).
        params = nn.ModuleDict(modules).to_empty(device=device)
        for m in modules.values():
            m.reset_parameters(generator)
        teacher = self.teacher.module
        if self._teacher_state is None:
            teacher.to_empty(device=device)
            teacher.reset_parameters(generator)
        else:
            teacher.load_state_dict(self._teacher_state)
        teacher = teacher.to(device).requires_grad_(False)
        a = self.args
        queue_size = int(a.queue_size) if a.queue_size != AUTO else 1024
        method_state = {
            "teacher": teacher,
            "queue": torch.zeros((queue_size, self.teacher.feature_dim),
                                 dtype=torch.float32, device=device),
            "queue_ptr": 0,
            "queue_filled": 0,
        }
        return params, method_state

    def draw_mixup(self, generator: Optional[torch.Generator],
                   images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lam in [0.5, 1), apply with probability ``mixup_prob``), each
        (B, 1, 1, 1), from the step's generator."""
        shape = (images.shape[0], 1, 1, 1)
        lam = 0.5 + 0.5 * torch.rand(shape, generator=generator,
                                     device=images.device)
        apply = torch.rand(shape, generator=generator,
                           device=images.device) < self.args.mixup_prob
        return lam, apply

    def forward_pair(self, params, method_state, images, generator=None):
        """(teacher global (B, Dt), teacher grid (B, gh, gw, Dt), student
        global head output, student local head output on the teacher's
        grid)."""
        with torch.no_grad():
            t_out = self.teacher.forward_features(
                images, None, train=False, module=method_state["teacher"])
            t_global = self.teacher.forward_pool(t_out)
            t_local = t_out["features"]
        s_out = self.wrapped.forward_features(
            images, None, train=True, generator=generator,
            module=params["student"])
        z_global = params["global_head"](self.wrapped.forward_pool(s_out))
        z_local = resample_grid(params["local_head"](s_out["features"]),
                                t_local.shape[1:3])
        return t_global, t_local, z_global, z_local

    def queue_losses(self, params, method_state, views, generator=None,
                     masks=None):
        """(global term, local term, the method state after the enqueue)."""
        a = self.args
        images = views[0]
        if a.mixup_prob > 0:
            lam, apply = (masks if masks is not None
                          else self.draw_mixup(generator, images))
            images = mixup(images, lam, apply)
        t_global, t_local, z_global, z_local = self.forward_pair(
            params, method_state, images, generator)
        # Until the queue holds entries, the batch's teacher embeddings
        # stand in for it.
        ref = (method_state["queue"] if method_state["queue_filled"] > 0
               else t_global)
        B, gh, gw, _ = t_local.shape
        loss_global = similarity_queue_ce(z_global, t_global, ref,
                                          a.temperature)
        loss_local = similarity_queue_ce(
            z_local.reshape(B, gh * gw, -1), t_local.reshape(B, gh * gw, -1),
            ref, a.temperature)
        return loss_global, loss_local, enqueue(method_state, t_global)

    def loss_fn(self, params, method_state, views, step, total_steps,
                generator=None, masks=None):
        loss_global, loss_local, new_method_state = self.queue_losses(
            params, method_state, views, generator, masks)
        loss = loss_global + self.args.lambda_local * loss_local
        metrics = {"loss_global": loss_global.detach(),
                   "loss_local": loss_local.detach()}
        return loss, (new_method_state, metrics)

    @classmethod
    def default_optimizer_args(cls) -> LARSArgs:
        return LARSArgs(lr=1.8, momentum=0.9, weight_decay=1e-6)
