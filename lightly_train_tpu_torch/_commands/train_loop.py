"""Pretraining runtime: the train step and the host step loop.

Port of ``lightly_train_tpu/_commands/train_loop.py``. One step runs
augmentation -> teacher and student forward -> loss -> backward -> the
update, eagerly on the device: the fused AdamW+EMA update where the
(optimizer, method) pair has one, else the unfused chain
(``_optim/update.py``) followed by the method's ``mask_updates`` and
``post_update``, as the JAX step branches. Gradient accumulation is a Python
loop over microbatches (the JAX package's ``lax.scan``).

A method that reads crop geometry (``needs_geometry``: DINOv31's PaKA) or
dataset region masks (``needs_masks``: DetCon with ``use_dataset_masks``)
gets them appended to its views, in the JAX order: the views, then one mask
crop per view (following the view's crop and flip), then one (B, 5)
geometry array per view.

Each step's randomness (augmentation, iBOT masks, drop path) comes from one
generator that :func:`fit` seeds from (seed, step) before the step, as the
JAX loop folds the step into its base key: a resumed run replays the steps
an uninterrupted one would have taken.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from lightly_train_tpu_torch._debug.nan_guard import NaNGuard
from lightly_train_tpu_torch._logging import get_logger
from lightly_train_tpu_torch._optim.fused_update import FusedAdamWEMA
from lightly_train_tpu_torch.methods.base import Method, TrainState, ViewSpec
from lightly_train_tpu_torch.ops.augment import (
    augment_view_with_params,
    crop_resize_nearest,
    override_view_specs,
    sample_view_params,
)

logger = get_logger("train_loop")


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: (seed, step) mixed by numpy's
    SeedSequence, so that every 32-bit part differs between steps (the CPU
    generator keeps the low 32 bits only)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def make_views(view_specs: List[ViewSpec], images_u8: torch.Tensor,
               generator: Optional[torch.Generator], dtype: torch.dtype,
               masks: Optional[torch.Tensor] = None,
               needs_masks: bool = False, needs_geometry: bool = False,
               view_params: Optional[List[Dict[str, torch.Tensor]]] = None,
               ) -> List[torch.Tensor]:
    """All views of ``view_specs`` of one uint8 (B, H, W, 3) batch; with
    ``needs_masks`` and region ``masks`` (int (B, H, W)) each view's mask
    crop after them, with ``needs_geometry`` each view's (B, 5) geometry
    after those. ``view_params`` (one :func:`sample_view_params` dict per
    view) replaces the draws from ``generator``."""
    views, mask_views, geoms = [], [], []
    i = 0
    for spec in view_specs:
        for _ in range(spec.count):
            p = (view_params[i] if view_params is not None else
                 sample_view_params(generator, images_u8.shape[0],
                                    tuple(images_u8.shape[1:3]), spec.config))
            view, geom = augment_view_with_params(images_u8, spec.config, p,
                                                  dtype)
            views.append(view)
            geoms.append(geom)
            if needs_masks and masks is not None:
                mv = crop_resize_nearest(masks, geom[:, 0], geom[:, 1],
                                         geom[:, 2], geom[:, 3],
                                         spec.config.out_size)
                mask_views.append(torch.where(
                    geom[:, 4][:, None, None] > 0.5, mv.flip(2), mv))
            i += 1
    return views + mask_views + (geoms if needs_geometry else [])


def make_train_step(
    method: Method,
    total_steps: int,
    aug_dtype: torch.dtype = torch.float32,
    grad_accum_steps: int = 1,
    transform_args: Optional[Dict[str, Any]] = None,
) -> Callable[..., Dict[str, Any]]:
    """Build ``train_step(state, images_u8, generator, views=None,
    masks=None) -> metrics``, which updates ``state`` in place.
    ``images_u8`` is a uint8 (B, H, W, 3) batch or a loader's ``{"images",
    "masks"}`` dict.

    ``transform_args`` overrides the method's views
    (:func:`override_view_specs`). ``views`` (one list per microbatch) and
    ``masks`` replace the sampled augmentation and iBOT masks, so a test can
    pin them. ``train_step.loss_and_grads`` (same arguments) is the step up
    to its update: ``(loss, grads, method_state, metrics)``, with ``state``
    left as it was and the gradients in the parameters' ``.grad``; the NaN
    replay runs it.
    """
    view_specs = override_view_specs(method.view_specs(), transform_args)
    needs_geometry = getattr(method, "needs_geometry", False)
    needs_masks = getattr(method, "needs_masks", False)
    if (needs_geometry or needs_masks) and any(
            s.config.vflip_prob > 0 or s.config.rotation_prob > 0
            for s in view_specs):
        raise ValueError(
            "vertical_prob/rotation > 0 is not supported with geometry/"
            "mask-consuming methods (DetCon, DINOv31): the recorded crop "
            "geometry carries hflip only, so vflipped/rotated views would "
            "pair with unflipped masks/teacher features.")

    def loss_and_grads(state: TrainState, images_u8,
                       generator: Optional[torch.Generator],
                       views: Optional[List[List[torch.Tensor]]] = None,
                       masks: Optional[List[torch.Tensor]] = None):
        k = grad_accum_steps
        if views is None:
            region = None
            if isinstance(images_u8, dict):
                images_u8, region = images_u8["images"], images_u8.get("masks")
            b = images_u8.shape[0]
            if b % k != 0:
                raise ValueError(
                    f"batch size {b} not divisible by grad_accum_steps {k}")
            region_mb = (region.chunk(k) if region is not None
                         else [None] * k)
            views = [make_views(view_specs, mb, generator, aug_dtype, rm,
                                needs_masks, needs_geometry)
                     for mb, rm in zip(images_u8.chunk(k), region_mb)]
        named = dict(state.params.named_parameters())
        for p in named.values():
            p.grad = None
        loss_sum = 0.0
        metric_sums: Dict[str, Any] = {}
        method_state = state.method_state
        for i, mb_views in enumerate(views):
            loss, (method_state, metrics) = method.loss_fn(
                state.params, method_state, mb_views, state.step,
                total_steps, generator=generator,
                masks=None if masks is None else masks[i],
            )
            (loss / len(views)).backward()
            loss_sum = loss_sum + loss.detach()
            for key, value in metrics.items():
                metric_sums[key] = metric_sums.get(key, 0.0) + value
        n = len(views)
        grads = {name: p.grad for name, p in named.items()}
        metrics = {key: value / n for key, value in metric_sums.items()}
        return loss_sum / n, grads, method_state, metrics

    def train_step(state: TrainState, images_u8: Optional[torch.Tensor],
                   generator: Optional[torch.Generator],
                   views: Optional[List[List[torch.Tensor]]] = None,
                   masks: Optional[List[torch.Tensor]] = None,
                   ) -> Dict[str, Any]:
        loss, grads, method_state, metrics = loss_and_grads(
            state, images_u8, generator, views, masks)
        params = state.params
        named = dict(params.named_parameters())
        if isinstance(state.updater, FusedAdamWEMA):
            grad_norm = state.updater.update_and_apply(
                grads, named,
                dict(method_state["teacher"].named_parameters()), state.step)
        else:
            # The grads dict holds the only reference to each gradient, so
            # the leaf-by-leaf update frees each as it goes.
            for p in named.values():
                p.grad = None
            step = state.step
            grad_norm = state.updater.update_and_apply(
                grads, named,
                lambda name, u: method.mask_updates({name: u}, step)[name])
            method_state = method.post_update(params, method_state,
                                              state.step, total_steps)
        state.method_state = method_state
        state.step += 1
        finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
        return {"train_loss": loss, "grad_norm": grad_norm, "finite": finite,
                **metrics}

    train_step.loss_and_grads = loss_and_grads
    return train_step


def _read_back(flag: torch.Tensor):
    """A host copy of a step's finite flag, started without waiting, and
    the event after which it holds (None on the CPU)."""
    if not flag.is_cuda:
        return flag, None
    host = torch.empty((), dtype=flag.dtype, pin_memory=True)
    host.copy_(flag, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def fit(
    train_step: Callable,
    state: TrainState,
    batches: Iterable[torch.Tensor],
    total_steps: int,
    generator: torch.Generator,
    seed: int = 0,
    log_every: int = 50,
    on_log: Optional[Callable[[int, Dict[str, float]], None]] = None,
    on_checkpoint: Optional[Callable[[int, TrainState], None]] = None,
    checkpoint_every: Optional[int] = None,
    nan_guard: Optional[NaNGuard] = None,
    on_first_batch: Optional[Callable[[torch.Tensor], None]] = None,
) -> TrainState:
    """Host step loop: feed batches, log throughput, checkpoint.

    Before each step ``generator`` is seeded from (``seed``, the step's
    number). The host reads metrics back (a device sync) only on logged
    steps, so the loop otherwise runs ahead of the device. With an enabled
    ``nan_guard`` every step's ``finite`` flag is read one step later, as
    the JAX loop does: once the next step is dispatched, so the device
    stays fed; a non-finite step is captured (its batch, its number and
    the generator's state at its start) and stops the run there.
    ``on_checkpoint`` runs every ``checkpoint_every`` steps before the
    last, and once at the end; ``on_first_batch`` on the run's first batch.
    """
    burn_in = {1, 2, 5, 10, 50, 100}
    current = state.step
    t_window = time.perf_counter()
    window_steps = 0
    data_wait = 0.0
    # The previous step's (host flag, event, state step, batch, generator
    # state at its start).
    lagged = None
    checking = nan_guard is not None and nan_guard.enabled

    def check(host, event, step, batch, generator_state) -> None:
        if event is not None:
            event.synchronize()  # this step's work only, not the one after
        nan_guard.check(bool(host), step, batch, generator_state,
                        dict(state.params.named_parameters()))

    batch_iter = iter(batches)
    while current < total_steps:
        t_data = time.perf_counter()
        batch = next(batch_iter)
        data_wait += time.perf_counter() - t_data
        images = batch["images"] if isinstance(batch, dict) else batch
        if on_first_batch is not None:
            on_first_batch(images)
            on_first_batch = None
        generator.manual_seed(step_seed(seed, current))
        start = generator.get_state() if checking else None
        metrics = train_step(state, batch, generator)
        current += 1
        window_steps += 1
        if checking:
            if lagged is not None:
                check(*lagged)
            lagged = (*_read_back(metrics["finite"]), current - 1, batch,
                      start)
        if current in burn_in or current % log_every == 0 or current == total_steps:
            values = {k: float(v) for k, v in metrics.items()}  # device sync
            dt = time.perf_counter() - t_window
            values["profiling/images_per_sec"] = (
                images.shape[0] * window_steps / max(dt, 1e-9))
            values["profiling/step_time"] = dt / max(window_steps, 1)
            values["profiling/data_time"] = data_wait / max(window_steps, 1)
            # The share of the window not spent waiting on host data (the
            # JAX loop's formula).
            values["profiling/device_duty_cycle"] = max(
                0.0, 1.0 - data_wait / max(dt, 1e-9))
            if on_log is not None:
                on_log(current, values)
            t_window = time.perf_counter()
            window_steps = 0
            data_wait = 0.0
        if (on_checkpoint is not None and checkpoint_every is not None
                and current % checkpoint_every == 0 and current < total_steps):
            on_checkpoint(current, state)
    if lagged is not None:
        check(*lagged)  # the last step's flag
    if on_checkpoint is not None:
        on_checkpoint(current, state)
    return state
