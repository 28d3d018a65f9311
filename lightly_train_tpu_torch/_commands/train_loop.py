"""Pretraining runtime: the train step and the host step loop.

Port of ``lightly_train_tpu/_commands/train_loop.py``. One step runs
augmentation -> teacher and student forward -> loss -> backward -> the
update, eagerly on the device: the fused AdamW+EMA update where the
(optimizer, method) pair has one, else the unfused chain
(``_optim/update.py``) followed by the method's ``mask_updates`` and
``post_update``, as the JAX step branches. Gradient accumulation is a Python
loop over microbatches (the JAX package's ``lax.scan``).

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

from lightly_train_tpu_torch._logging import get_logger
from lightly_train_tpu_torch._optim.fused_update import FusedAdamWEMA
from lightly_train_tpu_torch._optim.update import apply_updates
from lightly_train_tpu_torch.errors import NaNDetectedError
from lightly_train_tpu_torch.methods.base import Method, TrainState, ViewSpec
from lightly_train_tpu_torch.ops.augment import (
    augment_view_with_geometry,
    override_view_specs,
)

logger = get_logger("train_loop")


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: (seed, step) mixed by numpy's
    SeedSequence, so that every 32-bit part differs between steps (the CPU
    generator keeps the low 32 bits only)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def make_views(view_specs: List[ViewSpec], images_u8: torch.Tensor,
               generator: torch.Generator,
               dtype: torch.dtype) -> List[torch.Tensor]:
    """All views of ``view_specs`` of one uint8 (B, H, W, 3) batch."""
    views = []
    for spec in view_specs:
        for _ in range(spec.count):
            view, _ = augment_view_with_geometry(generator, images_u8,
                                                 spec.config, dtype)
            views.append(view)
    return views


def make_train_step(
    method: Method,
    total_steps: int,
    aug_dtype: torch.dtype = torch.float32,
    grad_accum_steps: int = 1,
    transform_args: Optional[Dict[str, Any]] = None,
) -> Callable[..., Dict[str, Any]]:
    """Build ``train_step(state, images_u8, generator, views=None,
    masks=None) -> metrics``, which updates ``state`` in place.

    ``transform_args`` overrides the method's views
    (:func:`override_view_specs`). ``views`` (one list per microbatch) and
    ``masks`` replace the sampled augmentation and iBOT masks, so a test can
    pin them.
    """
    view_specs = override_view_specs(method.view_specs(), transform_args)

    def train_step(state: TrainState, images_u8: Optional[torch.Tensor],
                   generator: Optional[torch.Generator],
                   views: Optional[List[List[torch.Tensor]]] = None,
                   masks: Optional[List[torch.Tensor]] = None,
                   ) -> Dict[str, Any]:
        k = grad_accum_steps
        if views is None:
            b = images_u8.shape[0]
            if b % k != 0:
                raise ValueError(
                    f"batch size {b} not divisible by grad_accum_steps {k}")
            views = [make_views(view_specs, mb, generator, aug_dtype)
                     for mb in images_u8.chunk(k)]
        params = state.params
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        loss_sum = 0.0
        metric_sums: Dict[str, Any] = {}
        method_state = state.method_state
        for i, mb_views in enumerate(views):
            loss, (method_state, metrics) = method.loss_fn(
                params, method_state, mb_views, state.step, total_steps,
                generator=generator,
                masks=None if masks is None else masks[i],
            )
            (loss / len(views)).backward()
            loss_sum = loss_sum + loss.detach()
            for key, value in metrics.items():
                metric_sums[key] = metric_sums.get(key, 0.0) + value
        n = len(views)
        loss = loss_sum / n
        grads = {name: p.grad for name, p in named.items()}
        if isinstance(state.updater, FusedAdamWEMA):
            grad_norm = state.updater.update_and_apply(
                grads, named,
                dict(method_state["teacher"].named_parameters()), state.step)
        else:
            updates, grad_norm = state.updater.update(grads, named)
            apply_updates(named, method.mask_updates(updates, state.step))
            method_state = method.post_update(params, method_state,
                                              state.step, total_steps)
        state.method_state = method_state
        state.step += 1
        finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
        return {"train_loss": loss, "grad_norm": grad_norm, "finite": finite,
                **{key: value / n for key, value in metric_sums.items()}}

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


def _check_finite(host: torch.Tensor, event, step: int) -> None:
    """Raises NaNDetectedError naming ``step`` if its flag is false. The
    JAX package also writes debug/nan_capture.npz here; the port's capture
    is ROADMAP item 7.3."""
    if event is not None:
        event.synchronize()  # this step's work only, not the one after it
    if not bool(host):
        raise NaNDetectedError(
            f"Non-finite loss/gradients at step {step} (the step's number "
            "in metrics.jsonl). No replay capture is written yet (ROADMAP "
            "item 7.3)."
        )


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
    nan_check: bool = False,
    on_first_batch: Optional[Callable[[torch.Tensor], None]] = None,
) -> TrainState:
    """Host step loop: feed batches, log throughput, checkpoint.

    Before each step ``generator`` is seeded from (``seed``, the step's
    number). The host reads metrics back (a device sync) only on logged
    steps, so the loop otherwise runs ahead of the device. With
    ``nan_check`` every step's ``finite`` flag is read one step later, as
    the JAX loop does: once the next step is dispatched, so the device
    stays fed, and a non-finite step stops the run there, named by its
    number. ``on_checkpoint`` runs every ``checkpoint_every`` steps before
    the last, and once at the end; ``on_first_batch`` on the run's first
    batch.
    """
    burn_in = {1, 2, 5, 10, 50, 100}
    current = state.step
    t_window = time.perf_counter()
    window_steps = 0
    data_wait = 0.0
    lagged = None  # the previous step's (host flag, event, step number)
    batch_iter = iter(batches)
    while current < total_steps:
        t_data = time.perf_counter()
        batch = next(batch_iter)
        data_wait += time.perf_counter() - t_data
        if on_first_batch is not None:
            on_first_batch(batch)
            on_first_batch = None
        generator.manual_seed(step_seed(seed, current))
        metrics = train_step(state, batch, generator)
        current += 1
        window_steps += 1
        if nan_check:
            if lagged is not None:
                _check_finite(*lagged)
            lagged = (*_read_back(metrics["finite"]), current)
        if current in burn_in or current % log_every == 0 or current == total_steps:
            values = {k: float(v) for k, v in metrics.items()}  # device sync
            dt = time.perf_counter() - t_window
            values["profiling/images_per_sec"] = (
                batch.shape[0] * window_steps / max(dt, 1e-9))
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
        _check_finite(*lagged)  # the last step's flag
    if on_checkpoint is not None:
        on_checkpoint(current, state)
    return state
