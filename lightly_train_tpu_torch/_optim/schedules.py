"""Learning-rate schedules.

Port of ``lightly_train_tpu/_optim/schedules.py``'s ``cosine_warmup``,
``two_stage_warmup_poly`` (EoMT), ``flat_cosine`` (detection) and
``scale_lr_for_batch_size``. The step
count lives on the host in the port, so a schedule is a plain
``step -> float`` function evaluated in Python (EoMT's in float32, in the
JAX schedule's order of operations).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np

Schedule = Callable[[int], float]


def cosine_warmup(
    base_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    end_lr_factor: float = 0.0,
    warmup_start_factor: float = 0.0,
) -> Schedule:
    """Linear warmup then cosine decay to ``base_lr * end_lr_factor``."""
    warmup_steps = min(warmup_steps, max(total_steps - 1, 0))

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (
                warmup_start_factor
                + (1.0 - warmup_start_factor) * step / max(warmup_steps, 1)
            )
        progress = min(max(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0
        ), 1.0)
        return base_lr * (
            end_lr_factor
            + (1.0 - end_lr_factor) * 0.5 * (1.0 + math.cos(math.pi * progress))
        )

    return schedule


def flat_cosine(
    base_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    flat_fraction: float = 0.5,
    end_lr_factor: float = 0.0,
) -> Schedule:
    """Detection's schedule, in float32 as the JAX one: a linear warmup,
    flat at ``base_lr`` to ``flat_fraction`` of the steps after it, then a
    cosine decay to ``base_lr * end_lr_factor``."""
    f32 = np.float32
    flat_end = warmup_steps + int(flat_fraction
                                  * max(total_steps - warmup_steps, 0))
    lr, end = f32(base_lr), f32(end_lr_factor)

    def schedule(step: int) -> float:
        t = f32(step)
        if t < warmup_steps:
            return float(lr * t / f32(max(warmup_steps, 1)))
        if t < flat_end:
            return float(lr)
        progress = min(max((t - f32(flat_end)) / f32(
            max(total_steps - flat_end, 1)), f32(0.0)), f32(1.0))
        return float(lr * (end + (f32(1.0) - end) * f32(0.5) * (
            f32(1.0) + np.cos(f32(np.pi) * progress))))

    return schedule


def two_stage_warmup_poly(
    base_lr: float,
    total_steps: int,
    warmup_steps: Tuple[int, int] = (500, 1000),
    poly_power: float = 0.9,
) -> Tuple[Schedule, Schedule]:
    """EoMT's two-stage warmup: (backbone schedule, heads' schedule).

    The heads warm up linearly over ``warmup_steps[0]``, then decay as
    ``(1 - t / horizon) ** poly_power`` over the rest; the backbone's lr is 0
    during the heads' warmup, then warms up over ``warmup_steps[1]``, then
    decays over what remains."""
    f32 = np.float32
    head_warm, bb_warm = int(warmup_steps[0]), int(warmup_steps[1])
    lr, power = f32(base_lr), f32(poly_power)

    def head_schedule(step: int) -> float:
        t = f32(step)
        if t < head_warm:
            return float(lr * t / f32(max(head_warm, 1)))
        adjusted = max(t - f32(head_warm), f32(0.0))
        return float(lr * (f32(1.0) - adjusted / f32(
            max(total_steps - head_warm, 1))) ** power)

    def backbone_schedule(step: int) -> float:
        t = f32(step)
        if t < head_warm:
            return 0.0
        if t < head_warm + bb_warm:
            return float(lr * (t - f32(head_warm)) / f32(max(bb_warm, 1)))
        adjusted = max(t - f32(head_warm) - f32(bb_warm), f32(0.0))
        return float(lr * (f32(1.0) - adjusted / f32(
            max(total_steps - head_warm - bb_warm, 1))) ** power)

    return backbone_schedule, head_schedule


def scale_lr_for_batch_size(
    base_lr: float,
    global_batch_size: int,
    reference_batch_size: int,
    method: str = "linear",
) -> float:
    """Global-batch LR scaling: "linear" (lr * B/B_ref) or "sqrt"."""
    ratio = global_batch_size / reference_batch_size
    if method == "linear":
        return base_lr * ratio
    if method == "sqrt":
        return base_lr * math.sqrt(ratio)
    raise ValueError(f"Unknown lr scale method '{method}' (linear|sqrt)")
