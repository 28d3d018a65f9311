"""Learning-rate schedules.

Port of the pretraining schedules of ``lightly_train_tpu/_optim/schedules.py``.
The step count lives on the host in the port, so a schedule is a plain
``step -> float`` function evaluated in Python.
"""

from __future__ import annotations

import math
from typing import Callable

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
