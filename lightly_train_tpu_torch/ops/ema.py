"""EMA schedules.

Port of ``lightly_train_tpu/ops/ema.py::cosine_schedule`` (teacher momentum
0.992 -> 1.0 and weight decay 0.04 -> 0.4 for DINOv2). The step lives on the
host, so the schedule returns a Python float. The EMA update itself runs in
the fused AdamW+EMA kernel (``_optim/fused_update.py``).
"""

from __future__ import annotations

import math


def cosine_schedule(
    step: int,
    total_steps: int,
    start_value: float,
    end_value: float,
    warmup_steps: int = 0,
    warmup_start: float = 0.0,
) -> float:
    """Cosine interpolation from start_value to end_value with linear warmup."""
    total = max(total_steps, 1)
    if step < warmup_steps:
        return warmup_start + (start_value - warmup_start) * (
            step / max(warmup_steps, 1)
        )
    denom = max(total - warmup_steps, 1)
    progress = min(max((step - warmup_steps) / denom, 0.0), 1.0)
    return end_value + (start_value - end_value) * 0.5 * (
        1.0 + math.cos(math.pi * progress)
    )
