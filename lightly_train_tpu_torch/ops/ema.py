"""EMA update and schedules.

Port of ``lightly_train_tpu/ops/ema.py``: ``ema_warmup_momentum``
(the fine-tuning EMA of detection), ``cosine_schedule`` (teacher
momentum 0.992 -> 1.0 and weight decay 0.04 -> 0.4 for DINOv2) and
``ema_update``. The step lives on the host, so the schedule returns a Python
float. With AdamW the EMA runs in the fused AdamW+EMA kernel
(``_optim/fused_update.py``); :func:`ema_update` is the unfused path's.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch


@torch.no_grad()
def ema_update(teacher: Mapping[str, torch.Tensor],
               student: Mapping[str, torch.Tensor], momentum: float) -> None:
    """In place: ``t <- m t + (1 - m) s`` for every teacher tensor."""
    for name, t in teacher.items():
        t.mul_(momentum).add_(student[name].to(t.dtype), alpha=1.0 - momentum)


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


def ema_warmup_momentum(step: int, decay: float,
                        warmup_steps: int = 2000) -> float:
    """Detection's EMA decay warmup ``decay * (1 - exp(-step / tau))``, in
    float32 as the JAX one."""
    f32 = np.float32
    return float(f32(decay) * (f32(1.0) - np.exp(
        -f32(step) / f32(max(warmup_steps, 1)))))
