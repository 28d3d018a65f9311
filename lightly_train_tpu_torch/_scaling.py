"""Dataset-size aware hyperparameter scaling.

Copy of ``lightly_train_tpu/_scaling.py``: methods resolve "auto"
hyperparameters (queue sizes, epochs, schedules) from the dataset size via
bucket lookup or interpolation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, TypeVar

T = TypeVar("T")

IMAGENET_SIZE = 1_281_167


@dataclass(frozen=True)
class ScalingInfo:
    dataset_size: int
    epochs: int

    @staticmethod
    def default() -> "ScalingInfo":
        return ScalingInfo(dataset_size=IMAGENET_SIZE, epochs=100)


def interpolate(
    value: float,
    input_start: float,
    input_end: float,
    value_start: float,
    value_end: float,
    round_ndigits: int | None = None,
) -> float:
    """Linear interpolation of ``value`` from input range to value range, clamped."""
    if input_start >= input_end:
        raise ValueError("input_start must be < input_end")
    t = (value - input_start) / (input_end - input_start)
    t = min(max(t, 0.0), 1.0)
    out = value_start + t * (value_end - value_start)
    if round_ndigits is not None:
        out = round(out, round_ndigits)
    return out


def get_bucket_value(value: float, buckets: Sequence[Tuple[float, T]]) -> T:
    """Return the payload of the first bucket whose upper bound exceeds ``value``.

    ``buckets`` is a sequence of ``(upper_bound, payload)`` sorted ascending; the
    final bucket should use ``float("inf")`` as its bound.
    """
    for upper, payload in buckets:
        if value < upper:
            return payload
    raise ValueError(f"No bucket found for value {value}; last bucket must be inf.")
