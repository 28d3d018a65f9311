"""The non-finite step's capture and the offender report.

Port of ``lightly_train_tpu/_debug/nan_guard.py``. The train loop reads
each step's finite flag one step later (``_commands/train_loop.py::fit``);
when a flag is false, :meth:`NaNGuard.check` writes
``debug/nan_capture_step<N>.npz`` with the step's number ``N`` (its
``state.step`` while it ran, as the JAX capture numbers it), its uint8
batch and the state of the step's generator at the step's start (the
port's counterpart of the JAX capture's key), then raises
``NaNDetectedError`` naming up to 20 non-finite parameter leaves. A batch
with region masks (``mask_dir``) also saves them, as ``masks``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from lightly_train_tpu_torch._logging import get_logger
from lightly_train_tpu_torch.errors import NaNDetectedError

logger = get_logger("debug")


def tree_abs_stats(tensors: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Tuple[float, float, bool]]:
    """name -> (abs_min, abs_max, finite) of each floating tensor; where a
    tensor is not finite, the extremes of its finite values (NaN if it has
    none)."""
    out = {}
    for name, t in tensors.items():
        if t is None or not t.is_floating_point():
            continue
        a = t.detach().float().abs()
        finite = bool(torch.isfinite(a).all())
        kept = a if finite else a[torch.isfinite(a)]
        out[name] = ((float(kept.min()), float(kept.max()), finite)
                     if kept.numel() else (float("nan"), float("nan"), finite))
    return out


class NaNGuard:
    """Writes the capture of a non-finite step and raises."""

    def __init__(self, out_dir: Path, enabled: bool = True):
        self.out_dir = Path(out_dir) / "debug"
        self.enabled = enabled

    def check(self, finite: bool, step: int, batch,
              generator_state: torch.Tensor,
              params: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        """Nothing if ``finite``; else the capture of the step that ran with
        ``state.step == step`` on ``batch`` from ``generator_state``, and
        ``NaNDetectedError`` naming the non-finite leaves of ``params``."""
        if not self.enabled or finite:
            return
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"nan_capture_step{step}.npz"
        arrays = ({"batch": batch["images"], "masks": batch["masks"]}
                  if isinstance(batch, dict) else {"batch": batch})
        np.savez_compressed(
            path, step=np.asarray(step),
            generator=generator_state.cpu().numpy(),
            generator_device=np.asarray(str(arrays["batch"].device.type)),
            **{k: v.detach().cpu().numpy() for k, v in arrays.items()})
        offenders = []
        if params is not None:
            offenders = [
                f"{name}: abs_max={amax:.3e} finite={fin}"
                for name, (_, amax, fin) in sorted(
                    tree_abs_stats(params).items())
                if not fin
            ][:20]
        msg = (
            f"Non-finite loss/gradients at step {step + 1} (the step's "
            f"number in metrics.jsonl; it ran with state step {step}). "
            f"Replay payload: {path}."
            + ("\nOffending leaves:\n" + "\n".join(offenders)
               if offenders else "")
        )
        logger.error(msg)
        raise NaNDetectedError(msg)


def replay_capture(path: Path) -> Dict[str, np.ndarray]:
    """The arrays of a capture file."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
