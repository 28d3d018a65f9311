"""Re-run a captured non-finite step.

Port of ``lightly_train_tpu/_debug/replay.py``. Everything it reads is in
the run's out directory:

- ``debug/nan_capture_step<N>.npz``: the step's number, its uint8 batch
  (and region masks, for a run with ``mask_dir``) and the state of its
  generator at its start (``NaNGuard.check``);
- ``metrics.jsonl``: the hyperparameters record (model and its
  ``model_args``, ``embed_dim``, method, the resolved method and optimizer
  arguments, steps, learning rate);
- ``checkpoints/``: the newest train state.

:func:`replay_nan_capture` rebuilds the method and the update as
``pretrain`` did, restores the newest checkpoint (a fresh init from the
run's seed where there is none), sets the step to the captured one, puts
the generator in its captured state and recomputes the loss and every
gradient of the captured batch, then names each non-finite gradient and
parameter. Only the port's own captures replay: a JAX capture holds a JAX
key, and the two packages' random streams differ. A capture replays on the
kind of device that wrote it (a CUDA generator's state does not fit a CPU
generator).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from lightly_train_tpu_torch._debug.nan_guard import (
    replay_capture,
    tree_abs_stats,
)
from lightly_train_tpu_torch._logging import get_logger

logger = get_logger("debug")


def _load_hyperparams(out_dir: Path) -> Dict[str, Any]:
    for line in (out_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        payload = rec.get("hyperparams", rec)
        if "model" in payload and "method" in payload:
            return payload
    raise FileNotFoundError(
        f"No hyperparameters record found in {out_dir / 'metrics.jsonl'}"
    )


def replay_nan_capture(out: Any, capture: Optional[Any] = None
                       ) -> Dict[str, Any]:
    """Re-run a captured step (default: the newest capture under
    ``out/debug``); returns ``{step, restored_checkpoint_step, loss, finite,
    offenders, metrics}``, the offenders named ``grads/<name>`` and
    ``params/<name>`` by the port's parameter names."""
    from lightly_train_tpu_torch._checkpoint.checkpoint import (
        CheckpointManager,
    )
    from lightly_train_tpu_torch._commands.train import (
        build_updater,
        resolve_device,
    )
    from lightly_train_tpu_torch._commands.train_loop import make_train_step
    from lightly_train_tpu_torch._configs.validate import config_validate
    from lightly_train_tpu_torch._optim import (
        OPTIMIZER_ARGS_TYPES,
        cosine_warmup,
    )
    from lightly_train_tpu_torch.methods.base import TrainState
    from lightly_train_tpu_torch.methods.method_helpers import get_method_cls
    from lightly_train_tpu_torch.models.embedding import project_wrapped
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    out_dir = Path(out)
    if capture is None:
        captures = sorted((out_dir / "debug").glob("nan_capture_step*.npz"),
                          key=lambda p: int(p.stem[len("nan_capture_step"):]))
        if not captures:
            raise FileNotFoundError(f"No captures under {out_dir / 'debug'}")
        capture = captures[-1]
    data = replay_capture(Path(capture))
    step = int(data["step"])

    hp = _load_hyperparams(out_dir)
    device = resolve_device(str(data["generator_device"]))
    dtype = torch.bfloat16 if hp.get("precision") == "bf16" else torch.float32
    wrapped = get_wrapped_model(hp["model"], dtype=dtype,
                                **(hp.get("model_args") or {}))
    if hp.get("embed_dim") is not None:
        wrapped = project_wrapped(wrapped, int(hp["embed_dim"]), dtype)
    method_cls, method_args_cls = get_method_cls(hp["method"])
    method = method_cls(wrapped, config_validate(method_args_cls,
                                                 hp["method_args"]))
    total_steps = int(hp["resolved_steps"])
    optim_dump = dict(hp["optim_args"])
    optim_args = config_validate(OPTIMIZER_ARGS_TYPES[optim_dump["type"]],
                                 optim_dump)
    warmup = int(float(hp.get("warmup_fraction", 0.1)) * total_steps)
    lr_schedule = cosine_warmup(float(hp["resolved_lr"]), total_steps, warmup)

    params, method_state = method.init(
        torch.Generator().manual_seed(int(hp.get("seed", 0))), device)
    updater = build_updater(method, optim_args, lr_schedule,
                            dict(params.named_parameters()), total_steps,
                            int(hp.get("seed", 0)))
    state = TrainState(step=0, params=params, method_state=method_state,
                       updater=updater)
    mgr = CheckpointManager(out_dir / "checkpoints")
    restored_step = mgr.latest_step()
    if restored_step is not None:
        mgr.restore(state)
    state.step = step  # the schedules' step and the captured draws'

    train_step = make_train_step(
        method, total_steps, aug_dtype=dtype,
        grad_accum_steps=int(hp.get("grad_accum_steps") or 1),
        transform_args=hp.get("transform_args") or None)
    generator = torch.Generator(device=device)
    generator.set_state(torch.from_numpy(data["generator"]))
    images = torch.from_numpy(data["batch"]).to(device)
    if "masks" in data:
        images = {"images": images,
                  "masks": torch.from_numpy(data["masks"]).to(device)}
    loss, grads, _, metrics = train_step.loss_and_grads(state, images,
                                                        generator)
    grad_stats = tree_abs_stats(grads)
    param_stats = tree_abs_stats(dict(state.params.named_parameters()))
    offenders = sorted(
        [f"grads/{n}" for n, (_, _, fin) in grad_stats.items() if not fin]
        + [f"params/{n}" for n, (_, _, fin) in param_stats.items() if not fin]
    )
    loss = float(loss.double())
    report = {
        "step": step,
        "restored_checkpoint_step": restored_step,
        "loss": loss,
        "finite": bool(np.isfinite(loss)) and not offenders,
        "offenders": offenders,
        "metrics": {k: float(v) for k, v in metrics.items()},
    }
    logger.info("Replayed step %d (checkpoint step %s): loss=%s "
                "offenders=%d", step, restored_step, report["loss"],
                len(offenders))
    return report
