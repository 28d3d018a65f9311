"""Logger backends: TensorBoard, W&B, MLflow, and the fan-out MultiLogger.

Port of ``lightly_train_tpu/_loggers/multi.py``: the same names (``jsonl``,
``tensorboard``, ``wandb``, ``mlflow``) in the same list or dict form, jsonl
on by default, an unknown name raising ``ValueError``. Each backend imports
its package lazily and, where that fails (the package is absent), logs a
warning and logs nothing while the run goes on, as the JAX package's
wrappers do. TensorBoard writes through ``torch.utils.tensorboard``'s
``SummaryWriter`` (which needs the ``tensorboard`` package) into
``<out>/tensorboard``; W&B and MLflow through their own packages. MLflow's
metric keys have ``/`` replaced by ``_`` and its params are cut to 250
characters. Only the main process logs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from lightly_train_tpu_torch._loggers.jsonl import JSONLLogger
from lightly_train_tpu_torch._logging import get_logger
from lightly_train_tpu_torch.parallel.distributed import is_main_process

logger = get_logger("loggers")

LoggerSpec = Union[List[str], Dict[str, Optional[Dict[str, Any]]]]


class TensorBoardLogger:
    def __init__(self, out_dir: Path):
        self._writer = None
        if not is_main_process():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(str(Path(out_dir) / "tensorboard"))
        except Exception as e:
            logger.warning("tensorboard logging unavailable: %s", e)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if self._writer is None:
            return
        for k, v in metrics.items():
            try:
                self._writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass
        self._writer.flush()

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if self._writer is None:
            return
        try:
            from torch.utils.tensorboard.summary import hparams

            # The hparams summaries into this run's own file (the writer's
            # add_hparams would open a run of its own).
            for summary in hparams({k: v for k, v in params.items()
                                    if isinstance(v, (int, float, str,
                                                      bool))}, {}):
                self._writer.file_writer.add_summary(summary)
        except Exception:
            pass

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class WandbLogger:
    def __init__(self, out_dir: Path, project: str = "lightly-train-tpu",
                 **kwargs: Any):
        self._run = None
        if not is_main_process():
            return
        try:
            import wandb

            self._run = wandb.init(project=project, dir=str(out_dir),
                                   **kwargs)
        except Exception as e:
            logger.warning("wandb logging unavailable: %s", e)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if self._run is not None:
            self._run.log(metrics, step=step)

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if self._run is not None:
            self._run.config.update(params, allow_val_change=True)

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()


class MLflowLogger:
    def __init__(self, out_dir: Path, run_name: Optional[str] = None,
                 **kwargs: Any):
        self._mlflow = None
        if not is_main_process():
            return
        try:
            import mlflow

            mlflow.start_run(run_name=run_name)
            self._mlflow = mlflow
        except Exception as e:
            logger.warning("mlflow logging unavailable: %s", e)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if self._mlflow is None:
            return
        clean = {}
        for k, v in metrics.items():
            try:
                clean[k.replace("/", "_")] = float(v)
            except (TypeError, ValueError):
                pass
        self._mlflow.log_metrics(clean, step=step)

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if self._mlflow is not None:
            self._mlflow.log_params(
                {k: str(v)[:250] for k, v in params.items()})

    def close(self) -> None:
        if self._mlflow is not None:
            self._mlflow.end_run()


class MultiLogger:
    """Fans every call out to all configured backends (none at all when the
    spec turns jsonl off)."""

    def __init__(self, loggers: List[Any]):
        self.loggers = loggers

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        for lg in self.loggers:
            lg.log_hyperparams(params)

    def close(self) -> None:
        for lg in self.loggers:
            lg.close()


_BACKENDS = {
    "jsonl": JSONLLogger,
    "tensorboard": TensorBoardLogger,
    "wandb": WandbLogger,
    "mlflow": MLflowLogger,
}


def resolve_loggers(spec: LoggerSpec) -> List[Tuple[str, Dict[str, Any]]]:
    """(name, kwargs) of each logger ``spec`` turns on. The list form names
    them; the dict form (name -> kwargs, or None to disable) starts from
    the default ``jsonl``. An unknown name raises ``ValueError``."""
    if isinstance(spec, dict):
        merged: Dict[str, Optional[Dict[str, Any]]] = {"jsonl": {}}
        merged.update(spec)
        entries = [(n, kw or {}) for n, kw in merged.items() if kw is not None]
    else:
        entries = [(n, {}) for n in spec]
    for name, _ in entries:
        if name not in _BACKENDS:
            raise ValueError(
                f"Unknown logger '{name}'. Options: {sorted(_BACKENDS)}")
    return entries


def build_loggers(out_dir: Path, spec: LoggerSpec) -> MultiLogger:
    """The logger fan-out of a list of names or a config dict (see
    :func:`resolve_loggers`)."""
    return MultiLogger([_BACKENDS[name](out_dir, **kwargs)
                        for name, kwargs in resolve_loggers(spec)])
