"""Logger selection and fan-out.

Port of ``lightly_train_tpu/_loggers/multi.py::build_loggers``: the same
names (``jsonl``, ``tensorboard``, ``wandb``, ``mlflow``) in the same list or
dict form, an unknown name raising ``ValueError``, and a backend whose
package is absent logging a warning while the run goes on, as the JAX
package's wrappers do. The port writes ``metrics.jsonl`` only: a backend
whose package is installed is refused (``NotImplementedError``, ROADMAP item
7.5) rather than silently logging nothing.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from lightly_train_tpu_torch._loggers.jsonl import JSONLLogger
from lightly_train_tpu_torch._logging import get_logger

logger = get_logger("loggers")

# Logger name -> the package its backend needs (None: the standard library).
BACKENDS = {"jsonl": None, "tensorboard": "tensorboard", "wandb": "wandb",
            "mlflow": "mlflow"}

LoggerSpec = Union[List[str], Dict[str, Optional[Dict[str, Any]]]]


def resolve_loggers(spec: LoggerSpec) -> List[Tuple[str, Dict[str, Any],
                                                     Optional[str]]]:
    """(name, kwargs, why it is unavailable or None) for each logger ``spec``
    turns on. The list form names them; the dict form (name -> kwargs, or
    None to disable) starts from the default ``jsonl``.

    Raises ``ValueError`` for an unknown name and ``NotImplementedError`` for
    a backend other than jsonl whose package is installed.
    """
    if isinstance(spec, dict):
        merged: Dict[str, Optional[Dict[str, Any]]] = {"jsonl": {}}
        merged.update(spec)
        entries = [(n, kw or {}) for n, kw in merged.items() if kw is not None]
    else:
        entries = [(n, {}) for n in spec]
    resolved = []
    for name, kwargs in entries:
        if name not in BACKENDS:
            raise ValueError(
                f"Unknown logger '{name}'. Options: {sorted(BACKENDS)}")
        package = BACKENDS[name]
        missing = None
        if package is not None:
            try:
                importlib.import_module(package)
            except ImportError as err:
                missing = str(err)
            else:
                raise NotImplementedError(
                    f"logger '{name}': {package} is installed, but the port "
                    "writes metrics.jsonl only (ROADMAP item 7.5)."
                )
        resolved.append((name, kwargs, missing))
    return resolved


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


def build_loggers(out_dir: Path, resolved) -> MultiLogger:
    """The loggers of :func:`resolve_loggers`' result; each unavailable one
    logs a warning and is left out."""
    loggers = []
    for name, kwargs, missing in resolved:
        if missing is not None:
            logger.warning("%s logging unavailable: %s", name, missing)
            continue
        loggers.append(JSONLLogger(out_dir, **kwargs))
    return MultiLogger(loggers)
