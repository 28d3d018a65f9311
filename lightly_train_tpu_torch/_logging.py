"""Console + file logging.

Copy of ``lightly_train_tpu/_logging.py``. The port runs one process so far,
so the console handler is always installed (the JAX package installs it on
process 0 only).
"""

from __future__ import annotations

import logging
import sys
import warnings
from pathlib import Path

from lightly_train_tpu_torch._env import Env

LOGGER_NAME = "lightly_train_tpu_torch"

_FORMAT = "%(asctime)s [%(levelname).1s] %(name)s: %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def get_logger(name: str | None = None) -> logging.Logger:
    if name is None:
        return logging.getLogger(LOGGER_NAME)
    return logging.getLogger(f"{LOGGER_NAME}.{name}")


def set_up_console_logging(level: str | int | None = None) -> None:
    """Install a console handler on the framework logger."""
    logger = logging.getLogger(LOGGER_NAME)
    if level is None:
        level = Env.LIGHTLY_TRAIN_LOG_LEVEL.value
    logger.setLevel(level)
    for handler in logger.handlers:
        if getattr(handler, "_lt_console", False):
            return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
    handler._lt_console = True  # type: ignore[attr-defined]
    logger.addHandler(handler)
    logging.captureWarnings(True)
    warnings.filterwarnings("default")


def set_up_file_logging(log_file: Path, level: str | int = logging.DEBUG) -> None:
    """Install a file handler writing to ``log_file``."""
    log_file = Path(log_file)
    log_file.parent.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger(LOGGER_NAME)
    for handler in logger.handlers:
        if isinstance(handler, logging.FileHandler) and Path(
            handler.baseFilename
        ) == log_file.resolve():
            return
    handler = logging.FileHandler(log_file)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
    logger.addHandler(handler)


def remove_file_handlers() -> None:
    logger = logging.getLogger(LOGGER_NAME)
    for handler in list(logger.handlers):
        if isinstance(handler, logging.FileHandler):
            logger.removeHandler(handler)
            handler.close()
