"""Framework exception hierarchy.

Copy of ``lightly_train_tpu/errors.py``, which mirrors the reference surface:
typed errors for config validation, unknown models/methods, and checkpoint
issues so callers can catch framework failures distinctly from library bugs.
"""

from __future__ import annotations


class LightlyTrainError(Exception):
    """Base class for all framework errors."""


class ConfigError(LightlyTrainError):
    """Invalid user configuration."""


class ConfigValidationError(ConfigError):
    """Validation of a user config failed."""


class ConfigUnknownKeyError(ConfigError):
    """User passed a key that does not exist in the config."""


class UnknownModelError(ConfigError):
    """Requested model name is not registered."""


class UnknownMethodError(ConfigError):
    """Requested SSL method name is not registered."""


class UnknownTaskError(ConfigError):
    """Requested fine-tuning task is not registered."""


class CheckpointError(LightlyTrainError):
    """Checkpoint missing, corrupt, or incompatible."""


class NaNDetectedError(LightlyTrainError):
    """A NaN/Inf was detected in losses or gradients during training."""


class DatasetError(LightlyTrainError):
    """Dataset is empty, malformed, or has unsupported layout."""


class ModifyScopeVariableError(LightlyTrainError):
    """A train-mode forward would update a model's running statistics where
    the method gives none to update: the JAX package's DINOv2 and DINOv31
    apply a BatchNorm student without ``mutable``, and Flax raises its
    error of this name there; the port raises this one at the same
    point."""
