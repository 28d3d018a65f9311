"""Validation turning user dicts/kwargs into typed configs.

Port of ``lightly_train_tpu/_configs/validate.py`` without pydantic: unknown
keys raise :class:`ConfigUnknownKeyError` with a "did you mean" hint, values
are checked against the field annotations (with pydantic's lax coercions
that the configs rely on: int -> float, list -> tuple, a value -> its enum
member) and wrong ones raise
:class:`ConfigValidationError`.
"""

from __future__ import annotations

import dataclasses
import difflib
import enum
import typing
from typing import Any, Mapping, Type, TypeVar

from lightly_train_tpu_torch.errors import (
    ConfigUnknownKeyError,
    ConfigValidationError,
)

TConfig = TypeVar("TConfig")


def _coerce(value: Any, tp: Any, where: str) -> Any:
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if tp is Any:
        return value
    if origin is typing.Literal:
        if value in args:
            return value
        raise ConfigValidationError(f"{where}: {value!r} is not one of {args}")
    if origin is typing.Union:
        for arg in args:
            try:
                return _coerce(value, arg, where)
            except ConfigValidationError:
                continue
        raise ConfigValidationError(
            f"{where}: {value!r} matches none of {args}"
        )
    if tp is type(None):
        if value is None:
            return value
        raise ConfigValidationError(f"{where}: expected None, got {value!r}")
    if tp is bool:
        if isinstance(value, bool):
            return value
        raise ConfigValidationError(f"{where}: expected bool, got {value!r}")
    if tp is int:
        if isinstance(value, int) and not isinstance(value, bool):
            return value
        raise ConfigValidationError(f"{where}: expected int, got {value!r}")
    if tp is float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        raise ConfigValidationError(f"{where}: expected float, got {value!r}")
    if tp is str:
        if isinstance(value, str):
            return value
        raise ConfigValidationError(f"{where}: expected str, got {value!r}")
    if origin in (tuple, typing.Tuple):
        if not isinstance(value, (list, tuple)) or len(value) != len(args):
            raise ConfigValidationError(
                f"{where}: expected a {len(args)}-tuple, got {value!r}"
            )
        return tuple(
            _coerce(v, a, f"{where}[{i}]")
            for i, (v, a) in enumerate(zip(value, args))
        )
    if origin in (list, typing.List):
        if not isinstance(value, (list, tuple)):
            raise ConfigValidationError(f"{where}: expected a list, got "
                                        f"{value!r}")
        return [_coerce(v, args[0], f"{where}[{i}]")
                for i, v in enumerate(value)]
    if origin in (dict, typing.Dict):
        if not isinstance(value, Mapping):
            raise ConfigValidationError(f"{where}: expected a dict, got "
                                        f"{value!r}")
        return dict(value)
    if isinstance(tp, type) and isinstance(value, tp):
        return value
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        try:
            return tp(value)
        except ValueError:
            raise ConfigValidationError(
                f"{where}: {value!r} is not one of "
                f"{[m.value for m in tp]}") from None
    raise ConfigValidationError(f"{where}: unsupported value {value!r}")


def config_validate(config_cls: Type[TConfig], obj: Mapping[str, Any]) -> TConfig:
    """Build ``config_cls`` from ``obj``, checking keys and value types."""
    fields = {f.name: f for f in dataclasses.fields(config_cls)}
    valid = sorted(fields)
    for key in obj:
        if key not in fields:
            match = difflib.get_close_matches(str(key), valid, n=1)
            hint = f" Did you mean '{match[0]}'?" if match else ""
            raise ConfigUnknownKeyError(
                f"Unknown config key '{key}' for {config_cls.__name__}.{hint} "
                f"Valid keys: {valid}"
            )
    hints = typing.get_type_hints(config_cls)
    kwargs = {
        key: _coerce(value, hints[key], f"{config_cls.__name__}.{key}")
        for key, value in obj.items()
    }
    try:
        return config_cls(**kwargs)
    except TypeError as err:  # a required field is missing
        raise ConfigValidationError(
            f"Invalid config for {config_cls.__name__}: {err}"
        ) from err
