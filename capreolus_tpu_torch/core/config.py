"""Typed configuration primitives for the module system.

A copy of the JAX package's ``capreolus_tpu/core/config.py``: typed scalar
options and dependency declarations with config overrides. The port keeps its
own copy so that it imports nothing of the JAX package. List-valued options
(parameter grids), instance sharing between dependencies and the CLI's
config-string parsers come with the slices that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


class ConfigError(Exception):
    """Raised on invalid config keys or values."""


def _cast_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)):
        return bool(value)
    s = str(value).strip().lower()
    if s in ("true", "1", "yes", "y", "on"):
        return True
    if s in ("false", "0", "no", "n", "off", ""):
        return False
    raise ConfigError(f"cannot interpret {value!r} as a boolean")


def _cast_none_ok(caster: Callable[[Any], Any]) -> Callable[[Any], Any]:
    def _cast(value: Any) -> Any:
        if value is None:
            return None
        if isinstance(value, str) and value.strip().lower() in ("none", "null"):
            return None
        return caster(value)

    return _cast


_VALUE_TYPES: dict = {
    "str": _cast_none_ok(str),
    "int": _cast_none_ok(int),
    "float": _cast_none_ok(float),
    "bool": _cast_bool,
}


def _infer_value_type(default: Any) -> str:
    if isinstance(default, bool):
        return "bool"
    if isinstance(default, int):
        return "int"
    if isinstance(default, float):
        return "float"
    return "str"


class ConfigOption:
    """A typed, documented config option belonging to a module."""

    def __init__(self, key: str, default_value: Any, description: str = "", value_type: Optional[str] = None):
        self.key = key
        self.description = description
        if value_type is None:
            value_type = _infer_value_type(default_value)
        if value_type not in _VALUE_TYPES:
            raise ConfigError(f"unknown value_type {value_type!r} for option {key!r}")
        self.value_type = value_type
        self.cast = _VALUE_TYPES[value_type]
        self.default_value = self.cast(default_value)

    def __repr__(self):
        return f"ConfigOption({self.key!r}, default={self.default_value!r}, type={self.value_type})"


@dataclasses.dataclass
class Dependency:
    """Declares that a module depends on another module type."""

    key: str
    module: str
    name: Optional[str] = None
    default_config_overrides: Optional[dict] = None


def merge_config_dicts(base: dict, override: dict) -> dict:
    """Recursively merge override into base (override wins)."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_config_dicts(out[k], v)
        else:
            out[k] = v
    return out
