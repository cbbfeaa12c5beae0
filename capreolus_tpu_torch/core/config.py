"""Typed configuration primitives for the module system.

A copy of the JAX package's ``capreolus_tpu/core/config.py``: typed options,
list-valued options with the range syntax (parameter grids), dependency
declarations with config overrides and ``provide_this`` / ``provide_children``
instance sharing, and the CLI's config-string parsers. The port keeps its own
copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence


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


def _list_caster(elem_cast: Callable[[Any], Any]) -> Callable[[Any], Any]:
    """A caster producing a tuple of elements.

    String values may be comma-separated (the ``k1=0.9,1.1`` grid syntax).
    Numeric lists also take the inclusive range syntax ``a..b`` or
    ``a..b,step`` (intlist ``"0..12,1"``, floatlist ``"0.4..1,0.2"``).
    Scalars are promoted to 1-tuples.
    """

    def _cast(value: Any) -> tuple:
        if isinstance(value, str):
            if ".." in value and elem_cast in (int, float):
                try:
                    range_part, _, step_part = value.partition(",")
                    lo_s, _, hi_s = range_part.partition("..")
                    lo, hi = float(lo_s), float(hi_s)
                    step = float(step_part) if step_part else 1.0
                    if step <= 0 or hi < lo:
                        raise ValueError("range needs hi >= lo and step > 0")
                    out = []
                    v = lo
                    while v <= hi + 1e-9:
                        out.append(elem_cast(round(v, 10)))
                        v += step
                    return tuple(out)
                except ValueError as e:
                    raise ConfigError(f"cannot interpret {value!r} as a range (a..b or a..b,step): {e}") from None
            parts = [p for p in value.split(",") if p != ""]
            return tuple(elem_cast(p) for p in parts)
        if isinstance(value, (list, tuple)):
            return tuple(elem_cast(v) for v in value)
        return (elem_cast(value),)

    return _cast


_VALUE_TYPES: dict = {
    "str": _cast_none_ok(str),
    "int": _cast_none_ok(int),
    "float": _cast_none_ok(float),
    "bool": _cast_bool,
    "strlist": _list_caster(str),
    "intlist": _list_caster(int),
    "floatlist": _list_caster(float),
}


def _infer_value_type(default: Any) -> str:
    if isinstance(default, bool):
        return "bool"
    if isinstance(default, int):
        return "int"
    if isinstance(default, float):
        return "float"
    if isinstance(default, (list, tuple)):
        if default and isinstance(default[0], bool):
            return "strlist"
        if default and isinstance(default[0], int):
            return "intlist"
        if default and isinstance(default[0], float):
            return "floatlist"
        return "strlist"
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
    """Declares that a module depends on another module type. With
    ``provide_this`` the created instance is shared with the dependencies
    declared after it; ``provide_children`` shares the named attributes of it."""

    key: str
    module: str
    name: Optional[str] = None
    default_config_overrides: Optional[dict] = None
    provide_this: bool = False
    provide_children: Sequence[str] = ()


def config_string_to_dict(config_str: str) -> dict:
    """Parse a CLI-style config string ``a.b=1 c=2`` into a nested dict."""
    pairs = [kv for kv in config_str.split() if kv]
    return config_list_to_dict(pairs)


def config_list_to_dict(config_pairs: Sequence[str]) -> dict:
    """Parse a list of ``dotted.key=value`` strings into a nested dict."""
    out: dict = {}
    for pair in config_pairs:
        if "=" not in pair:
            raise ConfigError(f"invalid config string {pair!r}: expected key=value")
        key, value = pair.split("=", 1)
        parts = key.split(".")
        d = out
        for part in parts[:-1]:
            existing = d.setdefault(part, {})
            if not isinstance(existing, dict):
                # a scalar was already assigned at this prefix (e.g. `a=1 a.b=2`):
                # keep the scalar under the reserved "name" slot
                existing = {"name": existing}
                d[part] = existing
            d = existing
        leaf = parts[-1]
        if leaf in d and isinstance(d[leaf], dict):
            d[leaf]["name"] = value
        else:
            d[leaf] = value
    return out


def merge_config_dicts(base: dict, override: dict) -> dict:
    """Recursively merge override into base (override wins)."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_config_dicts(out[k], v)
        else:
            out[k] = v
    return out
