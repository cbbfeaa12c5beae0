"""Module registry and dependency-injection runtime of the PyTorch port (the
JAX package's ``capreolus_tpu/core/module.py``):

- a registry of module classes keyed by (module_type, module_name). It is the
  port's OWN registry: ``ModuleRegistry.register`` replaces a name that is
  already registered, so a registry shared with the JAX package would let the
  last import win in a process that loads both packages;
- ``ModuleBase.create(name, config, provide)`` that recursively instantiates
  the dependency graph declared via ``Dependency``, earlier dependencies
  providing instances to later ones;
- deterministic, config-derived cache paths (``get_module_path`` /
  ``get_cache_path``) and ``config_keys_not_in_path`` exclusions, equal to the
  JAX package's for the same config;
- ``requires_random_seed`` per-module seeding, ``describe_class`` and
  ``print_config``.
"""

from __future__ import annotations

import hashlib
import importlib
import os
import pkgutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from capreolus_tpu_torch.core.config import ConfigError, ConfigOption, merge_config_dicts
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

# constants dict, patchable by tests; the port reads the same environment
# variables as the JAX package but keeps its artifacts under its own default root
constants: Dict[str, Any] = {}


def _default_constants():
    package_path = Path(__file__).resolve().parent.parent
    cache = Path(os.environ.get("CAPREOLUS_CACHE", os.path.expanduser("~/.capreolus_tpu_torch/cache")))
    results = Path(os.environ.get("CAPREOLUS_RESULTS", os.path.expanduser("~/.capreolus_tpu_torch/results")))
    constants.setdefault("PACKAGE_PATH", package_path)
    constants.setdefault("BASE_PACKAGE", "capreolus_tpu_torch")
    constants.setdefault("CACHE_BASE_PATH", cache)
    constants.setdefault("RESULTS_BASE_PATH", results)


_default_constants()


class ModuleRegistry:
    """Registry of module classes keyed by (module_type, module_name)."""

    def __init__(self):
        self._registry: Dict[str, Dict[str, type]] = {}

    def register(self, cls: type) -> type:
        module_type = getattr(cls, "module_type", None)
        module_name = getattr(cls, "module_name", None)
        if not module_type or not module_name:
            raise ConfigError(f"{cls} must define module_type and module_name to be registered")
        type_reg = self._registry.setdefault(module_type, {})
        if module_name in type_reg and type_reg[module_name] is not cls:
            logger.debug("re-registering %s/%s with %s", module_type, module_name, cls)
        type_reg[module_name] = cls
        return cls

    def lookup(self, module_type: str, module_name: str) -> type:
        try:
            return self._registry[module_type][module_name]
        except KeyError:
            known = sorted(self._registry.get(module_type, {}))
            raise ConfigError(
                f"unknown module {module_type}={module_name!r}; registered names: {known}"
            ) from None

    def get_module_types(self):
        return sorted(self._registry)

    def get_module_names(self, module_type: str):
        return sorted(self._registry.get(module_type, {}))


module_registry = ModuleRegistry()


def _path_safe(value: Any) -> str:
    """Render a config value into a filesystem-safe path fragment."""
    if isinstance(value, (list, tuple)):
        s = ",".join(str(v) for v in value)
    else:
        s = str(value)
    s = s.replace(os.sep, "_").replace(" ", "_").replace("=", "-")
    if len(s) > 60:
        s = s[:40] + "-" + hashlib.md5(s.encode("utf-8")).hexdigest()[:12]
    return s


class ModuleBase:
    """Base class for all framework modules.

    Subclasses declare:
      module_type (str), module_name (str),
      config_spec (list of ConfigOption), dependencies (list of Dependency),
      config_keys_not_in_path (list of str), requires_random_seed (bool)
    """

    module_type: str = None
    module_name: str = None
    config_spec = []
    dependencies = []
    config_keys_not_in_path = []
    requires_random_seed = False

    # ------------------------------------------------------------------ registry
    @classmethod
    def register(cls, subcls: type) -> type:
        return module_registry.register(subcls)

    @classmethod
    def lookup(cls, name: str) -> type:
        return module_registry.lookup(cls.module_type, name)

    # ------------------------------------------------------------------ creation
    @classmethod
    def create(cls, name: Optional[str] = None, config: Optional[dict] = None, provide: Optional[dict] = None):
        """Instantiate the module registered under ``name`` with ``config`` overrides.

        ``provide`` maps dependency keys (or module types) to already-created
        instances that are shared instead of created anew."""
        config = dict(config or {})
        if name is None:
            name = config.get("name") or getattr(cls, "module_name", None)
        if name is None:
            raise ConfigError(f"no module name given for module_type={cls.module_type}")
        target = module_registry.lookup(cls.module_type, name) if cls.module_type else cls
        return target._instantiate(config, provide or {})

    @classmethod
    def _effective_config_spec(cls):
        spec = list(cls.config_spec)
        if cls.requires_random_seed and not any(o.key == "seed" for o in spec):
            spec = spec + [ConfigOption("seed", 42, "random seed", value_type="int")]
        return spec

    @classmethod
    def _instantiate(cls, config: dict, provide: dict):
        self = cls.__new__(cls)
        cfg: Dict[str, Any] = {"name": cls.module_name}

        spec = {opt.key: opt for opt in cls._effective_config_spec()}
        for key in config:
            if key == "name" or key in spec or any(dep.key == key for dep in cls.dependencies):
                continue
            raise ConfigError(
                f"unknown config key {key!r} for module {cls.module_type}={cls.module_name}; "
                f"valid keys: {sorted(spec)} + deps {[d.key for d in cls.dependencies]}"
            )
        for key, opt in spec.items():
            raw = config.get(key, opt.default_value)
            try:
                cfg[key] = opt.cast(raw)
            except (TypeError, ValueError) as e:
                raise ConfigError(f"bad value {raw!r} for {cls.module_type}.{key}: {e}") from e

        # instantiate dependencies depth-first; earlier deps may provide instances to later ones
        provide = dict(provide)
        for dep in cls.dependencies:
            dep_config = dict(dep.default_config_overrides or {})
            user_cfg = config.get(dep.key, {})
            if isinstance(user_cfg, str):
                user_cfg = {"name": user_cfg}
            dep_config = merge_config_dicts(dep_config, user_cfg)

            provided = provide.get(dep.key)
            if provided is not None and (not dep_config.get("name") or dep_config.get("name") == provided.module_name):
                instance = provided
            else:
                base_cls = _MODULE_TYPE_BASES.get(dep.module)
                if base_cls is None:
                    raise ConfigError(f"unknown dependency module type {dep.module!r}")
                dep_name = dep_config.pop("name", None) or dep.name
                instance = base_cls.create(dep_name, dep_config, provide)

            setattr(self, dep.key, instance)
            cfg[dep.key] = instance.config
            if dep.provide_this:
                provide[dep.key] = instance
                provide[dep.module] = instance
            for child_key in dep.provide_children:
                child = getattr(instance, child_key, None)
                if child is not None:
                    provide[child_key] = child

        self.config = cfg
        if cls.requires_random_seed:
            self.rng = np.random.Generator(np.random.PCG64(cfg["seed"]))
        if hasattr(self, "build"):
            self.build()
        return self

    # ------------------------------------------------------------------ paths
    def _own_path_segment(self) -> str:
        parts = [f"{self.module_type}-{self.module_name}"]
        skip = set(self.config_keys_not_in_path) | {"name"}
        dep_keys = {dep.key for dep in self.dependencies}
        for key in sorted(self.config):
            if key in skip or key in dep_keys:
                continue
            parts.append(f"{key}-{_path_safe(self.config[key])}")
        seg = "_".join(parts)
        if len(seg) > 200:
            seg = seg[:150] + "-" + hashlib.md5(seg.encode("utf-8")).hexdigest()[:16]
        return seg

    def get_module_path(self) -> str:
        """Deterministic path fragment derived from this module's and its deps' configs."""
        dep_paths = []
        for dep in sorted(self.dependencies, key=lambda d: d.key):
            instance = getattr(self, dep.key, None)
            if instance is not None:
                dep_paths.append(instance.get_module_path())
        segments = dep_paths + [self._own_path_segment()]
        path = os.path.join(*segments)
        if len(path) > 900:
            digest = hashlib.md5(path.encode("utf-8")).hexdigest()[:16]
            path = os.path.join(segments[-1][:150], f"deps-{digest}")
        return path

    def get_cache_path(self) -> Path:
        return Path(constants["CACHE_BASE_PATH"]) / self.get_module_path()

    # ------------------------------------------------------------------ introspection
    @classmethod
    def describe_class(cls) -> str:
        lines = [f"{cls.module_type}={cls.module_name}  ({cls.__module__})"]
        doc = (cls.__doc__ or "").strip().splitlines()
        if doc:
            lines.append(f"  {doc[0]}")
        for opt in cls._effective_config_spec():
            lines.append(f"  option {opt.key} = {opt.default_value!r}  # {opt.description}")
        for dep in cls.dependencies:
            lines.append(f"  dependency {dep.key} -> {dep.module}={dep.name}")
        return "\n".join(lines)

    def print_config(self):
        import json

        print(json.dumps(self.config, indent=2, default=str))


# populated by module-type base classes as they are defined (collection, index, ...)
_MODULE_TYPE_BASES: Dict[str, type] = {}


def register_module_type(base_cls: type):
    """Register a module-type base class (Collection, Index, ...) for Dependency resolution."""
    _MODULE_TYPE_BASES[base_cls.module_type] = base_cls
    return base_cls


def import_all_modules(file: str, package: str):
    """Import all sibling modules of ``file`` so their @register decorators run."""
    directory = os.path.dirname(file)
    for _, name, _ in pkgutil.iter_modules([directory]):
        importlib.import_module(f"{package}.{name}")
