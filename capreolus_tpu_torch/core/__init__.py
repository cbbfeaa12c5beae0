from capreolus_tpu_torch.core.config import (
    ConfigError,
    ConfigOption,
    Dependency,
    merge_config_dicts,
)
from capreolus_tpu_torch.core.module import (
    ModuleBase,
    constants,
    import_all_modules,
    module_registry,
    register_module_type,
)

__all__ = [
    "ConfigError",
    "ConfigOption",
    "Dependency",
    "ModuleBase",
    "constants",
    "import_all_modules",
    "merge_config_dicts",
    "module_registry",
    "register_module_type",
]
