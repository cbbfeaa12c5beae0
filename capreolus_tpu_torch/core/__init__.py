from capreolus_tpu_torch.core.config import (
    ConfigError,
    ConfigOption,
    Dependency,
    config_list_to_dict,
    config_string_to_dict,
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
    "config_list_to_dict",
    "config_string_to_dict",
    "constants",
    "import_all_modules",
    "merge_config_dicts",
    "module_registry",
    "register_module_type",
]
