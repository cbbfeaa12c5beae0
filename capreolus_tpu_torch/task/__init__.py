"""Task modules: experiment orchestration (the JAX package's ``task/__init__.py``).

A Task is a module with ``commands`` runnable from the CLI, help commands, and
results paths derived from the full pipeline config. Ported so far: ``modules``,
``rank`` and ``rerank``; ``rererank`` waits for the other rerankers (ROADMAP.md item 6).
"""

from __future__ import annotations

from pathlib import Path

from capreolus_tpu_torch.core import ModuleBase, constants, import_all_modules, module_registry, register_module_type


@register_module_type
class Task(ModuleBase):
    module_type = "task"
    commands = []
    help_commands = ["describe", "print_config", "print_paths", "print_pipeline"]
    default_command = "describe"
    requires_random_seed = True

    def get_results_path(self) -> Path:
        """Results directory derived from the full pipeline config."""
        return Path(constants["RESULTS_BASE_PATH"]) / self.get_module_path()

    # ------------------------------------------------------------------ help commands
    def describe(self):
        print(type(self).describe_class())

    def print_config(self):
        import json

        print(json.dumps(self.config, indent=2, default=str))

    def print_paths(self):
        print("results:", self.get_results_path())
        print("cache:", self.get_cache_path())

    def print_pipeline(self):
        def walk(mod, depth=0):
            print("  " * depth + f"{mod.module_type}={mod.module_name}")
            for dep in mod.dependencies:
                child = getattr(mod, dep.key, None)
                if child is not None:
                    walk(child, depth + 1)

        walk(self)


@Task.register
class ModulesTask(Task):
    """List all registered modules."""

    module_name = "modules"
    commands = ["list_modules"]
    default_command = "list_modules"

    def list_modules(self):
        for module_type in module_registry.get_module_types():
            print(f"module type={module_type}")
            for name in module_registry.get_module_names(module_type):
                print(f"       name={name}")


import_all_modules(__file__, __package__)
