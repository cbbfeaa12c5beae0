"""capreolus_tpu_torch: the PyTorch / CUDA port of capreolus_tpu.

The JAX package ``capreolus_tpu`` is the reference; this package keeps its
layout and module names so that each module's counterpart is easy to find, and
imports nothing of it (nor of JAX). Slice 1 covers retrieve-then-rerank serving:
the BM25 exact scoring engine and KNRM, whose fused simmat + kernel-pooling
kernel is hand-written CUDA for Hopper (``csrc/knrm_pool.cu``).

Entry points run on the GPU unless the caller asks for the CPU
(``RetrievalService(..., device="cpu")``).
"""

__version__ = "0.1.0"

from capreolus_tpu_torch.core import (
    ConfigError,
    ConfigOption,
    Dependency,
    ModuleBase,
    constants,
    module_registry,
)
from capreolus_tpu_torch.utils.loginit import get_logger

_MODULE_PACKAGES = (
    "collection",
    "index",
    "tokenizer",
    "extractor",
    "reranker",
)

_loaded = False


def load_all_modules():
    """Import every module-type package so their @register decorators run."""
    global _loaded
    if _loaded:
        return
    import importlib

    for pkg in _MODULE_PACKAGES:
        importlib.import_module(f"capreolus_tpu_torch.{pkg}")
    _loaded = True


__all__ = [
    "ConfigError",
    "ConfigOption",
    "Dependency",
    "ModuleBase",
    "constants",
    "get_logger",
    "load_all_modules",
    "module_registry",
]
